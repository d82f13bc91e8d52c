"""``--scaled-e2e``: the composed train step at 1,000,001 item rows, the
counterpart of the JAX package's ``bench/scaled_e2e.py``.

``--scaled`` times separate ops at one vocab shard; this composes the whole
production step of ``train/step.make_train_step`` on the card at the
JAX script's shapes: 500,000 items a domain and the pad row, d 128, batch
512, len_max 15, two 3,000,000-edge graphs (``_synthetic_graph``, the JAX
script's numpy code, seeds 0 and 1), 2,048 synthetic users (seed 2), the
train split from seed 3 and an eval split of 512 users from seed 4, AdamW
amsgrad with ``steps_per_epoch=4``.  Every kernel of the one-card path runs
in the step: K1 over A and Aᵀ of both graphs into 1M-row tables, K2 and K3
at FK's tower shapes, K4 and K5 at V 500,000 a domain, and K7 into the
1M-row tables.

Gates, before any number counts:

* the loss is finite, and lower after the timed windows than at the first
  step, on the same batch; on the card every kernel of the step launched in the windows;
* the CE rows of 128 probe rows at the full V, and their gradients, against
  the float64 oracle over row chunks (``scaled_bench.ce_oracle``, CE_TOL
  and GRAD_TOL);
* full-rank ranks are >= 1 and at most the domain's items, and on 32 rows
  of each domain equal to ranks counted over vocab chunks but at near-ties
  (``scaled_bench.full_rank_delta``);
* on the card, one more step's own kernel calls, recorded as it makes
  them: K1 against the plain SpMM within SPMM_TOL, K4 and K5 against their
  plain versions in float64 over row chunks (K4_TOL, GRAD_TOL; the plain
  f32 versions' own error beside: at V 500,000 the plain f32 dh lies about
  2e-5 from float64), K7 bitwise CPU ``index_add_``; each then timed
  beside its plain f32 version and cuBLAS's (K4, K5), with its bound.

Reports step ms and train examples/s (the best of the windows), full-rank
eval examples/s and items/s, ``torch.cuda.max_memory_allocated``, each
kernel's launches in the windows and the card's name and power limit.
On the CPU (``device="cpu"``, the tests, at a tiny :class:`Size`) the
same path runs the plain versions; the kernel checks and launch gates are
the card's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from c2dsr_tpu_torch.bench import scaled_bench, timing

SPMM_TOL = 1e-5          # K1: max abs error over max |plain| (chip_smoke.py)
CE_TOL = scaled_bench.CE_TOL
GRAD_TOL = scaled_bench.GRAD_TOL
K4_TOL = 2.6e-6          # K4's lse and target logit on the step's calls,
                         # over max |float64|: ten times the plain f32
                         # version's error there (2.6e-7 on an H100)
PLAIN_CE_BYTES = 2 << 30  # the plain CE's logits a row chunk, at most
_rel = scaled_bench._rel   # max abs error over max |reference|


@dataclasses.dataclass(frozen=True)
class Size:
    """The run's shapes; the defaults are the JAX script's."""
    n_a: int = 500_000
    n_b: int = 500_000
    d: int = 128
    batch: int = 512
    len_max: int = 15
    n_edges: int = 3_000_000     # about FK's mean degree (3) at 1M rows
    n_users: int = 2048
    n_eval: int = 512
    n_neg: int = 999             # the eval split's sampled negatives
    warmup: int = 2
    windows: int = 3
    steps: int = 20              # steps a window
    n_probe: int = 128           # CE probe rows
    n_rank_rows: int = 32        # rows a domain of the chunked rank check


FULL = Size()


def _synthetic_graph(n_item: int, n_edges: int, seed: int):
    """Random COO with D^-1 row normalisation, degree structure only; the
    JAX script's ``_synthetic_graph`` (``bench/scaled_e2e.py:50-61``)."""
    from c2dsr_tpu_torch.graph.build import CooGraph
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, n_item, n_edges, dtype=np.int64)
    cols = rng.integers(1, n_item, n_edges, dtype=np.int64)
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    deg = np.bincount(rows, minlength=n_item).astype(np.float32)
    vals = 1.0 / deg[rows]
    return CooGraph(rows, cols, vals, n_item)


def step_wrappers() -> Dict:
    """{name: wrapper} of the kernels a one-card train step launches."""
    from c2dsr_tpu_torch.ops import (encoder_cuda, fused_ce_cuda, segsum_cuda,
                                     spmm_cuda)
    return {"spmm_csr": spmm_cuda.spmm_csr,
            "encoder_fwd": encoder_cuda.encoder_fwd,
            "encoder_bwd": encoder_cuda.encoder_bwd,
            "ce_fwd": fused_ce_cuda.ce_fwd, "ce_bwd": fused_ce_cuda.ce_bwd,
            "segsum": segsum_cuda.segsum}


def launches() -> Dict[str, int]:
    return {n: w.launches for n, w in step_wrappers().items()}


def _clone(x):
    """A copy of a tensor or a plain tuple of them; anything else (the
    graph, which nothing writes) as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if type(x) is tuple:
        return tuple(_clone(t) for t in x)
    return x


@contextlib.contextmanager
def recording(calls: List):
    """Append (name, args, result), copied, of every K1, K4, K5 and K7 call
    made while the body runs (the positional arguments; keywords such as
    ``bf16`` pass through unrecorded); the wrappers still launch and
    count."""
    from c2dsr_tpu_torch.ops import fused_ce_cuda, segsum_cuda, spmm_cuda
    names = ((spmm_cuda, "spmm_csr"), (fused_ce_cuda, "ce_fwd"),
             (fused_ce_cuda, "ce_bwd"), (segsum_cuda, "segsum"))
    saved = []
    for mod, name in names:
        orig = getattr(mod, name)

        def rec(*args, _orig=orig, _name=name, **kw):
            out = _orig(*args, **kw)
            calls.append((_name, _clone(args), _clone(out)))
            return out

        # the wrapper counts its launches on its module's name: carry them
        rec.launches = orig.launches
        setattr(mod, name, rec)
        saved.append((mod, name, orig))
    try:
        yield
    finally:
        for mod, name, orig in saved:
            orig.launches = getattr(mod, name).launches
            setattr(mod, name, orig)


def _plain_ce_fwd(h, w, bm, pad, tgt, dtype=torch.float32):
    """K4's plain version in ``dtype`` over row chunks whose logits fit
    PLAIN_CE_BYTES."""
    from c2dsr_tpu_torch.ops import fused_ce
    h, w, bm, pad = (t.to(dtype) for t in (h, w, bm, pad))
    step = max(1, PLAIN_CE_BYTES // (w.element_size() * w.shape[1]))
    parts = [fused_ce.ce_fwd_plain(h[s:s + step], w, bm, pad[s:s + step],
                                   tgt[s:s + step])
             for s in range(0, h.shape[0], step)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _plain_ce_bwd(h, w, bm, lse, dlse, dt, tgt, dtype=torch.float32):
    """K5's plain version in ``dtype`` over row chunks, dW and db summed
    over them."""
    from c2dsr_tpu_torch.ops import fused_ce
    h, w, bm, lse, dlse, dt = (t.to(dtype) for t in (h, w, bm, lse, dlse, dt))
    step = max(1, PLAIN_CE_BYTES // (w.element_size() * w.shape[1]))
    dh, dw, db = [], torch.zeros_like(w), torch.zeros_like(bm)
    for s in range(0, h.shape[0], step):
        g = fused_ce.ce_bwd_plain(h[s:s + step], w, bm, lse[s:s + step],
                                  dlse[s:s + step], dt[s:s + step],
                                  tgt[s:s + step])
        dh.append(g[0])
        dw += g[1]
        db += g[2]
    return torch.cat(dh), dw, db


def _library_ce_fwd_ms(h, w, bm, pad, tgt, timer) -> float:
    """cuBLAS's K4: ``logsumexp`` and ``gather`` of ``addmm(b, h, W)``
    with the pad logit, over the plain version's row chunks, timed chunk by
    chunk and summed."""
    step = max(1, PLAIN_CE_BYTES // (w.element_size() * w.shape[1]))
    tg = tgt.long().clamp(max=w.shape[1] - 1)[:, None]
    ms = 0.0
    for s in range(0, h.shape[0], step):
        hc, pc, tc = h[s:s + step], pad[s:s + step, None], tg[s:s + step]

        def fwd():
            logits = torch.addmm(bm, hc, w)
            return (torch.logsumexp(torch.cat([logits, pc], 1), 1),
                    logits.gather(1, tc))

        ms += timer(fwd, reps=3, warmup=1)
    return ms


def _library_ce_bwd_ms(h, w, bm, dlse, timer) -> float:
    """cuBLAS's K5: the autograd backward of ``logsumexp(addmm(b, h, W))``
    into h, W and b, over the plain version's row chunks, each chunk's
    graph built untimed, timed chunk by chunk and summed."""
    step = max(1, PLAIN_CE_BYTES // (w.element_size() * w.shape[1]))
    leaves = [t.detach().requires_grad_(True) for t in (w, bm)]
    ms = 0.0
    for s in range(0, h.shape[0], step):
        hc = h[s:s + step].detach().requires_grad_(True)
        out = torch.logsumexp(torch.addmm(leaves[1], hc, leaves[0]), 1)
        ms += timer(lambda: torch.autograd.grad(out, [hc] + leaves,
                                                dlse[s:s + step],
                                                retain_graph=True),
                    reps=3, warmup=1)
        del out
    return ms


def hold_recorded(calls: List, timer, card: str, peak_bw: float) -> Dict:
    """Each recorded kernel call against its plain version on the same
    inputs (GateFailure where one disagrees), then timed beside it, with
    its bound; summed by kernel over the step's calls."""
    from c2dsr_tpu_torch.ops import (fused_ce_cuda, segsum_cuda, spmm,
                                     spmm_cuda)
    clock = timing.sm_clock_hz()
    out = {k: {"calls": [], "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
               "bound_ms": 0.0, "max_abs_err": 0.0, "max_rel_err": 0.0}
           for k in ("spmm_csr", "ce_fwd", "ce_bwd", "segsum")}
    for k in ("spmm_csr", "ce_fwd", "ce_bwd"):
        out[k]["library_ms"] = 0.0
    for name, args, got in calls:
        if name == "spmm_csr":
            g, h, n_out = args
            want = spmm.spmm_reference(g, h, n_out)
            err, rel = float((got - want).abs().max()), _rel(got, want)
            if rel > SPMM_TOL:
                raise timing.GateFailure(f"K1 at {g.n} rows: {rel} from the "
                                         f"plain SpMM > {SPMM_TOL}")
            n_rows = want.shape[0]
            rowptr = torch.cat([g.rowptr, g.rowptr[-1:].expand(n_rows - g.n)])
            csr = torch.sparse_csr_tensor(rowptr.long(), g.cols.long(),
                                          g.vals, size=(n_rows, h.shape[0]),
                                          check_invariants=False)
            ms = timer(lambda: spmm_cuda.spmm_csr(g, h, n_out))
            plain_ms = timer(lambda: spmm.spmm_reference(g, h, n_out))
            lib_ms = timer(lambda: torch.sparse.mm(csr, h))
            nnz, d = int(g.cols.numel()), h.shape[1]
            used = int(torch.unique(g.cols).numel())
            nbytes = used * d * 4 + n_rows * d * 4 + nnz * 8 + (g.n + 1) * 4
            rec = {"rows": g.n, "nnz": nnz, "d": d, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": nbytes / peak_bw * 1e3, "bound_by": "bytes",
                   "max_abs_err": err, "max_rel_err": rel}
        elif name == "ce_fwd":
            h, w, bm, pad, tgt = args
            want = _plain_ce_fwd(h, w, bm, pad, tgt, torch.float64)
            plain = _plain_ce_fwd(h, w, bm, pad, tgt)
            real = tgt < w.shape[1]

            def rel_of(x):
                return max(_rel(x[0].double(), want[0]),
                           _rel(x[1][real].double(), want[1][real]))

            rel, plain_rel = rel_of(got), rel_of(plain)
            err = float((got[0].double() - want[0]).abs().max())
            if rel > K4_TOL:
                raise timing.GateFailure(f"K4 at V {w.shape[1]}: {rel} from "
                                         f"float64 > {K4_TOL} (the plain f32 "
                                         f"version: {plain_rel})")
            with torch.no_grad():
                ms = timer(lambda: fused_ce_cuda.ce_fwd(h, w, bm, pad, tgt),
                           reps=5, warmup=1)
                plain_ms = timer(lambda: _plain_ce_fwd(h, w, bm, pad, tgt),
                                 reps=3, warmup=1)
                lib_ms = _library_ce_fwd_ms(h, w, bm, pad, tgt, timer)
            N, d, V = h.shape[0], h.shape[1], w.shape[1]
            io = 4.0 * (N * d + d * V + V + 3 * N)
            rec = {"N": N, "d": d, "V": V, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms,
                   "bound_ms": timing.tc_bound_ms(2.0 * N * V * d, io, card,
                                                  peak_bw),
                   "bound_by": "operations", "max_abs_err": err,
                   "max_rel_err": rel, "plain_rel_err": plain_rel}
        elif name == "ce_bwd":
            h, w, bm, lse, dlse, dt, tgt = args
            want = _plain_ce_bwd(h, w, bm, lse, dlse, dt, tgt, torch.float64)
            plain = _plain_ce_bwd(h, w, bm, lse, dlse, dt, tgt)
            rels = {k: _rel(a.double(), b)
                    for k, a, b in zip(("dh", "dW", "db"), got, want)}
            plain_rels = {k: _rel(a.double(), b)
                          for k, a, b in zip(("dh", "dW", "db"), plain, want)}
            rel, plain_rel = max(rels.values()), max(plain_rels.values())
            err = max(float((a.double() - b).abs().max())
                      for a, b in zip(got, want))
            del want, plain
            if rel > GRAD_TOL:
                raise timing.GateFailure(f"K5 at V {w.shape[1]}: {rels} from "
                                         f"float64 > {GRAD_TOL} (the plain "
                                         f"f32 version: {plain_rels})")
            with torch.no_grad():
                ms = timer(lambda: fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse,
                                                        dt, tgt),
                           reps=5, warmup=1)
                plain_ms = timer(lambda: _plain_ce_bwd(h, w, bm, lse, dlse,
                                                       dt, tgt),
                                 reps=3, warmup=1)
            lib_ms = _library_ce_bwd_ms(h, w, bm, dlse, timer)
            N, d, V = h.shape[0], h.shape[1], w.shape[1]
            io = 4.0 * (2 * N * d + 2 * d * V + 2 * V + 4 * N)
            rec = {"N": N, "d": d, "V": V, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms,
                   "bound_ms": timing.tc_bound_ms(4.0 * N * V * d, io, card,
                                                  peak_bw),
                   "bound_by": "operations", "max_abs_err": err,
                   "max_rel_err": rel, "rel_err_by_output": rels,
                   "plain_rel_err": plain_rel,
                   "plain_rel_err_by_output": plain_rels}
        else:
            ids, g, n_rows = args
            want = segsum_cuda.segsum_plain(ids.cpu(), g.cpu(), n_rows)
            if not torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32)):
                raise timing.GateFailure(f"K7 into {n_rows} rows: not bitwise "
                                         "CPU index_add_")
            ms = timer(lambda: segsum_cuda.segsum(ids, g, n_rows))
            plain_ms = timer(lambda: segsum_cuda.segsum_plain(ids, g, n_rows))
            n, d = g.shape
            bytes_ms = (8 * n + 4 * n * d + 4 * n_rows * d) / peak_bw * 1e3
            order_ms = timing.chain_bound_ms(
                segsum_cuda.longest_chain(ids, g, n_rows), clock)
            rec = {"n_ids": n, "n_rows": n_rows, "d": d, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": max(bytes_ms, order_ms),
                   "bound_by": ("bytes" if bytes_ms >= order_ms
                                else "operations"),
                   "max_abs_err": 0.0, "max_rel_err": 0.0}
        agg = out[name]
        agg["calls"].append(rec)
        for k in ("ms", "plain_ms", "bound_ms"):
            agg[k] += rec[k]
        if name != "segsum":
            agg["library_ms"] += rec["library_ms"]
        agg["max_abs_err"] = max(agg["max_abs_err"], rec["max_abs_err"])
        agg["max_rel_err"] = max(agg["max_rel_err"], rec["max_rel_err"])
        agg["bound_by"] = rec["bound_by"]
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(device="cuda", size: Size = FULL, log=print) -> Dict:
    """The composed step's report, after its gates (GateFailure)."""
    from c2dsr_tpu_torch.config import Config, DataSpec
    from c2dsr_tpu_torch.data import preprocess, synthetic
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import backend, fused_ce, spmm
    from c2dsr_tpu_torch.parallel.strategy import LocalOps
    from c2dsr_tpu_torch.train import optim
    from c2dsr_tpu_torch.train import step as step_mod
    device = backend.resolve_device(device)
    on_card = device.type == "cuda"
    if on_card:
        from c2dsr_tpu_torch.kernels import build
        build.build_all()
        torch.cuda.reset_peak_memory_stats()
    cfg = Config(data="fk", batch_size=size.batch, d_latent=size.d,
                 n_neg_sample=size.n_neg)
    spec = DataSpec(n_item_a=size.n_a, n_item_b=size.n_b,
                    len_max=size.len_max)
    report = {"n_item": spec.n_item, "d_latent": size.d, "batch": size.batch,
              "len_max": size.len_max, "n_edges": size.n_edges,
              "device": timing.card_line() if on_card else "cpu"}

    t0 = time.perf_counter()
    hosts = [_synthetic_graph(spec.n_item, size.n_edges, s) for s in (0, 1)]
    t1 = time.perf_counter()
    graphs = c2dsr.Graphs(*(spmm.device_graph(g, device) for g in hosts))
    report["graph_host_s"] = t1 - t0
    report["device_graph_s"] = time.perf_counter() - t1
    log(f"scaled_e2e: two {size.n_edges}-edge graphs at {spec.n_item} rows "
        f"in {report['graph_host_s']:.2f} s, device_graph (CSR, transpose "
        f"and K1's plans) {report['device_graph_s']:.2f} s")
    seqs = synthetic.generate_sequences(spec, size.n_users, seed=2)
    train = preprocess.preprocess_train(seqs, spec, seed=3)
    evald = preprocess.preprocess_evaluate(seqs[:size.n_eval], spec,
                                           cfg.n_neg_sample, seed=4)

    gen = torch.Generator(device).manual_seed(0)
    params = params_mod.init_params(cfg, spec, gen, device)
    opt = optim.make_optimizer(cfg, steps_per_epoch=4)
    state = step_mod.init_state(params, opt)
    fn = step_mod.make_train_step(cfg, spec, graphs, opt, device)
    n_train = train["seq_share"].shape[0]
    feed = [{k: v[s:s + size.batch] for k, v in train.items()}
            for s in range(0, min(n_train, 4 * size.batch), size.batch)]

    t0 = time.perf_counter()
    state, aux = fn(state, feed[0])
    loss_first = float(aux["loss"])
    report["first_step_s"] = time.perf_counter() - t0
    if not np.isfinite(loss_first):
        raise timing.GateFailure(f"scaled_e2e: first loss {loss_first}")
    for i in range(1, size.warmup):
        state, aux = fn(state, feed[i % len(feed)])
    _sync(device)
    before = launches()
    times = []
    for _ in range(size.windows):
        t0 = time.perf_counter()
        for i in range(size.steps):
            # each window ends on the first step's batch
            state, aux = fn(state, feed[(i + 1 - size.steps) % len(feed)])
        _sync(device)
        times.append((time.perf_counter() - t0) / size.steps)
    after = launches()
    loss_last = float(aux["loss"])
    report["launches_in_windows"] = {k: after[k] - before[k] for k in after}
    if on_card:
        # the captured step's graphs, and the same step run op by op
        report["step_program"] = fn.program.stats()
        eager = step_mod.make_train_step(cfg, spec, graphs, opt, device,
                                         capture=False)
        eager_times = []
        for _ in range(size.windows):
            t0 = time.perf_counter()
            for i in range(size.steps):
                state, aux = eager(state, feed[(i + 1 - size.steps)
                                                % len(feed)])
            _sync(device)
            eager_times.append((time.perf_counter() - t0) / size.steps)
        report["eager_train_step_ms"] = min(eager_times) * 1e3
        report["eager_train_examples_per_s"] = size.batch / min(eager_times)
        log(f"scaled_e2e: the step's graphs {report['step_program']}; the "
            f"eager step {report['eager_train_step_ms']:.3f} ms")
    if not (np.isfinite(loss_last) and loss_last < loss_first):
        raise timing.GateFailure(f"scaled_e2e: loss {loss_first} -> "
                                 f"{loss_last}: not finite and lower")
    if on_card and not all(report["launches_in_windows"].values()):
        raise timing.GateFailure("scaled_e2e: a kernel of the step never "
                                 f"launched: {report['launches_in_windows']}")
    step_s = min(times)
    report.update({
        "train_examples": n_train, "train_batches_cycled": len(feed),
        "train_step_ms": step_s * 1e3, "window_step_ms":
            [t * 1e3 for t in times],
        "train_examples_per_s": size.batch / step_s,
        "loss_first_step": loss_first, "loss_after_timing": loss_last,
        "steps_timed": size.windows * size.steps,
        "peak_memory_train_bytes": (torch.cuda.max_memory_allocated()
                                    if on_card else None)})
    log(f"scaled_e2e: step {step_s * 1e3:.3f} ms ({size.batch / step_s:.1f} "
        f"train examples/s), loss {loss_first:.4f} -> {loss_last:.4f}, "
        f"launches in the windows {report['launches_in_windows']}, peak "
        f"memory {report['peak_memory_train_bytes']}")

    if on_card:
        calls = []
        with recording(calls):
            state, aux = fn(state, feed[0])
        _sync(device)
        timer = timing.Timer()
        _, peak_bw = timing.peaks(torch.cuda.get_device_name(0))
        report["kernels"] = hold_recorded(calls, timer,
                                          torch.cuda.get_device_name(0),
                                          peak_bw)
        del calls, timer
        torch.cuda.empty_cache()
        for k, r in report["kernels"].items():
            log(f"scaled_e2e {k}: {len(r['calls'])} calls of the step, "
                f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
                f"{r['library_ms']}, bound {r['bound_ms']:.4f} by "
                f"{r['bound_by']}), error {r['max_rel_err']:.3e}")

    # the CE gate at the full width: 128 probe rows against float64
    rng = np.random.default_rng(7)
    w, b = state.params["cls_a_w"].detach(), state.params["cls_a_b"].detach()
    h = torch.from_numpy(rng.normal(size=(size.n_probe, 1, size.d))).float()
    h = h.to(device).requires_grad_(True)
    tgt = torch.from_numpy(rng.integers(0, size.n_a, (size.n_probe, 1)))
    tgt = tgt.to(device)
    pad = torch.full((size.n_probe, 1), -30.0, device=device)
    leaves = [h, w.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    rows = fused_ce.fused_rec_ce_rows(leaves[0], leaves[1], leaves[2], pad,
                                      tgt, size.n_a)
    grads = torch.autograd.grad(rows.sum(), leaves)
    e_rows, e_grads = scaled_bench.ce_errors(
        rows.detach(), grads, scaled_bench.ce_oracle(h, w, b, pad, tgt,
                                                     size.n_a, 32))
    report["ce_oracle_rows_rel_err"] = e_rows
    report["ce_oracle_grads_rel_err"] = e_grads
    if e_rows > CE_TOL or e_grads > GRAD_TOL:
        raise timing.GateFailure(f"scaled_e2e CE at V {size.n_a}: rows "
                                 f"{e_rows}, gradients {e_grads} from the "
                                 "float64 oracle")
    log(f"scaled_e2e: CE probe at V {size.n_a}: rows {e_rows:.3e}, "
        f"gradients {e_grads:.3e} from float64")
    del rows, grads, leaves

    # full-rank eval over each domain's itemset
    convolve_eval, rank_step = ranker.make_eval_fns(cfg, spec, graphs, device)
    hi = convolve_eval(state.params)
    ranker.evaluate_split(state.params, hi, evald, rank_step, cfg, "full")
    _sync(device)
    t0 = time.perf_counter()
    ra, rb = ranker.evaluate_split(state.params, hi, evald, rank_step, cfg,
                                   "full")
    dt = time.perf_counter() - t0
    if not (all(1 <= r <= size.n_a for r in ra)
            and all(1 <= r <= size.n_b for r in rb)):
        raise timing.GateFailure("scaled_e2e: a full rank out of range")
    pops = LocalOps(cfg=cfg)
    groups = ranker.partition_by_domain(evald)
    deltas = {}
    with torch.inference_mode():
        for dom, n_real in (("a", size.n_a), ("b", size.n_b)):
            chunk = {k: v[:size.n_rank_rows] for k, v in groups[dom].items()}
            batch = ranker.to_device(chunk, device)
            hv = ranker._last_hidden(state.params, hi, batch, cfg, spec, dom,
                                     pops)
            deltas[dom] = scaled_bench.full_rank_delta(
                pops, hv, state.params[f"cls_{dom}_w"],
                state.params[f"cls_{dom}_b"], batch["gt_last"], n_real)
    n_ex = len(ra) + len(rb)
    report.update({
        "eval_examples": n_ex,
        "eval_full_rank_examples_per_s": n_ex / dt,
        "eval_full_rank_items_per_s": (len(ra) * size.n_a
                                       + len(rb) * size.n_b) / dt,
        "full_rank_max_rank_delta": deltas,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                              if on_card else None)})
    log(f"scaled_e2e: full rank {n_ex / dt:.1f} examples/s "
        f"({report['eval_full_rank_items_per_s']:.4g} items/s), rank delta "
        f"against the chunked count {deltas}, peak memory "
        f"{report['peak_memory_bytes']}")
    return report
