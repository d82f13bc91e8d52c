"""``--scaled``: one device's vocab shard of the scaled configuration
(BASELINE.json config 5: 10M items, d 512), the counterpart of the JAX
package's ``bench/scaled_bench.py``.

A 10M-row f32 table is 20 GB, more than a device holds beside its
optimizer state, so a deployment shards the vocab; this measures the
per-device ops of that regime at one f32 shard, V = 2^19 (W is 1 GiB), with
B 512 x R 20 CE rows, each op validated on the card first against a
vocab-chunked plain oracle:

1. the embedding gather (``ops/lookup``: ``index_select``, backward K7) of
   B 512 x L 15 ids from a 2^20-row table;
2. the fused CE forward and backward, K4 + K5 at d 512, over the shard
   (oracle: the plain versions in float64 over row chunks of 500);
3. full-rank scoring of 256 rows over the shard (``LocalOps.full_rank``;
   oracle: the ranks of 32 rows counted over vocab chunks).

Then the bf16-at-rest classifier (``classifier_dtype="bfloat16"``,
scaled_bench.py:15-16, :221-266): a shard twice as wide, V = 2^20, at two
bytes an element (W is 1 GiB again): the CE's bf16 instantiations (the
rows and gradients first held against the plain bf16 versions over row
chunks, W f32 rounded in the kernels' pre-pass so that dW is compared
before its rounding to bf16, then timed on the bf16 W) and full-rank
scoring with the bf16 classifier (f32 scores of bf16-rounded operands;
oracle: the ranks of 32 rows counted over vocab chunks of the same
rounded operands).

Also the per-device memory plan of the full configuration, for the H100's
80 GB, and the projection to 10M items over M devices
(:func:`project_10m`, scaled_bench.py:263-276): the measured per-shard
times of the bf16-at-rest shard scaled by each device's vocab slice.  It
runs nothing across devices.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from c2dsr_tpu_torch.bench import gates, timing

V_FULL = 10_000_000
D = 512
V_SHARD = 1 << 19          # the f32 shard: d·V·4 = 2^30 B
V_BF16 = 1 << 20           # the bf16-at-rest shard: d·V·2 = 2^30 B
V_TABLE = 1 << 20          # rows of the gathered table
B, R, L = 512, 20, 15      # train CE rows, lookup sequence length
B_RANK = 256               # full-rank rows a call
HBM_PER_CARD = 80e9        # H100 SXM
CE_TOL = 1e-5              # lse - tlog rows, over max |oracle|
GRAD_TOL = 1e-4            # dh, dW, db over max |oracle|: the train step's
                           # gradient gate (chip_smoke.py GRAD_TOL)
RANK_DELTA = 8             # full rank against a chunked count: near-ties
BF16_TOL = 1e-5            # the bf16 CE's rows against its plain bf16
BF16_GRAD_TOL = 5e-5       # version, and its gradients (chip_smoke.py's
                           # phase bf16 limits)


def memory_plan() -> list:
    """Per-device bytes of the full 10M-item configuration by shard count:
    3 embedding tables and 2 classifiers, with AMSGrad's three f32 moments
    beside each, in f32 and with bf16 parameters."""
    rows = []
    n_tables, n_cls = 3, 2
    for dtype_bytes, tag in ((4, "f32"), (2, "bf16_params")):
        params = (n_tables + n_cls) * V_FULL * D * dtype_bytes
        opt = (n_tables + n_cls) * V_FULL * D * 4 * 3
        total = params + opt
        for m in (8, 16, 32, 64):
            rows.append({"params": tag, "shards": m,
                         "per_device_gb": total / m / 1e9,
                         "fits_h100_80gb": bool(total / m
                                                < HBM_PER_CARD * 0.9)})
    return rows


def project_10m(ce_fwd_bwd_ms: float, full_rank_ms: float) -> list:
    """The 10M-item configuration's per-device times over M = 8, 16, 32
    shards, from the bf16-at-rest shard's measured CE forward + backward
    and full-rank ms (256 rows): each scaled by the device's vocab slice
    over the measured shard's, (V_FULL / M) / V_BF16, as the JAX bench
    projects them (scaled_bench.py:263-276, its keys, no rounding)."""
    rows = []
    for m in (8, 16, 32):
        scale = (V_FULL / m) / V_BF16
        rows.append({"shards": m, "vocab_per_device": V_FULL // m,
                     "classifier": "bf16_at_rest",
                     "ce_fwd_bwd_ms": ce_fwd_bwd_ms * scale,
                     "full_rank_ms_per_256": full_rank_ms * scale})
    return rows


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def ce_oracle(h, w, b, pad, tgt, n_real: int, chunk: int,
              bf16: bool = False):
    """(rows, dh, dW, db) of ``fused_rec_ce_rows(h, w, b, pad, tgt,
    n_real).sum()``: the plain versions in float64 over chunks of ``chunk``
    sequences (h [B, R, d]), dW and db summed over the chunks, so that no
    chunk's logits outgrow the device.  ``bf16``: the plain bf16 versions,
    in f32 (their products are the bf16 instantiations')."""
    from c2dsr_tpu_torch.ops import fused_ce
    dtype = torch.float32 if bf16 else torch.float64
    w64 = w.detach().to(dtype).requires_grad_(True)
    b64 = b.detach().to(dtype).requires_grad_(True)
    rows, dh = [], []
    dw = torch.zeros_like(w64)
    db = torch.zeros_like(b64)
    with gates.plain_versions():
        for s in range(0, h.shape[0], chunk):
            hc = h[s:s + chunk].detach().to(dtype).requires_grad_(True)
            out = fused_ce.fused_rec_ce_rows(hc, w64, b64,
                                             pad[s:s + hc.shape[0]],
                                             tgt[s:s + hc.shape[0]], n_real,
                                             bf16=bf16)
            gh, gw, gb = torch.autograd.grad(out.sum(), [hc, w64, b64])
            rows.append(out.detach())
            dh.append(gh)
            dw += gw
            db += gb
    return torch.cat(rows), torch.cat(dh), dw, db


def ce_errors(rows, grads, oracle):
    """(rows' error, the largest of dh's, dW's and db's), each max abs over
    max |oracle|, of the CE rows and their gradients against ce_oracle."""
    want_rows, dh, dw, db = oracle
    return (_rel(rows, want_rows),
            max(_rel(grads[0], dh), _rel(grads[1], dw), _rel(grads[2], db)))


def full_rank_delta(pops, hv, w, b, gt, n_real: int) -> int:
    """The largest |rank - oracle rank| of ``pops.full_rank`` over the rows
    of ``hv``, the oracle counting the real columns in chunks of 2^17 (of
    the bf16-rounded operands under a bf16 classifier).  Chunked and whole
    products may round a near-tie apart, as the JAX bench allows: more than
    RANK_DELTA raises GateFailure."""
    from c2dsr_tpu_torch.ops.bf16 import round_bf16
    with torch.no_grad():
        got = pops.full_rank(hv, w, b, gt, n_real)
        if pops.cfg.resolved_classifier_dtype() == "bfloat16":
            hv, w = round_bf16(hv), round_bf16(w)
        step = 1 << 17
        scores = torch.cat([hv @ w[:, s:min(s + step, n_real)]
                            + b[s:min(s + step, n_real)]
                            for s in range(0, n_real, step)], 1)
        want = (scores > scores.gather(1, gt[:, None].long())).sum(1) + 1
    dev = int((got.long() - want).abs().max())
    if dev > RANK_DELTA:
        raise timing.GateFailure(f"full rank: rank delta {dev} > "
                                 f"{RANK_DELTA} against the chunked count")
    return dev


def _lookup(timer, rng, peak_bw) -> Dict:
    from c2dsr_tpu_torch.ops import lookup, segsum_cuda
    tbl = torch.randn((V_TABLE, D), device="cuda", requires_grad=True)
    ids = torch.from_numpy(rng.integers(0, V_TABLE, size=(B, L))).cuda()
    g = torch.randn((B * L, D), device="cuda")
    with torch.no_grad():
        got = lookup.lookup(tbl, ids)
        if not torch.equal(got, tbl[ids]):
            raise timing.GateFailure("scaled lookup differs from indexing")
    # K7 against CPU index_add_ over the ids present (renumbered, which
    # keeps each id's order): bitwise, and zero on every other row
    grad = segsum_cuda.segsum(ids, g, V_TABLE)
    uniq, inv = torch.unique(ids.reshape(-1), return_inverse=True)
    want = segsum_cuda.segsum_plain(inv.cpu(), g.cpu(), uniq.numel())
    if not (torch.equal(grad[uniq].cpu(), want)
            and int((grad != 0).any(1).sum()) <= uniq.numel()):
        raise timing.GateFailure("scaled lookup backward differs")
    with torch.no_grad():
        t = timer(lambda: lookup.lookup(tbl, ids))

    def fwd_bwd():
        out = lookup.lookup(tbl, ids)
        return torch.autograd.grad(out, tbl, g.view(out.shape))

    t_fb = timer(fwd_bwd, reps=10)
    n = B * L
    return {"lookup_ms": t, "lookup_rows_per_s": n / t * 1e3,
            "lookup_bound_ms": (8.0 * n + 8.0 * n * D) / peak_bw * 1e3,
            "lookup_fwd_bwd_ms": t_fb,
            "lookup_fwd_bwd_bound_ms":
                (16.0 * n + 12.0 * n * D + 4.0 * V_TABLE * D) / peak_bw * 1e3,
            "validated": True}


def _ce(timer, rng, card, peak_flops, peak_bw) -> Dict:
    from c2dsr_tpu_torch.ops import fused_ce
    n_real = V_SHARD - 1024
    w = torch.randn((D, V_SHARD), device="cuda") * 0.02
    b = torch.zeros(V_SHARD, device="cuda")
    h = torch.randn((B, R, D), device="cuda")
    pad = torch.zeros((B, R, 1), device="cuda")
    tgt = torch.from_numpy(rng.integers(0, n_real, size=(B, R))).cuda()
    leaves = [h.requires_grad_(True), w.requires_grad_(True),
              b.requires_grad_(True)]

    def fwd():
        return fused_ce.fused_rec_ce_rows(h, w, b, pad, tgt, n_real)

    def fwd_bwd():
        return torch.autograd.grad(fwd().sum(), leaves)

    rows = fwd().detach()
    grads = fwd_bwd()
    e_f, e_b = ce_errors(rows, grads, ce_oracle(h, w, b, pad, tgt, n_real,
                                                25))
    if e_f > CE_TOL or e_b > GRAD_TOL:
        raise timing.GateFailure(f"scaled CE at d {D}: rows {e_f}, "
                                 f"gradients {e_b} from the oracle")
    with torch.no_grad():
        t_f = timer(fwd, reps=3, warmup=1)
    t_fb = timer(fwd_bwd, reps=3, warmup=1)
    N = B * R
    flops = 2.0 * N * V_SHARD * D
    io = 4.0 * (N * D + D * V_SHARD + V_SHARD + 3 * N)
    return {"v": V_SHARD, "w_dtype": "float32", "rows_rel_err": e_f,
            "grads_rel_err": e_b, "fwd_ms": t_f, "fwd_bwd_ms": t_fb,
            "fwd_bound_ms": timing.tc_bound_ms(flops, io, card, peak_bw),
            "fwd_bwd_bound_ms": timing.tc_bound_ms(3 * flops, 3 * io, card,
                                                   peak_bw),
            "fwd_bound_ffma_ms": flops / peak_flops * 1e3,
            "fwd_bwd_tflops": 3 * flops / t_fb / 1e9, "validated": True}


def _ce_bf16w(timer, rng, card, peak_bw) -> Dict:
    """The CE's bf16 instantiations over the bf16-at-rest shard."""
    from c2dsr_tpu_torch.ops import fused_ce
    n_real = V_BF16 - 1024
    w = torch.randn((D, V_BF16), device="cuda") * 0.02
    b = torch.zeros(V_BF16, device="cuda")
    h = torch.randn((B, R, D), device="cuda")
    pad = torch.zeros((B, R, 1), device="cuda")
    tgt = torch.from_numpy(rng.integers(0, n_real, size=(B, R))).cuda()
    leaves = [h.requires_grad_(True), w.requires_grad_(True),
              b.requires_grad_(True)]
    # the gate: f32 W rounded in the pre-pass (dW before its rounding)
    rows = fused_ce.fused_rec_ce_rows(h, w, b, pad, tgt, n_real, bf16=True)
    grads = torch.autograd.grad(rows.sum(), leaves)
    e_f, e_b = ce_errors(rows.detach(), grads,
                         ce_oracle(h, w, b, pad, tgt, n_real, 25, bf16=True))
    del rows, grads
    if e_f > BF16_TOL or e_b > BF16_GRAD_TOL:
        raise timing.GateFailure(f"scaled bf16 CE at d {D}: rows {e_f}, "
                                 f"gradients {e_b} from the plain bf16 "
                                 "versions")
    # timed as the bf16 classifier runs it: W cast to bf16 at each use
    wb = w.detach().to(torch.bfloat16).requires_grad_(True)
    leaves16 = [h, wb, b]

    def fwd():
        return fused_ce.fused_rec_ce_rows(h, wb, b, pad, tgt, n_real)

    def fwd_bwd():
        return torch.autograd.grad(fwd().sum(), leaves16)

    with torch.no_grad():
        t_f = timer(fwd, reps=3, warmup=1)
    t_fb = timer(fwd_bwd, reps=3, warmup=1)
    N = B * R
    flops = 2.0 * N * V_BF16 * D
    io = 4.0 * (N * D + V_BF16 + 3 * N) + 2.0 * D * V_BF16
    bound_f, one_pass_f = timing.bf16_bounds_ms(flops, io, card, peak_bw)
    bound_fb, one_pass_fb = timing.bf16_bounds_ms(3 * flops, 3 * io, card,
                                                  peak_bw)
    return {"v": V_BF16, "w_dtype": "bfloat16", "rows_rel_err": e_f,
            "grads_rel_err": e_b, "fwd_ms": t_f, "fwd_bwd_ms": t_fb,
            "fwd_bound_ms": bound_f, "fwd_bwd_bound_ms": bound_fb,
            "fwd_bound_tf32_one_pass_ms": one_pass_f,
            "fwd_bwd_bound_tf32_one_pass_ms": one_pass_fb,
            "fwd_bwd_tflops": 3 * flops / t_fb / 1e9, "validated": True}


def _full_rank(timer, rng, peak_flops, peak_bw, bf16: bool = False) -> Dict:
    """Full-rank scoring over the f32 shard, or with ``bf16`` over the
    bf16-at-rest one (keys suffixed ``_bf16w``)."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.parallel.strategy import LocalOps
    V = V_BF16 if bf16 else V_SHARD
    pops = LocalOps(cfg=Config(d_latent=D, classifier_dtype="bfloat16"
                               if bf16 else "auto"))
    w = torch.randn((D, V), device="cuda") * 0.02
    b = torch.zeros(V, device="cuda")
    hv = torch.randn((B_RANK, D), device="cuda")
    gt = torch.from_numpy(rng.integers(0, V, size=B_RANK)).cuda()
    dev = full_rank_delta(pops, hv[:32], w, b, gt[:32], V)
    with torch.no_grad():
        t = timer(lambda: pops.full_rank(hv, w, b, gt, V), reps=10)
    flops = 2.0 * B_RANK * D * V
    nbytes = 4.0 * (D * V + V + B_RANK * D)
    key = "full_rank_bf16w" if bf16 else "full_rank"
    return {f"{key}_ms": t, f"{key}_items_per_s": B_RANK * V / t * 1e3,
            f"{key}_max_rank_delta": dev,
            f"{key}_bound_ms": max(flops / peak_flops,
                                   nbytes / peak_bw) * 1e3,
            f"{key}_validated": True}


def run(device: str = "cuda") -> Dict:
    timing.require_cuda(device, "--scaled")
    card = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = timing.peaks(card)
    rng = np.random.default_rng(0)
    timer = timing.Timer()
    results = {}
    results.update(_lookup(timer, rng, peak_bw))
    torch.cuda.empty_cache()
    results["fused_ce_f32"] = _ce(timer, rng, card, peak_flops, peak_bw)
    torch.cuda.empty_cache()
    results.update(_full_rank(timer, rng, peak_flops, peak_bw))
    torch.cuda.empty_cache()
    results["fused_ce_bf16w"] = _ce_bf16w(timer, rng, card, peak_bw)
    torch.cuda.empty_cache()
    results.update(_full_rank(timer, rng, peak_flops, peak_bw, bf16=True))
    return {"config": {"v_full": V_FULL, "d": D, "v_shard": V_SHARD,
                       "v_shard_bf16w": V_BF16, "batch": B, "len_rec": R},
            "device": timing.card_line(),
            "measured_per_shard": results,
            "projected_10m": project_10m(
                results["fused_ce_bf16w"]["fwd_bwd_ms"],
                results["full_rank_bf16w_ms"]),
            "memory_plan": memory_plan()}
