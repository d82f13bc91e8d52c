#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and is right on an NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the ``c2dsr_tpu_torch`` package beside
this file; it builds the CUDA kernels from ``c2dsr_tpu_torch/csrc`` itself.
Phases (any failure exits non-zero without the final line):

1. setup: build the kernels, print the build time and the card; the CUDA
   dropout hash must equal ops/dropout.bits_reference.
2. kernels: hold each kernel against its plain PyTorch version on the card
   at the main paths' shapes, and time kernel, plain version and one
   PyTorch library call (a yardstick the port never calls): the SpMM over A
   and over Aᵀ, the encoder forward in eval and in train mode and its
   backward (at dropout 0 and 0.2), the CE forward and backward.
3. serving path: the ranking path at Food-Kitchen geometry with the
   default Config and random seeded weights: convolve once, then rank the
   eval split in sampled and in full mode.  Every serving kernel must
   launch there; the ranks must equal those of the same run with the plain
   versions, except at counted near-ties, and every metric must be finite.
4. training path: train_step at Food-Kitchen geometry with the default
   Config (batch 512, dropout 0.2) on the synthetic train split: the loss
   must stay finite and fall, every kernel must launch its expected count a
   step, and one step at dropout 0 must give the plain versions' loss and
   gradients; then train examples/s in turns with the plain versions, and
   one profiled step.
5. experiment path: ``train.loop.Experiment`` at Food-Kitchen geometry
   with ``Config(batch_sparse_gnn=True, n_epoch=2)``, checkpointing to a
   temporary directory: finite losses and metrics, the batch-sparse SpMM
   (K6) on every hop of every step and the dense one (K1) in every eval
   convolve, the checkpoint written and a resumed run finished; one step
   at dropout 0 with the flags on and off gives the same loss and
   gradients; warm train examples/s with the flags on and off, in turns.
6. CLI: ``python -m c2dsr_tpu_torch.cli --synthetic 2000 --n_epoch 1`` in a
   temporary directory exits 0 and prints the final result table.
7. summary: one JSON line of kernel numbers, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

The kernel phase also holds K6 against its plain version and against K1
over A and Aᵀ, with the row flags of one real training batch, and records
the share of each graph's edges that such a batch keeps.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_ITEM_A, N_ITEM_B, LEN_MAX = 29207, 34886, 15   # Food-Kitchen (paper Table 1)
N_TRAIN_USERS = 34117                            # real FK train-set size
N_EVAL_USERS = 8192
SPMM_TOL = 1e-5          # max abs error relative to max |out|: f32 sums in another order
ENCODER_TOL = 1e-4       # abs, on LayerNorm outputs of order 1
TIE_TOL = 1e-5           # a candidate this close to the gt score is a near-tie
WARM_ROUNDS = 10         # rounds of (plain, kernel, kernel, plain) warm runs
GRAD_TOL = 1e-4          # max abs err over max |plain|, per gradient tensor:
                         # f32 sums over thousands of rows in another order
CE_TOL = 1e-5            # lse / target logit, relative to max |plain|
TRAIN_STEPS = 30         # train steps whose launches and losses are checked
TRAIN_ROUNDS = 5         # rounds of (plain, kernel, kernel, plain) train runs
TRAIN_RUN_STEPS = 4      # steps per timed train run
CLI_USERS = 2000         # synthetic users of the CLI phase
REPO_DIR = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    """(FP32 non-tensor FLOP/s, memory bytes/s) from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 51e12, 2.0e12
    if "NVL" in name:
        return 60e12, 3.9e12
    return 67e12, 3.35e12            # H100 SXM


class Timer:
    """Median CUDA-event time of ``reps`` runs after warm-up; L2 is flushed
    (a 256 MB write) before each run, outside the timed window."""

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def __call__(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


@contextlib.contextmanager
def plain_versions():
    """Route CUDA tensors through the plain PyTorch versions instead of the
    kernels, for the comparison run of the main path."""
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import (encoder_cuda, fused_ce, fused_ce_cuda,
                                     spmm, spmm_cuda)
    swaps = [(spmm_cuda, "spmm_csr", spmm.spmm_reference),
             (spmm_cuda, "spmm_csr_flagged", spmm.spmm_reference_flagged),
             (encoder_cuda, "encoder_fwd", enc.encoder_fwd_plain),
             (encoder_cuda, "encoder_bwd", enc.encoder_bwd_plain),
             (fused_ce_cuda, "ce_fwd", fused_ce.ce_fwd_plain),
             (fused_ce_cuda, "ce_bwd", fused_ce.ce_bwd_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def kernel_wrappers():
    """{name: wrapper} of every kernel the main paths launch."""
    from c2dsr_tpu_torch.ops import encoder_cuda, fused_ce_cuda, spmm_cuda
    return {"spmm_csr": spmm_cuda.spmm_csr,
            "spmm_csr_flagged": spmm_cuda.spmm_csr_flagged,
            "encoder_fwd": encoder_cuda.encoder_fwd,
            "encoder_bwd": encoder_cuda.encoder_bwd,
            "ce_fwd": fused_ce_cuda.ce_fwd, "ce_bwd": fused_ce_cuda.ce_bwd}


def reset_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def phase_spmm(graphs, timer, peak_flops, peak_bw, transpose=False):
    """K1 over A (a hop's forward) or over Aᵀ (its backward, on a table
    gradient), for one hop over each graph."""
    from c2dsr_tpu_torch.ops import spmm, spmm_cuda
    gen = torch.Generator(device="cuda").manual_seed(1)
    n_rows = 65536                     # the padded table (vocab_pad_multiple)
    res = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0}
    for name, g, d in (("share", graphs.share, 128),
                       ("specific_ab", graphs.specific, 256)):
        if transpose:
            g, name = g.t, name + " transpose"
        h = torch.randn((n_rows, d), generator=gen, device="cuda")
        h[g.n:] = 0.0
        out = spmm_cuda.spmm_csr(g, h)
        ref = spmm.spmm_reference(g, h)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        check(bool(torch.isfinite(out).all()), f"spmm {name}: non-finite")
        check(err <= SPMM_TOL * scale,
              f"spmm {name} d={d}: max abs err {err} > {SPMM_TOL} x {scale}")
        check(bool((out[g.n:] == 0).all()), f"spmm {name}: pad rows not zero")
        rowptr = torch.cat([g.rowptr, g.rowptr[-1:].expand(n_rows - g.n)])
        csr = torch.sparse_csr_tensor(rowptr.long(), g.cols.long(), g.vals,
                                      size=(n_rows, n_rows),
                                      check_invariants=False)
        lib = torch.sparse.mm(csr, h)
        check(float((lib - ref).abs().max()) <= SPMM_TOL * scale,
              f"spmm {name}: library call disagrees")
        ms = timer(lambda: spmm_cuda.spmm_csr(g, h))
        plain_ms = timer(lambda: spmm.spmm_reference(g, h))
        library_ms = timer(lambda: torch.sparse.mm(csr, h))
        nnz = int(g.cols.numel())
        used_rows = int(torch.unique(g.cols).numel())
        nbytes = (used_rows * d * 4 + n_rows * d * 4 + nnz * 8
                  + (g.n + 1) * 4)
        bound_ms = max(nbytes / peak_bw, 2 * nnz * d / peak_flops) * 1e3
        log(f"spmm {name}: d={d} rows={n_rows} nnz={nnz} used_rows="
            f"{used_rows} err={err:.3e} (scale {scale:.3f}) kernel {ms:.4f} ms"
            f" plain {plain_ms:.4f} ms library {library_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB)")
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        res["library_ms"] += library_ms
        res["bound_ms"] += bound_ms
        res["max_abs_err"] = max(res["max_abs_err"], err)
    return res


def _encoder_inputs(B, L, d, pad, seed):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 1000, size=(B, L))
    n_pad = rng.integers(0, L + 1, size=B)       # left padding, 0..L pads
    n_pad[::16] = L                              # every 16th sequence all pads
    n_pad[1::16] = 0                             # and some with none
    seq[np.arange(L)[None, :] < n_pad[:, None]] = pad
    x = rng.normal(size=(B, L, d)).astype(np.float32) * 4.0
    return (torch.from_numpy(x).cuda(),
            torch.from_numpy(seq.astype(np.int64)).cuda())


def _torch_tower(p, d, n_head, n_layers, dropout=0.0):
    """nn.TransformerEncoder with the port's weights: the library yardstick
    (in train mode when dropout > 0)."""
    import torch.nn as nn
    layer = nn.TransformerEncoderLayer(
        d_model=d, nhead=n_head, dim_feedforward=d, dropout=dropout,
        activation="relu", layer_norm_eps=1e-8, batch_first=True,
        norm_first=False)
    tower = nn.TransformerEncoder(layer, n_layers, nn.LayerNorm(d, eps=1e-8),
                                  enable_nested_tensor=False)
    with torch.no_grad():
        for i, tl in enumerate(tower.layers):
            lp = {k: v[i] for k, v in p["layers"].items()}
            tl.self_attn.in_proj_weight.copy_(lp["w_qkv"].T)
            tl.self_attn.in_proj_bias.copy_(lp["b_qkv"])
            tl.self_attn.out_proj.weight.copy_(lp["w_out"].T)
            tl.self_attn.out_proj.bias.copy_(lp["b_out"])
            tl.linear1.weight.copy_(lp["w_ff1"].T)
            tl.linear1.bias.copy_(lp["b_ff1"])
            tl.linear2.weight.copy_(lp["w_ff2"].T)
            tl.linear2.bias.copy_(lp["b_ff2"])
            tl.norm1.weight.copy_(lp["ln1_scale"])
            tl.norm1.bias.copy_(lp["ln1_bias"])
            tl.norm2.weight.copy_(lp["ln2_scale"])
            tl.norm2.bias.copy_(lp["ln2_bias"])
        tower.norm.weight.copy_(p["lnf_scale"])
        tower.norm.bias.copy_(p["lnf_bias"])
    return tower.cuda().train(dropout > 0)


def phase_encoder(timer, peak_flops, peak_bw):
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import encoder_cuda
    B, d, pad = 2048, 128, 64093
    worst = 0.0
    for L in (15, 30):
        for n_head in (1, 2):
            for n_layers in (1, 2):
                cfg = Config(d_latent=d, n_head=n_head, n_attn=n_layers)
                g = torch.Generator().manual_seed(L * 100 + n_head * 10
                                                  + n_layers)
                p = params_mod.init_encoder_params(g, cfg, L)
                p = params_mod._map(lambda t: t.cuda(), p)
                x, seq = _encoder_inputs(B, L, d, pad, seed=L + n_head)
                for invert in (False, True):
                    kw = dict(idx_pad=pad, n_head=n_head,
                              invert_padding_mask=invert)
                    out = encoder_cuda.encoder_fwd(x, seq, p, **kw)
                    ref = enc.encode_layers(x, seq, p, norm_first=False,
                                            **kw)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(out).all()),
                          f"encoder L={L} h={n_head}: non-finite")
                    err = float((out - ref).abs().max())
                    log(f"encoder L={L} n_head={n_head} n_attn={n_layers} "
                        f"invert={invert}: max abs err {err:.3e}")
                    check(err <= ENCODER_TOL,
                          f"encoder L={L} n_head={n_head} n_attn={n_layers} "
                          f"invert={invert}: max abs err {err} > "
                          f"{ENCODER_TOL}")
                    worst = max(worst, err)
    # time at the main path's shape: L 15, one head, one layer, correct mask
    L, n_head, n_layers = LEN_MAX, 1, 1
    cfg = Config(d_latent=d, n_head=n_head, n_attn=n_layers)
    p = params_mod._map(lambda t: t.cuda(), params_mod.init_encoder_params(
        torch.Generator().manual_seed(7), cfg, L))
    x, seq = _encoder_inputs(B, L, d, pad, seed=7)
    kw = dict(idx_pad=pad, n_head=n_head, invert_padding_mask=False)
    tower = _torch_tower(p, d, n_head, n_layers)
    causal = torch.triu(torch.ones(L, L, dtype=torch.bool, device="cuda"), 1)
    kpm = seq == pad
    with torch.inference_mode():
        ms = timer(lambda: encoder_cuda.encoder_fwd(x, seq, p, **kw))
        plain_ms = timer(lambda: enc.encode_layers(x, seq, p, norm_first=False,
                                                   **kw))
        library_ms = timer(lambda: tower(x, mask=causal,
                                         src_key_padding_mask=kpm))
    N = B * L
    flops = n_layers * (12 * N * d * d + 4 * N * L * d)
    nbytes = 4 * (2 * N * d + N + n_layers * (6 * d * d + 10 * d) + 2 * d)
    bound_ms = max(flops / peak_flops, nbytes / peak_bw) * 1e3
    log(f"encoder B={B} L={L} d={d}: kernel {ms:.4f} ms plain {plain_ms:.4f} "
        f"ms library {library_ms:.4f} ms bound {bound_ms:.4f} ms "
        f"({flops / 1e9:.3f} GFLOP, {flops / ms / 1e9:.2f} TFLOP/s)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "max_abs_err": worst,
            "bound_by": "operations" if flops / peak_flops > nbytes / peak_bw
            else "bytes"}


def near_ties(params, hi, data, cfg, spec, mode):
    """Per domain: for each example, the number of candidates other than
    the ground truth whose score is within TIE_TOL of the gt score."""
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.parallel.strategy import LocalOps
    pops = LocalOps(cfg=cfg)
    out = {}
    groups = ranker.partition_by_domain(data)
    with torch.inference_mode():
        for dom in ("a", "b"):
            counts = []
            for chunk, n in ranker._batches(groups[dom], cfg.batch_size_eval):
                b = ranker.to_device(chunk, "cuda")
                h = ranker._last_hidden(params, hi, b, cfg, spec, dom, pops)
                w, bias, n_real = ((params["cls_a_w"], params["cls_a_b"],
                                    spec.n_item_a) if dom == "a" else
                                   (params["cls_b_w"], params["cls_b_b"],
                                    spec.n_item_b))
                s = pops._scores(h, w, bias)
                gt = s.gather(1, b["gt_last"][:, None])
                if mode == "sampled":
                    cand = s.gather(1, b["list_neg"])
                    c = ((cand - gt).abs() <= TIE_TOL).sum(1)
                else:
                    c = ((s[:, :n_real] - gt).abs() <= TIE_TOL).sum(1) - 1
                counts.append(c[:n].cpu().numpy())
            out[dom] = np.concatenate(counts)
    return out


def profile_main_path(run_all, label="profile"):
    """Where a main path's time goes: one warm run under torch.profiler;
    device time by kernel, and the device's idle share of the run's wall
    time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_all()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue        # host ops carry their kernels' time too
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    busy_us = sum(r[0] for r in rows)
    if busy_us == 0:
        log(f"{label}: the profiler saw no device time (not measured)")
        return
    log(f"{label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}")
    for dev_us, count, key in sorted(rows, reverse=True)[:14]:
        log(f"{label}:   {dev_us / 1e3:9.3f} ms {dev_us / busy_us:6.1%} "
            f"x{count:<5d} {key[:90]}")


def phase_main(spec, graphs_host, data):
    from c2dsr_tpu_torch import metrics
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import spmm

    cfg = Config()
    n_ex = int(data["gt_last"].shape[0])
    groups = ranker.partition_by_domain(data)
    steps = sum(-(-int(groups[dm]["gt_last"].shape[0]) // cfg.batch_size_eval)
                for dm in ("a", "b"))
    graphs = c2dsr.Graphs(spmm.device_graph(graphs_host[0], "cuda"),
                          spmm.device_graph(graphs_host[1], "cuda"))
    params = params_mod.init_params(cfg, spec,
                                     torch.Generator().manual_seed(0), "cuda")
    convolve_eval, rank_step = ranker.make_eval_fns(cfg, spec, graphs, "cuda")

    def run_all():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hi = convolve_eval(params)
        torch.cuda.synchronize()
        t_conv = time.perf_counter() - t0
        ranks, secs = {}, {}
        for mode in ("sampled", "full"):
            t0 = time.perf_counter()
            ranks[mode] = ranker.evaluate_split(params, hi, data, rank_step,
                                                cfg, mode)
            torch.cuda.synchronize()
            secs[mode] = time.perf_counter() - t0
        return hi, ranks, t_conv, secs

    reset_launches()
    hi, ranks, t_conv, secs = run_all()
    launches = read_launches()
    log(f"serving path: {n_ex} eval examples, {steps} rank steps per mode, "
        f"launches {launches}")
    check(launches["spmm_csr"] == 2 * cfg.n_gnn,
          f"spmm_csr launched {launches['spmm_csr']} times, want "
          f"{2 * cfg.n_gnn}")
    check(launches["encoder_fwd"] == 3 * 2 * steps,
          f"encoder_fwd launched {launches['encoder_fwd']} times, want "
          f"{3 * 2 * steps}")
    for mode, n_cand in (("sampled", cfg.n_neg_sample + 1), ("full", None)):
        ra, rb = ranks[mode]
        check(len(ra) + len(rb) == n_ex, f"{mode}: rank count")
        for r, n_real in ((ra, spec.n_item_a), (rb, spec.n_item_b)):
            hi_rank = n_cand or n_real
            check(min(r) >= 1 and max(r) <= hi_rank,
                  f"{mode}: ranks outside [1, {hi_rank}]")
        score = metrics.cal_score(ra, rb, cfg.benchmark)
        check(all(math.isfinite(v) for v in score), f"{mode}: metric not finite")
        log(f"main path {mode}: {n_ex / secs[mode]:.1f} eval examples/s "
            f"({secs[mode]:.3f} s), improvement {score[0]:.4f}, hr5_a "
            f"{score[1]:.4f} hr5_b {score[7]:.4f}")
    log(f"main path convolve: {t_conv * 1e3:.2f} ms (first run)")

    # warm timings in turns on the same card, (plain, kernel, kernel, plain)
    # repeated, so drift falls on both alike; the gap between the two counts
    # as resolved only beyond 3 standard errors of the difference of means
    runs = {"kernel": [], "plain": []}
    ranks_plain = None
    for which in ("plain", "kernel", "kernel", "plain") * WARM_ROUNDS:
        ctx = plain_versions() if which == "plain" else contextlib.nullcontext()
        with ctx:
            _, r, t_c, s_m = run_all()
        if which == "plain" and ranks_plain is None:
            ranks_plain = r
        runs[which].append((t_c, s_m))
    stats = {}
    for which, rs in runs.items():
        conv_ms = np.array([t for t, _ in rs]) * 1e3
        log(f"main path warm ({which}, {len(rs)} runs): convolve mean "
            f"{conv_ms.mean():.3f} ms sd {conv_ms.std(ddof=1):.3f}")
        for m in ("sampled", "full"):
            rate = n_ex / np.array([s_m[m] for _, s_m in rs])
            stats[which, m] = rate
            log(f"main path warm ({which}) {m}: eval examples/s mean "
                f"{rate.mean():.1f} sd {rate.std(ddof=1):.1f} min "
                f"{rate.min():.1f} max {rate.max():.1f}; runs "
                f"{[round(float(v)) for v in rate]}")
    for m in ("sampled", "full"):
        k, p = stats["kernel", m], stats["plain", m]
        diff = k.mean() - p.mean()
        se = math.sqrt(k.var(ddof=1) / len(k) + p.var(ddof=1) / len(p))
        log(f"main path warm {m}: kernel - plain {diff:.1f} eval examples/s "
            f"({diff / p.mean():+.2%}), standard error {se:.1f}: "
            f"{'resolved' if abs(diff) > 3 * se else 'unresolved'}")
    profile_main_path(run_all)

    for mode in ("sampled", "full"):
        ties = near_ties(params, hi, data, cfg, spec, mode)
        n_diff = n_tied = n_masked = n_unexplained = 0
        for i, dom in enumerate(("a", "b")):
            rk = np.asarray(ranks[mode][i])
            rp = np.asarray(ranks_plain[mode][i])
            diff = rk != rp
            # A domain tower with no item of its domain is read at an
            # all-masked row: its logits are all -1e9 + x, rounded to steps
            # of 64, so two summation orders may round one logit apart.
            masked = groups[dom][f"idx_last_{dom}"] < 0
            n_diff += int(diff.sum())
            n_tied += int((ties[dom] > 0).sum())
            n_masked += int((diff & masked).sum())
            n_unexplained += int(((np.abs(rk - rp) > ties[dom])
                                  & ~masked).sum())
        log(f"ranks {mode}: {n_diff} of {n_ex} differ from the plain run; "
            f"{n_tied} examples have a near-tie (|s - s_gt| <= {TIE_TOL}); "
            f"{n_masked} differences at all-masked rows; "
            f"{n_unexplained} differences not explained by either")
        check(n_unexplained == 0,
              f"{mode}: {n_unexplained} ranks differ beyond near-ties")
    return launches


def phase_hash():
    """The kernels' dropout hash against the plain-integer reference (the
    values tests/test_torch_dropout.py holds the torch hash against)."""
    from c2dsr_tpu_torch.ops import dropout as drop
    from c2dsr_tpu_torch.ops import encoder_cuda
    for seed, site, tower, layer in ((0, 0, 0, 0), (12345, 1, 2, 0),
                                     (2 ** 31 - 1, 4, 1, 3)):
        got = encoder_cuda.dropout_bits(seed, site, tower, layer, 512)
        want = [drop.bits_reference(seed, site, tower, layer, i)
                for i in range(512)]
        check(got.cpu().tolist() == want,
              f"dropout hash differs from the reference at seed {seed}")
    log("dropout hash: CUDA bits equal ops/dropout.bits_reference "
        "(3 streams x 512 elements)")


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def phase_encoder_train(timer, peak_flops, peak_bw):
    """K2 in train mode and K3 at the three tower segments of a train step
    (shared 3B, A B, B B at B = 512), dropout 0 and 0.2, against the plain
    tower and its autograd; timed at 0.2 and summed over the segments."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import encoder_cuda
    d, L, pad, B = 128, LEN_MAX, 64093, 512
    cfg = Config()
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    fwd = dict.fromkeys(keys, 0.0)
    bwd = dict.fromkeys(keys, 0.0)
    fwd["max_abs_err"] = bwd["max_abs_err"] = bwd["max_rel_err"] = 0.0
    causal = torch.triu(torch.ones(L, L, dtype=torch.bool, device="cuda"), 1)
    for tower_id, n_seq in ((0, 3 * B), (1, B), (2, B)):
        p = params_mod._map(lambda t: t.cuda(), params_mod.init_encoder_params(
            torch.Generator().manual_seed(10 + tower_id), cfg, L))
        x, seq = _encoder_inputs(n_seq, L, d, pad, seed=20 + tower_id)
        gout = torch.randn(x.shape, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(3))
        for dropout in (0.0, 0.2):
            kw = dict(idx_pad=pad, n_head=1, invert_padding_mask=False,
                      dropout=dropout, seed=1234, tower=tower_id)
            with torch.no_grad():
                out = encoder_cuda.encoder_fwd(x, seq, p, **kw)
                ref = enc.encoder_fwd_plain(x, seq, p, **kw)
            dx, grads = encoder_cuda.encoder_bwd(x, seq, gout, p, **kw)
            rdx, rgrads = enc.encoder_bwd_plain(x, seq, gout, p, **kw)
            torch.cuda.synchronize()
            err_f = float((out - ref).abs().max())
            check(bool(torch.isfinite(out).all() and torch.isfinite(dx).all()),
                  f"encoder train tower {tower_id}: non-finite")
            check(err_f <= ENCODER_TOL, f"encoder_fwd train tower {tower_id} "
                  f"p={dropout}: max abs err {err_f} > {ENCODER_TOL}")
            rels = {"dx": _rel(dx, rdx)}
            abs_err = float((dx - rdx).abs().max())
            for name, g, r in zip(enc._NAMES + ("lnf_scale", "lnf_bias"),
                                  grads, rgrads):
                rels[name] = _rel(g, r)
                abs_err = max(abs_err, float((g - r).abs().max()))
            worst = max(rels, key=rels.get)
            log(f"encoder train tower {tower_id} B={n_seq} p={dropout}: "
                f"fwd max abs err {err_f:.3e}; bwd max abs err {abs_err:.3e},"
                f" worst relative {rels[worst]:.3e} ({worst})")
            check(rels[worst] <= GRAD_TOL, f"encoder_bwd tower {tower_id} "
                  f"p={dropout}: {worst} relative err {rels[worst]} > "
                  f"{GRAD_TOL}")
            fwd["max_abs_err"] = max(fwd["max_abs_err"], err_f)
            bwd["max_abs_err"] = max(bwd["max_abs_err"], abs_err)
            bwd["max_rel_err"] = max(bwd["max_rel_err"], rels[worst])
        # times at the training rate, dropout 0.2
        tower = _torch_tower(p, d, 1, 1, dropout=kw["dropout"])
        kpm = seq == pad
        xg = x.clone().requires_grad_(True)
        lib_params = [xg] + list(tower.parameters())
        with torch.no_grad():
            f_ms = timer(lambda: encoder_cuda.encoder_fwd(x, seq, p, **kw))
            f_plain = timer(lambda: enc.encoder_fwd_plain(x, seq, p, **kw))
            f_lib = timer(lambda: tower(x, mask=causal,
                                        src_key_padding_mask=kpm))
        b_ms = timer(lambda: encoder_cuda.encoder_bwd(x, seq, gout, p, **kw))
        b_plain = timer(lambda: enc.encoder_bwd_plain(x, seq, gout, p, **kw))
        b_lib = timer(lambda: torch.autograd.grad(
            tower(xg, mask=causal, src_key_padding_mask=kpm), lib_params,
            gout))
        N = n_seq * L
        w_bytes = 4 * (6 * d * d + 10 * d + 2 * d)
        f_flops = 12 * N * d * d + 4 * N * L * d
        b_flops = 24 * N * d * d + 8 * N * L * d      # recompute-free
        f_bytes = 8 * N * d + 4 * N + w_bytes
        b_bytes = 12 * N * d + 4 * N + 2 * w_bytes
        f_bound = max(f_flops / peak_flops, f_bytes / peak_bw) * 1e3
        b_bound = max(b_flops / peak_flops, b_bytes / peak_bw) * 1e3
        fwd["bound_by"] = ("operations" if f_flops / peak_flops
                           >= f_bytes / peak_bw else "bytes")
        bwd["bound_by"] = ("operations" if b_flops / peak_flops
                           >= b_bytes / peak_bw else "bytes")
        log(f"encoder train tower {tower_id} B={n_seq}: fwd kernel {f_ms:.4f} "
            f"ms plain {f_plain:.4f} library {f_lib:.4f} bound {f_bound:.4f};"
            f" bwd kernel {b_ms:.4f} ms plain {b_plain:.4f} library "
            f"{b_lib:.4f} (forward + backward) bound {b_bound:.4f} "
            f"({b_flops / b_ms / 1e9:.2f} TFLOP/s)")
        for acc, vals in ((fwd, (f_ms, f_plain, f_lib, f_bound)),
                          (bwd, (b_ms, b_plain, b_lib, b_bound))):
            for k, v in zip(keys, vals):
                acc[k] += v
    return fwd, bwd


def kernel_times(fn, calls: int = 3):
    """{kernel name: device ms of one launch} for a fn that launches each of
    its kernels once, under torch.profiler: the mean over the launches the
    profiler recorded in ``calls`` calls.  The profiler may miss the first
    kernels of its window, so one profiled call is not enough."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if ev.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            name = ev.key.split("::")[-1].split("(")[0]
            total[name] = total.get(name, 0.0) + us / 1e3
            count[name] = count.get(name, 0) + ev.count
    return {name: total[name] / count[name] for name in total}


def phase_ce(timer, peak_flops, peak_bw):
    """K4 and K5 at a train step's shapes (N = 512 x 2 x len_rec rows, d 128,
    V 30,720 and 36,864), against their plain versions; summed over both
    domains."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    N, d = 512 * 2 * 10, 128
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    fwd = dict.fromkeys(keys, 0.0)
    bwd = dict.fromkeys(keys, 0.0)
    fwd["max_abs_err"] = bwd["max_abs_err"] = bwd["max_rel_err"] = 0.0
    for dom, V, n_real in (("A", 30720, N_ITEM_A), ("B", 36864, N_ITEM_B)):
        rng = np.random.default_rng(V)

        def put(a):
            return torch.from_numpy(np.asarray(a, np.float32)).cuda()

        h = put(rng.normal(size=(N, d)))
        w_np = rng.normal(size=(d, V)) * 0.05
        w_np[:, n_real:] = 0.0
        w = put(w_np)
        bm = fused_ce.mask_bias(put(rng.normal(size=V) * 0.1), n_real)
        pad_l = put(rng.normal(size=N))
        tgt_np = rng.integers(0, n_real, size=N)
        tgt_np[::5] = n_real                             # ignored rows
        tgt = torch.from_numpy(tgt_np).cuda()
        real = tgt != n_real
        dlse = put(rng.normal(size=N) / N) * real
        dt = put(rng.normal(size=N) / N) * real
        with torch.no_grad():
            lse, tlog = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)
            rlse, rtlog = fused_ce.ce_fwd_plain(h, w, bm, pad_l, tgt)
            got = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
            want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt)
        torch.cuda.synchronize()
        e_lse = _rel(lse, rlse)
        e_t = _rel(tlog[real], rtlog[real])
        rels = {n: _rel(g, r) for n, g, r in zip(("dh", "dw", "db"), got,
                                                 want)}
        log(f"ce {dom}: N={N} d={d} V={V}: lse rel err {e_lse:.3e}, target "
            f"logit rel err {e_t:.3e}; backward rel err {rels}")
        check(max(e_lse, e_t) <= CE_TOL, f"ce_fwd {dom}: rel err "
              f"{max(e_lse, e_t)} > {CE_TOL}")
        check(max(rels.values()) <= GRAD_TOL, f"ce_bwd {dom}: rel err "
              f"{rels} > {GRAD_TOL}")
        check(bool((got[2][n_real:] == 0).all()), f"ce_bwd {dom}: db on "
              "padded columns not zero")
        fwd["max_abs_err"] = max(fwd["max_abs_err"],
                                 float((lse - rlse).abs().max()))
        bwd["max_abs_err"] = max(bwd["max_abs_err"], max(
            float((g - r).abs().max()) for g, r in zip(got, want)))
        bwd["max_rel_err"] = max(bwd["max_rel_err"], max(rels.values()))
        hg, wg, bg = (t.detach().clone().requires_grad_(True)
                      for t in (h, w, bm))
        with torch.no_grad():
            f_ms = timer(lambda: fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt))
            f_plain = timer(lambda: fused_ce.ce_fwd_plain(h, w, bm, pad_l,
                                                          tgt))
            f_lib = timer(lambda: torch.logsumexp(
                torch.cat([h @ w + bm, pad_l[:, None]], 1), 1))
            b_ms = timer(lambda: fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt,
                                                      tgt))
            b_plain = timer(lambda: fused_ce.ce_bwd_plain(h, w, bm, lse, dlse,
                                                          dt, tgt))
        sub = kernel_times(lambda: fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse,
                                                        dt, tgt))
        log(f"ce {dom}: bwd device time by kernel (a launch's mean over 3 "
            "profiled calls): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in sub.items()))
        # summed over both domains; None where the profiler saw no launch
        by_kernel = bwd.setdefault("kernels_ms", {})
        for k in ("ce_dh_kernel", "ce_dh_merge_kernel", "ce_dw_kernel"):
            before = by_kernel.get(k, 0.0)
            by_kernel[k] = (None if before is None or k not in sub
                            else before + sub[k])
        lib_out = torch.logsumexp(torch.cat([hg @ wg + bg, pad_l[:, None]],
                                            1), 1)
        b_lib = timer(lambda: torch.autograd.grad(lib_out, [hg, wg, bg], dlse,
                                                  retain_graph=True))
        del lib_out
        io = 4 * (N * d + d * V + V + 3 * N)
        f_bound = max(2 * N * V * d / peak_flops, (io + 8 * N) / peak_bw) * 1e3
        b_bound = max(4 * N * V * d / peak_flops,
                      (2 * io + 4 * N * d) / peak_bw) * 1e3
        log(f"ce {dom}: fwd kernel {f_ms:.4f} ms plain {f_plain:.4f} library "
            f"{f_lib:.4f} bound {f_bound:.4f} "
            f"({2 * N * V * d / f_ms / 1e9:.2f} TFLOP/s); bwd kernel "
            f"{b_ms:.4f} ms plain {b_plain:.4f} library {b_lib:.4f} bound "
            f"{b_bound:.4f} (bound counts 4·N·V·d FLOPs, "
            f"{4 * N * V * d / b_ms / 1e9:.2f} TFLOP/s)")
        for acc, vals in ((fwd, (f_ms, f_plain, f_lib, f_bound)),
                          (bwd, (b_ms, b_plain, b_lib, b_bound))):
            for k, v in zip(keys, vals):
                acc[k] += v
    fwd["bound_by"] = bwd["bound_by"] = "operations"
    return fwd, bwd


def phase_train(spec, train, graphs):
    """The training path at FK geometry, default Config."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.data.pipeline import BatchIterator
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.train import optim
    from c2dsr_tpu_torch.train import step as step_mod

    cfg = Config()
    it = BatchIterator(train, cfg.batch_size, shuffle=True, seed=0,
                       drop_last=True)
    log(f"train path: {train['seq_share'].shape[0]} train examples, "
        f"{len(it)} full batches of {cfg.batch_size} an epoch")

    def batches():
        while True:
            yield from it.epoch()

    feed = batches()
    params = params_mod.init_params(cfg, spec,
                                    torch.Generator().manual_seed(0), "cuda")
    opt = optim.make_optimizer(cfg, steps_per_epoch=len(it))
    state = step_mod.init_state(params, opt)
    leaves = state.opt_state.leaves
    fn = step_mod.make_train_step(cfg, spec, graphs, opt,
                                  torch.Generator().manual_seed(cfg.seed),
                                  "cuda")

    # one step at dropout 0 through the kernels and through the plain
    # versions: the same loss and gradients
    cfg0 = cfg.with_(dropout_gnn=0.0, dropout_attn=0.0)
    b0 = ranker.to_device(next(feed), "cuda")

    def grads_of(ctx):
        for t in leaves:
            t.grad = None
        with ctx:
            loss, _ = step_mod.loss_fn(params, graphs, b0, None, cfg0, spec)
            loss.backward()
        return float(loss), [t.grad.clone() for t in leaves]

    loss_k, g_k = grads_of(contextlib.nullcontext())
    loss_p, g_p = grads_of(plain_versions())
    for t in leaves:
        t.grad = None
    rel = [_rel(a, b) if float(b.abs().max()) > 0 else float(a.abs().max())
           for a, b in zip(g_k, g_p)]
    log(f"train path dropout 0: loss {loss_k:.6f} (kernels) {loss_p:.6f} "
        f"(plain); worst gradient relative err {max(rel):.3e} over "
        f"{len(rel)} tensors")
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
          f"train loss {loss_k} (kernels) != {loss_p} (plain)")
    check(max(rel) <= GRAD_TOL, f"train gradients: relative err {max(rel)}")

    # TRAIN_STEPS steps through the kernels: launches and the loss
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, aux = fn(state, next(feed))
        losses.append(aux["loss"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    losses = [float(v) for v in losses]
    per_step = {"spmm_csr": 4 * cfg.n_gnn, "spmm_csr_flagged": 0,
                "encoder_fwd": 3, "encoder_bwd": 3, "ce_fwd": 2, "ce_bwd": 2}
    log(f"train path: {TRAIN_STEPS} steps (first, cold) in {secs:.3f} s, "
        f"{TRAIN_STEPS * cfg.batch_size / secs:.1f} train examples/s; "
        f"launches {launches}")
    log(f"train path losses: {[round(v, 4) for v in losses]}")
    for name, n in per_step.items():
        check(launches[name] == n * TRAIN_STEPS,
              f"{name} launched {launches[name]} times in {TRAIN_STEPS} "
              f"steps, want {n} a step")
    check(all(math.isfinite(v) for v in losses), "train loss not finite")
    check(np.mean(losses[-5:]) < losses[0],
          f"train loss did not fall: {losses[0]} -> {losses[-5:]}")

    # warm train examples/s in turns, (plain, kernel, kernel, plain)
    runs = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain") * TRAIN_ROUNDS:
        ctx = plain_versions() if which == "plain" else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_RUN_STEPS):
                state, aux = fn(state, next(feed))
            torch.cuda.synchronize()
        rate = TRAIN_RUN_STEPS * cfg.batch_size / (time.perf_counter() - t0)
        check(math.isfinite(float(aux["loss"])), "train loss not finite")
        runs[which].append(rate)
    k, p = np.array(runs["kernel"]), np.array(runs["plain"])
    for which, r in (("kernel", k), ("plain", p)):
        log(f"train path warm ({which}, {len(r)} runs of {TRAIN_RUN_STEPS} "
            f"steps): train examples/s mean {r.mean():.1f} sd "
            f"{r.std(ddof=1):.1f}; runs {[round(float(v)) for v in r]}")
    diff = k.mean() - p.mean()
    se = math.sqrt(k.var(ddof=1) / len(k) + p.var(ddof=1) / len(p))
    log(f"train path warm: kernel - plain {diff:.1f} train examples/s "
        f"({diff / p.mean():+.2%}), standard error {se:.1f}: "
        f"{'resolved' if abs(diff) > 3 * se else 'unresolved'}")

    batch = next(feed)

    def one_step():
        fn(state, batch)
        torch.cuda.synchronize()

    profile_main_path(one_step, label="train profile")
    return launches, float(k.mean())


def _flagged_batch(train, batch_size):
    """One real training batch on the card and its row flags over the
    padded tables (``train/step.row_flags``, as ``loss_fn`` builds them)."""
    from c2dsr_tpu_torch.data.pipeline import BatchIterator
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.train import step as step_mod
    it = BatchIterator(train, batch_size, shuffle=True, seed=0,
                       drop_last=True)
    b = ranker.to_device(next(iter(it.epoch())), "cuda")
    seq3 = torch.cat([b["seq_share"], b["seq_share_neg_a"],
                      b["seq_share_neg_b"]], dim=0)
    return b, step_mod.row_flags(seq3, b["seq_share_a"], b["seq_share_b"],
                                 65536)


def phase_spmm_flagged(graphs, train, timer, peak_flops, peak_bw):
    """K6, the batch-sparse hop, with the flags of one FK training batch:
    over A in dest mode (a hop's forward) and over Aᵀ in src mode (its
    backward, on a gradient that is zero off the flags), over each graph,
    against its plain version and against K1.  Times kernel, plain version
    and dense ``torch.sparse.mm`` (no single PyTorch call computes the
    flagged hop: the dense product does more work)."""
    from c2dsr_tpu_torch.ops import spmm, spmm_cuda
    _, (f_share, f_ab) = _flagged_batch(train, 512)
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_rows = 65536
    res = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "kept_edge_share": {}, "by_hop": {}}
    for name, g, d, flag in (("share", graphs.share, 128, f_share),
                             ("specific_ab", graphs.specific, 256, f_ab)):
        sel = flag.bool()
        for mode, graph in (("dest", g), ("src", g.t)):
            x = torch.randn((n_rows, d), generator=gen, device="cuda")
            x[g.n:] = 0.0
            if mode == "src":
                x = x * flag[:, None]          # the gradient of read rows
            out = spmm_cuda.spmm_csr_flagged(graph, x, flag, mode)
            ref = spmm.spmm_reference_flagged(graph, x, flag, mode)
            dense = spmm_cuda.spmm_csr(graph, x)
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            err = float((out - ref).abs().max())
            tag = f"spmm_flagged {name} {mode}"
            check(bool(torch.isfinite(out).all()), f"{tag}: non-finite")
            check(err <= SPMM_TOL * scale,
                  f"{tag}: max abs err {err} > {SPMM_TOL} x {scale}")
            if mode == "dest":
                check(bool((out[~sel] == 0).all()),
                      f"{tag}: unflagged rows not zero")
                same = torch.equal(out[sel], dense[sel])
                check(same, f"{tag}: flagged rows differ from K1's")
                probe = graph.rows.long()        # edges kept by out row
            else:
                same = torch.equal(out, dense)
                err_k1 = float((out - dense).abs().max())
                check(err_k1 <= SPMM_TOL * scale,
                      f"{tag}: differs from K1 over the transpose by "
                      f"{err_k1}")
                probe = graph.cols.long()        # edges kept by src row
            keep = flag[probe].bool()
            nnz = int(graph.cols.numel())
            n_kept = int(keep.sum())
            used = int(torch.unique(graph.cols[keep]).numel())
            rowptr = torch.cat([graph.rowptr,
                                graph.rowptr[-1:].expand(n_rows - g.n)])
            csr = torch.sparse_csr_tensor(rowptr.long(), graph.cols.long(),
                                          graph.vals, size=(n_rows, n_rows),
                                          check_invariants=False)
            ms = timer(lambda: spmm_cuda.spmm_csr_flagged(graph, x, flag,
                                                          mode))
            plain_ms = timer(lambda: spmm.spmm_reference_flagged(
                graph, x, flag, mode))
            library_ms = timer(lambda: torch.sparse.mm(csr, x))
            # each input read once, each output written once: the row
            # pointers and the flag byte of every row; in dest mode the id
            # and weight of each kept edge, in src mode of every edge (and
            # its flag byte); each gathered row once; every output row
            edge_bytes = 8 * n_kept if mode == "dest" else 9 * nnz
            nbytes = ((g.n + 1) * 4 + n_rows + edge_bytes + used * d * 4
                      + n_rows * d * 4)
            bound_ms = max(nbytes / peak_bw,
                           2 * n_kept * d / peak_flops) * 1e3
            share = n_kept / max(nnz, 1)
            log(f"{tag}: d={d} nnz={nnz} kept={n_kept} ({share:.4f}) "
                f"gathered rows={used} err={err:.3e} (scale {scale:.3f}) "
                f"bitwise K1={same} kernel {ms:.4f} ms plain {plain_ms:.4f} "
                f"ms library (dense) {library_ms:.4f} ms bound "
                f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB)")
            res["kept_edge_share"][f"{name} {mode}"] = share
            res["by_hop"][f"{name} {mode}"] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "max_abs_err": err}
            res["ms"] += ms
            res["plain_ms"] += plain_ms
            res["library_ms"] += library_ms
            res["bound_ms"] += bound_ms
            res["max_abs_err"] = max(res["max_abs_err"], err)
    return res


def _warm_rates(fns, feed, batch_size):
    """Warm train examples/s of each of two step functions, run in turns
    (a, b, b, a) TRAIN_ROUNDS times, TRAIN_RUN_STEPS steps a run; both
    update the same state in place.  Returns {name: rates}."""
    (na, fa), (nb, fb) = fns
    runs = {na: [], nb: []}
    for name, fn in ((na, fa), (nb, fb), (nb, fb), (na, fa)) * TRAIN_ROUNDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_RUN_STEPS):
            aux = fn(next(feed))
        torch.cuda.synchronize()
        check(math.isfinite(float(aux["loss"])), "train loss not finite")
        runs[name].append(TRAIN_RUN_STEPS * batch_size
                          / (time.perf_counter() - t0))
    return {k: np.array(v) for k, v in runs.items()}


def phase_experiment(spec, train, data, graphs, name):
    """The experiment entry point at FK geometry with the batch-sparse
    propagation: two epochs of ``Experiment.run`` with save-on-best, a
    resumed third, the flags-on/off equality and the warm step rates."""
    from c2dsr_tpu_torch import checkpoint as ckpt_mod
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.data.pipeline import BatchIterator
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.train import step as step_mod
    from c2dsr_tpu_torch.train.loop import Experiment

    cfg = Config(batch_sparse_gnn=True, n_epoch=2)
    half = data["gt_last"].shape[0] // 2
    val = {k: v[:half] for k, v in data.items()}
    test = {k: v[half:] for k, v in data.items()}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        exp = Experiment(cfg, spec, graphs, train, val, test, ckpt_path=ckpt,
                         device="cuda")
        losses, convolves = [], [0]
        train_epoch, convolve_eval = exp.run_train_epoch, exp.convolve_eval

        def train_and_record():
            losses.append(train_epoch())
            return losses[-1]

        def convolve_and_count(params):
            convolves[0] += 1
            return convolve_eval(params)

        exp.run_train_epoch = train_and_record
        exp.convolve_eval = convolve_and_count
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exp.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        steps = cfg.n_epoch * len(exp.train_iter)
        log(f"experiment path: {exp.n_tr} train examples, {len(val['gt_last'])}"
            f" val and {len(test['gt_last'])} test examples; {cfg.n_epoch} "
            f"epochs ({steps} steps, {convolves[0]} eval convolves) in "
            f"{secs:.3f} s; losses {[[round(v, 4) for v in l] for l in losses]}"
            f"; best epoch improvement {out['imp_val_best']:.4f}; launches "
            f"{launches}")
        check(out["epoch"] == cfg.n_epoch, f"experiment ended at {out}")
        check(all(math.isfinite(v) for l in losses for v in l),
              f"experiment loss not finite: {losses}")
        check(all(math.isfinite(v) for v in [out["imp_val_best"]]
                  + list(out["res_test"])), f"experiment metric: {out}")
        want = {"spmm_csr_flagged": 4 * steps,
                "spmm_csr": 4 * (cfg.n_gnn - 1) * steps
                + 2 * cfg.n_gnn * convolves[0],
                "encoder_bwd": 3 * steps, "ce_fwd": 2 * steps,
                "ce_bwd": 2 * steps}
        for k, n in want.items():
            check(launches[k] == n, f"experiment: {k} launched "
                  f"{launches[k]} times, want {n}")
        check(launches["encoder_fwd"] > 3 * steps, "experiment: eval towers")

        meta = ckpt_mod.load_meta(ckpt)
        check(ckpt_mod.exists(ckpt) and meta.get("epoch") in (1, 2),
              f"experiment: no checkpoint ({meta})")
        exp2 = Experiment(cfg.with_(n_epoch=3, resume=True), spec, graphs,
                          train, val, test, ckpt_path=ckpt, device="cuda")
        check(exp2._start_epoch == meta["epoch"]
              and exp2.state.step == meta["epoch"] * len(exp.train_iter),
              f"resume: epoch {exp2._start_epoch} step {exp2.state.step}, "
              f"meta {meta}")
        t0 = time.perf_counter()
        out2 = exp2.run()
        torch.cuda.synchronize()
        secs2 = time.perf_counter() - t0
        check(out2["epoch"] == 3 and out2["imp_val_best"]
              >= meta["imp_val_best"], f"resumed run: {out2}")
        log(f"experiment resume: from epoch {meta['epoch']} (state "
            f"{meta['state_dir']}) to {out2['epoch']} in {secs2:.3f} s, best "
            f"improvement {out2['imp_val_best']:.4f}")
        del exp2

    # one step at dropout 0 with the flags on and off
    cfg0 = cfg.with_(dropout_gnn=0.0, dropout_attn=0.0)
    b0, _ = _flagged_batch(train, cfg.batch_size)
    leaves = exp.state.opt_state.leaves

    def grads_of(sparse):
        for t in leaves:
            t.grad = None
        loss, _ = step_mod.loss_fn(exp.state.params, graphs, b0, None,
                                   cfg0.with_(batch_sparse_gnn=sparse), spec)
        loss.backward()
        return float(loss.detach()), [t.grad.clone() for t in leaves]

    loss_on, g_on = grads_of(True)
    loss_off, g_off = grads_of(False)
    for t in leaves:
        t.grad = None
    rel = [_rel(a, b) if float(b.abs().max()) > 0 else float(a.abs().max())
           for a, b in zip(g_on, g_off)]
    log(f"experiment dropout 0: loss {loss_on:.6f} (flags on) {loss_off:.6f}"
        f" (off); worst gradient relative err {max(rel):.3e}")
    check(abs(loss_on - loss_off) <= 1e-5 * abs(loss_off),
          f"batch-sparse loss {loss_on} != dense {loss_off}")
    check(max(rel) <= GRAD_TOL, f"batch-sparse gradients: {max(rel)}")

    # warm train examples/s, flags on and off in turns (logged, not claimed)
    it = BatchIterator(train, cfg.batch_size, shuffle=True, seed=1,
                       drop_last=True)

    def batches():
        while True:
            yield from it.epoch()

    feed = batches()
    dense = step_mod.make_train_step(
        cfg.with_(batch_sparse_gnn=False), spec, graphs, exp.optimizer,
        torch.Generator().manual_seed(9), "cuda")

    def on(batch):
        exp.state, aux = exp.train_step(exp.state, batch)
        return aux

    def off(batch):
        exp.state, aux = dense(exp.state, batch)
        return aux

    rates = _warm_rates((("dense", off), ("batch_sparse", on)), feed,
                        cfg.batch_size)
    for k, r in rates.items():
        log(f"experiment warm ({k}, {len(r)} runs of {TRAIN_RUN_STEPS} "
            f"steps): train examples/s mean {r.mean():.1f} sd "
            f"{r.std(ddof=1):.1f}; runs {[round(float(v)) for v in r]}")
    k, p = rates["batch_sparse"], rates["dense"]
    diff = k.mean() - p.mean()
    se = math.sqrt(k.var(ddof=1) / len(k) + p.var(ddof=1) / len(p))
    log(f"experiment warm: batch_sparse - dense {diff:.1f} train examples/s "
        f"({diff / p.mean():+.2%}), standard error {se:.1f}: "
        f"{'resolved' if abs(diff) > 3 * se else 'unresolved'} (on {name})")
    return launches, {"batch_sparse": float(k.mean()),
                      "dense": float(p.mean())}


def phase_cli():
    """``python -m c2dsr_tpu_torch.cli`` on the card in a temporary working
    directory: exit 0 and the final result table."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO_DIR] + [p for p in [env.get("PYTHONPATH")] if p])
        cmd = [sys.executable, "-m", "c2dsr_tpu_torch.cli", "--synthetic",
               str(CLI_USERS), "--n_epoch", "1", "--ckpt",
               os.path.join(tmp, "ckpt")]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                             text=True, timeout=600)
        secs = time.perf_counter() - t0
        check(run.returncode == 0, f"cli exited {run.returncode}: "
              f"{run.stderr[-2000:]}")
        check("[ Test result ]" in run.stdout,
              "cli printed no final result table")
        check(os.path.isfile(os.path.join(tmp, "ckpt", "meta.json")),
              "cli wrote no checkpoint")
        table = run.stdout[run.stdout.rindex("[ Test result ]"):]
        log(f"cli: {' '.join(cmd[1:])} exited 0 in {secs:.1f} s; test "
            f"result {table.splitlines()[2].strip()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from c2dsr_tpu_torch.config import DataSpec
        from c2dsr_tpu_torch.data import preprocess, synthetic
        from c2dsr_tpu_torch.graph import build as graph_build
        from c2dsr_tpu_torch.kernels import build
        from c2dsr_tpu_torch.ops import backend, spmm
    except ImportError as e:
        print(f"chip_smoke: the c2dsr_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    backend.resolve_device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peaks(name)
    log(f"setup: torch {torch.__version__} cuda {torch.version.cuda}; "
        f"card {card}; peaks {peak_flops / 1e12:.0f} TFLOP/s FP32, "
        f"{peak_bw / 1e12:.2f} TB/s")
    t0 = time.perf_counter()
    build.build_all()
    log(f"setup: kernels built in {time.perf_counter() - t0:.1f} s")

    spec = DataSpec(n_item_a=N_ITEM_A, n_item_b=N_ITEM_B, len_max=LEN_MAX)
    t0 = time.perf_counter()
    seqs = synthetic.generate_sequences(spec, N_TRAIN_USERS, seed=0)
    graphs_host = graph_build.build_graphs(seqs, spec)
    log(f"setup: FK graphs nnz share {graphs_host[0].nnz} specific "
        f"{graphs_host[1].nnz} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train = preprocess.preprocess_train(seqs, spec, seed=1)
    eval_data = preprocess.preprocess_evaluate(
        synthetic.generate_sequences(spec, N_EVAL_USERS, seed=1), spec,
        n_neg_sample=999, seed=2)
    log(f"setup: {train['seq_share'].shape[0]} train examples from "
        f"{len(seqs)} users, {eval_data['gt_last'].shape[0]} eval examples "
        f"from {N_EVAL_USERS} users in {time.perf_counter() - t0:.1f} s")

    from c2dsr_tpu_torch.model import c2dsr
    graphs = c2dsr.Graphs(spmm.device_graph(graphs_host[0], "cuda"),
                          spmm.device_graph(graphs_host[1], "cuda"))
    phase_hash()
    timer = Timer()
    with torch.inference_mode():
        k1 = phase_spmm(graphs, timer, peak_flops, peak_bw)
        k1t = phase_spmm(graphs, timer, peak_flops, peak_bw, transpose=True)
        k6 = phase_spmm_flagged(graphs, train, timer, peak_flops, peak_bw)
    k2 = phase_encoder(timer, peak_flops, peak_bw)
    k2t, k3 = phase_encoder_train(timer, peak_flops, peak_bw)
    k4, k5 = phase_ce(timer, peak_flops, peak_bw)
    del timer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serving = phase_main(spec, graphs_host, eval_data)
    log(f"phase serving: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    training, train_rate = phase_train(spec, train, graphs)
    log(f"phase training: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    experiment, exp_rates = phase_experiment(spec, train, eval_data, graphs,
                                             card)
    log(f"phase experiment: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_cli()
    log(f"phase cli: {time.perf_counter() - t0:.1f} s")
    paths = {"serving": serving, "training": training,
             "experiment": experiment}
    for path, kernels_of_path in (
            ("serving", ("spmm_csr", "encoder_fwd")),
            ("training", ("spmm_csr", "encoder_fwd", "encoder_bwd", "ce_fwd",
                          "ce_bwd")),
            ("experiment", tuple(kernel_wrappers()))):
        check(all(paths[path][n] > 0 for n in kernels_of_path),
              f"a kernel never launched on the {path} path: {paths[path]}")

    def counts(name):
        return {"launches": sum(p[name] for p in paths.values()),
                "launches_by_path": {k: p[name] for k, p in paths.items()}}

    step_hops = {k: k1[k] + k1t[k] for k in ("ms", "plain_ms", "library_ms",
                                               "bound_ms")}
    kernels = [
        {"name": "spmm_csr", "route": "cuda",
         "source": "c2dsr_tpu_torch/csrc/spmm.cu",
         "replaces": "c2dsr_tpu/ops/spmm_pallas.py:175",
         **counts("spmm_csr"),
         "max_abs_err": max(k1["max_abs_err"], k1t["max_abs_err"]),
         **step_hops, "bound_by": "bytes",
         "forward": k1, "transpose": k1t,
         "note": "the four hops of a train step: over A and over its "
                 "transpose (the hop's backward, spmm_pallas.py:224-225), "
                 "each over the share table (d 128) and A|B (d 256)"},
        {"name": "spmm_csr_flagged", "route": "cuda",
         "source": "c2dsr_tpu_torch/csrc/spmm.cu",
         "replaces": "c2dsr_tpu/ops/spmm_pallas.py:231-264 via :175",
         **counts("spmm_csr_flagged"),
         **{k: k6[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                               "bound_ms")},
         "bound_by": "bytes", "kept_edge_share": k6["kept_edge_share"],
         "by_hop": k6["by_hop"],
         "note": "K6: the four hops of a batch-sparse train step with one "
                 "FK batch's flags: dest over A, src over its transpose, "
                 "share (d 128) and A|B (d 256); library: dense "
                 "torch.sparse.mm, which does more work"},
        {"name": "encoder_fwd", "route": "cuda",
         "source": "c2dsr_tpu_torch/csrc/encoder.cu",
         "replaces": "c2dsr_tpu/ops/encoder_pallas.py:444",
         **counts("encoder_fwd"),
         "max_abs_err": max(k2["max_abs_err"], k2t["max_abs_err"]),
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"], "train": k2t,
         "note": "eval: one tower at B 2048, L 15, d 128; train: the three "
                 "towers of a step (B 1536, 512, 512) at dropout 0.2"},
        {"name": "encoder_bwd", "route": "cuda",
         "source": "c2dsr_tpu_torch/csrc/encoder_bwd.cu",
         "replaces": "c2dsr_tpu/ops/encoder_pallas.py:477",
         **counts("encoder_bwd"), **k3,
         "note": "the three towers of a step (B 1536, 512, 512), L 15, "
                 "d 128, dropout 0.2; library: nn.TransformerEncoder "
                 "forward + backward in train mode"},
        {"name": "ce_fwd", "route": "cuda",
         "source": "c2dsr_tpu_torch/csrc/ce.cu",
         "replaces": "c2dsr_tpu/ops/fused_ce.py:263",
         **counts("ce_fwd"), **k4,
         "note": "both domains of a step: N 10240, d 128, V 30720 + 36864"},
        {"name": "ce_bwd", "route": "cuda",
         "source": "c2dsr_tpu_torch/csrc/ce.cu",
         "replaces": "c2dsr_tpu/ops/fused_ce.py:308",
         **counts("ce_bwd"), **k5,
         "note": "dh and dW/db kernels, both domains of a step; also "
                 "replaces fused_ce.py:339 and :360; bound counts "
                 "4*N*V*d FLOPs"},
    ]
    log(f"train path: {train_rate:.1f} train examples/s (warm mean, "
        f"kernels); experiment path: {exp_rates['batch_sparse']:.1f} "
        f"batch-sparse, {exp_rates['dense']:.1f} dense")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
