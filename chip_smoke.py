#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and is right on an NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare OTHER   # train and serving measures
                                            # against OTHER/'s
                                            # c2dsr_tpu_torch, in turns

Needs one CUDA card, ``nvcc`` and the ``c2dsr_tpu_torch`` package beside
this file; it builds the CUDA kernels from ``c2dsr_tpu_torch/csrc`` itself.
Phases (any failure exits non-zero without the final line):

1. setup: build the kernels, print the build time and the card; the CUDA
   dropout hash must equal ops/dropout.bits_reference.
2. kernels: hold each kernel against its plain PyTorch version on the card
   at the main paths' shapes, and time kernel, plain version and one
   PyTorch library call (a yardstick the port never calls): the SpMM over A
   and over Aᵀ, the encoder forward in eval and in train mode (saving the
   activations the backward reads; its kernel launches a tower call and
   its GEMM, attention and LayerNorm parts profiled) and its backward (at
   dropout 0 and 0.2; K3 against the plain version at K2's branches,
   and bitwise against a second launch, with its kernel launches a tower
   call and its backward and weight-gradient parts profiled), the CE
   forward and backward (both also bitwise against a second launch, their
   kernels timed apart, with the FP32 FFMA and the 3xTF32 tensor-core
   bounds).  Then the wider shapes: K2 and K3 at d 32, 40, 96, 160, 256
   and 512 and at L up to 64, K4 and K5 at d 256 and 40.
3. serving path: the ranking path at Food-Kitchen geometry with the
   default Config and random seeded weights: convolve once, then rank the
   eval split in sampled and in full mode.  Every serving kernel must
   launch there; the ranks must equal those of the same run with the plain
   versions, except at counted near-ties (a band from the plain versions'
   own score error against float64, near_ties), and every metric must be
   finite; the kernels' scores must lie within SCORE_K times the plain
   versions' error of the float64 ones; a tower perturbed by PERTURB must
   fail both gates.  Then the same once at ``d_latent=512`` against one
   plain run.
4. training path: train_step at Food-Kitchen geometry with the default
   Config (batch 512, dropout 0.2) on the synthetic train split: the loss
   must stay finite and fall, every kernel must launch its expected count a
   step, and one step at dropout 0 must give the plain versions' loss and
   gradients (the plain versions taken at K2's branches, k2_branches;
   the comparison at their own branches is logged); then train examples/s
   in turns with the plain versions, and one profiled step.  Then four
   steps at dropout 0, three with ``d_latent=256`` (the third at
   ``len_max=30``) and one at ``len_max=64``, each first held against the
   plain versions (loss and gradients).
5. experiment path: ``train.loop.Experiment`` at Food-Kitchen geometry
   with ``Config(batch_sparse_gnn=True, n_epoch=2)``, checkpointing to a
   temporary directory: finite losses and metrics, the batch-sparse SpMM
   (K6) on every hop of every step and the dense one (K1) in every eval
   convolve, the checkpoint written and a resumed run finished; at dropout
   0.2 a run resumed from a checkpoint takes the uninterrupted run's next
   step; one step at dropout 0 with the flags on and off gives the same
   loss and gradients; warm train examples/s with the flags on and off,
   in turns.
6. CLI: ``python -m c2dsr_tpu_torch.cli --synthetic 2000 --n_epoch 1``,
   and again with ``--d_latent 40``, each in a temporary directory, exits
   0 and prints the final result table.
7. parallel: the mesh of ``c2dsr_tpu_torch/parallel/`` with its ranks
   sharing the one card over gloo, each a process (2 ranks 1x2 with the
   psum lookups, 4 ranks 2x2 with the a2a lookups) at FK geometry and the
   default Config: one step at dropout 0 whose loss (1e-5 relative) and
   gathered gradients (GRAD_TOL) are the one-process kernel step's, while
   the same gradients with the sharded ones scaled by M fail; each rank's
   K1 (over the all-to-all plan's CSRs), K2/K3 (at dropout 0.2 under its
   dropout row map), K4/K5 (at its vocab shard's width) and K7 (a masked
   lookup's gradient) against their plain versions on the sharded path's
   inputs; the mesh's eval ranks equal the one-process kernels' but at
   near-ties; K4/K5 timed at the shard widths (one process alone); and
   ``python -m c2dsr_tpu_torch.cli --mesh_model 2`` for an epoch with a
   checkpoint, resumed on one process.
8. summary: one JSON line of kernel numbers, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

The kernel phase also holds K6 against its plain version and against K1
over A and Aᵀ, with the row flags of one real training batch, and records
the share of each graph's edges that such a batch keeps; K1 is also held
bitwise against a second launch, with its launches a call.  The
determinism phase holds K7 bitwise against CPU ``index_add_`` on the six
calls of one FK step's backward, recorded as the step makes them, and
times each beside ``index_add_`` with atomics and under
``torch.use_deterministic_algorithms`` (the library yardstick), with its
launches a call and the larger of its byte and order bounds.
"""

from __future__ import annotations

import contextlib
import inspect
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
ENCODER_REL_TOL = 2e-5   # K2 against its plain version, max abs err over
                         # max |plain| on query rows that have an allowed
                         # key: f32-accurate products (3xTF32) and sums in
                         # another order
PERTURB = 1e-4           # noise on each tower's final LN bias: a tower this
                         # wrong must fail the serving gates
WARM_ROUNDS = 10         # rounds of (plain, kernel, kernel, plain) warm runs
GRAD_TOL = 1e-4          # max abs err over max |plain|, per gradient tensor:
                         # f32 sums over thousands of rows in another order
CE_TOL = 1e-5            # lse / target logit, relative to max |plain|
CE_BWD_TOL = 2e-5        # K5's dh, dW, db, relative to max |plain|: 3xTF32
                         # products are f32-accurate (one-pass TF32: ~1e-3)
TRAIN_STEPS = 30         # train steps whose launches and losses are checked
TRAIN_ROUNDS = 5         # rounds of (plain, kernel, kernel, plain) train runs
TRAIN_RUN_STEPS = 4      # steps per timed train run
CLI_USERS = 2000         # synthetic users of the CLI phase
SERVE_RUNS = 8           # timed serving runs of each --rates process
BUSY_ROUNDS = 16         # rounds of (K7, index_add_, index_add_, K7)
                         # profiled steps (_k7_step_cost)
LOOKUPS = 6              # K7 launches a train step: the propagated plus the
                         # raw table (one K7, ops/lookup.lookup_add) and the
                         # positions, for each of the three tower inputs
                         # (model/c2dsr.forward_joint)
REPO_DIR = os.path.dirname(os.path.abspath(__file__))


def _load_timing():
    """This checkout's ``c2dsr_tpu_torch/bench/timing.py`` (the timer), loaded
    from its file for ``--rates``, which imports the package of another
    checkout and so must not import this checkout's package."""
    import importlib.util
    path = os.path.join(REPO_DIR, "c2dsr_tpu_torch", "bench", "timing.py")
    spec = importlib.util.spec_from_file_location("c2dsr_bench_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the package's bench/timing.py and bench/gates.py, bound by main() once the
# card and the package are found (--rates: timing alone, by _load_timing)
timing = gates = None


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def _k3_against_plain(x, seq, gout, p, acts, n_head, n_layers, kw, got):
    """K3's (dx, grads) ``got`` against encoder_bwd_plain: ({tensor: max
    abs error over max |plain|} at K2's branches, the same against the
    plain forward's own branches, the max abs error of the former)."""
    from c2dsr_tpu_torch.ops import encoder as enc
    matched = enc.encoder_bwd_plain(
        x, seq, gout, p, branches=gates.k2_branches(
            acts, x.shape, n_head, n_layers, kw["tower"]), **kw)
    own = enc.encoder_bwd_plain(x, seq, gout, p, **kw)
    names = ("dx",) + enc._NAMES + ("lnf_scale", "lnf_bias")
    rels, rels_own, abs_err = {}, {}, 0.0
    for name, g, m, o in zip(names, [got[0]] + list(got[1]),
                             [matched[0]] + list(matched[1]),
                             [own[0]] + list(own[1])):
        rels[name] = _rel(g, m)
        rels_own[name] = _rel(g, o)
        abs_err = max(abs_err, float((g - m).abs().max()))
    return rels, rels_own, abs_err


def kernel_wrappers():
    """{name: wrapper} of every kernel the main paths launch."""
    from c2dsr_tpu_torch.bench import ce_variants
    from c2dsr_tpu_torch.ops import (encoder_cuda, fused_ce_cuda, segsum_cuda,
                                     spmm_cuda)
    return {"spmm_csr": spmm_cuda.spmm_csr,
            "spmm_csr_flagged": spmm_cuda.spmm_csr_flagged,
            "encoder_fwd": encoder_cuda.encoder_fwd,
            "encoder_bwd": encoder_cuda.encoder_bwd,
            "ce_fwd": fused_ce_cuda.ce_fwd, "ce_bwd": fused_ce_cuda.ce_bwd,
            "segsum": segsum_cuda.segsum,
            "ce_fwd_variant": ce_variants.ce_fwd_variant}


def reset_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0
    kernel_wrappers()["ce_fwd_variant"].by_variant.clear()


def read_launches():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def phase_spmm(graphs, timer, peak_flops, peak_bw, transpose=False):
    """K1 over A (a hop's forward) or over Aᵀ (its backward, on a table
    gradient), for one hop over each graph."""
    from c2dsr_tpu_torch.ops import spmm, spmm_cuda
    gen = torch.Generator(device="cuda").manual_seed(1)
    n_rows = 65536                     # the padded table (vocab_pad_multiple)
    res = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "by_hop": {}}
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
        check(torch.equal(out, spmm_cuda.spmm_csr(g, h)),
              f"spmm {name}: two launches differ")
        parts, n_launch = timing.kernel_times(lambda: spmm_cuda.spmm_csr(g, h))
        log(f"spmm {name}: d={d} rows={n_rows} nnz={nnz} used_rows="
            f"{used_rows} split rows={g.heavy_rows.numel()} tasks="
            f"{g.tasks.shape[0]} err={err:.3e} (scale {scale:.3f}) kernel "
            f"{ms:.4f} ms ({100 * bound_ms / ms:.1f}% of bound, "
            f"{sum(n_launch.values()):g} launches a call) plain "
            f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB); device ms a call: "
            + ", ".join(f"{k[:44]} {v:.4f}" for k, v in parts.items()))
        res["by_hop"][name] = {"ms": ms, "plain_ms": plain_ms,
                               "library_ms": library_ms,
                               "bound_ms": bound_ms, "max_abs_err": err,
                               "launches_per_call": sum(n_launch.values()),
                               "kernels_ms": parts}
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


def _fwd_errs(out, ref, seq, pad, invert):
    """(max abs err over max |ref| on query rows with an allowed key, max
    abs err on all-masked rows, their count).  An all-masked row's logits
    are -1e9 + x, rounded to steps of 64, so two summation orders may round
    one logit apart there: such rows are counted apart."""
    key_ok = (seq == pad) if invert else (seq != pad)
    masked = ~(key_ok.long().cumsum(1) > 0)            # [B, L]
    diff = (out - ref).abs().amax(-1)
    scale = max(float(ref.abs().max()), 1e-30)
    live = float(diff[~masked].max()) if bool((~masked).any()) else 0.0
    dead = float(diff[masked].max()) if bool(masked.any()) else 0.0
    return live / scale, dead, int(masked.sum())


def phase_encoder(timer, peak_flops, peak_bw, gpu):
    from c2dsr_tpu_torch.bench import kernel_bench
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import encoder_cuda
    B, d, pad = 2048, 128, 64093
    worst = worst_rel = 0.0
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
                    rel, dead, n_dead = _fwd_errs(out, ref, seq, pad, invert)
                    tag = (f"encoder L={L} n_head={n_head} n_attn={n_layers} "
                           f"invert={invert}")
                    log(f"{tag}: max abs err {err:.3e}; relative "
                        f"{rel:.3e} on rows with an allowed key, abs "
                        f"{dead:.3e} on {n_dead} all-masked rows")
                    check(err <= ENCODER_TOL,
                          f"{tag}: max abs err {err} > {ENCODER_TOL}")
                    check(rel <= ENCODER_REL_TOL, f"{tag}: relative err "
                          f"{rel} > {ENCODER_REL_TOL}")
                    worst = max(worst, err)
                    worst_rel = max(worst_rel, rel)
    # time at the main path's shape: L 15, one head, one layer, correct mask
    L, n_head, n_layers = LEN_MAX, 1, 1
    cfg = Config(d_latent=d, n_head=n_head, n_attn=n_layers)
    p = params_mod._map(lambda t: t.cuda(), params_mod.init_encoder_params(
        torch.Generator().manual_seed(7), cfg, L))
    x, seq = _encoder_inputs(B, L, d, pad, seed=7)
    kw = dict(idx_pad=pad, n_head=n_head, invert_padding_mask=False)
    tower = kernel_bench.torch_tower(p, d, n_head, n_layers)
    causal = torch.triu(torch.ones(L, L, dtype=torch.bool, device="cuda"), 1)
    kpm = seq == pad
    with torch.inference_mode():
        ms = timer(lambda: encoder_cuda.encoder_fwd(x, seq, p, **kw))
        plain_ms = timer(lambda: enc.encode_layers(x, seq, p, norm_first=False,
                                                   **kw))
        library_ms = timer(lambda: tower(x, mask=causal,
                                         src_key_padding_mask=kpm))
        times, counts = timing.kernel_times(
            lambda: encoder_cuda.encoder_fwd(x, seq, p, **kw))
    parts = _k2_parts(times)
    n_launch = int(round(sum(counts.values())))
    N = B * L
    flops = n_layers * (12 * N * d * d + 4 * N * L * d)
    nbytes = 4 * (2 * N * d + N + n_layers * (6 * d * d + 10 * d) + 2 * d)
    bound_ffma = max(flops / peak_flops, nbytes / peak_bw) * 1e3
    bound_tc = timing.tc_bound_ms(flops, nbytes, gpu, peak_bw)
    log(f"encoder B={B} L={L} d={d}: kernel {ms:.4f} ms plain {plain_ms:.4f} "
        f"ms library {library_ms:.4f} ms bound 3xTF32 tensor cores "
        f"{bound_tc:.4f} ms, FP32 FFMA {bound_ffma:.4f} ms ({flops / 1e9:.3f} "
        f"GFLOP, {flops / ms / 1e9:.2f} TFLOP/s); {n_launch} kernel launches "
        "a tower call; profiled device ms a call: "
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + "; all: " + ", ".join(f"{k} {v:.4f} x{counts[k]:g}"
                                for k, v in sorted(times.items())))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_tc, "bound_ffma_ms": bound_ffma,
            "max_abs_err": worst, "max_rel_err": worst_rel,
            "launches_per_call": n_launch,
            "kernels_ms": parts,
            "bound_by": "operations" if 3 * flops / timing.tf32_peak(gpu)
            > nbytes / peak_bw else "bytes"}


# the CUDA kernels of each wrapper, by name (first match wins): K2 and K3
# are sequences of kernels, and K4 and K5 share the transpose pre-pass
KERNEL_FAMILIES = (
    ("K1/K6 spmm", ("spmm",)),
    ("K2 encoder_fwd", ("encoder_fwd_",)),
    ("K3 encoder_bwd", ("tc_gemm_kernel", "attn_bwd_kernel",
                        "ln_bwd_kernel", "wgrad_kernel",
                        "sum_partials_kernel")),
    ("K4/K5 pre-pass", ("transpose_split_kernel",)),
    ("K4 ce_fwd", ("ce_fwd_kernel", "ce_fwd_merge_kernel")),
    ("K5 ce_bwd", ("ce_bwd_kernel", "ce_merge_kernel", "split_kernel")),
    ("K7 segsum", ("segsum_",)),
)


def kernel_family(name: str):
    for family, parts in KERNEL_FAMILIES:
        if any(part in name for part in parts):
            return family
    return None


def profile_main_path(run_all, label="profile"):
    """Where a main path's time goes: one warm run under torch.profiler;
    device time by kernel and by kernel family (KERNEL_FAMILIES), and the
    device's idle share of the run's wall time."""
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
    fam = {}
    for dev_us, count, key in rows:
        f = kernel_family(key)
        if f:
            us, n = fam.get(f, (0.0, 0))
            fam[f] = (us + dev_us, n + count)
    log(f"{label}: by kernel: " + "; ".join(
        f"{f} {us / 1e3:.3f} ms ({us / busy_us:.1%}, {n} launches)"
        for f, (us, n) in sorted(fam.items(), key=lambda kv: -kv[1][0])))


def phase_main(spec, graphs_host, data, cfg=None, label="main path"):
    """The serving path: convolve once, rank the eval split in sampled and
    full mode; launches, finite metrics, ranks against the plain versions'
    run.  At the default Config also warm rates in turns and a profile;
    with another ``cfg`` one kernel run and one plain run."""
    from c2dsr_tpu_torch import metrics
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import spmm

    warm = cfg is None
    cfg = cfg or Config()
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
    log(f"{label}: d_latent {cfg.d_latent}, {n_ex} eval examples, {steps} "
        f"rank steps per mode, launches {launches}")
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
        log(f"{label} {mode}: {n_ex / secs[mode]:.1f} eval examples/s "
            f"({secs[mode]:.3f} s), improvement {score[0]:.4f}, hr5_a "
            f"{score[1]:.4f} hr5_b {score[7]:.4f}")
    log(f"{label} convolve: {t_conv * 1e3:.2f} ms (first run)")
    if not warm:
        with gates.plain_versions():
            hi_plain, ranks_plain, _, _ = run_all()
        _check_ranks(params, hi, hi_plain,
                     gates.convolve_float64(params, graphs, cfg, spec), data,
                     cfg, spec, ranks, ranks_plain, n_ex, label)
        return launches

    # warm timings in turns on the same card, (plain, kernel, kernel, plain)
    # repeated, so drift falls on both alike; the gap between the two counts
    # as resolved only beyond 3 standard errors of the difference of means
    runs = {"kernel": [], "plain": []}
    ranks_plain = None
    for which in ("plain", "kernel", "kernel", "plain") * WARM_ROUNDS:
        ctx = (gates.plain_versions() if which == "plain"
               else contextlib.nullcontext())
        with ctx:
            h, r, t_c, s_m = run_all()
        if which == "plain" and ranks_plain is None:
            hi_plain, ranks_plain = h, r
        runs[which].append((t_c, s_m))
    stats = {}
    for which, rs in runs.items():
        conv_ms = np.array([t for t, _ in rs]) * 1e3
        log(f"{label} warm ({which}, {len(rs)} runs): convolve mean "
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
    params_q = _perturbed_towers(params)
    ranks_q = {mode: ranker.evaluate_split(params_q, hi, data, rank_step,
                                           cfg, mode)
               for mode in ("sampled", "full")}
    _check_ranks(params, hi, hi_plain,
                 gates.convolve_float64(params, graphs, cfg, spec), data, cfg,
                 spec, ranks, ranks_plain, n_ex, label,
                 perturbed=(params_q, ranks_q))
    return launches


def _perturbed_towers(params):
    """``params`` with PERTURB times a seeded normal draw added to each
    tower's final LayerNorm bias."""
    g = torch.Generator(device="cuda").manual_seed(7)
    out = dict(params)
    for name in ("attn_share", "attn_a", "attn_b"):
        tower = dict(params[name])
        tower["lnf_bias"] = tower["lnf_bias"] + PERTURB * torch.randn(
            tower["lnf_bias"].shape, generator=g, device="cuda")
        out[name] = tower
    return out


def _check_ranks(params, hi, hi_plain, hi64, data, cfg, spec, ranks,
                 ranks_plain, n_ex, label, perturbed=None):
    """bench/gates.check_ranks in each mode, logged: the kernels' ranks
    equal the plain versions' except at near-ties and all-masked rows, both
    counted, and the kernels' scores lie within SCORE_K times the plain
    versions' error of the float64 ones.  With ``perturbed`` = (params,
    ranks) of a kernel run with perturbed towers, that run must fail both
    gates."""
    from c2dsr_tpu_torch.evaluate import ranker
    groups = ranker.partition_by_domain(data)
    for mode in ("sampled", "full"):
        try:
            st = gates.check_ranks(params, hi, hi_plain, hi64, data, cfg,
                                   spec, mode, ranks[mode], ranks_plain[mode])
        except timing.GateFailure as e:
            raise SmokeFailure(f"{label} {e}")
        log(f"{label} ranks {mode}: {st['differ']} of {n_ex} differ from "
            f"the plain run; {st['tied']} examples have a near-tie (plain "
            f"scores within the example's band, at most {st['band']:.3e}); "
            f"{st['masked']} differences at all-masked rows; "
            f"{st['unexplained']} differences not explained by either; "
            f"largest score error against float64: kernels "
            f"{st['err_kernels']:.3e}, plain {st['err_plain']:.3e} (limit "
            f"{gates.SCORE_K:g}x)")
        if perturbed is None:
            continue
        ties, _, _, _ = gates.near_ties(params, hi, hi_plain, hi64, data, cfg,
                                        spec, mode)
        _, _, err_q, _ = gates.near_ties(params, hi, hi_plain, hi64, data,
                                         cfg, spec, mode,
                                         params_k=perturbed[0])
        _, _, n_q = gates.rank_differences(perturbed[1][mode],
                                           ranks_plain[mode], ties, groups)
        log(f"{label} ranks {mode}, towers' final LN bias perturbed by "
            f"{PERTURB:g}: {n_q} differences not explained, score error "
            f"against float64 {err_q:.3e}")
        check(n_q > 0 and err_q > gates.SCORE_K * st["err_plain"],
              f"{label} {mode}: a perturbed tower passes the serving gates")


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


def _k2_parts(times):
    """K2's profiled device ms a call, by part: the four GEMMs of a layer
    (with their epilogues), attention, the LayerNorm kernel (d > 256) and
    the input kernel (dropout, or the saved copy of the input)."""
    out = {"gemm": 0.0, "attention": 0.0, "layernorm": 0.0, "input": 0.0}
    for name, ms in times.items():
        for part, key in (("gemm", "encoder_fwd_gemm"),
                          ("attention", "encoder_fwd_attn"),
                          ("layernorm", "encoder_fwd_ln"),
                          ("input", "encoder_fwd_input")):
            if key in name:
                out[part] += ms
    return out


def _k3_parts(times):
    """K3's profiled device ms a call, by part: the backward walk
    (LayerNorm backward, the GEMMs, attention backward) and the weight
    gradients (the row-split kernel and the ordered merge)."""
    out = {"backward": 0.0, "weight_grads": 0.0}
    for name, ms in times.items():
        part = ("weight_grads" if "wgrad" in name or "sum_partials" in name
                else "backward")
        out[part] += ms
    return out


def phase_encoder_train(timer, peak_flops, peak_bw, gpu):
    """K2 in train mode and K3 at the three tower segments of a train step
    (shared 3B, A B, B B at B = 512), dropout 0 and 0.2, against the plain
    tower and its autograd, K3 also against a second launch (bitwise);
    timed at 0.2 and summed over the segments.  ``bound_ms`` is the 3xTF32
    tensor-core bound of each, ``bound_ffma_ms`` the FP32 FFMA one; K2's
    bytes count the activations it saves, an output of the training
    forward."""
    from c2dsr_tpu_torch.bench import kernel_bench
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import encoder_cuda
    d, L, pad, B = 128, LEN_MAX, 64093, 512
    cfg = Config()
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_ffma_ms")
    fwd = dict.fromkeys(keys, 0.0)
    bwd = dict.fromkeys(keys, 0.0)
    fwd["max_abs_err"] = bwd["max_abs_err"] = bwd["max_rel_err"] = 0.0
    f_parts = fwd["kernels_ms"] = {}
    f_launches = fwd["launches_per_call"] = {}
    parts = bwd["kernels_ms"] = {}
    launches = bwd["launches_per_call"] = {}
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
            acts = encoder_cuda.saved_buffer(x, 1, 1)
            with torch.no_grad():
                out = encoder_cuda.encoder_fwd(x, seq, p, saved=acts, **kw)
                ref = enc.encoder_fwd_plain(x, seq, p, **kw)
            dx, grads = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts,
                                                 **kw)
            dx2, grads2 = encoder_cuda.encoder_bwd(x, seq, gout, p,
                                                   saved=acts, **kw)
            rels, rels_own, abs_err = _k3_against_plain(
                x, seq, gout, p, acts, 1, 1, kw, (dx, grads))
            torch.cuda.synchronize()
            err_f = float((out - ref).abs().max())
            check(bool(torch.isfinite(out).all() and torch.isfinite(dx).all()),
                  f"encoder train tower {tower_id}: non-finite")
            check(err_f <= ENCODER_TOL, f"encoder_fwd train tower {tower_id} "
                  f"p={dropout}: max abs err {err_f} > {ENCODER_TOL}")
            check(torch.equal(dx, dx2) and all(
                torch.equal(g, g2) for g, g2 in zip(grads, grads2)),
                f"encoder_bwd tower {tower_id} p={dropout}: two launches "
                "differ")
            worst = max(rels, key=rels.get)
            worst_own = max(rels_own, key=rels_own.get)
            log(f"encoder train tower {tower_id} B={n_seq} p={dropout}: "
                f"fwd max abs err {err_f:.3e}; bwd max abs err {abs_err:.3e},"
                f" worst relative {rels[worst]:.3e} ({worst}) at K2's ReLU "
                f"branches, {rels_own[worst_own]:.3e} ({worst_own}) at the "
                "plain forward's; two backward launches bitwise equal")
            bwd["max_rel_err_own_branches"] = max(
                bwd.get("max_rel_err_own_branches", 0.0), rels_own[worst_own])
            check(rels[worst] <= GRAD_TOL, f"encoder_bwd tower {tower_id} "
                  f"p={dropout}: {worst} relative err {rels[worst]} > "
                  f"{GRAD_TOL}")
            fwd["max_abs_err"] = max(fwd["max_abs_err"], err_f)
            bwd["max_abs_err"] = max(bwd["max_abs_err"], abs_err)
            bwd["max_rel_err"] = max(bwd["max_rel_err"], rels[worst])
        # times at the training rate, dropout 0.2
        tower = kernel_bench.torch_tower(p, d, 1, 1, dropout=kw["dropout"])
        kpm = seq == pad
        xg = x.clone().requires_grad_(True)
        lib_params = [xg] + list(tower.parameters())
        # K2 as a train step runs it, saving the activations K3 reads
        with torch.no_grad():
            f_ms = timer(lambda: encoder_cuda.encoder_fwd(x, seq, p,
                                                          saved=acts, **kw))
            f_nosave = timer(lambda: encoder_cuda.encoder_fwd(x, seq, p,
                                                              **kw))
            f_plain = timer(lambda: enc.encoder_fwd_plain(x, seq, p, **kw))
            f_lib = timer(lambda: tower(x, mask=causal,
                                        src_key_padding_mask=kpm))
        b_ms = timer(lambda: encoder_cuda.encoder_bwd(x, seq, gout, p,
                                                      saved=acts, **kw))
        b_plain = timer(lambda: enc.encoder_bwd_plain(x, seq, gout, p, **kw))
        b_lib = timer(lambda: torch.autograd.grad(
            tower(xg, mask=causal, src_key_padding_mask=kpm), lib_params,
            gout))
        with torch.no_grad():
            f_times, f_counts = timing.kernel_times(
                lambda: encoder_cuda.encoder_fwd(x, seq, p, saved=acts, **kw))
        times, counts = timing.kernel_times(
            lambda: encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts,
                                             **kw))
        fwd["ms_without_saving"] = fwd.get("ms_without_saving", 0.0) + f_nosave
        f_launches[f"tower {tower_id}"] = int(round(sum(f_counts.values())))
        for k, v in _k2_parts(f_times).items():
            f_parts[k] = f_parts.get(k, 0.0) + v
        n_launch = int(round(sum(counts.values())))
        launches[f"tower {tower_id}"] = n_launch
        k3 = _k3_parts(times)
        for k, v in k3.items():
            parts[k] = parts.get(k, 0.0) + v
        N = n_seq * L
        w_bytes = 4 * (6 * d * d + 10 * d + 2 * d)
        f_flops = 12 * N * d * d + 4 * N * L * d
        b_flops = 24 * N * d * d + 8 * N * L * d
        f_bytes = 8 * N * d + 4 * N + w_bytes + 4 * acts.numel()
        b_bytes = 12 * N * d + 4 * N + 2 * w_bytes
        f_bound = max(f_flops / peak_flops, f_bytes / peak_bw) * 1e3
        b_bound = max(b_flops / peak_flops, b_bytes / peak_bw) * 1e3
        f_tc = timing.tc_bound_ms(f_flops, f_bytes, gpu, peak_bw)
        b_tc = timing.tc_bound_ms(b_flops, b_bytes, gpu, peak_bw)
        fwd["bound_by"] = ("operations" if 3 * f_flops / timing.tf32_peak(gpu)
                           >= f_bytes / peak_bw else "bytes")
        bwd["bound_by"] = ("operations" if 3 * b_flops / timing.tf32_peak(gpu)
                           >= b_bytes / peak_bw else "bytes")
        log(f"encoder train tower {tower_id} B={n_seq}: fwd kernel {f_ms:.4f} "
            f"ms saving the activations ({f_nosave:.4f} without) plain "
            f"{f_plain:.4f} library {f_lib:.4f} bound 3xTF32 {f_tc:.4f} "
            f"(FFMA {f_bound:.4f}; bytes with the saved activations "
            f"{f_bytes / 1e6:.1f} MB), "
            f"{f_launches[f'tower {tower_id}']} launches a call, parts "
            + ", ".join(f"{k} {v:.4f}" for k, v in
                        _k2_parts(f_times).items())
            + f"; bwd kernel {b_ms:.4f} ms "
            f"plain {b_plain:.4f} library {b_lib:.4f} (forward + backward) "
            f"bound 3xTF32 tensor cores {b_tc:.4f}, FP32 FFMA {b_bound:.4f} "
            f"({b_flops / b_ms / 1e9:.2f} TFLOP/s); {n_launch} kernel "
            "launches a tower call; profiled device ms a call: "
            + ", ".join(f"{k} {v:.4f}" for k, v in k3.items())
            + "; all: " + ", ".join(f"{k} {v:.4f} x{counts[k]:g}"
                                    for k, v in sorted(times.items())))
        for acc, vals in ((fwd, (f_ms, f_plain, f_lib, f_tc, f_bound)),
                          (bwd, (b_ms, b_plain, b_lib, b_tc, b_bound))):
            for k, v in zip(keys, vals):
                acc[k] += v
    return fwd, bwd


def _ce_inputs(N, d, V, n_real, seed):
    """One domain's CE inputs at FK scales: h ~ N(0, 1), W ~ 0.05 N(0, 1)
    (zero on the padded vocab tail), every 5th row ignored (target n_real),
    dlse and dt ~ N(0, 1) / N on the other rows."""
    rng = np.random.default_rng(seed)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    from c2dsr_tpu_torch.ops import fused_ce
    h = put(rng.normal(size=(N, d)))
    w_np = rng.normal(size=(d, V)) * 0.05
    w_np[:, n_real:] = 0.0
    w = put(w_np)
    bm = fused_ce.mask_bias(put(rng.normal(size=V) * 0.1), n_real)
    pad_l = put(rng.normal(size=N))
    tgt_np = rng.integers(0, n_real, size=N)
    tgt_np[::5] = n_real                                 # ignored rows
    tgt = torch.from_numpy(tgt_np).cuda()
    real = tgt != n_real
    dlse = put(rng.normal(size=N) / N) * real
    dt = put(rng.normal(size=N) / N) * real
    return h, w, bm, pad_l, tgt, real, dlse, dt


def _check_ce_bwd(tag, got, want, again, n_real):
    """K5 against its plain version (CE_BWD_TOL) and against a second
    launch (bitwise); returns {dh, dw, db: relative error}."""
    rels = {n: _rel(g, r) for n, g, r in zip(("dh", "dw", "db"), got, want)}
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"ce_bwd {tag}: non-finite")
    check(max(rels.values()) <= CE_BWD_TOL, f"ce_bwd {tag}: rel err {rels} "
          f"> {CE_BWD_TOL}")
    check(all(torch.equal(g, g2) for g, g2 in zip(got, again)),
          f"ce_bwd {tag}: two launches differ")
    check(bool((got[2][n_real:] == 0).all()), f"ce_bwd {tag}: db on "
          "padded columns not zero")
    return rels


def phase_ce(timer, peak_flops, peak_bw, gpu):
    """K4 and K5 at a train step's shapes (N = 512 x 2 x len_rec rows, d 128,
    V 30,720 and 36,864), against their plain versions; summed over both
    domains.  Both also against a second launch (bitwise), their kernels
    timed apart under the profiler, with the 3xTF32 tensor-core bound
    (``bound_ms``) and the FP32 FFMA bound (``bound_ffma_ms``)."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    N, d = 512 * 2 * 10, 128
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_ffma_ms")
    fwd = dict.fromkeys(keys, 0.0)
    bwd = dict.fromkeys(keys, 0.0)
    fwd["max_abs_err"] = fwd["max_rel_err"] = 0.0
    bwd["max_abs_err"] = bwd["max_rel_err"] = 0.0
    f_kernel = fwd["kernels_ms"] = {}
    by_kernel = bwd["kernels_ms"] = {}
    for dom, V, n_real in (("A", 30720, N_ITEM_A), ("B", 36864, N_ITEM_B)):
        h, w, bm, pad_l, tgt, real, dlse, dt = _ce_inputs(N, d, V, n_real, V)
        with torch.no_grad():
            lse, tlog = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)
            rlse, rtlog = fused_ce.ce_fwd_plain(h, w, bm, pad_l, tgt)
            lse2, tlog2 = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)
            got = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
            want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt)
            again = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
        torch.cuda.synchronize()
        e_lse = _rel(lse, rlse)
        e_t = _rel(tlog[real], rtlog[real])
        check(max(e_lse, e_t) <= CE_TOL, f"ce_fwd {dom}: rel err "
              f"{max(e_lse, e_t)} > {CE_TOL}")
        check(torch.equal(lse, lse2) and torch.equal(tlog, tlog2),
              f"ce_fwd {dom}: two launches differ")
        rels = _check_ce_bwd(dom, got, want, again, n_real)
        log(f"ce {dom}: N={N} d={d} V={V}: lse rel err {e_lse:.3e}, target "
            f"logit rel err {e_t:.3e}, two forward launches bitwise equal; "
            "backward rel err "
            + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
            + "; two backward launches bitwise equal")
        fwd["max_abs_err"] = max(fwd["max_abs_err"],
                                 float((lse - rlse).abs().max()))
        fwd["max_rel_err"] = max(fwd["max_rel_err"], e_lse, e_t)
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
        # K4's parts, device ms a call: its kernel, the pre-pass (Wᵀ's
        # TF32 split) and the split merge
        sub = timing.kernel_times(lambda: fused_ce_cuda.ce_fwd(h, w, bm, pad_l,
                                                        tgt))[0]
        f_parts = {"kernel": sum(v for k, v in sub.items()
                                 if "ce_fwd_kernel" in k),
                   "prepass": sub.get("transpose_split_kernel", 0.0),
                   "merge": sub.get("ce_fwd_merge_kernel", 0.0)}
        f_flops = 2 * N * V * d
        log(f"ce {dom}: fwd device time a call under the profiler: kernel "
            f"{f_parts['kernel']:.4f} ms "
            f"({f_flops / f_parts['kernel'] / 1e9:.2f} TFLOP/s of "
            "f32-accurate work, 3x that in TF32), pre-pass "
            f"{f_parts['prepass']:.4f} ms, merge {f_parts['merge']:.4f} ms")
        for k, v in f_parts.items():
            f_kernel[k] = f_kernel.get(k, 0.0) + v
        sub = timing.kernel_times(lambda: fused_ce_cuda.ce_bwd(
            h, w, bm, lse, dlse, dt, tgt))[0]
        # K5's parts, device ms a call: dh kernel, dW/db kernel, the
        # pre-pass (Wᵀ and the TF32 splits of Wᵀ and h), the split merges
        parts = {"dh": sum(v for k, v in sub.items()
                           if "ce_bwd_kernel" in k and "true>" in k),
                 "dw": sum(v for k, v in sub.items()
                           if "ce_bwd_kernel" in k and "false>" in k),
                 "prepass": sub.get("transpose_split_kernel", 0.0)
                 + sub.get("split_kernel", 0.0),
                 "merge": sub.get("ce_merge_kernel", 0.0)}
        flops = 4 * N * V * d               # f32-accurate work of each kernel
        log(f"ce {dom}: bwd device time a call under the profiler: dh "
            f"kernel {parts['dh']:.4f} ms ({flops / parts['dh'] / 1e9:.2f} "
            f"TFLOP/s), dW/db kernel {parts['dw']:.4f} ms ("
            f"{flops / parts['dw'] / 1e9:.2f} TFLOP/s), pre-pass "
            f"{parts['prepass']:.4f} ms, merges {parts['merge']:.4f} ms "
            "(TFLOP/s count each kernel's 4·N·V·d: its logits and its "
            "product); all: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in sub.items()))
        for k, v in parts.items():
            by_kernel[k] = by_kernel.get(k, 0.0) + v
        lib_out = torch.logsumexp(torch.cat([hg @ wg + bg, pad_l[:, None]],
                                            1), 1)
        b_lib = timer(lambda: torch.autograd.grad(lib_out, [hg, wg, bg], dlse,
                                                  retain_graph=True))
        del lib_out
        io = 4 * (N * d + d * V + V + 3 * N)
        f_ffma = max(f_flops / peak_flops, (io + 8 * N) / peak_bw) * 1e3
        f_tc = timing.tc_bound_ms(f_flops, io + 8 * N, gpu, peak_bw)
        b_bytes = 2 * io + 4 * N * d
        b_ffma = max(4 * N * V * d / peak_flops, b_bytes / peak_bw) * 1e3
        b_tc = timing.tc_bound_ms(4 * N * V * d, b_bytes, gpu, peak_bw)
        log(f"ce {dom}: fwd kernel {f_ms:.4f} ms plain {f_plain:.4f} library "
            f"{f_lib:.4f} bound 3xTF32 tensor cores {f_tc:.4f}, FP32 FFMA "
            f"{f_ffma:.4f} ({f_flops / f_ms / 1e9:.2f} TFLOP/s); bwd "
            f"kernel {b_ms:.4f} ms plain {b_plain:.4f} library {b_lib:.4f} "
            f"bound 3xTF32 tensor cores {b_tc:.4f}, FP32 FFMA {b_ffma:.4f} "
            f"(bounds count 4·N·V·d FLOPs; "
            f"{4 * N * V * d / b_ms / 1e9:.2f} TFLOP/s of them)")
        for acc, vals in ((fwd, (f_ms, f_plain, f_lib, f_tc, f_ffma)),
                          (bwd, (b_ms, b_plain, b_lib, b_tc, b_ffma))):
            for k, v in zip(keys, vals):
                acc[k] += v
    fwd["bound_by"] = bwd["bound_by"] = "operations"
    log(f"ce both domains: fwd kernel {fwd['ms']:.4f} ms (kernel "
        f"{f_kernel['kernel']:.4f} + pre-pass {f_kernel['prepass']:.4f} + "
        f"merge {f_kernel['merge']:.4f}, profiled) against library "
        f"{fwd['library_ms']:.4f} ms; bounds 3xTF32 {fwd['bound_ms']:.4f}, "
        f"FFMA {fwd['bound_ffma_ms']:.4f}")
    log(f"ce both domains: bwd kernel {bwd['ms']:.4f} ms (dh "
        f"{by_kernel['dh']:.4f} + dW {by_kernel['dw']:.4f} + pre-pass "
        f"{by_kernel['prepass']:.4f} + merges {by_kernel['merge']:.4f}, "
        f"profiled) against library {bwd['library_ms']:.4f} ms; bounds "
        f"3xTF32 {bwd['bound_ms']:.4f}, FFMA {bwd['bound_ffma_ms']:.4f}")
    return fwd, bwd


# tower shapes beyond d 64 and 128 that K2 and K3 take: (d, n_head, L);
# d 512 (two column tiles, K2's LayerNorm kernel) and L past 32 (two keys a
# lane in attention) last
WIDE_TOWERS = ((96, 2, 30), (32, 1, 30), (256, 4, 15), (160, 2, 16),
               (40, 1, 30), (256, 4, 30), (512, 4, 15), (512, 8, 30),
               (128, 2, 64), (256, 4, 64), (96, 2, 48))


def phase_shapes():
    """K2 (eval, both mask polarities, and train) and K3 at WIDE_TOWERS,
    dropout 0 and 0.2, two layers, and K4/K5 at d 256 and 40 (FK's rows and
    domain A's vocab), against their plain versions; K3, K4 and K5 also
    bitwise against a second launch.  Returns the worst errors."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import encoder_cuda, fused_ce, fused_ce_cuda
    pad, B = 64093, 256
    worst = {"encoder_fwd": 0.0, "encoder_fwd_rel": 0.0, "encoder_bwd": 0.0}
    for d, n_head, L in WIDE_TOWERS:
        cfg = Config(d_latent=d, n_head=n_head, n_attn=2)
        p = params_mod._map(lambda t: t.cuda(), params_mod.init_encoder_params(
            torch.Generator().manual_seed(d), cfg, L))
        x, seq = _encoder_inputs(B, L, d, pad, seed=d)
        gout = torch.randn(x.shape, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(d))
        tag = f"d={d} n_head={n_head} L={L}"
        with torch.no_grad():
            kw = dict(idx_pad=pad, n_head=n_head, invert_padding_mask=True)
            out_i = encoder_cuda.encoder_fwd(x, seq, p, **kw)
            ref_i = enc.encode_layers(x, seq, p, norm_first=False, **kw)
            err_i = float((out_i - ref_i).abs().max())
            rel_i = _fwd_errs(out_i, ref_i, seq, pad, True)[0]
        check(err_i <= ENCODER_TOL, f"encoder {tag} inverted: max abs err "
              f"{err_i} > {ENCODER_TOL}")
        check(rel_i <= ENCODER_REL_TOL, f"encoder {tag} inverted: relative "
              f"err {rel_i} > {ENCODER_REL_TOL}")
        for dropout in (0.0, 0.2):
            kw = dict(idx_pad=pad, n_head=n_head, invert_padding_mask=False,
                      dropout=dropout, seed=5, tower=1)
            acts = encoder_cuda.saved_buffer(x, n_head, 2)
            with torch.no_grad():
                out = encoder_cuda.encoder_fwd(x, seq, p, saved=acts, **kw)
                ref = enc.encoder_fwd_plain(x, seq, p, **kw)
                # the eval workspace path: the same arithmetic, bitwise
                same = torch.equal(out, encoder_cuda.encoder_fwd(x, seq, p,
                                                                 **kw))
            dx, grads = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts,
                                                 **kw)
            dx2, grads2 = encoder_cuda.encoder_bwd(x, seq, gout, p,
                                                   saved=acts, **kw)
            rels, rels_own, _ = _k3_against_plain(
                x, seq, gout, p, acts, n_head, 2, kw, (dx, grads))
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all() and torch.isfinite(dx).all()),
                  f"encoder {tag}: non-finite")
            check(same, f"encoder_fwd {tag} p={dropout}: the workspace "
                  "forward differs from the saving one")
            rel_f = _fwd_errs(out, ref, seq, pad, False)[0]
            check(rel_f <= ENCODER_REL_TOL, f"encoder_fwd {tag} p={dropout}: "
                  f"relative err {rel_f} > {ENCODER_REL_TOL}")
            check(torch.equal(dx, dx2) and all(
                torch.equal(g, g2) for g, g2 in zip(grads, grads2)),
                f"encoder_bwd {tag} p={dropout}: two launches differ")
            err_f = float((out - ref).abs().max())
            bad = max(rels, key=rels.get)
            own = max(rels_own, key=rels_own.get)
            log(f"shapes: encoder {tag} p={dropout}: fwd max abs err "
                f"{max(err_f, err_i):.3e}, relative {max(rel_f, rel_i):.3e} "
                "on rows with an allowed key (saving and workspace forwards "
                "bitwise equal); bwd worst relative "
                f"{rels[bad]:.3e} ({bad}) at K2's branches, "
                f"{rels_own[own]:.3e} ({own}) at the plain forward's")
            check(err_f <= ENCODER_TOL, f"encoder_fwd {tag} p={dropout}: max "
                  f"abs err {err_f} > {ENCODER_TOL}")
            check(rels[bad] <= GRAD_TOL, f"encoder_bwd {tag} p={dropout}: "
                  f"{bad} relative err {rels[bad]} > {GRAD_TOL}")
            worst["encoder_fwd"] = max(worst["encoder_fwd"], err_f, err_i)
            worst["encoder_fwd_rel"] = max(worst["encoder_fwd_rel"], rel_f,
                                           rel_i)
            worst["encoder_bwd"] = max(worst["encoder_bwd"], rels[bad])
    worst["ce_fwd"] = worst["ce_bwd"] = 0.0
    N, V, n_real = 512 * 2 * 10, 30720, N_ITEM_A
    for d in (256, 40):
        h, w, bm, pad_l, tgt, real, dlse, dt = _ce_inputs(N, d, V, n_real, d)
        with torch.no_grad():
            lse, tlog = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)
            rlse, rtlog = fused_ce.ce_fwd_plain(h, w, bm, pad_l, tgt)
            lse2, tlog2 = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)
            got = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
            want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt)
            again = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
        torch.cuda.synchronize()
        e_f = max(_rel(lse, rlse), _rel(tlog[real], rtlog[real]))
        check(e_f <= CE_TOL, f"ce_fwd d={d}: rel err {e_f} > {CE_TOL}")
        check(torch.equal(lse, lse2) and torch.equal(tlog, tlog2),
              f"ce_fwd d={d}: two launches differ")
        rels = _check_ce_bwd(f"d={d}", got, want, again, n_real)
        log(f"shapes: ce N={N} d={d} V={V}: fwd rel err {e_f:.3e}; bwd rel "
            "err " + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
            + "; two launches of each bitwise equal")
        worst["ce_fwd"] = max(worst["ce_fwd"], e_f)
        worst["ce_bwd"] = max(worst["ce_bwd"], max(rels.values()))
    return worst


def leaf_names(params, prefix=""):
    """Names of ``train/step.param_leaves(params)``, in its order."""
    if isinstance(params, dict):
        return [n for k in sorted(params)
                for n in leaf_names(params[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def _loss_grads(params, leaves, graphs, batch, cfg, spec, ctx):
    """(loss, gradient of every leaf) of one batch without dropout."""
    from c2dsr_tpu_torch.train import step as step_mod
    for t in leaves:
        t.grad = None
    with ctx:
        loss, _ = step_mod.loss_fn(params, graphs, batch, None, cfg, spec)
        loss.backward()
    out = float(loss), [t.grad.clone() for t in leaves]
    for t in leaves:
        t.grad = None
    return out


def _fro(got, want):
    """Per tensor, ||got - want|| / ||want|| (Frobenius; want on any
    device); the largest over the tensors, and that tensor's index."""
    errs = [float((a - b.to(a.device)).norm())
            / max(float(b.norm()), 1e-30) for a, b in zip(got, want)]
    return max(errs), int(np.argmax(errs))


def _tower_accuracy(calls):
    """The tower calls of a train step (captured: input, sequence, output
    gradient, params, K2's saved activations, K3's result) against the
    plain tower in float64 at K2's branches: {"qkv": {k2, plain}, "dx" and
    "w_qkv": {k3, plain}} relative Frobenius errors, worst over the calls,
    for K2's saved q/k/v, K3's gradients and the plain f32 tower's.  A
    softmax that is partly sharp passes the absolute error of its logits
    (so of q and k) on to a row's gradient: this is the error the step's
    gradient gate sees."""
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import encoder_cuda

    def rel(a, r):
        a = a.to(r.device, r.dtype)
        return float((a - r).norm()) / max(float(r.norm()), 1e-300)

    out = {"qkv": {"k2": 0.0, "plain": 0.0}, "dx": {"k3": 0.0, "plain": 0.0},
           "w_qkv": {"k3": 0.0, "plain": 0.0}}
    for c in calls:
        x, seq, gout, p, kw = c["x"], c["seq"], c["gout"], c["p"], c["kw"]
        n_head, n_layers = kw["n_head"], p["layers"]["w_qkv"].shape[0]
        br = gates.k2_branches(c["saved"], x.shape, n_head, n_layers,
                               kw["tower"])
        p64 = params_mod._map(lambda t: t.double(), p)
        w0 = p["layers"]["w_qkv"][0]
        qkv64 = x.double() @ p64["layers"]["w_qkv"][0] + p64["layers"]["b_qkv"][0]
        qkv32 = x @ w0 + p["layers"]["b_qkv"][0]
        qkv_k2 = encoder_cuda.saved_views(c["saved"], x.shape, n_head,
                                          n_layers)["layers"][0]["qkv"]
        g64 = enc.encoder_bwd_plain(x.double(), seq, gout.double(), p64,
                                    branches=br, **kw)
        g32 = enc.encoder_bwd_plain(x, seq, gout, p, branches=br, **kw)
        got = c["got"]
        for key, ours, plain, ref in (
                ("qkv", qkv_k2, qkv32, qkv64),
                ("dx", got[0], g32[0], g64[0]),
                ("w_qkv", got[1][0], g32[1][0], g64[1][0])):
            mine = "k2" if key == "qkv" else "k3"
            out[key][mine] = max(out[key][mine], rel(ours, ref))
            out[key]["plain"] = max(out[key]["plain"], rel(plain, ref))
    return out


def phase_train_wide(spec, train, graphs, graphs_host):
    """The training step at FK's itemsets and graphs beyond the default
    shapes, dropout 0: with d_latent 256 (the towers' widest fused-LN
    tiles, K4 and K5 at d 256, K1 at d 256 and 512) at FK's len_max 15 for
    two steps and at EE's 30 for one, then at d 128 with len_max 64 (the
    longest sequences the towers take: two keys a lane in attention), then
    at d_latent 512 (BASELINE.json config 5's width: K4 and K5 at d 512,
    K2 and K3 at their widest), each run with its own params and batches.
    Before each step, the loss and every gradient from the step's params
    through the kernels, through the plain versions on the card and
    through the plain versions on the CPU; every kernel launches its count
    a step.

    The loss must agree to 1e-5.  The gradients are held by the relative
    Frobenius error of each tensor, to the larger of GRAD_TOL and three
    times the plain versions' own disagreement between card and CPU at that
    step (the two errors are draws of the same f32 disagreement):
    at this width single gradient elements jump between any two f32 runs
    (an input of a ReLU at zero, an all-masked attention row's -1e9
    rounding), so the train phase's max-abs metric moves by a factor of a
    few from one run of the same code to the next: it is logged, not
    gated."""
    from c2dsr_tpu_torch.config import Config, DataSpec
    from c2dsr_tpu_torch.data import preprocess, synthetic
    from c2dsr_tpu_torch.data.pipeline import BatchIterator
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import spmm
    from c2dsr_tpu_torch.train import optim
    from c2dsr_tpu_torch.train import step as step_mod

    cfg256 = Config(d_latent=256, dropout_gnn=0.0, dropout_attn=0.0)
    runs = []                      # [cfg, spec, state, step fn, batches]
    for cfg, len_max, seed in ((cfg256, LEN_MAX, 2), (cfg256, 30, 5),
                               (cfg256.with_(d_latent=128), 64, 6),
                               (cfg256.with_(d_latent=512), LEN_MAX, 7)):
        sp, tr = spec, train
        if len_max != LEN_MAX:
            sp = DataSpec(n_item_a=spec.n_item_a, n_item_b=spec.n_item_b,
                          len_max=len_max)
            tr = preprocess.preprocess_train(
                synthetic.generate_sequences(sp, 2000, seed=seed - 1), sp,
                seed=1)
        it = BatchIterator(tr, cfg.batch_size, shuffle=True, seed=seed,
                           drop_last=True)
        params = params_mod.init_params(cfg, sp,
                                        torch.Generator().manual_seed(3),
                                        "cuda")
        opt = optim.make_optimizer(cfg, steps_per_epoch=len(it))
        fn = step_mod.make_train_step(cfg, sp, graphs, opt, "cuda")
        runs.append([cfg, sp, step_mod.init_state(params, opt), fn,
                     it.epoch()])
    cpu_graphs = c2dsr.Graphs(spmm.device_graph(graphs_host[0], "cpu"),
                              spmm.device_graph(graphs_host[1], "cpu"))
    schedule = (0, 0, 1, 2, 3)     # d 256 at len_max 15, 15, 30; d 128 at
                                   # 64; d 512 at 15
    launches = dict.fromkeys(kernel_wrappers(), 0)
    losses = []
    for i, which in enumerate(schedule):
        cfg, sp, state, fn, feed = runs[which]
        names = leaf_names(state.params)
        batch = next(feed)
        b = ranker.to_device(batch, "cuda")
        leaves = state.opt_state.leaves
        masks, calls = {}, []
        loss_k, g_k = _loss_grads(state.params, leaves, graphs, b, cfg, sp,
                                  gates.recording_k2_branches(
                                      masks, calls if i == 0 else None))
        loss_p, g_p = _loss_grads(state.params, leaves, graphs, b, cfg, sp,
                                  gates.plain_versions(masks))
        _, g_o = _loss_grads(state.params, leaves, graphs, b, cfg, sp,
                             gates.plain_versions())
        cpu = params_mod.params_from_numpy(
            params_mod.params_to_numpy(state.params), "cpu")
        cpu_leaves = step_mod.param_leaves(cpu)
        for t in cpu_leaves:
            t.requires_grad_(True)
        loss_c, g_c = _loss_grads(cpu, cpu_leaves, cpu_graphs,
                                  ranker.to_device(batch, "cpu"), cfg, sp,
                                  contextlib.nullcontext())
        noise, wn = _fro(g_o, g_c)
        err, we = _fro(g_k, g_p)
        err_own, wo = _fro(g_k, g_o)
        tol = max(GRAD_TOL, 3 * noise)
        rel = [_rel(a, c) if float(c.abs().max()) > 0
               else float(a.abs().max()) for a, c in zip(g_k, g_p)]
        wm = int(np.argmax(rel))
        tag = f"train d_latent {cfg.d_latent} step {i} (len_max {sp.len_max})"
        log(f"{tag}: loss "
            f"{loss_k:.6f} (kernels) {loss_p:.6f} (plain) {loss_c:.6f} "
            f"(plain, CPU); gradients, worst relative Frobenius err kernels "
            f"against plain at K2's branches {err:.3e} ({names[we]}), "
            f"at the plain forward's own {err_own:.3e} ({names[wo]}), plain "
            f"card against CPU {noise:.3e} ({names[wn]}), tolerance "
            f"{tol:.3e}; max-abs relative {rel[wm]:.3e} ({names[wm]}), "
            f"logged")
        if calls:
            accuracy = _tower_accuracy(calls)
            log(f"{tag}: the step's tower calls against a float64 plain "
                f"tower at K2's branches, relative Frobenius, worst call: "
                f"q/k/v K2 {accuracy['qkv']['k2']:.3e} (plain f32 "
                f"{accuracy['qkv']['plain']:.3e}); dx K3 "
                f"{accuracy['dx']['k3']:.3e} (plain f32 "
                f"{accuracy['dx']['plain']:.3e}); w_qkv K3 "
                f"{accuracy['w_qkv']['k3']:.3e} (plain f32 "
                f"{accuracy['w_qkv']['plain']:.3e})")
        check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
              f"{tag}: loss {loss_k} (kernels) != {loss_p}")
        check(err <= tol, f"{tag}: gradients relative Frobenius err {err} > "
              f"{tol}")
        reset_launches()
        runs[which][2], aux = fn(state, batch)
        torch.cuda.synchronize()
        losses.append(float(aux["loss"]))
        for k, v in read_launches().items():
            launches[k] += v
    steps = len(schedule)
    per_step = {"spmm_csr": 4 * cfg256.n_gnn, "spmm_csr_flagged": 0,
                "encoder_fwd": 3, "encoder_bwd": 3, "ce_fwd": 2, "ce_bwd": 2,
                "segsum": LOOKUPS}
    log(f"train wide: {steps} steps, losses "
        f"{[round(v, 4) for v in losses]}, launches {launches}")
    check(all(math.isfinite(v) for v in losses), "train wide: loss")
    for k, n in per_step.items():
        check(launches[k] == n * steps, f"train wide: {k} launched "
              f"{launches[k]} times in {steps} steps, want {n} a step")
    return launches


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
    fn = step_mod.make_train_step(cfg, spec, graphs, opt, "cuda")

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

    def rels(got, want):
        return [_rel(a, b) if float(b.abs().max()) > 0
                else float(a.abs().max()) for a, b in zip(got, want)]

    masks = {}
    loss_k, g_k = grads_of(gates.recording_k2_branches(masks))
    loss_p, g_p = grads_of(gates.plain_versions(masks))
    _, g_o = grads_of(gates.plain_versions())
    for t in leaves:
        t.grad = None
    rel, rel_own = rels(g_k, g_p), rels(g_k, g_o)
    log(f"train path dropout 0: loss {loss_k:.6f} (kernels) {loss_p:.6f} "
        f"(plain); worst gradient relative err {max(rel):.3e} ("
        f"{leaf_names(params)[int(np.argmax(rel))]}) over {len(rel)} "
        f"tensors at K2's branches, {max(rel_own):.3e} ("
        f"{leaf_names(params)[int(np.argmax(rel_own))]}) at the plain "
        "forward's own")
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
                "encoder_fwd": 3, "encoder_bwd": 3, "ce_fwd": 2, "ce_bwd": 2,
                "segsum": LOOKUPS}
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
        ctx = (gates.plain_versions() if which == "plain"
               else contextlib.nullcontext())
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
    resumed third, a resumed next step at dropout 0.2 against the
    uninterrupted one, the flags-on/off equality and the warm step
    rates."""
    from c2dsr_tpu_torch import checkpoint as ckpt_mod
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.data.pipeline import BatchIterator
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.ops import dropout as drop
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
                "ce_bwd": 2 * steps, "segsum": LOOKUPS * steps}
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

        # at dropout 0.2, a run restored from a checkpoint of this state
        # takes its next step with the uninterrupted run's dropout: the
        # same loss; the step-0 seed a replayed stream would draw gives
        # another
        path2 = os.path.join(tmp, "ckpt_now")
        ckpt_mod.save(path2, exp.state, meta={"epoch": cfg.n_epoch},
                      block=True)
        exp3 = Experiment(cfg.with_(resume=True), spec, graphs, train, val,
                          test, ckpt_path=path2, device="cuda")
        check(exp3.state.step == exp.state.step > 0,
              f"resume: step {exp3.state.step} != {exp.state.step}")
        nxt = next(iter(exp.train_iter.epoch()))
        with torch.no_grad():
            replayed = float(step_mod.loss_fn(
                exp3.state.params, graphs, ranker.to_device(nxt, "cuda"),
                drop.step_seed(cfg.seed + 1, 0), cfg, spec)[0])
        _, aux1 = exp.train_step(exp.state, nxt)
        _, aux3 = exp3.train_step(exp3.state, nxt)
        l1, l3 = float(aux1["loss"]), float(aux3["loss"])
        log(f"experiment resume at dropout {cfg.dropout_attn}: step "
            f"{exp.state.step - 1} loss {l1:.7f} uninterrupted, {l3:.7f} "
            f"resumed (bitwise equal: {l1 == l3}); the step-0 seed gives "
            f"{replayed:.7f}")
        check(abs(l1 - l3) <= 1e-6 * abs(l1),
              f"resumed step loss {l3} != uninterrupted {l1}")
        check(replayed != l1, "the step-0 seed gives the same loss")
        del exp3

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
        cfg.with_(batch_sparse_gnn=False), spec, graphs, exp.optimizer, "cuda")

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


def phase_ce_wide(timer, peak_flops, peak_bw, gpu):
    """K4 and K5 at d 384 and 512, the widths above 256 (64 resident rows a
    block, K5's output columns over two blocks), at a train step's rows of
    domain A (N 10,240, V 30,720): against the plain versions in float64
    (CE_TOL, CE_BWD_TOL), as the d 256 card tests hold them, and bitwise
    against a second launch; then timed beside the plain versions in f32,
    with K5's dh and dW kernels profiled and the bounds."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    N, V, n_real = 512 * 2 * 10, 30720, N_ITEM_A
    out = {}
    for d in (384, 512):
        h, w, bm, pad_l, tgt, real, dlse, dt = _ce_inputs(N, d, V, n_real, d)
        with torch.no_grad():
            lse, tlog = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)
            lse2, tlog2 = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)
            got = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
            again = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
            h64, w64, b64, p64 = (t.double() for t in (h, w, bm, pad_l))
            rlse, rtlog = fused_ce.ce_fwd_plain(h64, w64, b64, p64, tgt)
            want = fused_ce.ce_bwd_plain(h64, w64, b64, lse.double(),
                                         dlse.double(), dt.double(), tgt)
        torch.cuda.synchronize()
        e_f = max(_rel(lse, rlse), _rel(tlog[real], rtlog[real]))
        check(e_f <= CE_TOL, f"ce_fwd d={d}: rel err {e_f} > {CE_TOL}")
        check(torch.equal(lse, lse2) and torch.equal(tlog, tlog2),
              f"ce_fwd d={d}: two launches differ")
        rels = _check_ce_bwd(f"d={d}", got, want, again, n_real)
        del want, h64, w64, rlse, rtlog
        with torch.no_grad():
            f_ms = timer(lambda: fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt))
            f_plain = timer(lambda: fused_ce.ce_fwd_plain(h, w, bm, pad_l,
                                                          tgt))
            b_ms = timer(lambda: fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt,
                                                      tgt))
            b_plain = timer(lambda: fused_ce.ce_bwd_plain(h, w, bm, lse, dlse,
                                                          dt, tgt))
        sub = timing.kernel_times(lambda: fused_ce_cuda.ce_bwd(
            h, w, bm, lse, dlse, dt, tgt))[0]
        parts = {"dh": sum(v for k, v in sub.items()
                           if "ce_bwd_kernel" in k and "true>" in k),
                 "dw": sum(v for k, v in sub.items()
                           if "ce_bwd_kernel" in k and "false>" in k)}
        flops = 2.0 * N * V * d
        io = 4 * (N * d + d * V + V + 3 * N)
        out[d] = {"fwd_ms": f_ms, "fwd_plain_ms": f_plain,
                  "bwd_ms": b_ms, "bwd_plain_ms": b_plain,
                  "bwd_dh_ms": parts["dh"], "bwd_dw_ms": parts["dw"],
                  "fwd_bound_ms": timing.tc_bound_ms(flops, io, gpu, peak_bw),
                  "fwd_bound_ffma_ms": flops / peak_flops * 1e3,
                  "bwd_bound_ms": timing.tc_bound_ms(2 * flops, 2 * io, gpu,
                                                     peak_bw),
                  "bwd_bound_ffma_ms": 2 * flops / peak_flops * 1e3,
                  "fwd_rel_err_f64": e_f,
                  "bwd_rel_err_f64": max(rels.values())}
        log(f"ce wide d={d}: N={N} V={V}: against float64 fwd rel err "
            f"{e_f:.3e}, bwd " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in rels.items())
            + "; two launches of each bitwise equal; fwd kernel "
            f"{f_ms:.4f} ms plain {f_plain:.4f}, bwd kernel {b_ms:.4f} ms "
            f"(dh {parts['dh']:.4f} + dW {parts['dw']:.4f}, profiled) plain "
            f"{b_plain:.4f}; bounds 3xTF32 fwd {out[d]['fwd_bound_ms']:.4f} "
            f"bwd {out[d]['bwd_bound_ms']:.4f}, FFMA fwd "
            f"{out[d]['fwd_bound_ffma_ms']:.4f}")
    return out


def _k7_calls_of_a_step(cfg, spec, graphs, params, batch, seed):
    """The (ids, g, n_rows) of every K7 call of one train step's backward
    (loss_fn at cfg's dropout), recorded as the step makes them: the
    shapes and the gradient rows the main path gives K7."""
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import segsum_cuda
    from c2dsr_tpu_torch.train import step as step_mod
    p = params_mod._map(lambda t: t.detach().clone(), params)
    for t in step_mod.param_leaves(p):
        t.requires_grad_(True)
    calls = []
    k7 = segsum_cuda.segsum

    def record(ids, g, n_rows):
        calls.append((ids.detach().clone(), g.detach().clone(), n_rows))
        return k7(ids, g, n_rows)

    # K7's wrapper counts its launches on the module's ``segsum``, which is
    # ``record`` meanwhile
    record.launches = k7.launches
    segsum_cuda.segsum = record
    try:
        loss, _ = step_mod.loss_fn(p, graphs, ranker.to_device(batch, "cuda"),
                                   seed, cfg, spec)
        loss.backward()
    finally:
        segsum_cuda.segsum = k7
        k7.launches = record.launches
    return calls


def _k7_call(name, ids, g, n_rows, timer, peak_bw, clock_hz):
    """K7 on one call's inputs: bitwise CPU index_add_ (gated), timed with
    its launches a call and device ms by kernel, against index_add_ on the
    card (its plain version, atomics) and under
    torch.use_deterministic_algorithms (the library yardstick, checked
    bitwise against CPU index_add_ and logged), with the byte bound and the
    order bound (the longest chain of non-zero rows, a FADD latency each)."""
    from c2dsr_tpu_torch.bench.kernel_bench import deterministic_index_add
    from c2dsr_tpu_torch.ops import segsum_cuda
    got = segsum_cuda.segsum(ids, g, n_rows).cpu()
    want = segsum_cuda.segsum_plain(ids.cpu(), g.cpu(), n_rows)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          f"K7 {name}: not bitwise CPU index_add_")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    try:
        det = deterministic_index_add(ids, g, n_rows).cpu()
        det_bitwise = torch.equal(det.view(torch.int32),
                                  want.view(torch.int32))
        det_ms = timer(lambda: deterministic_index_add(ids, g, n_rows))
    except RuntimeError as e:           # no deterministic form on this build
        log(f"K7 {name}: deterministic index_add_ refused: {e}")
        det_bitwise, det_ms = None, None
    ms = timer(lambda: segsum_cuda.segsum(ids, g, n_rows))
    atomic_ms = timer(lambda: segsum_cuda.segsum_plain(ids, g, n_rows))
    parts, launches = _k7_kernels(lambda: segsum_cuda.segsum(ids, g, n_rows))
    check(2 <= launches <= 3,
          f"K7 {name}: {launches:g} launches a call, not 2 or 3")
    n, d = g.shape
    chain = segsum_cuda.longest_chain(ids, g, n_rows)
    live = int((g.view(torch.int32) & 0x7fffffff).ne(0).any(1).sum())
    bytes_ms = (8 * n + 4 * n * d + 4 * n_rows * d) / peak_bw * 1e3
    order_ms = timing.chain_bound_ms(chain, clock_hz)
    res = {"ms": ms, "plain_ms": atomic_ms, "library_ms": det_ms,
           "index_add_atomic_ms": atomic_ms,
           "deterministic_index_add_bitwise_cpu": det_bitwise,
           "bound_ms": max(bytes_ms, order_ms), "bytes_bound_ms": bytes_ms,
           "order_bound_ms": order_ms,
           "bound_by": "bytes" if bytes_ms >= order_ms else "operations",
           "n_ids": n, "n_rows": n_rows, "live_rows": live,
           "longest_chain": chain,
           "launches_per_call": launches,
           "kernels_ms": parts,
           "max_abs_err": err}
    log(f"K7 {name}: {n} ids ({live} non-zero gradient rows) into {n_rows} "
        f"rows, d {d}, longest chain {chain}: bitwise CPU index_add_; K7 "
        f"{ms:.4f} ms in {launches:g} launches a call (profiled); "
        f"index_add_ {atomic_ms:.4f} ms (atomics), deterministic "
        f"index_add_ {det_ms if det_ms is None else f'{det_ms:.4f}'} ms "
        f"(bitwise CPU index_add_: {det_bitwise}); bound {res['bound_ms']:.4f}"
        f" ms (bytes {bytes_ms:.4f}, order {order_ms:.4f})")
    return res


def _k7_kernels(fn, calls: int = 5):
    """({K7 kernel: device ms a call}, K7 launches a call) of ``fn`` under
    torch.profiler.  In a process that has run many profiles, the profiler
    missed the first few K7 launches of its window, so the window opens
    with other kernels and a pause, which are not counted."""
    from torch.profiler import ProfilerActivity, profile
    lead = torch.empty(16 << 20, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            lead.zero_()
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms, launches = _k7_by_kernel(prof)
    return {k: v / calls for k, v in ms.items()}, launches / calls


def _k7_by_kernel(prof):
    """({K7 kernel: device ms}, K7 launches) in a torch.profiler run."""
    ms, launches = {}, 0
    for ev in prof.key_averages():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and "segsum_" in ev.key):
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ")
            ms[name] = ms.get(name, 0.0) + getattr(
                ev, "self_device_time_total",
                getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
            launches += ev.count
    return ms, launches


def _k7_step_profile(cfg, spec, graphs, params, batch, seed):
    """K7's kernels in one step's backward under torch.profiler: ({kernel:
    device ms}, launches)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _k7_calls_of_a_step(cfg, spec, graphs, params, batch, seed)
        torch.cuda.synchronize()
    return _k7_by_kernel(prof)


def phase_determinism(spec, train, graphs, timer, peak_bw):
    """The step is bitwise repeatable.  K7 against CPU ``index_add_``,
    bitwise, each call timed (_k7_call): at a train step's shared-tower ids
    with random gradient rows (every row non-zero, so the padding id's
    chain is 8,802 long: the case K7's skipping of zero rows does not
    help), and on every call of one train step's backward with the
    gradients the step makes (_k7_calls_of_a_step).  Two FK train steps at
    dropout 0.2 from copies of one state on one batch: bitwise equal
    gradients and parameters.  Logged beside, not gated: the same two
    gradients with ``index_add_`` (atomics) in K7's place, and what K7
    costs a step's device busy time (_k7_step_cost)."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import dropout as drop
    from c2dsr_tpu_torch.ops import segsum_cuda
    from c2dsr_tpu_torch.train import optim
    from c2dsr_tpu_torch.train import step as step_mod
    cfg = Config()
    b, _ = _flagged_batch(train, cfg.batch_size)
    seq3 = torch.cat([b["seq_share"], b["seq_share_neg_a"],
                      b["seq_share_neg_b"]])
    pos3 = torch.cat([b["pos"]] * 3)
    gen = torch.Generator(device="cuda").manual_seed(4)
    clock_hz = timing.sm_clock_hz()
    k7 = {"calls": [], "all_nonzero": {}}
    for name, ids, n_rows in (("items", seq3, spec.n_item + 1),
                              ("positions", pos3, spec.len_max)):
        g = torch.randn((ids.numel(), cfg.d_latent), generator=gen,
                        device="cuda")
        k7["all_nonzero"][name] = _k7_call(
            f"{name}, random rows (every row non-zero)", ids, g, n_rows,
            timer, peak_bw, clock_hz)

    params = params_mod.init_params(cfg, spec,
                                    torch.Generator().manual_seed(0), "cuda")
    batch = {k: v[:cfg.batch_size] for k, v in train.items()}
    seed = drop.step_seed(cfg.seed + 1, 0)
    calls = _k7_calls_of_a_step(cfg, spec, graphs, params, batch, seed)
    check(len(calls) == LOOKUPS, f"a step made {len(calls)} K7 calls, not "
          f"{LOOKUPS}")
    n_top = max(ids.numel() for ids, _, _ in calls)
    for i, (ids, g, n_rows) in enumerate(calls):
        kind = "items" if n_rows > segsum_cuda.SMALL_ROWS else "positions"
        res = _k7_call(f"step call {i} ({kind})", ids, g, n_rows, timer,
                       peak_bw, clock_hz)
        k7["calls"].append(res)
        if ids.numel() == n_top and kind not in k7:
            k7[kind] = res              # the shared tower's, 23,040 ids
    k7["step"] = {k: sum(c[k] for c in k7["calls"])
                  for k in ("ms", "plain_ms", "bound_ms", "launches_per_call")}
    k7["step"]["library_ms"] = (
        None if any(c["library_ms"] is None for c in k7["calls"])
        else sum(c["library_ms"] for c in k7["calls"]))
    parts, seen = _k7_step_profile(cfg, spec, graphs, params, batch, seed)
    check(seen == k7["step"]["launches_per_call"],
          f"the step profile saw {seen} K7 launches, the calls' own "
          f"profiles {k7['step']['launches_per_call']:g}")
    k7["step"]["launches"] = seen
    k7["step"]["device_ms"] = sum(parts.values())
    k7["step"]["kernels_ms"] = parts
    log(f"K7 in a step ({len(calls)} calls): {k7['step']['ms']:.4f} ms in "
        f"{seen} launches in the step profile (as many in the calls' own "
        f"profiles; device {k7['step']['device_ms']:.4f} ms: "
        + ", ".join(f"{k[:40]} {v:.4f}" for k, v in parts.items())
        + f") against index_add_ {k7['step']['plain_ms']:.4f} ms (atomics) "
        f"and {k7['step']['library_ms']} ms (deterministic); bounds sum "
        f"{k7['step']['bound_ms']:.4f} ms")

    def grads_of(state):
        leaves = state.opt_state.leaves
        for t in leaves:
            t.grad = None
        loss, _ = step_mod.loss_fn(state.params, graphs,
                                   ranker.to_device(batch, "cuda"), seed,
                                   cfg, spec)
        loss.backward()
        out = [t.grad.clone() for t in leaves]
        for t in leaves:
            t.grad = None
        return out

    def run():
        opt = optim.make_optimizer(cfg, steps_per_epoch=58)
        state = step_mod.init_state(
            params_mod._map(lambda t: t.detach().clone(), params), opt)
        grads = grads_of(state)
        fn = step_mod.make_train_step(cfg, spec, graphs, opt, "cuda")
        state, aux = fn(state, batch)
        return grads, [t.detach().clone() for t in
                       step_mod.param_leaves(state.params)], float(aux["loss"])

    (g1, p1, l1), (g2, p2, l2) = run(), run()
    same_g = all(torch.equal(a, c) for a, c in zip(g1, g2))
    same_p = all(torch.equal(a, c) for a, c in zip(p1, p2))
    k7_fn = segsum_cuda.segsum
    segsum_cuda.segsum = segsum_cuda.segsum_plain
    try:
        opt = optim.make_optimizer(cfg, steps_per_epoch=58)
        s0 = step_mod.init_state(
            params_mod._map(lambda t: t.detach().clone(), params), opt)
        atomics = [grads_of(s0) for _ in range(2)]
    finally:
        segsum_cuda.segsum = k7_fn
    differ = sum(not torch.equal(a, c) for a, c in zip(*atomics))
    log(f"determinism: two FK train steps at dropout {cfg.dropout_attn} "
        f"from one state and batch: losses {l1:.7f} {l2:.7f}; gradients "
        f"bitwise equal {same_g} ({len(g1)} tensors), parameters after the "
        f"step bitwise equal {same_p}; with index_add_ in K7's place "
        f"{differ} of {len(g1)} gradients differ between two runs (logged)")
    check(same_g and same_p and l1 == l2,
          "two train steps from one state differ")
    return k7, {"index_add_grads_differ": differ,
                "step_busy_ms": _k7_step_cost(cfg, spec, graphs, params,
                                              batch)}


def _k7_step_cost(cfg, spec, graphs, params, batch):
    """A train step's device busy ms with K7 against the same step with the
    lookups as they were before K7 (``index_select`` alone, whose backward
    is ``index_add_`` with atomics; the propagated and the raw table looked
    up apart), on one state and batch in one process, in turns (K7,
    index_add_, index_add_, K7) for BUSY_ROUNDS rounds.  Logged and
    returned: each side's mean, their difference and its standard error."""
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import lookup as lookup_mod
    from c2dsr_tpu_torch.train import optim
    from c2dsr_tpu_torch.train import step as step_mod
    opt = optim.make_optimizer(cfg, steps_per_epoch=58)
    state = step_mod.init_state(
        params_mod._map(lambda t: t.detach().clone(), params), opt)
    fn = step_mod.make_train_step(cfg, spec, graphs, opt, "cuda")

    def select(table, ids):
        return table.index_select(0, ids.reshape(-1)).view(*ids.shape,
                                                           table.shape[1])

    def one_step():
        nonlocal state
        state, _ = fn(state, batch)
        torch.cuda.synchronize()

    for _ in range(2):
        one_step()
    k7_fns = lookup_mod.lookup, lookup_mod.lookup_add
    busy = {"k7": [], "index_add": []}
    for arm in ("k7", "index_add", "index_add", "k7") * BUSY_ROUNDS:
        if arm == "index_add":
            lookup_mod.lookup = select
            lookup_mod.lookup_add = lambda a, b, ids: (select(a, ids)
                                                       + select(b, ids))
        try:
            busy[arm] += _busy_ms(one_step, reps=1)[0]
        finally:
            lookup_mod.lookup, lookup_mod.lookup_add = k7_fns
    k, a = np.array(busy["k7"]), np.array(busy["index_add"])
    diff = float(k.mean() - a.mean())
    se = math.sqrt(k.var(ddof=1) / len(k) + a.var(ddof=1) / len(a))
    log(f"K7 in a train step: device busy {k.mean():.4f} ms with K7 against "
        f"{a.mean():.4f} ms with index_add_ ({diff:+.4f} ms, standard error "
        f"{se:.4f}: {'resolved' if abs(diff) > 3 * se else 'unresolved'}; "
        f"{len(k)} profiled steps a side, one state and batch)")
    return {"k7": float(k.mean()), "index_add": float(a.mean()),
            "diff": diff, "standard_error": se, "steps_a_side": len(k)}


def _bench_logs(name, res):
    """A few lines of a bench mode's result."""
    if name == "headline":
        log(f"bench headline: {json.dumps(res['line'])}; eval full rank "
            f"{res['details']['eval_full_rank_examples_per_s']:.1f} "
            f"examples/s, {res['details']['eval_full_rank_items_per_s']:.4g}"
            f" items/s; gates {res['details']['train_gate']} "
            f"{res['details']['eval_gate']}")
    elif name == "kernels":
        for r in res["results"]:
            log(f"bench kernels {r['kernel']}: {r['ms']:.4f} ms plain "
                f"{r['plain_ms']:.4f} library {r['library_ms']} bound "
                f"{r['bound_ms']:.4f} ({r['bound_by']}, FFMA "
                f"{r['bound_ffma_ms']:.4f}); err {r['max_rel_err']:.3e}")
    elif name == "ce_variants":
        for sh in res["shapes"]:
            for v, r in sh["variants"].items():
                log(f"bench ce_variants N={sh['N']} d={sh['d']} "
                    f"V={sh['V']} {v}: call {r['ms']:.4f} ms "
                    f"({r['tflops']:.1f} TFLOP/s), "
                    f"plain {r['plain_ms']:.4f}, library {r['library_ms']}, "
                    f"bounds 3xTF32 {r['bound_ms']:.4f} FFMA "
                    f"{r['bound_ffma_ms']:.4f}, unphysical {r['unphysical']}"
                    f"; errors {r.get('base_rel_err', 0.0):.3e} from base, "
                    f"{r['plain_rel_err']:.3e} from plain")
    elif name == "scaled":
        m = res["measured_per_shard"]
        ce = m["fused_ce_f32"]
        log(f"bench scaled: lookup {m['lookup_ms']:.4f} ms (fwd+bwd "
            f"{m['lookup_fwd_bwd_ms']:.4f}); CE d 512 V 2^19 fwd "
            f"{ce['fwd_ms']:.3f} ms fwd+bwd {ce['fwd_bwd_ms']:.3f} ms "
            f"({ce['fwd_bwd_tflops']:.1f} TFLOP/s; bounds "
            f"{ce['fwd_bound_ms']:.3f} / {ce['fwd_bwd_bound_ms']:.3f}); "
            f"errors rows {ce['rows_rel_err']:.3e} grads "
            f"{ce['grads_rel_err']:.3e}; full rank {m['full_rank_ms']:.4f} "
            f"ms (delta {m['full_rank_max_rank_delta']})")
    else:
        for r in res["results"]:
            log(f"bench batches: {json.dumps(r)}")


def phase_bench():
    """The port's bench (``python -m c2dsr_tpu_torch.bench``), each mode in
    this process at its real size, with its gates: the headline,
    ``--kernels``, ``--ce-variants``, ``--scaled``, and ``--batches`` up to
    2,048.  Returns ({mode: result}, {mode: kernel launches})."""
    import dataclasses
    from c2dsr_tpu_torch.bench import __main__ as bench_main
    from c2dsr_tpu_torch.bench import ce_variants, kernel_bench, scaled_bench
    modes = (("headline", bench_main.headline),
             ("kernels", kernel_bench.run),
             ("ce_variants", ce_variants.run),
             ("scaled", scaled_bench.run),
             ("batches", lambda: bench_main.batch_scaling(
                 dataclasses.replace(bench_main.FK,
                                     batches=(256, 512, 1024, 2048)))))
    out, launches = {}, {}
    for name, fn in modes:
        reset_launches()
        t0 = time.perf_counter()
        try:
            out[name] = fn()
        except timing.GateFailure as e:
            raise SmokeFailure(f"bench {name}: gate failed: {e}")
        launches[name] = read_launches()
        launches[name]["by_variant"] = dict(
            kernel_wrappers()["ce_fwd_variant"].by_variant)
        torch.cuda.empty_cache()
        _bench_logs(name, out[name])
        log(f"bench {name}: {time.perf_counter() - t0:.1f} s, launches "
            f"{launches[name]}")
    bench_main.merge_details({k: v["details"] if k == "headline" else v
                              for k, v in out.items()})
    return out, launches


def phase_cli():
    """``python -m c2dsr_tpu_torch.cli`` on the card in a temporary working
    directory, at the default width and at ``--d_latent 40`` (d % 32 == 8,
    one head: every tower and CE kernel at a ragged width): exit 0, the
    final result table and a checkpoint."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_DIR] + [p for p in [env.get("PYTHONPATH")] if p])
    for extra in ([], ["--d_latent", "40"]):
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [sys.executable, "-m", "c2dsr_tpu_torch.cli", "--synthetic",
                   str(CLI_USERS), "--n_epoch", "1", "--ckpt",
                   os.path.join(tmp, "ckpt")] + extra
            t0 = time.perf_counter()
            run = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                                 text=True, timeout=600)
            secs = time.perf_counter() - t0
            check(run.returncode == 0, f"cli {extra} exited "
                  f"{run.returncode}: {run.stderr[-2000:]}")
            check("[ Test result ]" in run.stdout,
                  "cli printed no final result table")
            check(os.path.isfile(os.path.join(tmp, "ckpt", "meta.json")),
                  "cli wrote no checkpoint")
            table = run.stdout[run.stdout.rindex("[ Test result ]"):]
            log(f"cli: {' '.join(cmd[1:])} exited 0 in {secs:.1f} s; test "
                f"result {table.splitlines()[2].strip()}")


def _busy_ms(fn, reps: int = 3):
    """Device busy ms of each of ``reps`` profiled calls of ``fn`` (which
    synchronises), and the part of it in K2's kernels."""
    from torch.profiler import ProfilerActivity, profile
    busy, k2 = [], []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
        us = {ev.key: getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0.0))
              for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA}
        busy.append(sum(us.values()) / 1e3)
        k2.append(sum(v for k, v in us.items() if "encoder_fwd_" in k) / 1e3)
    return busy, k2


def measure_rates() -> dict:
    """Measures of the ``c2dsr_tpu_torch`` first on sys.path, at FK
    geometry with the default Config.  The training step: 10 warm-up steps,
    8 runs of 4 steps (train examples/s each, and the host's ms a step
    until the last step is enqueued, before the synchronise), then 3
    profiled steps (device busy ms, and K2's ms, each).  K1 a hop of each
    table over A and Aᵀ, and K7's six calls of one step's backward (3
    timings each, the median of 20 CUDA-event timings).  K2 alone at the
    serving path's tower (B 2048, L 15, d 128, one head, one layer; the
    median of 20 timed calls, 3 times).  The serving path (convolve, then
    rank the eval split in sampled and full mode): 3 profiled runs after
    one warm-up (device busy ms, and K2's ms, each), after SERVE_RUNS
    timed runs (the convolve's wall ms, and eval examples/s of each mode
    by the wall time of its ``evaluate_split``, as the main path's warm
    rates)."""
    from c2dsr_tpu_torch.config import Config, DataSpec
    from c2dsr_tpu_torch.data import preprocess, synthetic
    from c2dsr_tpu_torch.data.pipeline import BatchIterator
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.graph import build as graph_build
    from c2dsr_tpu_torch.kernels import build
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import (backend, encoder_cuda, segsum_cuda, spmm,
                                     spmm_cuda)
    from c2dsr_tpu_torch.ops import dropout as drop
    from c2dsr_tpu_torch.train import optim
    from c2dsr_tpu_torch.train import step as step_mod
    backend.resolve_device("cuda")
    build.build_all()
    spec = DataSpec(n_item_a=N_ITEM_A, n_item_b=N_ITEM_B, len_max=LEN_MAX)
    seqs = synthetic.generate_sequences(spec, N_TRAIN_USERS, seed=0)
    share, specific = graph_build.build_graphs(seqs, spec)
    graphs = c2dsr.Graphs(spmm.device_graph(share, "cuda"),
                          spmm.device_graph(specific, "cuda"))
    cfg = Config()
    train = preprocess.preprocess_train(seqs, spec, seed=1)
    it = BatchIterator(train, cfg.batch_size, shuffle=True, seed=0,
                       drop_last=True)

    def batches():
        while True:
            yield from it.epoch()

    feed = batches()
    opt = optim.make_optimizer(cfg, steps_per_epoch=len(it))
    state = step_mod.init_state(params_mod.init_params(
        cfg, spec, torch.Generator().manual_seed(0), "cuda"), opt)
    # A checkout from before the seed followed state.step takes a CPU
    # generator: drop this once no compared checkout predates that.
    gen = ((torch.Generator().manual_seed(cfg.seed),) if "generator" in
           inspect.signature(step_mod.make_train_step).parameters else ())
    fn = step_mod.make_train_step(cfg, spec, graphs, opt, *gen, "cuda")
    for _ in range(10):
        state, aux = fn(state, next(feed))
    torch.cuda.synchronize()
    rates, host = [], []
    for _ in range(8):
        t0 = time.perf_counter()
        for _ in range(TRAIN_RUN_STEPS):
            state, aux = fn(state, next(feed))
        host.append((time.perf_counter() - t0) / TRAIN_RUN_STEPS * 1e3)
        torch.cuda.synchronize()
        rates.append(TRAIN_RUN_STEPS * cfg.batch_size
                     / (time.perf_counter() - t0))

    def one_step():
        fn(state, next(feed))
        torch.cuda.synchronize()

    busy, k2 = _busy_ms(one_step)
    check(math.isfinite(float(aux["loss"])), "train loss not finite")
    del state, opt, fn

    # K1 and K7 at a step's shapes, on inputs made alike in both checkouts:
    # K1 a hop of each table over A and Aᵀ on a seeded table; K7 the six
    # calls of one step's backward from seeded params on the first batch
    timer = timing.Timer()
    kernels = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name, g, d in (("share", graphs.share, 128),
                       ("ab", graphs.specific, 256)):
        for tag, csr in ((name, g), (name + "_t", g.t)):
            h = torch.randn((65536, d), generator=gen, device="cuda")
            h[csr.n:] = 0.0
            kernels[f"k1_{tag}_ms"] = [
                timer(lambda: spmm_cuda.spmm_csr(csr, h)) for _ in range(3)]
    kernels["k1_step_ms"] = [sum(kernels[f"k1_{t}_ms"][i] for t in (
        "share", "share_t", "ab", "ab_t")) for i in range(3)]
    calls = _k7_calls_of_a_step(
        cfg, spec, graphs, params_mod.init_params(
            cfg, spec, torch.Generator().manual_seed(0), "cuda"),
        {k: v[:cfg.batch_size] for k, v in train.items()}, drop.step_seed(
            cfg.seed + 1, 0))
    kernels["k7_step_ms"] = [
        sum(timer(lambda: segsum_cuda.segsum(ids, g, n_rows))
            for ids, g, n_rows in calls) for _ in range(3)]
    del timer, calls

    pad = spec.idx_pad
    p = params_mod._map(lambda t: t.cuda(), params_mod.init_encoder_params(
        torch.Generator().manual_seed(7), Config(n_head=1, n_attn=1),
        LEN_MAX))
    x, seq = _encoder_inputs(2048, LEN_MAX, cfg.d_latent, pad, seed=7)
    timer = timing.Timer()
    with torch.inference_mode():
        k2_eval = [timer(lambda: encoder_cuda.encoder_fwd(
            x, seq, p, idx_pad=pad, n_head=1, invert_padding_mask=False))
            for _ in range(3)]
    del timer

    data = preprocess.preprocess_evaluate(
        synthetic.generate_sequences(spec, N_EVAL_USERS, seed=1), spec,
        n_neg_sample=999, seed=2)
    params = params_mod.init_params(cfg, spec,
                                    torch.Generator().manual_seed(0), "cuda")
    convolve_eval, rank_step = ranker.make_eval_fns(cfg, spec, graphs, "cuda")

    n_ex = int(data["gt_last"].shape[0])
    serve_rates = {"convolve": [], "sampled": [], "full": []}

    def serve():
        t0 = time.perf_counter()
        hi = convolve_eval(params)
        torch.cuda.synchronize()
        serve_rates["convolve"].append((time.perf_counter() - t0) * 1e3)
        for mode in ("sampled", "full"):
            t0 = time.perf_counter()
            ranker.evaluate_split(params, hi, data, rank_step, cfg, mode)
            torch.cuda.synchronize()
            serve_rates[mode].append(n_ex / (time.perf_counter() - t0))

    serve()
    for rs in serve_rates.values():
        rs.clear()
    for _ in range(SERVE_RUNS):
        serve()
    serve_busy, serve_k2 = _busy_ms(serve)
    return {"rates": rates, "host_ms": host, "busy_ms": busy, "k2_ms": k2,
            "k2_eval_ms": k2_eval,
            "serve_convolve_ms": serve_rates["convolve"][:SERVE_RUNS],
            "serve_sampled_rates": serve_rates["sampled"][:SERVE_RUNS],
            "serve_full_rates": serve_rates["full"][:SERVE_RUNS],
            "serve_busy_ms": serve_busy, "serve_k2_ms": serve_k2, **kernels}


def compare(other: str) -> int:
    """This checkout's measure_rates against that of ``other`` (a directory
    holding another version of ``c2dsr_tpu_torch``), each in a process of
    its own, in turns (other, this, this, other), on one card.  For each
    measure, the difference of the means and whether it exceeds 3 standard
    errors."""
    runs = {other: [], REPO_DIR: []}
    for root in (other, REPO_DIR, REPO_DIR, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--rates", root], capture_output=True,
                             text=True, timeout=600)
        check(out.returncode == 0, f"rates of {root}: {out.stderr[-2000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs[root].append(res)
        log(f"compare {root}: " + "; ".join(
            f"{k} {[round(v, 4) for v in vs]}" for k, vs in res.items()))
    for key, unit in (("rates", "train examples/s"),
                      ("host_ms", "host ms to enqueue a train step"),
                      ("busy_ms", "ms busy a train step"),
                      ("k2_ms", "ms of K2 a train step"),
                      ("k2_eval_ms", "ms a K2 serving tower"),
                      ("serve_convolve_ms", "wall ms a serving convolve"),
                      ("serve_sampled_rates", "eval examples/s sampled"),
                      ("serve_full_rates", "eval examples/s full"),
                      ("serve_busy_ms", "ms busy a serving run"),
                      ("serve_k2_ms", "ms of K2 a serving run"),
                      ("k1_share_ms", "ms a K1 share hop (d 128)"),
                      ("k1_share_t_ms", "ms a K1 share hop over Aᵀ"),
                      ("k1_ab_ms", "ms a K1 A|B hop (d 256)"),
                      ("k1_ab_t_ms", "ms a K1 A|B hop over Aᵀ"),
                      ("k1_step_ms", "ms of K1's four hops a step"),
                      ("k7_step_ms", "ms of K7's six calls a step")):
        vals = {k: np.array([r for res in v for r in res[key]])
                for k, v in runs.items()}
        mine, theirs = vals[REPO_DIR], vals[other]
        diff = mine.mean() - theirs.mean()
        se = math.sqrt(sum(r.var(ddof=1) / len(r) for r in vals.values()))
        log(f"compare {key}: this {mine.mean():.4f} against "
            f"{theirs.mean():.4f} {unit} ({diff / theirs.mean():+.2%}), "
            f"standard error {se:.4f}: "
            f"{'resolved' if abs(diff) > 3 * se else 'unresolved'}")
    log(f"compare: card {timing.card_line()}")
    return 0


# --- the parallel phase: the mesh's ranks sharing the one card ----------------

PAR_MESHES = (((1, 2), "psum"), ((2, 2), "a2a"))
PAR_EVAL_ROWS = 4096     # eval examples ranked on each mesh
PAR_TIMEOUT = 600        # seconds, the ranks' process group and their run


def _clone(obj):
    """A copy of a call's arguments that later in-place updates leave be."""
    if torch.is_tensor(obj):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    return obj


@contextlib.contextmanager
def _recording_first_calls(store):
    """Record (a copy of) the arguments of the first call of K2's (a
    training call, with ``saved``), K4's and K7's wrappers, and of K3's
    first call for each tower (as ``encoder_bwd/<tower>``), while the body
    runs; the wrappers still count."""
    from c2dsr_tpu_torch.ops import encoder_cuda, fused_ce_cuda, segsum_cuda
    saved = []
    for mod, name in ((encoder_cuda, "encoder_fwd"),
                      (encoder_cuda, "encoder_bwd"), (fused_ce_cuda, "ce_fwd"),
                      (segsum_cuda, "segsum")):
        orig = getattr(mod, name)

        def rec(*args, _orig=orig, _name=name, **kw):
            key = (f"{_name}/{kw.get('tower', 0)}" if _name == "encoder_bwd"
                   else _name)
            if key not in store and (_name != "encoder_fwd"
                                     or kw.get("saved") is not None):
                store[key] = _clone((args, {k: v for k, v in kw.items()
                                            if k != "saved"}))
            return _orig(*args, **kw)

        # the wrapper counts its launches under its module name, which now
        # names the recorder
        rec.launches = orig.launches
        setattr(mod, name, rec)
        saved.append((mod, name, orig))
    try:
        yield
    finally:
        for mod, name, orig in saved:
            orig.launches = getattr(mod, name).launches
            setattr(mod, name, orig)


def _shard_kernels_against_plain(calls, graphs, row_map):
    """This rank's kernels on the sharded path's own inputs against their
    plain versions: K4/K5 at the vocab shard's width (CE_TOL, CE_BWD_TOL),
    K2/K3 on the step's first tower call (its input, weights and output
    gradient) at dropout 0.2 under the rank's dropout row map (K2 against
    the float64 plain tower, see below; K3 GRAD_TOL at K2's branches), K1
    over the all-to-all plan's local CSR of each graph and its transpose
    (SPMM_TOL), K7 on the first sharded lookup's gradient (bitwise CPU
    index_add_).  Returns the errors."""
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import (encoder_cuda, fused_ce, fused_ce_cuda,
                                     segsum_cuda, spmm, spmm_cuda)
    errs = {}
    (h, w, bm, pad, t), _ = calls["ce_fwd"]
    with torch.no_grad():
        lse, tlog = fused_ce_cuda.ce_fwd(h, w, bm, pad, t)
        rlse, rtlog = fused_ce.ce_fwd_plain(h, w, bm, pad, t)
        hit = t < w.shape[1]
        errs["ce_fwd"] = max(_rel(lse, rlse), _rel(tlog[hit], rtlog[hit]))
        g = torch.Generator("cuda").manual_seed(5)
        dlse = torch.randn(h.shape[0], device="cuda", generator=g) / h.shape[0]
        dt = torch.randn(h.shape[0], device="cuda", generator=g) / h.shape[0]
        got = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, t)
        want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, t)
        errs["ce_bwd"] = max(_rel(a, b) for a, b in zip(got, want))
    errs["ce_shape"] = [int(h.shape[0]), int(w.shape[1])]
    check(errs["ce_fwd"] <= CE_TOL, f"K4 at the shard width: rel err "
          f"{errs['ce_fwd']} > {CE_TOL}")
    check(errs["ce_bwd"] <= CE_BWD_TOL, f"K5 at the shard width: rel err "
          f"{errs['ce_bwd']} > {CE_BWD_TOL}")

    # K2/K3 on the rank's first tower call of the step as recorded: its x,
    # seq and weights, and the gradient its backward received, at dropout
    # 0.2 under the rank's row map.  The step's tower input (std ~13, against
    # 4 in phase_encoder) makes the attention logits ~10x larger, and f32
    # rounding of them moves the softmax: on an H100 the plain f32 tower is
    # 2.5e-5 to 3.3e-5 relative from float64 there, above ENCODER_REL_TOL,
    # so two f32 towers differ by as much.  K2 is therefore held to the
    # float64 plain tower, within the larger of ENCODER_REL_TOL and 2x the
    # plain f32 tower's own error (the serving gate's rule), on query rows
    # with an allowed key (_fwd_errs: all-masked rows reported apart); its
    # distance from the plain f32 tower is reported beside.
    (x, seq, p), kw = calls["encoder_fwd"]
    kw = dict(kw, dropout=0.2, seed=77, row_map=row_map)
    gout = calls[f"encoder_bwd/{kw['tower']}"][0][2]
    pad, invert = kw["idx_pad"], kw["invert_padding_mask"]
    acts = encoder_cuda.saved_buffer(x, kw["n_head"], 1)
    with torch.no_grad():
        out = encoder_cuda.encoder_fwd(x, seq, p, saved=acts, **kw)
        ref = enc.encoder_fwd_plain(x, seq, p, **kw)
        ref64 = enc.encoder_fwd_plain(
            x.double(), seq, params_mod._map(lambda t: t.double(), p), **kw)
    got = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts, **kw)
    rels, _, _ = _k3_against_plain(x, seq, gout, p, acts, kw["n_head"], 1,
                                   kw, got)
    k2_64, dead, n_dead = _fwd_errs(out.double(), ref64, seq, pad, invert)
    errs.update(
        x_std=float(x.std()), encoder_fwd_rel_f64=k2_64,
        plain_rel_f64=_fwd_errs(ref.double(), ref64, seq, pad, invert)[0],
        encoder_fwd_rel_plain=_fwd_errs(out, ref, seq, pad, invert)[0],
        encoder_fwd_dead_abs=dead, encoder_fwd_dead_rows=n_dead,
        encoder_bwd=max(rels.values()))
    tol = max(ENCODER_REL_TOL, 2 * errs["plain_rel_f64"])
    check(errs["encoder_fwd_rel_f64"] <= tol, f"K2 with the row map "
          f"{row_map} on the step's inputs: relative err against float64 "
          f"{errs['encoder_fwd_rel_f64']} > {tol} (the plain f32 tower's "
          f"{errs['plain_rel_f64']})")
    check(errs["encoder_bwd"] <= GRAD_TOL, f"K3 with the row map {row_map} "
          f"on the step's inputs: rel err {errs['encoder_bwd']} > {GRAD_TOL}")

    errs["spmm_csr"] = 0.0
    for graph, d in ((graphs.share, 128), (graphs.specific, 256)):
        for csr in (graph.a2a.csr, graph.a2a.csr.t):
            n_in = int(csr.cols.max()) + 1 if csr.cols.numel() else 1
            buf = torch.randn(n_in, d, device="cuda",
                              generator=torch.Generator("cuda").manual_seed(d))
            with torch.no_grad():
                got = spmm_cuda.spmm_csr(csr, buf, n_out=csr.n)
                want = spmm.spmm_reference(csr, buf, n_out=csr.n)
            errs["spmm_csr"] = max(errs["spmm_csr"], _rel(got, want))
    check(errs["spmm_csr"] <= SPMM_TOL, f"K1 over the a2a plan's CSR: rel "
          f"err {errs['spmm_csr']} > {SPMM_TOL}")

    (ids, gk, n_rows), _ = calls["segsum"]
    got = segsum_cuda.segsum(ids, gk, n_rows).cpu()
    want = torch.zeros(n_rows, gk.shape[1]).index_add_(0, ids.cpu(), gk.cpu())
    errs["segsum"] = float((got - want).abs().max())
    errs["segsum_zero_rows"] = int((gk.abs().sum(1) == 0).sum())
    check(torch.equal(got, want), "K7 on a sharded lookup's gradient: not "
          "bitwise CPU index_add_")
    return errs


def _parallel_rank(rank, world, job):
    """One rank of the parallel phase, started by ``parallel/launch`` on the
    one card, the ranks talking over gloo.  At FK geometry and the default
    Config (dropout 0 for the gate): the eval ranks of both modes, then one
    train step on its rows of the global batch; the kernels' launches of
    each; on rank 0 the one-process kernel step's loss and gradients
    against the mesh's (gathered), and the same with the sharded gradients
    scaled by M, which must fail; then on every rank its kernels against
    their plain versions on the sharded path's inputs."""
    global gates, timing
    from c2dsr_tpu_torch.bench import gates, timing
    from c2dsr_tpu_torch.config import Config, padded_sizes
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import spmm
    from c2dsr_tpu_torch.parallel import mesh as mesh_mod, strategy
    from c2dsr_tpu_torch.train import optim
    from c2dsr_tpu_torch.train import step as step_mod
    n_data, n_model = job["mesh"]
    mesh = mesh_mod.make_mesh(n_data, n_model)
    dev = torch.device("cuda", torch.cuda.current_device())
    spec = job["spec"]
    cfg = Config(mesh_data=n_data, mesh_model=n_model,
                 lookup_mode=job["lookup_mode"], dropout_gnn=0.0,
                 dropout_attn=0.0)
    t0 = time.perf_counter()
    n_p = padded_sizes(cfg, spec)[0]
    graphs = c2dsr.Graphs(*(spmm.attach_a2a_plan(spmm.device_graph(g, dev),
                                                 n_p, n_model,
                                                 mesh.model_index)
                            for g in job["graphs"]))
    whole = params_mod.init_params(cfg, spec, torch.Generator().manual_seed(0),
                                   dev)
    params = mesh_mod.shard_params(whole, mesh)
    opt = optim.make_optimizer(cfg, steps_per_epoch=10)
    state = step_mod.init_state(params, opt, mesh)
    fn = step_mod.make_train_step(cfg, spec, graphs, opt, dev, mesh=mesh)
    local = mesh_mod.local_batch(job["batch"], mesh)
    out = {"setup_s": time.perf_counter() - t0}

    # the eval ranks from the initial params (the one-process ranks' too)
    convolve, rank_step = ranker.make_eval_fns(cfg, spec, graphs, dev,
                                               mesh=mesh)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    hi = convolve(state.params)
    ranks = {m: ranker.evaluate_split(
        state.params, hi, job["eval"], rank_step, cfg, m,
        to_global=lambda c: mesh_mod.eval_slice(c, mesh))
        for m in ("sampled", "full")}
    torch.cuda.synchronize()
    out["eval_s"] = time.perf_counter() - t0
    out["eval_launches"] = read_launches()
    del hi

    calls = {}
    reset_launches()
    t0 = time.perf_counter()
    with _recording_first_calls(calls):
        state, aux = fn(state, local)
    torch.cuda.synchronize()
    out["step_s"] = time.perf_counter() - t0
    out["step_launches"] = read_launches()
    out["loss"] = float(aux["loss"])
    grads = mesh_mod.unshard_params(
        params_mod._map(lambda t: t.grad, state.params), mesh)
    if rank == 0:
        out["ranks"] = ranks
        # the one-process kernel step from the same params and batch
        leaves = step_mod.param_leaves(whole)
        for t in leaves:
            t.requires_grad_(True)
        ref_loss, ref_grads = _loss_grads(
            whole, leaves, c2dsr.Graphs(*(g._replace(a2a=None)
                                          for g in graphs)),
            ranker.to_device(job["batch"], dev),
            cfg.with_(mesh_data=1, mesh_model=1), spec,
            contextlib.nullcontext())
        names = leaf_names(whole)
        got = step_mod.param_leaves(grads)
        sharded = [mesh_mod.shard_dim(n.split(".")[0]) is not None
                   for n in names]
        errs = [_rel(a, b) for a, b in zip(got, ref_grads)]
        bad = [_rel(a * (n_model if sh else 1), b)
               for a, b, sh in zip(got, ref_grads, sharded)]
        out["loss_ref"] = ref_loss
        out["grad_err"] = max(errs)
        out["grad_worst"] = names[int(np.argmax(errs))]
        out["grad_err_scaled"] = max(bad)
    out["shard_kernels"] = _shard_kernels_against_plain(
        calls, graphs, strategy.make_ops(cfg, mesh).dropout_rows(
            local["seq_share"].shape[0]))
    return out


def _row_map_rows():
    """K2 and K3 under the towers' dropout row map on the card: a data
    rank's rows of the shared tower's stacked call (2 data ranks, a local
    batch of 256 of 512, three segments), at dropout 0.2, give the
    one-process call's rows (K2's output and K3's dx, ENCODER_TOL and
    GRAD_TOL relative); without the map the rank's rows draw rank 0's
    masks and differ (the gate can fail).  Returns the errors."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import dropout as drop
    from c2dsr_tpu_torch.ops import encoder_cuda
    B, m, L, d, pad = 512, 256, LEN_MAX, 128, 64093
    p = params_mod._map(lambda t: t.cuda(), params_mod.init_encoder_params(
        torch.Generator().manual_seed(31), Config(), L))
    x, seq = _encoder_inputs(3 * B, L, d, pad, seed=31)
    gout = torch.randn(x.shape, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(4))
    kw = dict(idx_pad=pad, n_head=1, invert_padding_mask=False, dropout=0.2,
              seed=99, tower=0)

    def run(rows, rmap):
        xs, ss, gs = (t[rows].contiguous() for t in (x, seq, gout))
        acts = encoder_cuda.saved_buffer(xs, 1, 1)
        with torch.no_grad():
            out = encoder_cuda.encoder_fwd(xs, ss, p, saved=acts,
                                           row_map=rmap, **kw)
        dx, _ = encoder_cuda.encoder_bwd(xs, ss, gs, p, saved=acts,
                                         row_map=rmap, **kw)
        return out, dx

    full_out, full_dx = run(slice(None), None)
    rows = torch.cat([torch.arange(s * B + m, s * B + 2 * m)
                      for s in range(3)]).cuda()
    out, dx = run(rows, drop.row_map(m, m, B))
    bad_out, _ = run(rows, None)
    errs = {"fwd": float((out - full_out[rows]).abs().max()),
            "dx": _rel(dx, full_dx[rows]),
            "fwd_without_map": float((bad_out - full_out[rows]).abs().max())}
    log(f"row map on the card: data rank 1's rows of the shared tower "
        f"(3 x {m} of 3 x {B}) at dropout 0.2: K2 max abs err "
        f"{errs['fwd']:.3e}, K3 dx rel err {errs['dx']:.3e} against the "
        f"one-process call's rows; without the map K2 {errs['fwd_without_map']:.3e}")
    check(errs["fwd"] <= ENCODER_TOL and errs["dx"] <= GRAD_TOL,
          f"K2/K3 under the row map differ from the one-process rows: {errs}")
    check(errs["fwd_without_map"] > 100 * ENCODER_TOL, "K2 without the row "
          "map draws the one-process masks: the gate cannot fail")
    return errs


def _ce_shard_times(N, V, timer, peak_flops, peak_bw, gpu):
    """K4 and K5 at one rank's vocab shard (N rows, d 128, V columns), each
    timed with its plain version and one library call (cuBLAS
    ``logsumexp`` of ``h @ w + b``, and its autograd), with the 3xTF32
    bound: the ms of each, one process alone on the card."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    d = 128
    h, w, bm, pad_l, tgt, real, dlse, dt = _ce_inputs(N, d, V, V, V + N)
    hg, wg, bg = (t.detach().clone().requires_grad_(True) for t in (h, w, bm))
    with torch.no_grad():
        lse, _ = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)
        f = {"ms": timer(lambda: fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)),
             "plain_ms": timer(lambda: fused_ce.ce_fwd_plain(h, w, bm, pad_l,
                                                             tgt)),
             "library_ms": timer(lambda: torch.logsumexp(
                 torch.cat([h @ w + bm, pad_l[:, None]], 1), 1))}
        b = {"ms": timer(lambda: fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt,
                                                      tgt)),
             "plain_ms": timer(lambda: fused_ce.ce_bwd_plain(
                 h, w, bm, lse, dlse, dt, tgt))}
    lib_out = torch.logsumexp(torch.cat([hg @ wg + bg, pad_l[:, None]], 1), 1)
    b["library_ms"] = timer(lambda: torch.autograd.grad(
        lib_out, [hg, wg, bg], dlse, retain_graph=True))
    del lib_out
    io = 4 * (N * d + d * V + V + 3 * N)
    f["bound_ms"] = timing.tc_bound_ms(2 * N * V * d, io + 8 * N, gpu,
                                       peak_bw)
    b["bound_ms"] = timing.tc_bound_ms(4 * N * V * d, 2 * io + 4 * N * d,
                                       gpu, peak_bw)
    return {"N": N, "V": V, "fwd": f, "bwd": b}


def phase_parallel(spec, graphs_host, graphs, train, eval_data, timer,
                   peak_flops, peak_bw, gpu):
    """The mesh on the one card: 2 ranks (1x2, psum lookups) and 4 ranks
    (2x2, a2a lookups) over gloo, each a process of its own
    (``parallel/launch``; the kernels are built, the ranks load them), at FK
    geometry and the default Config.  Gates: the step's loss within 1e-5
    relative and every gathered gradient within GRAD_TOL of the
    one-process kernel step (and the same gradients with the sharded ones
    scaled by M fail); each rank's kernels against their plain versions on
    the sharded path's inputs; the mesh's ranks equal to the one-process
    kernels' but at near-ties (bench/gates.near_ties).  Then K4/K5 timed at
    the shard widths, one process alone.  Returns ({path: summed launches},
    the shard times, the errors)."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.parallel import launch
    cfg = Config()
    batch = {k: v[:cfg.batch_size] for k, v in train.items()}
    data = {k: v[:PAR_EVAL_ROWS] for k, v in eval_data.items()}
    row_map = _row_map_rows()
    groups = ranker.partition_by_domain(data)

    # the one-process kernels' ranks and the near-tie bands
    params = params_mod.init_params(cfg, spec,
                                    torch.Generator().manual_seed(0), "cuda")
    convolve, rank_step = ranker.make_eval_fns(cfg, spec, graphs, "cuda")
    with torch.inference_mode():
        hi = convolve(params)
        with gates.plain_versions():
            hi_plain = convolve(params)
    hi64 = gates.convolve_float64(params, graphs, cfg, spec)
    ranks_one, ties = {}, {}
    for mode in ("sampled", "full"):
        ranks_one[mode] = ranker.evaluate_split(params, hi, data, rank_step,
                                                cfg, mode)
        ties[mode] = gates.near_ties(params, hi, hi_plain, hi64, data, cfg,
                                     spec, mode)[0]
    del params, hi, hi_plain, hi64
    torch.cuda.empty_cache()

    launches, errs = {}, {}
    for shape, lookup_mode in PAR_MESHES:
        world = shape[0] * shape[1]
        tag = f"{shape[0]}x{shape[1]}"
        job = {"mesh": shape, "lookup_mode": lookup_mode, "spec": spec,
               "graphs": graphs_host, "batch": batch, "eval": data}
        t0 = time.perf_counter()
        try:
            res = launch.run_ranks(_parallel_rank, world, (job,),
                                   device="cuda", timeout=PAR_TIMEOUT)
        except (RuntimeError, TimeoutError) as e:
            raise SmokeFailure(f"parallel {tag}: {e}")
        r0 = res[0]
        log(f"parallel {tag} ({lookup_mode} lookups, {world} ranks sharing "
            f"one card over gloo): {time.perf_counter() - t0:.1f} s; rank 0 "
            f"setup {r0['setup_s']:.1f} s, step {r0['step_s'] * 1e3:.1f} ms "
            f"(first, host clock), eval {r0['eval_s']:.2f} s")
        rel = abs(r0["loss"] - r0["loss_ref"]) / abs(r0["loss_ref"])
        log(f"parallel {tag} step at dropout 0: loss {r0['loss']:.7f} "
            f"against the one-process kernel step's {r0['loss_ref']:.7f} "
            f"(rel {rel:.3e}); gathered gradients worst rel err "
            f"{r0['grad_err']:.3e} ({r0['grad_worst']}); with the sharded "
            f"gradients scaled by {shape[1]}: {r0['grad_err_scaled']:.3e}")
        check(rel <= 1e-5, f"parallel {tag}: loss rel err {rel} > 1e-5")
        check(r0["grad_err"] <= GRAD_TOL, f"parallel {tag}: gradient "
              f"{r0['grad_worst']} rel err {r0['grad_err']} > {GRAD_TOL}")
        check(r0["grad_err_scaled"] > GRAD_TOL, f"parallel {tag}: gradients "
              "scaled by M pass the gradient gate")
        for mode in ("sampled", "full"):
            got = r0["ranks"][mode]
            check(len(got[0]) == len(ranks_one[mode][0])
                  and len(got[1]) == len(ranks_one[mode][1]),
                  f"parallel {tag} {mode}: an example lost its rank")
            n_diff, n_masked, n_bad = gates.rank_differences(
                got, ranks_one[mode], ties[mode], groups)
            log(f"parallel {tag} ranks {mode}: {n_diff} of "
                f"{len(got[0]) + len(got[1])} differ from the one-process "
                f"kernels' ({n_masked} at all-masked rows), {n_bad} not "
                "explained by a near-tie")
            check(n_bad == 0, f"parallel {tag} {mode}: {n_bad} ranks differ "
                  "beyond near-ties")
        for rank, r in enumerate(res):
            k = r["shard_kernels"]
            log(f"parallel {tag} rank {rank}'s kernels on the sharded path "
                f"against their plain versions: K4 at N x V/M = "
                f"{k['ce_shape']} rel {k['ce_fwd']:.3e}, K5 "
                f"{k['ce_bwd']:.3e}; K2 on the step's tower input (std "
                f"{k['x_std']:.2f}) with the row map at dropout 0.2, "
                f"relative on rows with an allowed key: against float64 "
                f"{k['encoder_fwd_rel_f64']:.3e} (plain f32 "
                f"{k['plain_rel_f64']:.3e}), against plain f32 "
                f"{k['encoder_fwd_rel_plain']:.3e}, abs "
                f"{k['encoder_fwd_dead_abs']:.3e} on "
                f"{k['encoder_fwd_dead_rows']} all-masked rows; K3 rel "
                f"{k['encoder_bwd']:.3e}; K1 over the a2a CSRs rel "
                f"{k['spmm_csr']:.3e}; K7 bitwise ({k['segsum_zero_rows']} "
                "zero gradient rows of the masked ids skipped)")
        k = {n: max(r["shard_kernels"][n] for r in res)
             for n in ("ce_fwd", "ce_bwd", "encoder_fwd_rel_f64",
                       "plain_rel_f64", "encoder_fwd_rel_plain",
                       "encoder_bwd", "spmm_csr")}
        total = {}
        for r in res:
            for part in ("step_launches", "eval_launches"):
                for n, v in r[part].items():
                    total[n] = total.get(n, 0) + v
        log(f"parallel {tag} launches over the ranks (step + eval): {total}")
        launches[f"parallel_{tag}"] = total
        errs[tag] = dict(k, row_map=row_map)
    t0 = time.perf_counter()
    times = []
    # a rank's CE rows (its batch rows x 2 len_rec) and vocab shard: 1x2 and
    # 2x2 as above, and 1x4, the model axis of a four-card mesh
    for tag, N, n_model in (("1x2", 512 * 2 * 10, 2), ("2x2", 256 * 2 * 10, 2),
                            ("1x4", 512 * 2 * 10, 4)):
        for V in (30720, 36864):
            r = _ce_shard_times(N, V // n_model, timer, peak_flops, peak_bw,
                                gpu)
            r["mesh"] = tag
            times.append(r)
            log(f"ce at the shard width of {tag} (one process alone) N {N} V "
                f"{V // n_model}: K4 {r['fwd']['ms']:.4f} ms plain "
                f"{r['fwd']['plain_ms']:.4f} library "
                f"{r['fwd']['library_ms']:.4f} bound "
                f"{r['fwd']['bound_ms']:.4f}; K5 {r['bwd']['ms']:.4f} plain "
                f"{r['bwd']['plain_ms']:.4f} library "
                f"{r['bwd']['library_ms']:.4f} bound "
                f"{r['bwd']['bound_ms']:.4f}")
    log(f"phase parallel ce shard times: {time.perf_counter() - t0:.1f} s")
    return launches, times, errs


def phase_parallel_cli():
    """``python -m c2dsr_tpu_torch.cli --synthetic 2000 --mesh_model 2`` for
    one epoch with a checkpoint (the CLI starts its two ranks on the card),
    then the same resumed on one process for a second epoch."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_DIR] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as tmp:
        base = [sys.executable, "-m", "c2dsr_tpu_torch.cli", "--synthetic",
                str(CLI_USERS), "--ckpt", os.path.join(tmp, "ckpt")]
        for extra, want in ((["--n_epoch", "1", "--mesh_model", "2"],
                             "x 2 ranks (mesh 1x2)"),
                            (["--n_epoch", "2", "--resume"],
                             "resumed from")):
            t0 = time.perf_counter()
            run = subprocess.run(base + extra, cwd=tmp, env=env,
                                 capture_output=True, text=True, timeout=600)
            secs = time.perf_counter() - t0
            check(run.returncode == 0, f"cli {extra} exited "
                  f"{run.returncode}: {run.stderr[-2000:]}")
            check(want in run.stdout and "[ Test result ]" in run.stdout,
                  f"cli {extra}: no '{want}' or no final result table")
            check(os.path.isfile(os.path.join(tmp, "ckpt", "meta.json")),
                  "cli wrote no checkpoint")
            table = run.stdout[run.stdout.rindex("[ Test result ]"):]
            log(f"cli: {' '.join(base[1:] + extra)} exited 0 in {secs:.1f} "
                f"s; test result {table.splitlines()[2].strip()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    global timing, gates
    if sys.argv[1:2] == ["--rates"]:
        timing = _load_timing()
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        print(json.dumps(measure_rates()), flush=True)
        return 0
    try:
        from c2dsr_tpu_torch.bench import gates, timing
        from c2dsr_tpu_torch.config import DataSpec
        from c2dsr_tpu_torch.data import preprocess, synthetic
        from c2dsr_tpu_torch.graph import build as graph_build
        from c2dsr_tpu_torch.kernels import build
        from c2dsr_tpu_torch.ops import backend, spmm
    except ImportError as e:
        print(f"chip_smoke: the c2dsr_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--compare"]:
        return compare(os.path.abspath(sys.argv[2]))
    t_start = time.perf_counter()
    backend.resolve_device("cuda")
    card = timing.card_line()
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = timing.peaks(name)
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
    timer = timing.Timer()
    with torch.inference_mode():
        k1 = phase_spmm(graphs, timer, peak_flops, peak_bw)
        k1t = phase_spmm(graphs, timer, peak_flops, peak_bw, transpose=True)
        k6 = phase_spmm_flagged(graphs, train, timer, peak_flops, peak_bw)
    k2 = phase_encoder(timer, peak_flops, peak_bw, name)
    k2t, k3 = phase_encoder_train(timer, peak_flops, peak_bw, name)
    k4, k5 = phase_ce(timer, peak_flops, peak_bw, name)
    t0 = time.perf_counter()
    wide = phase_shapes()
    log(f"phase shapes: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ce_wide = phase_ce_wide(timer, peak_flops, peak_bw, name)
    log(f"phase ce wide: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serving = phase_main(spec, graphs_host, eval_data)
    log(f"phase serving: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    from c2dsr_tpu_torch.config import Config
    serving_wide = phase_main(spec, graphs_host, eval_data,
                              Config(d_latent=512), label="serving d 512")
    log(f"phase serving d_latent 512: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    training, train_rate = phase_train(spec, train, graphs)
    log(f"phase training: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    training_wide = phase_train_wide(spec, train, graphs, graphs_host)
    log(f"phase training wide: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reset_launches()
    k7, atomics = phase_determinism(spec, train, graphs, timer, peak_bw)
    determinism = read_launches()
    log(f"phase determinism: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    par_launches, par_times, par_errs = phase_parallel(
        spec, graphs_host, graphs, train, eval_data, timer, peak_flops,
        peak_bw, name)
    log(f"phase parallel: {time.perf_counter() - t0:.1f} s")
    del timer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    experiment, exp_rates = phase_experiment(spec, train, eval_data, graphs,
                                             card)
    log(f"phase experiment: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_cli()
    log(f"phase cli: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_parallel_cli()
    log(f"phase parallel cli: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bench, bench_launches = phase_bench()
    log(f"phase bench: {time.perf_counter() - t0:.1f} s")
    paths = {"serving": serving, "serving_d512": serving_wide,
             "training": training, "training_wide": training_wide,
             "experiment": experiment, "determinism": determinism,
             **par_launches,
             **{f"bench_{k}": v for k, v in bench_launches.items()}}
    step_kernels = ("spmm_csr", "encoder_fwd", "encoder_bwd", "ce_fwd",
                    "ce_bwd", "segsum")
    for path, kernels_of_path in (
            ("serving", ("spmm_csr", "encoder_fwd")),
            ("serving_d512", ("spmm_csr", "encoder_fwd")),
            ("training", step_kernels), ("training_wide", step_kernels),
            ("experiment", ("spmm_csr_flagged",) + step_kernels),
            ("determinism", step_kernels),
            ("parallel_1x2", step_kernels), ("parallel_2x2", step_kernels),
            ("bench_headline", step_kernels),
            ("bench_kernels", step_kernels + ("spmm_csr_flagged",)),
            ("bench_ce_variants", ("ce_fwd_variant", "ce_fwd")),
            ("bench_scaled", ("ce_fwd", "ce_bwd", "segsum")),
            ("bench_batches", step_kernels)):
        check(all(paths[path][n] > 0 for n in kernels_of_path),
              f"a kernel never launched on the {path} path: {paths[path]}")
    by_variant = bench_launches["ce_variants"]["by_variant"]
    check(all(by_variant.get(v, 0) > 0 for v in ("base", "nomatch", "exp2",
                                                  "bf16exp", "matmulonly")),
          f"a CE variant never launched: {by_variant}")

    def counts(name):
        return {"launches": sum(p[name] for p in paths.values()),
                "launches_by_path": {k: p[name] for k, p in paths.items()
                                     if p[name]}}

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
         "a2a_local_csr_max_rel_err": max(e["spmm_csr"]
                                          for e in par_errs.values()),
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
         "max_rel_err": k2["max_rel_err"],
         **{k: k2[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by", "bound_ffma_ms",
                               "launches_per_call", "kernels_ms")},
         "train": k2t,
         "mesh_step_inputs": {
             n: max(e[n] for e in par_errs.values())
             for n in ("encoder_fwd_rel_f64", "plain_rel_f64",
                       "encoder_fwd_rel_plain")},
         "wide_shapes_max_abs_err": wide["encoder_fwd"],
         "wide_shapes_max_rel_err": wide["encoder_fwd_rel"],
         "note": "eval: one tower at B 2048, L 15, d 128; train: the three "
                 "towers of a step (B 1536, 512, 512) at dropout 0.2, "
                 "saving the activations K3 reads (ms_without_saving "
                 "beside); a sequence of kernels over all rows, 3xTF32 "
                 "GEMMs on the tensor cores; bound_ms the 3xTF32 "
                 "tensor-core bound (3*(12*N*d^2 + 4*N*L*d) TF32 FLOPs at "
                 "495 TFLOP/s, or the bytes; train bytes count the saved "
                 "activations), bound_ffma_ms the FP32 FFMA one; "
                 "launches_per_call the CUDA kernels of one tower call, "
                 "kernels_ms the profiled split"},
        {"name": "encoder_bwd", "route": "cuda",
         "source": "c2dsr_tpu_torch/csrc/encoder_bwd.cu",
         "replaces": "c2dsr_tpu/ops/encoder_pallas.py:477",
         **counts("encoder_bwd"), **k3,
         "mesh_step_inputs_max_rel_err": max(e["encoder_bwd"]
                                             for e in par_errs.values()),
         "wide_shapes_max_rel_err": wide["encoder_bwd"],
         "note": "the three towers of a step (B 1536, 512, 512), L 15, "
                 "d 128, dropout 0.2, from the activations K2 saves: "
                 "tensor-core GEMMs (3xTF32), attention per sequence, "
                 "weight gradients over row splits summed in order; "
                 "library: nn.TransformerEncoder forward + backward in "
                 "train mode; bound_ms the 3xTF32 tensor-core bound "
                 "(3*(24*N*d^2 + 8*N*L*d) TF32 FLOPs at 495 TFLOP/s), "
                 "bound_ffma_ms the FP32 FFMA one; launches_per_call the "
                 "CUDA kernels of one tower call, kernels_ms the profiled "
                 "split"},
        {"name": "ce_fwd", "route": "cuda",
         "source": "c2dsr_tpu_torch/csrc/ce.cu",
         "replaces": "c2dsr_tpu/ops/fused_ce.py:263",
         **counts("ce_fwd"), **k4, "d256_max_rel_err": wide["ce_fwd"],
         "shard_widths": [{"mesh": t["mesh"], "N": t["N"], "V": t["V"],
                           **t["fwd"]} for t in par_times],
         "shard_max_rel_err": max(e["ce_fwd"] for e in par_errs.values()),
         "d384": {k: v for k, v in ce_wide[384].items() if "fwd" in k},
         "d512": {k: v for k, v in ce_wide[512].items() if "fwd" in k},
         "note": "both domains of a step: N 10240, d 128, V 30720 + 36864; "
                 "3xTF32 on the tensor cores; bound_ms the 3xTF32 tensor-core "
                 "bound (3*2*N*V*d TF32 FLOPs at 495 TFLOP/s), bound_ffma_ms "
                 "the FP32 FFMA one (2*N*V*d at 67); kernels_ms the "
                 "profiled split"},
        {"name": "ce_bwd", "route": "cuda",
         "source": "c2dsr_tpu_torch/csrc/ce.cu",
         "replaces": "c2dsr_tpu/ops/fused_ce.py:308",
         **counts("ce_bwd"), **k5, "d256_max_rel_err": wide["ce_bwd"],
         "shard_widths": [{"mesh": t["mesh"], "N": t["N"], "V": t["V"],
                           **t["bwd"]} for t in par_times],
         "shard_max_rel_err": max(e["ce_bwd"] for e in par_errs.values()),
         "d384": {k: v for k, v in ce_wide[384].items() if "bwd" in k},
         "d512": {k: v for k, v in ce_wide[512].items() if "bwd" in k},
         "note": "dh and dW/db kernels (3xTF32 on the tensor cores), both "
                 "domains of a step; also replaces fused_ce.py:339 and "
                 ":360; bound_ms is the 3xTF32 tensor-core bound "
                 "(3*4*N*V*d TF32 FLOPs at 495 TFLOP/s), bound_ffma_ms "
                 "the FP32 FFMA one (4*N*V*d at 67); kernels_ms the "
                 "profiled split"},
        {"name": "segsum", "route": "cuda",
         "source": "c2dsr_tpu_torch/csrc/segsum.cu",
         "replaces": "no Pallas kernel: the backward of the lookups "
                     "(c2dsr_tpu_torch/parallel/strategy.py LocalOps.lookup, "
                     "jnp.take in the JAX package)",
         **counts("segsum"),
         "max_abs_err": max(c["max_abs_err"] for c in
                            k7["calls"] + list(k7["all_nonzero"].values())),
         **{k: k7["step"][k] for k in ("ms", "plain_ms", "library_ms",
                                       "bound_ms")},
         "kernel_launches_a_step": k7["step"]["launches"],
         "bound_by": max((k7["items"], k7["positions"]),
                         key=lambda r: r["bound_ms"])["bound_by"],
         "items": k7["items"], "positions": k7["positions"],
         "calls": k7["calls"], "all_nonzero_rows": k7["all_nonzero"],
         **atomics,
         "note": "K7, the ordered segment sum: the six calls of one FK "
                 "train step's backward on the gradients the step makes "
                 "(items: the shared tower's 23,040 ids into the item "
                 "table; positions: into the 15-row position table); ms "
                 "K7's launches; plain index_add_ on the card (atomics, not "
                 "repeatable); library index_add_ under "
                 "torch.use_deterministic_algorithms(True); bound_ms the "
                 "sum over the calls of the larger of the byte bound and "
                 "the order bound (the longest chain of non-zero rows into "
                 "one table row, a FADD latency each: operations); "
                 "max_abs_err against CPU index_add_ (bitwise), the most "
                 "over the step's calls and all_nonzero_rows; "
                 "kernel_launches_a_step the step profile's K7 kernels, "
                 "launches_per_call each call's profiled kernels; "
                 "all_nonzero_rows: the same 23,040 ids with random "
                 "gradient rows, none of them zero"},
    ]
    variants = bench["ce_variants"]["shapes"]
    for v in ("base", "nomatch", "exp2", "bf16exp", "matmulonly"):
        r = variants[0]["variants"][v]
        kernels.append({
            "name": f"ce_fwd_variants/{v}", "route": "cuda",
            "source": "c2dsr_tpu_torch/csrc/ce_variants.cu",
            "replaces": "bench/ce_experiments.py:105",
            "launches": bench_launches["ce_variants"]["by_variant"][v],
            "max_abs_err": r["max_abs_err"],
            **{k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_ffma_ms", "unphysical")},
            "bound_by": "operations",
            "fk_shapes": [{"V": sh["V"], **{k: sh["variants"][v][k] for k in
                                            ("ms", "plain_ms", "bound_ms")}}
                          for sh in variants[1:]],
            "note": "K4's variant at the JAX script's shape, N 10240, d 128, "
                    "V 64512 (fk_shapes: V 30720 and 36864); ms the call "
                    "(the production pre-pass, the variant's kernel, a "
                    "merge); max_abs_err of the lse against its plain "
                    "version"})
    log(f"train path: {train_rate:.1f} train examples/s (warm mean, "
        f"kernels); experiment path: {exp_rates['batch_sparse']:.1f} "
        f"batch-sparse, {exp_rates['dense']:.1f} dense")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(timing.card_line())
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
