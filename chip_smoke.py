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
7. summary: one JSON line of kernel numbers, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

The kernel phase also holds K6 against its plain version and against K1
over A and Aᵀ, with the row flags of one real training batch, and records
the share of each graph's edges that such a batch keeps.
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
TIE_TOL = 1e-5           # the least near-tie band (near_ties)
SCORE_K = 2.0            # the kernels' serving scores may lie up to this many
                         # times as far from a float64 scoring as the plain
                         # versions' (K2's GEMMs are 3xTF32, its attention
                         # dots compensated: more accurate than cuBLAS's f32)
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


def tf32_peak(name: str) -> float:
    """Dense TF32 tensor-core FLOP/s from NVIDIA's data sheets.  A 3xTF32
    product (K5's f32-accurate scheme) costs three of them."""
    if "PCIe" in name:
        return 378e12
    return 495e12                    # H100 SXM


def tc_bound_ms(flops: float, nbytes: float, name: str, peak_bw: float):
    """Least time on the tensor cores for `flops` of f32-accurate work done
    as 3xTF32, or for the bytes, whichever is larger."""
    return max(3 * flops / tf32_peak(name), nbytes / peak_bw) * 1e3


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


def _ignore_saved(fn):
    """A plain tower version called as its kernel wrapper is: the kernels'
    saved-activation buffer is passed and ignored."""
    return lambda *args, saved=None, **kw: fn(*args, **kw)


@contextlib.contextmanager
def plain_versions(branches=None):
    """Route CUDA tensors through the plain PyTorch versions instead of the
    kernels, for the comparison run of the main path; the plain tower taken
    at ``branches`` (``ops/encoder.encode_layers``) if given."""
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import (encoder_cuda, fused_ce, fused_ce_cuda,
                                     spmm, spmm_cuda)
    swaps = [(spmm_cuda, "spmm_csr", spmm.spmm_reference),
             (spmm_cuda, "spmm_csr_flagged", spmm.spmm_reference_flagged),
             (encoder_cuda, "encoder_fwd", _ignore_saved(
                 lambda *a, **kw: enc.encoder_fwd_plain(
                     *a, branches=branches, **kw))),
             (encoder_cuda, "encoder_bwd", _ignore_saved(
                 lambda *a, **kw: enc.encoder_bwd_plain(
                     *a, branches=branches, **kw))),
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


def k2_branches(saved, shape, n_head, n_layers, tower):
    """{(tower, layer): (K2's ReLU mask, K2's attention probabilities
    [B, H, L, L])} from a saved-activation buffer."""
    from c2dsr_tpu_torch.ops import encoder_cuda
    views = encoder_cuda.saved_views(saved, shape, n_head, n_layers)
    return {(tower, li): ((lv["fr"] > 0).float(),
                          lv["p"].permute(1, 0, 2, 3).clone())
            for li, lv in enumerate(views["layers"])}


@contextlib.contextmanager
def recording_k2_branches(store, calls=None):
    """The kernels as they are, with K2's branches (k2_branches) of every
    training tower call recorded into ``store`` by (tower, layer); with a
    list ``calls``, each backward call's inputs, K2's saved activations
    and K3's result appended to it (_tower_accuracy)."""
    from c2dsr_tpu_torch.ops import encoder_cuda
    fwd, bwd = encoder_cuda.encoder_fwd, encoder_cuda.encoder_bwd

    def recording(x, seq, params, *, saved=None, **kw):
        out = fwd(x, seq, params, saved=saved, **kw)
        if saved is not None:
            store.update(k2_branches(saved, x.shape, kw["n_head"],
                                     params["layers"]["w_qkv"].shape[0],
                                     kw["tower"]))
        return out

    def capturing(x, seq, gout, params, *, saved=None, **kw):
        got = bwd(x, seq, gout, params, saved=saved, **kw)
        calls.append({"x": x.detach().clone(), "seq": seq, "p": params,
                      "gout": gout.detach().clone(), "kw": kw,
                      "saved": saved.clone(), "got": got})
        return got

    # the wrappers count their launches on the module's names: carry them
    recording.launches, capturing.launches = fwd.launches, bwd.launches
    encoder_cuda.encoder_fwd = recording
    if calls is not None:
        encoder_cuda.encoder_bwd = capturing
    try:
        yield
    finally:
        fwd.launches = recording.launches
        if calls is not None:
            bwd.launches = capturing.launches
        encoder_cuda.encoder_fwd, encoder_cuda.encoder_bwd = fwd, bwd


def _k3_against_plain(x, seq, gout, p, acts, n_head, n_layers, kw, got):
    """K3's (dx, grads) ``got`` against encoder_bwd_plain: ({tensor: max
    abs error over max |plain|} at K2's branches, the same against the
    plain forward's own branches, the max abs error of the former)."""
    from c2dsr_tpu_torch.ops import encoder as enc
    matched = enc.encoder_bwd_plain(
        x, seq, gout, p, branches=k2_branches(acts, x.shape, n_head,
                                              n_layers, kw["tower"]), **kw)
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


def phase_encoder(timer, peak_flops, peak_bw, gpu):
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
    tower = _torch_tower(p, d, n_head, n_layers)
    causal = torch.triu(torch.ones(L, L, dtype=torch.bool, device="cuda"), 1)
    kpm = seq == pad
    with torch.inference_mode():
        ms = timer(lambda: encoder_cuda.encoder_fwd(x, seq, p, **kw))
        plain_ms = timer(lambda: enc.encode_layers(x, seq, p, norm_first=False,
                                                   **kw))
        library_ms = timer(lambda: tower(x, mask=causal,
                                         src_key_padding_mask=kpm))
        times, counts = kernel_times(
            lambda: encoder_cuda.encoder_fwd(x, seq, p, **kw))
    parts = _k2_parts(times)
    n_launch = int(round(sum(counts.values())))
    N = B * L
    flops = n_layers * (12 * N * d * d + 4 * N * L * d)
    nbytes = 4 * (2 * N * d + N + n_layers * (6 * d * d + 10 * d) + 2 * d)
    bound_ffma = max(flops / peak_flops, nbytes / peak_bw) * 1e3
    bound_tc = tc_bound_ms(flops, nbytes, gpu, peak_bw)
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
            "bound_by": "operations" if 3 * flops / tf32_peak(gpu)
            > nbytes / peak_bw else "bytes"}


def convolve_float64(params, graphs, cfg, spec):
    """The plain propagation in float64 from ``params``: the tables of the
    exact serving run (near_ties)."""
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.parallel.strategy import LocalOps
    cfg64 = cfg.with_(compute_dtype="float64")
    with torch.inference_mode(), plain_versions():
        return c2dsr.convolve_graph(
            params_mod._map(lambda t: t.double(), params), graphs, cfg64,
            spec, LocalOps(cfg=cfg64))


def near_ties(params, hi, hi_plain, hi64, data, cfg, spec, mode,
              params_k=None):
    """The serving ranks' tie bands, from the plain versions alone.  Per
    example, e is the largest gap over its candidates between the plain
    run's f32 scores (from the tables ``hi_plain``) and a float64 run of
    the plain path from the same params (tables ``hi64``,
    convolve_float64).  If the kernels' scores lie within SCORE_K·e of the
    float64 ones, a candidate can change
    order against the ground truth between the kernels' and the plain run
    only if its plain score lies within 2·(SCORE_K + 1)·e (at least TIE_TOL)
    of the gt's.  Returns (per domain, each example's count of such
    candidates other than the gt; the largest band; the kernels' largest
    score error against float64, from ``params_k`` (default ``params``) and
    ``hi``; the plain versions' largest; both over examples not read at an
    all-masked row)."""
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.parallel.strategy import LocalOps
    pops = LocalOps(cfg=cfg)
    cfg64 = cfg.with_(compute_dtype="float64")
    p64 = params_mod._map(lambda t: t.double(), params)
    out, widest, err_k, err_p = {}, TIE_TOL, 0.0, 0.0
    groups = ranker.partition_by_domain(data)
    with torch.inference_mode():
        for dom in ("a", "b"):
            counts = []
            for chunk, n in ranker._batches(groups[dom], cfg.batch_size_eval):
                b = ranker.to_device(chunk, "cuda")
                h = ranker._last_hidden(params_k or params, hi, b, cfg, spec,
                                        dom, pops)
                with plain_versions():
                    hp = ranker._last_hidden(params, hi_plain, b, cfg, spec,
                                             dom, pops)
                    h64 = ranker._last_hidden(p64, hi64, b, cfg64, spec, dom,
                                              LocalOps(cfg=cfg64))
                w, bias, n_real = ((params["cls_a_w"], params["cls_a_b"],
                                    spec.n_item_a) if dom == "a" else
                                   (params["cls_b_w"], params["cls_b_b"],
                                    spec.n_item_b))
                if mode == "sampled":      # the gt in column 0
                    idx = torch.cat([b["gt_last"][:, None], b["list_neg"]], 1)
                    gt_col = torch.zeros_like(idx[:, :1])
                else:
                    idx = torch.arange(n_real, device=h.device).expand(
                        h.shape[0], n_real)
                    gt_col = b["gt_last"][:, None]
                s = pops._scores(h, w, bias).gather(1, idx)
                sp = pops._scores(hp, w, bias).gather(1, idx)
                s64 = (h64 @ w.double() + bias.double()).gather(1, idx)
                e = (sp - s64).abs().amax(1, keepdim=True)
                band = torch.clamp(2 * (SCORE_K + 1) * e, min=TIE_TOL)
                c = ((sp - sp.gather(1, gt_col)).abs() <= band).sum(1) - 1
                widest = max(widest, float(band[:n].max()))
                # all-masked rows are exempt, as in _rank_differences
                real = b[f"idx_last_{dom}"][:, None] >= 0
                err_k = max(err_k, float(((s - s64).abs() * real)[:n].max()))
                err_p = max(err_p, float((e * real)[:n].max()))
                counts.append(c[:n].cpu().numpy())
            out[dom] = np.concatenate(counts)
    return out, widest, err_k, err_p


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
        with plain_versions():
            hi_plain, ranks_plain, _, _ = run_all()
        _check_ranks(params, hi, hi_plain,
                     convolve_float64(params, graphs, cfg, spec), data, cfg,
                     spec, groups, ranks, ranks_plain, n_ex, label)
        return launches

    # warm timings in turns on the same card, (plain, kernel, kernel, plain)
    # repeated, so drift falls on both alike; the gap between the two counts
    # as resolved only beyond 3 standard errors of the difference of means
    runs = {"kernel": [], "plain": []}
    ranks_plain = None
    for which in ("plain", "kernel", "kernel", "plain") * WARM_ROUNDS:
        ctx = plain_versions() if which == "plain" else contextlib.nullcontext()
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
                 convolve_float64(params, graphs, cfg, spec), data, cfg, spec,
                 groups, ranks, ranks_plain, n_ex, label,
                 perturbed=(params_q, ranks_q))
    return launches


def _rank_differences(ranks, ranks_plain, ties, groups):
    """(ranks that differ, of them at all-masked rows, not explained by a
    near-tie or an all-masked row) over both domains.  A domain tower with
    no item of its domain is read at an all-masked row: its logits are all
    -1e9 + x, rounded to steps of 64, so two summation orders may round one
    logit apart."""
    n_diff = n_masked = n_unexplained = 0
    for i, dom in enumerate(("a", "b")):
        rk, rp = np.asarray(ranks[i]), np.asarray(ranks_plain[i])
        diff = rk != rp
        masked = groups[dom][f"idx_last_{dom}"] < 0
        n_diff += int(diff.sum())
        n_masked += int((diff & masked).sum())
        n_unexplained += int(((np.abs(rk - rp) > ties[dom]) & ~masked).sum())
    return n_diff, n_masked, n_unexplained


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


def _check_ranks(params, hi, hi_plain, hi64, data, cfg, spec, groups, ranks,
                 ranks_plain, n_ex, label, perturbed=None):
    """The kernels' ranks equal the plain versions' except at near-ties
    (near_ties) and all-masked rows, both counted, and the kernels' scores
    lie within SCORE_K times the plain versions' error of the float64 ones.
    With ``perturbed`` = (params, ranks) of a kernel run with perturbed
    towers, that run must fail both gates."""
    for mode in ("sampled", "full"):
        ties, band, err_k, err_p = near_ties(params, hi, hi_plain, hi64,
                                             data, cfg, spec, mode)
        n_diff, n_masked, n_unexplained = _rank_differences(
            ranks[mode], ranks_plain[mode], ties, groups)
        n_tied = sum(int((ties[dom] > 0).sum()) for dom in ("a", "b"))
        log(f"{label} ranks {mode}: {n_diff} of {n_ex} differ from the plain "
            f"run; {n_tied} examples have a near-tie (plain scores within "
            f"the example's band, at most {band:.3e}); {n_masked} "
            f"differences at all-masked rows; {n_unexplained} differences "
            f"not explained by either; largest score error against float64: "
            f"kernels {err_k:.3e}, plain {err_p:.3e} (limit {SCORE_K:g}x)")
        check(err_k <= SCORE_K * err_p,
              f"{label} {mode}: kernels' scores {err_k} from float64, more "
              f"than {SCORE_K} x the plain versions' {err_p}")
        check(n_unexplained == 0,
              f"{label} {mode}: {n_unexplained} ranks differ beyond near-ties")
        if perturbed is None:
            continue
        _, _, err_q, _ = near_ties(params, hi, hi_plain, hi64, data, cfg,
                                   spec, mode, params_k=perturbed[0])
        _, _, n_q = _rank_differences(perturbed[1][mode], ranks_plain[mode],
                                      ties, groups)
        log(f"{label} ranks {mode}, towers' final LN bias perturbed by "
            f"{PERTURB:g}: {n_q} differences not explained, score error "
            f"against float64 {err_q:.3e}")
        check(n_q > 0 and err_q > SCORE_K * err_p,
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
        tower = _torch_tower(p, d, 1, 1, dropout=kw["dropout"])
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
            f_times, f_counts = kernel_times(
                lambda: encoder_cuda.encoder_fwd(x, seq, p, saved=acts, **kw))
        times, counts = kernel_times(
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
        f_tc = tc_bound_ms(f_flops, f_bytes, gpu, peak_bw)
        b_tc = tc_bound_ms(b_flops, b_bytes, gpu, peak_bw)
        fwd["bound_by"] = ("operations" if 3 * f_flops / tf32_peak(gpu)
                           >= f_bytes / peak_bw else "bytes")
        bwd["bound_by"] = ("operations" if 3 * b_flops / tf32_peak(gpu)
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


def kernel_times(fn, calls: int = 3):
    """({kernel name: device ms a call}, {kernel name: launches a call}) for
    a fn that launches the same kernels each call, under torch.profiler:
    the totals over ``calls`` calls over ``calls``.  The profiler may miss
    the first kernels of its window, so one profiled call is not enough.
    Names drop the argument list and the anonymous namespace, and keep
    template arguments."""
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
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ")
            total[name] = total.get(name, 0.0) + us / 1e3
            count[name] = count.get(name, 0) + ev.count
    return ({name: ms / calls for name, ms in total.items()},
            {name: n / calls for name, n in count.items()})


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
        sub = kernel_times(lambda: fused_ce_cuda.ce_fwd(h, w, bm, pad_l,
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
        sub = kernel_times(lambda: fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse,
                                                        dt, tgt))[0]
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
        f_tc = tc_bound_ms(f_flops, io + 8 * N, gpu, peak_bw)
        b_bytes = 2 * io + 4 * N * d
        b_ffma = max(4 * N * V * d / peak_flops, b_bytes / peak_bw) * 1e3
        b_tc = tc_bound_ms(4 * N * V * d, b_bytes, gpu, peak_bw)
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
        br = k2_branches(c["saved"], x.shape, n_head, n_layers, kw["tower"])
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
    longest sequences the towers take: two keys a lane in attention), each
    run with its own params and batches.  Before each step, the loss and
    every gradient from the step's params through the kernels, through the
    plain versions on the card and through the plain versions on the CPU;
    every kernel launches its count a step.

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
                               (cfg256.with_(d_latent=128), 64, 6)):
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
    schedule = (0, 0, 1, 2)        # d 256 at len_max 15, 15, 30; d 128 at 64
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
                                  recording_k2_branches(masks,
                                                        calls if i == 0
                                                        else None))
        loss_p, g_p = _loss_grads(state.params, leaves, graphs, b, cfg, sp,
                                  plain_versions(masks))
        _, g_o = _loss_grads(state.params, leaves, graphs, b, cfg, sp,
                             plain_versions())
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
                "encoder_fwd": 3, "encoder_bwd": 3, "ce_fwd": 2, "ce_bwd": 2}
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
    loss_k, g_k = grads_of(recording_k2_branches(masks))
    loss_p, g_p = grads_of(plain_versions(masks))
    _, g_o = grads_of(plain_versions())
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
    profiled steps (device busy ms, and K2's ms, each).  K2 alone at the
    serving path's tower (B 2048, L 15, d 128, one head, one layer; the
    median of 20 timed calls, 3 times).  The serving path (convolve, then
    rank the eval split in sampled and full mode): 3 profiled runs after
    one warm-up (device busy ms, and K2's ms, each)."""
    from c2dsr_tpu_torch.config import Config, DataSpec
    from c2dsr_tpu_torch.data import preprocess, synthetic
    from c2dsr_tpu_torch.data.pipeline import BatchIterator
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.graph import build as graph_build
    from c2dsr_tpu_torch.kernels import build
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import backend, encoder_cuda, spmm
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
    it = BatchIterator(preprocess.preprocess_train(seqs, spec, seed=1),
                       cfg.batch_size, shuffle=True, seed=0, drop_last=True)

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

    pad = spec.idx_pad
    p = params_mod._map(lambda t: t.cuda(), params_mod.init_encoder_params(
        torch.Generator().manual_seed(7), Config(n_head=1, n_attn=1),
        LEN_MAX))
    x, seq = _encoder_inputs(2048, LEN_MAX, cfg.d_latent, pad, seed=7)
    timer = Timer()
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

    def serve():
        hi = convolve_eval(params)
        for mode in ("sampled", "full"):
            ranker.evaluate_split(params, hi, data, rank_step, cfg, mode)
        torch.cuda.synchronize()

    serve()
    serve_busy, serve_k2 = _busy_ms(serve)
    return {"rates": rates, "host_ms": host, "busy_ms": busy, "k2_ms": k2,
            "k2_eval_ms": k2_eval, "serve_busy_ms": serve_busy,
            "serve_k2_ms": serve_k2}


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
                      ("busy_ms", "ms busy a train step"),
                      ("k2_ms", "ms of K2 a train step"),
                      ("k2_eval_ms", "ms a K2 serving tower"),
                      ("serve_busy_ms", "ms busy a serving run"),
                      ("serve_k2_ms", "ms of K2 a serving run")):
        vals = {k: np.array([r for res in v for r in res[key]])
                for k, v in runs.items()}
        mine, theirs = vals[REPO_DIR], vals[other]
        diff = mine.mean() - theirs.mean()
        se = math.sqrt(sum(r.var(ddof=1) / len(r) for r in vals.values()))
        log(f"compare {key}: this {mine.mean():.4f} against "
            f"{theirs.mean():.4f} {unit} ({diff / theirs.mean():+.2%}), "
            f"standard error {se:.4f}: "
            f"{'resolved' if abs(diff) > 3 * se else 'unresolved'}")
    log(f"compare: card {card_line()}")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--rates"]:
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        print(json.dumps(measure_rates()), flush=True)
        return 0
    if sys.argv[1:2] == ["--compare"]:
        return compare(os.path.abspath(sys.argv[2]))
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
    k2 = phase_encoder(timer, peak_flops, peak_bw, name)
    k2t, k3 = phase_encoder_train(timer, peak_flops, peak_bw, name)
    k4, k5 = phase_ce(timer, peak_flops, peak_bw, name)
    t0 = time.perf_counter()
    wide = phase_shapes()
    log(f"phase shapes: {time.perf_counter() - t0:.1f} s")
    del timer
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
    experiment, exp_rates = phase_experiment(spec, train, eval_data, graphs,
                                             card)
    log(f"phase experiment: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_cli()
    log(f"phase cli: {time.perf_counter() - t0:.1f} s")
    paths = {"serving": serving, "serving_d512": serving_wide,
             "training": training, "training_wide": training_wide,
             "experiment": experiment}
    step_kernels = ("spmm_csr", "encoder_fwd", "encoder_bwd", "ce_fwd",
                    "ce_bwd")
    for path, kernels_of_path in (
            ("serving", ("spmm_csr", "encoder_fwd")),
            ("serving_d512", ("spmm_csr", "encoder_fwd")),
            ("training", step_kernels), ("training_wide", step_kernels),
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
         "max_rel_err": k2["max_rel_err"],
         **{k: k2[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by", "bound_ffma_ms",
                               "launches_per_call", "kernels_ms")},
         "train": k2t,
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
         "note": "both domains of a step: N 10240, d 128, V 30720 + 36864; "
                 "3xTF32 on the tensor cores; bound_ms the 3xTF32 tensor-core "
                 "bound (3*2*N*V*d TF32 FLOPs at 495 TFLOP/s), bound_ffma_ms "
                 "the FP32 FFMA one (2*N*V*d at 67); kernels_ms the "
                 "profiled split"},
        {"name": "ce_bwd", "route": "cuda",
         "source": "c2dsr_tpu_torch/csrc/ce.cu",
         "replaces": "c2dsr_tpu/ops/fused_ce.py:308",
         **counts("ce_bwd"), **k5, "d256_max_rel_err": wide["ce_bwd"],
         "note": "dh and dW/db kernels (3xTF32 on the tensor cores), both "
                 "domains of a step; also replaces fused_ce.py:339 and "
                 ":360; bound_ms is the 3xTF32 tensor-core bound "
                 "(3*4*N*V*d TF32 FLOPs at 495 TFLOP/s), bound_ffma_ms "
                 "the FP32 FFMA one (4*N*V*d at 67); kernels_ms the "
                 "profiled split"},
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
