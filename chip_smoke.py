#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and is right on an NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare OTHER   # train and serving measures
                                            # against OTHER/'s
                                            # c2dsr_tpu_torch, in turns
    python3 chip_smoke.py --compare OTHER --bitwise   # and fail unless
                                            # every output but the towers'
                                            # past d 256 is OTHER's bits

Needs one CUDA card, ``nvcc`` and the ``c2dsr_tpu_torch`` package beside
this file; it builds the CUDA kernels from ``c2dsr_tpu_torch/csrc`` itself.
Phases (any failure exits non-zero without the final line):

1. setup: build the kernels, print the build time and the card; the CE
   kernels' SASS (``cuobjdump -sass``, ``_mma_sass``): every bf16
   instantiation of K4 and K5, of K2's and K3's products with a weight and
   of their attention kernels past L 64 runs bf16 MMAs (HMMA.16816.F32.BF16)
   and no TF32 one, every f32 one the reverse; the CUDA dropout hash must
   equal
   ops/dropout.bits_reference.
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
   bounds; both also against float64: K4's lse and target logit within
   K4_F64_TOL, and on trained-scale logits within K4_TRAINED_TOL, K5's dW
   within DW_F64_TOL).  Then the wider shapes: K2 and K3 at d 32, 40, 96, 160, 256
   and 512 and at L up to 64, K4 and K5 at d 256 and 40; K4 and K5 past
   d 256 (``phase_ce_wide``, CE_WIDTHS; K5 on its cluster kernels, held to
   float64 and bitwise, and timed in turns against its kernels of before;
   bf16 at CE_BF16_WIDTHS against the plain bf16 CE).  (K4/K5 bf16 at d
   256 and 1,024, BF16_CE_DS, run in phase bf16.)
3. serving path: the ranking path at Food-Kitchen geometry with the
   default Config and random seeded weights: convolve once, then rank the
   eval split in sampled and in full mode.  Every serving kernel must
   launch there; the ranks must equal those of the same run with the plain
   versions, except at counted near-ties (a band from the plain versions'
   own score error against float64, near_ties), and every metric must be
   finite; the kernels' scores must lie within SCORE_K times the plain
   versions' error of the float64 ones (the plain run with PyTorch's
   deterministic kernels, gates.deterministic); a tower perturbed by PERTURB must
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
   plain versions (loss and gradients).  Then the widths the kernels take
   only padded (ODD_WIDTHS: ``d_latent`` 36 with one head, 10 with two):
   one step each at dropout 0 against the same step on the CPU (loss 1e-5,
   gradients GRAD_TOL), its launches, and a serving run against the plain
   versions' ranks.  Then the bf16 path (``phase_bf16``: compute_dtype and
   classifier_dtype bfloat16): every kernel's bf16 instantiation against
   its plain bf16 version at FK shapes (K1/K6 and K4 SPMM_BF16_TOL /
   CE_BF16_TOL, K5 CE_BWD_BF16_TOL, K2/K3 K2_BF16_TOL / K3_BF16_TOL by
   relative Frobenius), the f32 instantiation in its place failing each
   limit, K3-K5 bitwise across launches (K5 also timed beside its
   library version, ``kernel_bench.ce_bwd_bf16_library``, gated against
   the plain bf16 CE); one bf16 FK step at dropout 0
   against the CPU's (loss 1e-5, gradients STEP_BF16_GRAD_TOL; the f32
   step fails them) with only the bf16 instantiations launched; the bf16
   main path (a step, a batch-sparse step, a step at d_latent 512, whose
   K5 runs its cluster kernels, and a serving run whose ranks equal the
   plain versions' but at near-ties) with its launches; and the
   bf16 step timed against the f32 step in turns.
   Then the step and the rank step as CUDA graphs (``phase_graph``, after
   the determinism phase): at FK, f32 and bf16, dense and batch-sparse,
   GRAPH_STEPS captured steps (epochs of two full batches and a ragged
   one, StepLR moving the lr) bitwise the eager program's (params, AdamW
   state, lr, aux), also under bug_epoch_grad_accum, and resumed from a
   checkpoint at step 3 into a fresh program;
   one replay profiled: every step kernel (K6 when batch-sparse, the bf16
   instantiations on the bf16 path) from one cudaGraphLaunch; captured
   ranks equal the eager ones; then captured against eager train and
   serving rates in turns, with host and busy ms a step, capture seconds
   and graph pool bytes.  The train
   and rank steps of every other phase are the default, captured ones;
   the kernels line counts a graph's launches at each replay.
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
   default Config, each rank initialised by ``init_params_sharded``
   (bitwise the full draw's shard; its card memory after init printed
   beside the full tree's bytes; also on a 1x4 mesh, init alone): one step
   at dropout 0 whose loss (1e-5 relative) and
   gathered gradients (GRAD_TOL) are the one-process kernel step's, while
   the same gradients with the sharded ones scaled by M fail; each rank's
   K1 (over the all-to-all plan's CSRs), K2/K3 (at dropout 0.2 under its
   dropout row map), K4/K5 (at its vocab shard's width) and K7 (a masked
   lookup's gradient) against their plain versions on the sharded path's
   inputs; the mesh's eval ranks equal the one-process kernels' but at
   near-ties; K4/K5 timed at the shard widths (one process alone); and
   ``python -m c2dsr_tpu_torch.cli --mesh_model 2`` for an epoch with a
   checkpoint, resumed on one process.
8. bench: every mode of the port's bench in this process (the ablation
   aside; ``--spmm-sweep``, K1's plan parameters, at the points
   SPMM_SWEEP, each gated before it is timed), the ``--scaled``
   projection to 10M items logged.
9. native: the native data layer (``c2dsr_tpu_torch/native``, g++) on a
   raw directory of synthetic users: ``load_or_build_split`` and
   ``build_graphs_from_file`` equal to the Python path in every
   deterministic field and graph, the random fields within their
   invariants, and the CLI trains an epoch on the directory.
10. scaled_e2e: the composed train step at 1,000,001 item rows
   (``bench/scaled_e2e.py``) with 5 timed steps and its gates, the step's
   own K1, K4, K5 and K7 calls held against their plain versions and
   timed; step ms, train and full-rank examples/s, peak memory, launches.
11. summary: one JSON line of kernel numbers, the card's name and power
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
import dataclasses
import inspect
import json
import math
import os
import re
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
K4_F64_TOL = 2.6e-6      # K4's lse and target logit (relative to max
DW_F64_TOL = 1e-5        # |float64|) and K5's dW: sums in f32, not in the
                         # tensor cores' truncating accumulator (ce.cu)
K4_TRAINED_TOL = 7.5e-7  # K4's lse and target logit on logits of a trained
                         # state's size (_k4_trained_errs), relative to max
                         # |float64|: between this tile's 4.2e-7 and the
                         # one-chain tile's 1.4e-6 (PERF.md §6)
TRAIN_STEPS = 30         # train steps whose launches and losses are checked
TRAIN_ROUNDS = 5         # rounds of (plain, kernel, kernel, plain) train runs
TRAIN_RUN_STEPS = 4      # steps per timed train run
CLI_USERS = 2000         # synthetic users of the CLI phase
NATIVE_ITEMS = (2000, 3000)   # the native phase's raw directory: items of
                              # A and B (above the 999 eval negatives), and
NATIVE_USERS = 2000           # users of each interaction file
SERVE_RUNS = 8           # timed serving runs of each --rates process
BUSY_ROUNDS = 16         # rounds of (K7, index_add_, index_add_, K7)
                         # profiled steps (_k7_step_cost)
LEAD = 64                # fills that open (and close) a profiled window:
                         # the profiler loses its window's first kernels,
                         # up to 9 in this PR's runs (_k7_kernels)
PROFILE_PAUSE_S = 0.05   # the pause after them
K7_WINDOWS = 3           # profile windows _k7_kernels may take to see one
                         # that kept an opening fill
LOOKUPS = 6              # K7 launches a train step: the propagated plus the
                         # raw table (one K7, ops/lookup.lookup_add) and the
                         # positions, for each of the three tower inputs
                         # (model/c2dsr.forward_joint)
# phase bf16: each kernel's bf16 instantiation against its plain bf16
# version on the card.  Both round the same operands to bf16 and sum in f32
# in different orders; an f32 value that the two sums put on either side of
# a bf16 rounding boundary goes to neighbouring bf16 values (2^-8 apart),
# and in the tower its row carries that through the layers after it.  Each
# limit lies between the bf16 instantiation's reading and the f32
# instantiation's run in its place, which must fail it (readings against
# the JAX package on the CPU in tests/test_torch_bf16.py; the card's in the
# log and PERF.md).
SPMM_BF16_TOL = 1e-5     # K1/K6: max abs err over max |plain|
K2_BF16_TOL = 5e-4       # K2: relative Frobenius on rows with a key
K2_BF16_TOL2 = 1e-3      # the same over two layers (phase_shapes): a second
                         # layer re-rounds the first's output, and K2 read
                         # up to 5.43e-4 from the plain bf16 tower at the
                         # long and wide towers (d 1,024), the f32
                         # instantiation at least 4.11e-3 (an H100)
BF16_F64_K = 1.25        # phase_shapes: K2/K3 bf16 from the plain bf16 tower
                         # in float64, at most this many times the plain
                         # bf16 tower's distance from it (read: at most
                         # 1.01x; before the bf16 GEMMs summed their chunks
                         # in f32, K2 lay 1.35-1.5x at d 520-1,024)
K3_BF16_TOL = 1e-2       # K3: relative Frobenius, the worst tensor
CE_BF16_TOL = 1e-5       # K4: lse and target logit, max abs over max
CE_BWD_BF16_TOL = 5e-5   # K5: dh, dW, db, max abs over max
STEP_BF16_GRAD_TOL = 1e-2  # the bf16 step's gradients against the CPU's,
                           # relative Frobenius per tensor (the worst read
                           # 2.2e-3 on an H100, max abs over max 4.3e-3;
                           # the f32 step's max 0.57)
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
    from c2dsr_tpu_torch.ops import wrappers
    out = {name: getattr(mod, name) for mod, name in wrappers.WRAPPERS}
    out["ce_fwd_variant"] = ce_variants.ce_fwd_variant
    return out


def reset_launches():
    from c2dsr_tpu_torch.ops import wrappers
    for fn in kernel_wrappers().values():
        for attr in wrappers.COUNTERS:
            if hasattr(fn, attr):
                setattr(fn, attr, 0)
    kernel_wrappers()["ce_fwd_variant"].by_variant.clear()


def read_launches():
    """Launches by wrapper, "ce_bwd_cluster" and "ce_bwd_onepass": those of
    K5's that ran its cluster kernels or its one pass (counted also under
    "ce_bwd"), and "encoder_fwd_wide" and "encoder_bwd_wide": K2's and
    K3's past d 256, whose products ran the wgmma tile (counted also under
    their wrappers)."""
    out = {name: fn.launches for name, fn in kernel_wrappers().items()}
    out["ce_bwd_cluster"] = kernel_wrappers()["ce_bwd"].launches_cluster
    out["ce_bwd_onepass"] = kernel_wrappers()["ce_bwd"].launches_onepass
    for k in ("encoder_fwd", "encoder_bwd"):
        out[f"{k}_wide"] = kernel_wrappers()[k].launches_wide
    return out


def read_launches_bf16():
    """The bf16 instantiations' launches, by wrapper (and
    "ce_bwd_cluster", "encoder_fwd_wide", "encoder_bwd_wide")."""
    out = {name: fn.launches_bf16 for name, fn in kernel_wrappers().items()
           if hasattr(fn, "launches_bf16")}
    out["ce_bwd_cluster"] = kernel_wrappers()["ce_bwd"].launches_cluster_bf16
    for k in ("encoder_fwd", "encoder_bwd"):
        out[f"{k}_wide"] = kernel_wrappers()[k].launches_wide_bf16
    return out


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
    ("K3 encoder_bwd", ("tc_gemm_kernel", "attn_bwd_",
                        "ln_bwd_kernel", "wgrad_kernel",
                        "sum_partials_kernel",
                        "encoder_bwd_weights_bf16_kernel",
                        "encoder_bwd_split_kernel")),
    ("K4/K5 pre-pass", ("transpose_split_kernel", "transpose_bf16_kernel",
                        "round_bf16_kernel")),
    ("K4 ce_fwd", ("ce_fwd_kernel", "ce_fwd_wide_kernel",
                   "ce_fwd_merge_kernel")),
    ("K5 ce_bwd", ("ce_bwd_kernel", "ce_bwd_onepass_kernel",
                   "ce_bwd_wide_kernel", "ce_bwd_cluster_kernel",
                   "ce_merge_kernel", "split_kernel")),
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


def phase_main(spec, graphs_host, data, cfg=None, label="main path",
               fused_towers=True):
    """The serving path: convolve once, rank the eval split in sampled and
    full mode; launches, finite metrics, ranks against the plain versions'
    run.  At the default Config also warm rates in turns and a profile;
    with another ``cfg`` one kernel run and one plain run.  K2 launches
    three towers a rank step, none with ``fused_towers`` False (head dims
    the plain tower takes)."""
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
    launches = (read_launches_bf16() if cfg.bf16_products()
                else read_launches())
    log(f"{label}: d_latent {cfg.d_latent}, {n_ex} eval examples, {steps} "
        f"rank steps per mode, launches {launches}")
    check(launches["spmm_csr"] == 2 * cfg.n_gnn,
          f"spmm_csr launched {launches['spmm_csr']} times, want "
          f"{2 * cfg.n_gnn}")
    towers = 3 * 2 * steps if fused_towers else 0
    check(launches["encoder_fwd"] == towers,
          f"encoder_fwd launched {launches['encoder_fwd']} times, want "
          f"{towers}")
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
        with gates.plain_versions(), gates.deterministic():
            hi_plain, ranks_plain, _, _ = run_all()
        _check_ranks(params, hi, hi_plain,
                     gates.convolve_float64(params, graphs, cfg, spec), data,
                     cfg, spec, ranks, ranks_plain, n_ex, label)
        return launches

    # warm timings in turns on the same card, (plain, kernel, kernel, plain)
    # repeated, so drift falls on both alike; the gap between the two counts
    # as resolved only beyond 3 standard errors of the difference of means
    runs = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain") * WARM_ROUNDS:
        ctx = (gates.plain_versions() if which == "plain"
               else contextlib.nullcontext())
        with ctx:
            _, _, t_c, s_m = run_all()
        runs[which].append((t_c, s_m))
    # the gates' reference: one plain run with deterministic kernels
    with gates.plain_versions(), gates.deterministic():
        hi_plain, ranks_plain, _, _ = run_all()
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
            f"{gates.SCORE_K:g}x, the plain run deterministic)")
        if perturbed is None:
            continue
        ties = gates.near_ties(params, hi, hi_plain, hi64, data, cfg, spec,
                               mode)[0]
        err_q = gates.near_ties(params, hi, hi_plain, hi64, data, cfg, spec,
                                mode, params_k=perturbed[0])[2]
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
    (with their epilogues), attention, the LayerNorm kernel (d > 256), the
    input kernel (dropout, or the saved copy of the input), the bf16
    instantiation's copy of the weights and, past d 256, the pre-pass that
    writes them K-major for the wgmma tile (encoder_fwd_split_kernel)."""
    out = {"gemm": 0.0, "attention": 0.0, "layernorm": 0.0, "input": 0.0,
           "weights_bf16": 0.0, "weights_split": 0.0}
    for name, ms in times.items():
        for part, key in (("gemm", "encoder_fwd_gemm"),
                          ("attention", "encoder_fwd_attn"),
                          ("layernorm", "encoder_fwd_ln"),
                          ("input", "encoder_fwd_input"),
                          ("weights_bf16", "encoder_fwd_weights"),
                          ("weights_split", "encoder_fwd_split")):
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
    from c2dsr_tpu_torch.ops import dropout as drop
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
            # the seed in device memory, as the train step holds it (an
            # int seed costs each call a fill, which the times would count)
            kw = dict(idx_pad=pad, n_head=1, invert_padding_mask=False,
                      dropout=dropout, seed=drop.seed_tensor(1234, "cuda"),
                      tower=tower_id)
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


def _ce_inputs(N, d, V, n_real, seed, trained=False):
    """One domain's CE inputs at FK scales: h ~ N(0, 1), W ~ 0.05 N(0, 1)
    (zero on the padded vocab tail), every 5th row ignored (target n_real),
    dlse and dt ~ N(0, 1) / N on the other rows.  ``trained``: at a trained
    state's size, h ~ 4 N(0, 1) and W ~ N(0, 1) (logits up to ~200, the
    softmax sharp)."""
    rng = np.random.default_rng(seed)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    from c2dsr_tpu_torch.ops import fused_ce
    h = put(rng.normal(size=(N, d)) * (4.0 if trained else 1.0))
    w_np = rng.normal(size=(d, V)) * (1.0 if trained else 0.05)
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


def _k4_trained_errs(V, n_real):
    """K4's lse and target logit from float64 on one domain's trained-scale
    inputs (``_ce_inputs`` trained, N 10,240, d 128), beside the plain f32
    version's: (kernel, plain), relative to max |float64|.  There a logit
    tile that sums d's k-steps in one truncating chain lies several times
    further from float64 than plain f32 (tests/test_torch_tf32.py)."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    h, w, bm, pad_l, tgt, real, _, _ = _ce_inputs(512 * 2 * 10, 128, V,
                                                  n_real, V + 1, trained=True)
    with torch.no_grad():
        got = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)
        plain = fused_ce.ce_fwd_plain(h, w, bm, pad_l, tgt)
        f64 = fused_ce.ce_fwd_plain(h.double(), w.double(), bm.double(),
                                    pad_l.double(), tgt)

    def err(out):
        return max(_rel(out[0].double(), f64[0]),
                   _rel(out[1][real].double(), f64[1][real]))

    return err(got), err(plain)


def _ce_bwd_pass(name):
    """"dh" or "dw": the pass of a profiled ``ce_bwd_kernel<DT, kRowsX,
    kBf>``, ``ce_bwd_wide_kernel<kRowsX, kBf>`` (ce.cu) or
    ``ce_bwd_cluster_kernel<WS, kRowsX, kBf>`` (ce_cluster.cu; the dh kernel
    where kRowsX), or None for another kernel."""
    for prefix, at in (("ce_bwd_kernel<", 1), ("ce_bwd_wide_kernel<", 0),
                       ("ce_bwd_cluster_kernel<", 1)):
        if name.startswith(prefix):
            args = name[name.index("<") + 1:name.rindex(">")].split(",")
            return "dh" if args[at].strip() == "true" else "dw"
    return None


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
    (``bound_ms``) and the FP32 FFMA bound (``bound_ffma_ms``).  K5 runs
    its route there, the one pass (``csrc/ce_onepass.cu``: its bound of
    6·N·V·d, and ``bound_products_ms`` of the products' 4·N·V·d); the
    pair of kernels it replaced (``ce.cu``'s dh and dW passes, through
    their C entry) is held to the same gates and timed in turns with the
    route, each profiled.  Returns (K4, K5 by the one pass, the pair)."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    N, d = 512 * 2 * 10, 128
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_ffma_ms")
    fwd = dict.fromkeys(keys, 0.0)
    bwd = dict.fromkeys(keys, 0.0)
    fwd["max_abs_err"] = fwd["max_rel_err"] = 0.0
    bwd["max_abs_err"] = bwd["max_rel_err"] = 0.0
    f_kernel = fwd["kernels_ms"] = {}
    by_kernel = bwd["kernels_ms"] = {}
    bwd["bound_products_ms"] = 0.0
    bwd.update(runs_in_turns={}, plan={})
    pair = dict.fromkeys(("ms", "max_abs_err", "max_rel_err",
                          "max_rel_err_f64"), 0.0)
    pair["kernels_ms"] = {}
    for dom, V, n_real in (("A", 30720, N_ITEM_A), ("B", 36864, N_ITEM_B)):
        h, w, bm, pad_l, tgt, real, dlse, dt = _ce_inputs(N, d, V, n_real, V)
        with torch.no_grad():
            lse, tlog = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)
            rlse, rtlog = fused_ce.ce_fwd_plain(h, w, bm, pad_l, tgt)
            lse2, tlog2 = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)
            n1 = fused_ce_cuda.ce_bwd.launches_onepass
            got = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
            want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt)
            again = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
        torch.cuda.synchronize()
        check(fused_ce_cuda.ce_bwd.launches_onepass == n1 + 2,
              f"ce_bwd {dom}: K5 did not take its one pass at d {d}")
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
        # both against float64, beside the plain f32 versions
        with torch.no_grad():
            ins64 = [t.double() for t in (h, w, bm)]
            f64 = fused_ce.ce_fwd_plain(*ins64, pad_l.double(), tgt)
            b64 = fused_ce.ce_bwd_plain(*ins64, lse.double(), dlse.double(),
                                        dt.double(), tgt)
            del ins64

        def fwd_err(lse_, tlog_):
            return max(_rel(lse_.double(), f64[0]),
                       _rel(tlog_[real].double(), f64[1][real]))

        e64 = {"lse": fwd_err(lse, tlog), "plain_lse": fwd_err(rlse, rtlog)}
        for k, g_, p_, r_ in zip(("dh", "dw", "db"), got, want, b64):
            e64[k] = _rel(g_.double(), r_)
            e64["plain_" + k] = _rel(p_.double(), r_)
        del f64
        log(f"ce {dom}: from float64 (kernels, plain f32): lse and target "
            f"logit {e64['lse']:.3e}, {e64['plain_lse']:.3e}; "
            + "; ".join(f"{k} {e64[k]:.3e}, {e64['plain_' + k]:.3e}"
                        for k in ("dh", "dw", "db")))
        check(e64["lse"] <= K4_F64_TOL, f"ce_fwd {dom}: {e64['lse']} from "
              f"float64 > {K4_F64_TOL}")
        check(e64["dw"] <= DW_F64_TOL and max(e64["dh"], e64["db"])
              <= CE_BWD_TOL, f"ce_bwd {dom}: from float64 {e64}")
        # the pair of before, held to the same gates
        pair_plan = fused_ce_cuda.plan_bwd(N, d, V, False)
        designs = {"pair": lambda: _k5_entry("pair", h, w, bm, lse, dlse,
                                             dt, tgt)}
        with torch.no_grad():
            got1, again1 = designs["pair"](), designs["pair"]()
        rels1 = _check_ce_bwd(f"{dom} (pair)", got1, want, again1, n_real)
        e64_1 = {k: _rel(g_.double(), r_)
                 for k, g_, r_ in zip(("dh", "dw", "db"), got1, b64)}
        check(e64_1["dw"] <= DW_F64_TOL and max(e64_1["dh"], e64_1["db"])
              <= CE_BWD_TOL, f"ce_bwd {dom} (pair): from float64 {e64_1}")
        log(f"ce {dom} pair (splits {pair_plan}): against plain f32 "
            + ", ".join(f"{k} {v:.3e}" for k, v in rels1.items())
            + "; from float64 " + ", ".join(f"{k} {v:.3e}"
                                             for k, v in e64_1.items())
            + "; two launches bitwise equal")
        pair["max_rel_err_f64"] = max([pair["max_rel_err_f64"]]
                                      + list(e64_1.values()))
        pair["max_rel_err"] = max([pair["max_rel_err"]]
                                  + list(rels1.values()))
        pair["max_abs_err"] = max([pair["max_abs_err"]] + [
            float((g - r).abs().max()) for g, r in zip(got1, want)])
        del got1, again1
        del b64
        e_tr, e_tr_plain = _k4_trained_errs(V, n_real)
        log(f"ce {dom}: trained-scale logits, lse and target logit from "
            f"float64: kernel {e_tr:.3e}, plain f32 {e_tr_plain:.3e}")
        check(e_tr <= K4_TRAINED_TOL, f"ce_fwd {dom}: {e_tr} from float64 "
              f"on trained-scale logits > {K4_TRAINED_TOL}")
        fwd["trained_rel_err_f64"] = max(fwd.get("trained_rel_err_f64", 0.0),
                                         e_tr)
        fwd["trained_plain_rel_err_f64"] = max(
            fwd.get("trained_plain_rel_err_f64", 0.0), e_tr_plain)
        for acc, keys64 in ((fwd, ("lse",)), (bwd, ("dh", "dw", "db"))):
            acc["max_rel_err_f64"] = max([acc.get("max_rel_err_f64", 0.0)]
                                         + [e64[k] for k in keys64])
            acc["plain_rel_err_f64"] = max(
                [acc.get("plain_rel_err_f64", 0.0)]
                + [e64["plain_" + k] for k in keys64])
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
        # K5 in turns with the pair (route, pair, pair, route; three
        # rounds), then each profiled: the one pass's kernel, pre-pass (Wᵀ's
        # TF32 split) and merges; the pair's dh kernel, dW/db kernel,
        # pre-pass (Wᵀ and the TF32 splits of Wᵀ and h) and merges
        t1, runs1 = _k5_in_turns(timer, {
            "onepass": lambda: fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt,
                                                    tgt),
            "pair": designs["pair"]}, 10, rounds=3)
        b_ms = t1["onepass"]
        sub = timing.kernel_times(lambda: fused_ce_cuda.ce_bwd(
            h, w, bm, lse, dlse, dt, tgt))[0]
        parts = {"kernel": sum(v for k, v in sub.items()
                               if "ce_bwd_onepass_kernel" in k),
                 "prepass": sub.get("transpose_split_kernel", 0.0),
                 "merge": sub.get("ce_merge_kernel", 0.0)}
        sub_p = timing.kernel_times(designs["pair"])[0]
        parts_p = {"dh": sum(v for k, v in sub_p.items()
                             if _ce_bwd_pass(k) == "dh"),
                   "dw": sum(v for k, v in sub_p.items()
                             if _ce_bwd_pass(k) == "dw"),
                   "prepass": sub_p.get("transpose_split_kernel", 0.0)
                   + sub_p.get("split_kernel", 0.0),
                   "merge": sub_p.get("ce_merge_kernel", 0.0)}
        flops = 6 * N * V * d               # the one pass's f32-accurate work
        log(f"ce {dom}: bwd in turns one pass {t1['onepass']:.4f} ms, pair "
            f"{t1['pair']:.4f} (runs {runs1}); under the profiler one pass "
            f"(plan {fused_ce_cuda.plan_onepass(N, d, V)}): kernel "
            f"{parts['kernel']:.4f} ms ({flops / parts['kernel'] / 1e9:.2f} "
            f"TFLOP/s of its 6·N·V·d), pre-pass {parts['prepass']:.4f}, "
            f"merges {parts['merge']:.4f}; pair: dh kernel "
            f"{parts_p['dh']:.4f} ms, dW/db kernel {parts_p['dw']:.4f} "
            f"({4 * N * V * d / parts_p['dh'] / 1e9:.2f} and "
            f"{4 * N * V * d / parts_p['dw'] / 1e9:.2f} TFLOP/s of 4·N·V·d "
            f"each), pre-pass {parts_p['prepass']:.4f}, merges "
            f"{parts_p['merge']:.4f}")
        for acc, ps in ((by_kernel, parts), (pair["kernels_ms"], parts_p)):
            for k, v in ps.items():
                acc[k] = acc.get(k, 0.0) + v
        pair["ms"] += t1["pair"]
        bwd["runs_in_turns"][dom] = runs1
        bwd["plan"][dom] = dataclasses.asdict(
            fused_ce_cuda.plan_onepass(N, d, V))
        lib_out = torch.logsumexp(torch.cat([hg @ wg + bg, pad_l[:, None]],
                                            1), 1)
        b_lib = timer(lambda: torch.autograd.grad(lib_out, [hg, wg, bg], dlse,
                                                  retain_graph=True))
        del lib_out
        io = 4 * (N * d + d * V + V + 3 * N)
        f_ffma = max(f_flops / peak_flops, (io + 8 * N) / peak_bw) * 1e3
        f_tc = timing.tc_bound_ms(f_flops, io + 8 * N, gpu, peak_bw)
        b_bytes = 2 * io + 4 * N * d
        b_ffma = max(6 * N * V * d / peak_flops, b_bytes / peak_bw) * 1e3
        b_tc = timing.tc_bound_ms(6 * N * V * d, b_bytes, gpu, peak_bw)
        b_products = timing.tc_bound_ms(4 * N * V * d, b_bytes, gpu, peak_bw)
        bwd["bound_products_ms"] += b_products
        log(f"ce {dom}: fwd kernel {f_ms:.4f} ms plain {f_plain:.4f} library "
            f"{f_lib:.4f} bound 3xTF32 tensor cores {f_tc:.4f}, FP32 FFMA "
            f"{f_ffma:.4f} ({f_flops / f_ms / 1e9:.2f} TFLOP/s); bwd "
            f"kernel {b_ms:.4f} ms plain {b_plain:.4f} library {b_lib:.4f} "
            f"bound 3xTF32 tensor cores {b_tc:.4f} (the products' "
            f"{b_products:.4f}), FP32 FFMA {b_ffma:.4f} (bounds count "
            f"6·N·V·d FLOPs; {6 * N * V * d / b_ms / 1e9:.2f} TFLOP/s of "
            "them)")
        for acc, vals in ((fwd, (f_ms, f_plain, f_lib, f_tc, f_ffma)),
                          (bwd, (b_ms, b_plain, b_lib, b_tc, b_ffma))):
            for k, v in zip(keys, vals):
                acc[k] += v
    fwd["bound_by"] = bwd["bound_by"] = "operations"
    d_ms, se, ok = timing.se_resolved(
        [sum(r) for r in zip(*(bwd["runs_in_turns"][k]["onepass"]
                               for k in ("A", "B")))],
        [sum(r) for r in zip(*(bwd["runs_in_turns"][k]["pair"]
                               for k in ("A", "B")))])
    bwd["against_pair"] = {"diff_ms": d_ms, "se_ms": se, "resolved": ok}
    log(f"ce both domains: fwd kernel {fwd['ms']:.4f} ms (kernel "
        f"{f_kernel['kernel']:.4f} + pre-pass {f_kernel['prepass']:.4f} + "
        f"merge {f_kernel['merge']:.4f}, profiled) against library "
        f"{fwd['library_ms']:.4f} ms; bounds 3xTF32 {fwd['bound_ms']:.4f}, "
        f"FFMA {fwd['bound_ffma_ms']:.4f}")
    log(f"ce both domains: bwd one pass {bwd['ms']:.4f} ms (kernel "
        f"{by_kernel['kernel']:.4f} + pre-pass {by_kernel['prepass']:.4f} + "
        f"merges {by_kernel['merge']:.4f}, profiled) against the pair "
        f"{pair['ms']:.4f} in turns ({bwd['ms'] / pair['ms'] - 1:+.2%}, "
        f"{d_ms:+.4f} ms, se {se:.4f}, "
        f"{'resolved' if ok else 'unresolved'}; pair dh "
        f"{pair['kernels_ms']['dh']:.4f} + dW {pair['kernels_ms']['dw']:.4f}"
        f" + pre-pass {pair['kernels_ms']['prepass']:.4f} + merges "
        f"{pair['kernels_ms']['merge']:.4f}) and library "
        f"{bwd['library_ms']:.4f} ms; bounds 3xTF32 6·N·V·d "
        f"{bwd['bound_ms']:.4f}, 4·N·V·d {bwd['bound_products_ms']:.4f}, "
        f"FFMA {bwd['bound_ffma_ms']:.4f}")
    for k in ("plain_ms", "library_ms", "bound_products_ms"):
        pair[k] = bwd[k]
    pair["bound_ms"] = bwd["bound_products_ms"]
    pair["bound_by"] = "operations"
    return fwd, bwd, pair


# tower shapes beyond d 64 and 128 that K2 and K3 take: (d, n_head, L);
# d 512 (two column tiles, K2's LayerNorm kernel) and L past 32 (two keys a
# lane in attention), then L past 64 (key chunks, query tiles: L 65 a
# one-row second tile, L 512 eight tiles) and d past 512 (the LayerNorm
# kernels' rows past 16 floats a lane; d 520 one head of 520 columns, nine
# head-column chunks in attention)
LONG_WIDE_TOWERS = ((128, 1, 65), (64, 1, 128), (128, 1, 200), (64, 1, 512),
                    (520, 1, 15), (640, 5, 30), (1024, 8, 15))
WIDE_TOWERS = ((96, 2, 30), (32, 1, 30), (256, 4, 15), (160, 2, 16),
               (40, 1, 30), (256, 4, 30), (512, 4, 15), (512, 8, 30),
               (128, 2, 64), (256, 4, 64), (96, 2, 48)) + LONG_WIDE_TOWERS


TIMED_TOWERS = ((128, 1, 200, 512), (512, 4, 15, 512),
                (1024, 8, 15, 512))                       # (d, heads, L, B)


def _tower_work(seq, pad, p, acts, n_head):
    """(forward FLOPs, the attention's part of them, forward bytes,
    backward bytes) of one tower layer of K2 in train mode (saving
    ``acts``) and K3 on these inputs; the backward does twice the forward's
    FLOPs."""
    from c2dsr_tpu_torch.train import step as step_mod
    B, L = seq.shape
    d = p["lnf_scale"].numel()
    N = B * L
    # the attention this run's masks need: a query row with k allowed
    # keys (causal and not padding) 4·k·d FLOPs, an all-masked row the
    # mean of its sequence's V (L·d adds, once a sequence)
    k = (seq != pad).long().cumsum(1)
    attn_flops = (4.0 * d * float(k.sum())
                  + float(L * d) * int((k == 0).any(1).sum()))
    # bytes: x and the output, every weight once, and in train the
    # activations the backward reads, not the H·B·L² probabilities this
    # design saves beside them
    w_bytes = 4.0 * sum(t.numel() for t in step_mod.param_leaves(p))
    kept = acts.numel() - n_head * B * L * L
    return (12.0 * N * d * d + attn_flops, attn_flops,
            8.0 * N * d + w_bytes + 4.0 * kept,
            4.0 * kept + 8.0 * N * d + 2 * w_bytes)


def _tower_times(timer, gpu, peak_flops, peak_bw):
    """K2 in train mode (dropout 0.2, saving K3's activations) and K3 at the
    long and the wide tower (TIMED_TOWERS: one domain tower of a step, one
    layer), timed beside the plain versions and nn.TransformerEncoder with
    the same weights in train mode (forward, and forward + backward), with
    the 3xTF32 and FFMA bounds (12·N·d² FLOPs forward plus the causal
    attention the inputs' masks need, twice that backward; the bytes of x,
    the output, the weights and the activations the backward reads) and
    K3's kernels profiled; then the bf16 instantiations at the same tower
    beside the library's bf16 calls.  Both dtypes' attention kernels and
    products with a weight (past d 256 the wgmma tile and its weight
    pre-pass) are profiled apart (``attention_*``, ``gemm_*``)."""
    from c2dsr_tpu_torch.bench import kernel_bench
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import dropout as drop
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import encoder_cuda
    pad, out = 64093, {}
    for d, n_head, L, B in TIMED_TOWERS:
        p = params_mod._map(lambda t: t.cuda(), params_mod.init_encoder_params(
            torch.Generator().manual_seed(d + 5),
            Config(d_latent=d, n_head=n_head), L))
        x, seq = _encoder_inputs(B, L, d, pad, seed=d + 5)
        gout = torch.randn(x.shape, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(d))
        kw = dict(idx_pad=pad, n_head=n_head, invert_padding_mask=False,
                  dropout=0.2, seed=drop.seed_tensor(7, "cuda"), tower=1)
        acts = encoder_cuda.saved_buffer(x, n_head, 1)
        with torch.no_grad():
            f_ms = timer(lambda: encoder_cuda.encoder_fwd(x, seq, p,
                                                          saved=acts, **kw))
            f_plain = timer(lambda: enc.encoder_fwd_plain(x, seq, p, **kw))
        b_ms = timer(lambda: encoder_cuda.encoder_bwd(x, seq, gout, p,
                                                      saved=acts, **kw))
        b_plain = timer(lambda: enc.encoder_bwd_plain(x, seq, gout, p, **kw))
        tower = kernel_bench.torch_tower(p, d, n_head, 1, dropout=0.2)
        causal = torch.triu(torch.ones(L, L, dtype=torch.bool,
                                       device="cuda"), 1)
        kpm = seq == pad
        xg = x.clone().requires_grad_(True)
        lib_params = [xg] + list(tower.parameters())
        with torch.no_grad():
            f_lib = timer(lambda: tower(x, mask=causal,
                                        src_key_padding_mask=kpm))
        b_lib = timer(lambda: torch.autograd.grad(
            tower(xg, mask=causal, src_key_padding_mask=kpm), lib_params,
            gout))
        flops, attn_flops, f_bytes, b_bytes = _tower_work(seq, pad, p, acts,
                                                          n_head)
        subs, attn, gemm = {}, {}, {}
        for bf in (False, True):
            name = "bf16" if bf else "f32"
            subs[name] = (
                timing.kernel_times(lambda: encoder_cuda.encoder_fwd(
                    x, seq, p, saved=acts, bf16=bf, **kw))[0],
                timing.kernel_times(lambda: encoder_cuda.encoder_bwd(
                    x, seq, gout, p, saved=acts, bf16=bf, **kw))[0])
            attn[name] = [sum(v for k, v in sub.items() if "attn" in k)
                          for sub in subs[name]]
            # the products with a weight (and past d 256 their pre-pass)
            gemm[name] = [sum(v for k, v in sub.items()
                              if "gemm" in k or "split" in k)
                          for sub in subs[name]]
        with torch.no_grad():
            f_bf = timer(lambda: encoder_cuda.encoder_fwd(
                x, seq, p, saved=acts, bf16=True, **kw))
        b_bf = timer(lambda: encoder_cuda.encoder_bwd(
            x, seq, gout, p, saved=acts, bf16=True, **kw))
        f_lib_bf, b_lib_bf = _bf16_tower_library(p, x, seq, gout, pad,
                                                 n_head, 0.2, timer)
        f_sub, b_sub = subs["f32"]
        out[f"d{d}_L{L}"] = {
            "B": B, "n_head": n_head, "fwd_ms": f_ms, "fwd_plain_ms": f_plain,
            "fwd_library_ms": f_lib, "bwd_ms": b_ms, "bwd_plain_ms": b_plain,
            "fwd_bwd_library_ms": b_lib,
            "fwd_bound_ms": timing.tc_bound_ms(flops, f_bytes, gpu, peak_bw),
            "fwd_bound_ffma_ms": flops / peak_flops * 1e3,
            "bwd_bound_ms": timing.tc_bound_ms(2 * flops, b_bytes, gpu,
                                               peak_bw),
            "bwd_bound_ffma_ms": 2 * flops / peak_flops * 1e3,
            "attention_fwd_ms": attn["f32"][0],
            "attention_bwd_ms": attn["f32"][1],
            "attention_share_of_flops": attn_flops / flops,
            "fwd_bf16_ms": f_bf, "bwd_bf16_ms": b_bf,
            "fwd_library_bf16_ms": f_lib_bf,
            "fwd_bwd_library_bf16_ms": b_lib_bf,
            "attention_fwd_bf16_ms": attn["bf16"][0],
            "attention_bwd_bf16_ms": attn["bf16"][1],
            "gemm_fwd_ms": gemm["f32"][0], "gemm_bwd_ms": gemm["f32"][1],
            "gemm_fwd_bf16_ms": gemm["bf16"][0],
            "gemm_bwd_bf16_ms": gemm["bf16"][1]}
        r = out[f"d{d}_L{L}"]
        log(f"shapes timed: tower d={d} n_head={n_head} L={L} B={B} "
            f"dropout 0.2: K2 {f_ms:.4f} ms plain {f_plain:.4f} library "
            f"{f_lib:.4f} bound 3xTF32 {r['fwd_bound_ms']:.4f} FFMA "
            f"{r['fwd_bound_ffma_ms']:.4f} (attention {attn['f32'][0]:.4f}, "
            f"products with a weight {gemm['f32'][0]:.4f}, profiled); K3 "
            f"{b_ms:.4f} ms (products with a weight, dX and their "
            f"pre-pass, {gemm['f32'][1]:.4f}) plain {b_plain:.4f} library "
            f"fwd + "
            f"bwd {b_lib:.4f} bound {r['bwd_bound_ms']:.4f} FFMA "
            f"{r['bwd_bound_ffma_ms']:.4f} (attention {attn['f32'][1]:.4f}); "
            "K3's kernels " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in b_sub.items())
            + f"; bf16: K2 {f_bf:.4f} ms library {f_lib_bf:.4f} (attention "
            f"{attn['bf16'][0]:.4f}, products {gemm['bf16'][0]:.4f}), K3 "
            f"{b_bf:.4f} ms library fwd + bwd {b_lib_bf:.4f} (attention "
            f"{attn['bf16'][1]:.4f}, products {gemm['bf16'][1]:.4f})")
        del acts, tower, xg, lib_params
        torch.cuda.empty_cache()
    return out


WIDE_GEMM_WIDTHS = (264, 512, 520, 1024)   # phase_wide_gemm's d (n 7,680)
WIDE_GEMM_TIMED = (512, 1024)              # the widths it times
WIDE_GEMM_F64_K = 1.25   # the wgmma tile's distance from float64 (of the
                         # rounded operands in bf16), at most this many
                         # times the 64-row tile's


def _wide_products(d):
    """The products with a weight of one layer past d 256, as the tile
    runs them: (name, K2 or K3, k, m, mode or bf16, epilogue, dropout
    site): QKV (the 6-term split), the out-projection and FF2 (dropout and
    residual), FF1 (ReLU and its dropout); K3's dX of FF2 (ReLU's mask),
    FF1 and QKV (the residual; k 3·d), and of the out-projection."""
    return (("qkv", "fwd", d, 3 * d, 6, "bias", 0),
            ("out", "fwd", d, d, 3, "residual", 2),
            ("ff1", "fwd", d, d, 3, "relu", 3),
            ("ff2", "fwd", d, d, 3, "residual", 4),
            ("ff2", "bwd", d, d, 3, "drelu", 3),
            ("ff1", "bwd", d, d, 3, "res", 0),
            ("out", "bwd", d, d, 3, "store", 0),
            ("qkv", "bwd", 3 * d, d, 3, "res", 0))


def phase_wide_gemm(timer, gpu, peak_bw):
    """The wgmma tile (csrc/wgmma.cuh) on its own: each of K2's and K3's
    products with a weight (_wide_products) at WIDE_GEMM_WIDTHS over 7,680
    rows (B 512, L 15), f32 and bf16, at dropout 0.2 under a row map,
    through ``encoder_cuda.gemm_fwd`` / ``gemm_bwd`` (which count no
    launches), bitwise the 64-row tile's outputs in both dtypes (the same
    rounded operands, the same k-steps in the same order, the same
    masks), and at dropout 0 against float64 beside it (WIDE_GEMM_F64_K); at
    WIDE_GEMM_TIMED each profiled (device ms a call, ``timing.kernel_times``)
    beside the 64-row tile, its plain version (the product and epilogue in
    torch ops, f32 with TF32 off, or of the bf16-rounded operands) and one
    library call (``torch.mm`` of the f32 operands, or of bf16 ones), with
    its bound (f32-accurate work at 3 TF32 passes, as ``timing.tc_bound_ms``
    prices it, or one bf16 pass, or the bytes; the QKV product's 6-term
    split issues three passes more, reported apart as ``split6_extra_ms``)
    and the Timer's reading (cold L2; it counts the wrapper's host work).  Each
    call includes its weight's pre-pass, as a tower call does once a
    call.  Returns {d: {dtype:
    {product: numbers}}}."""
    from c2dsr_tpu_torch.ops import encoder_cuda as ec
    from c2dsr_tpu_torch.ops.bf16 import round_bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    B, L = 512, 15
    n = B * L
    row_map = (5, B, B + 40)
    out = {}
    for d in WIDE_GEMM_WIDTHS:
        gen = torch.Generator("cuda").manual_seed(d)
        res_d = {}
        for bf in (False, True):
            dt = "bf16" if bf else "f32"
            rows = res_d[dt] = {}
            for name, kind, k, m, mode, epi, site in _wide_products(d):
                a = torch.randn(n, k, device="cuda", generator=gen)
                w = torch.randn(*((k, m) if kind == "fwd" else (m, k)),
                                device="cuda", generator=gen) * k ** -0.5
                bias = torch.randn(m, device="cuda", generator=gen) * 0.1
                res = torch.randn(n, m, device="cuda", generator=gen)
                mode = 1 if bf else mode

                def run(wide, dropout, a=a, w=w, bias=bias, res=res,
                        kind=kind, mode=mode, epi=epi, site=site):
                    kw = dict(dropout=dropout, seed=13, tower=1, L=L,
                              site=site,
                              row_map=row_map if dropout else None)
                    if kind == "fwd":
                        c, c2 = ec.gemm_fwd(a, w, bias, epi=epi, mode=mode,
                                            wide=wide, res=res,
                                            with_c2=epi == "relu", **kw)
                        return (c, c2) if c2 is not None else (c,)
                    return (ec.gemm_bwd(a, w, epi=epi, bf16=mode == 1,
                                        wide=wide, res=res, aux=res, **kw),)
                got, old = run(True, 0.2), run(False, 0.2)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(got, old))
                err_old = max(_rel(x, y) for x, y in zip(got, old))
                tag = f"wide gemm d={d} {dt} {kind} {name} ({epi})"
                check(all(bool(torch.isfinite(x).all()) for x in got),
                      f"{tag}: non-finite")
                check(same, f"{tag}: not bitwise the 64-row tile's "
                      f"(max rel err {err_old:.3e})")
                # the product alone, at dropout 0 (the epilogue before the
                # store: bias, ReLU, residual or ReLU's mask)
                a_r, w_r = (round_bf16(a), round_bf16(w)) if bf else (a, w)
                wm = w_r if kind == "fwd" else w_r.T
                prod64 = a_r.double() @ wm.double()
                if kind == "fwd":
                    want = prod64 + bias.double()
                    if epi == "relu":
                        want = want.clamp_min(0)
                    if epi == "residual":
                        want = want + res.double()
                else:
                    want = prod64
                    if epi == "res":
                        want = want + res.double()
                    if epi == "drelu":
                        want = want * (res > 0)
                c_new, c_old = run(True, 0.0)[0], run(False, 0.0)[0]
                e_new, e_old = _rel(c_new, want), _rel(c_old, want)
                check(e_new <= WIDE_GEMM_F64_K * e_old + 1e-7,
                      f"{tag}: from float64 {e_new:.3e}, the 64-row tile "
                      f"{e_old:.3e}")
                r = {"k": k, "m": m, "mode": mode, "bitwise_tile64": same,
                     "max_rel_err_f64": e_new, "tile64_max_rel_err_f64": e_old,
                     "max_abs_err_f64": float((c_new.double() - want).abs()
                                              .max())}
                if d in WIDE_GEMM_TIMED:
                    if kind == "fwd":
                        def plain(a_r=a_r, w_r=w_r, bias=bias, res=res,
                                  epi=epi):
                            y = torch.addmm(bias, a_r, w_r)
                            if epi == "relu":
                                y = y.clamp_min(0)
                            return y + res if epi == "residual" else y
                    else:
                        def plain(a_r=a_r, w_r=w_r, res=res, epi=epi):
                            y = a_r @ w_r.T
                            if epi == "drelu":
                                return y * (res > 0)
                            return y + res if epi == "res" else y
                    if bf:
                        a16, w16 = a.bfloat16(), w.bfloat16()
                        lib = (lambda: a16 @ w16) if kind == "fwd" else (
                            lambda: a16 @ w16.T)
                    else:
                        lib = (lambda: a @ w) if kind == "fwd" else (
                            lambda: a @ w.T)
                    flops = 2.0 * n * k * m
                    nbytes = 4.0 * (n * k + n * m) + (2 if bf else 4) * k * m
                    # f32-accurate work at 3xTF32, as every tower bound
                    # (timing.tc_bound_ms); the 6-term split's other three
                    # passes are its numerics' cost, apart from the bound
                    ops_ms = (flops / timing.bf16_peak(gpu) if bf
                              else 3 * flops / timing.tf32_peak(gpu)) * 1e3
                    if mode == 6:
                        r["split6_extra_ms"] = ops_ms
                    bytes_ms = nbytes / peak_bw * 1e3
                    # device ms a call, profiled (the wrapper's host
                    # work, its allocations and tensor maps, left out),
                    # and the Timer's reading of the tile beside
                    fns = {"ms": lambda: run(True, 0.2),
                           "tile64_ms": lambda: run(False, 0.2),
                           "plain_ms": plain, "library_ms": lib}
                    for key, fn in fns.items():
                        t = timing.kernel_times(fn)[0]
                        r[key] = sum(t.values())
                        if key in ("ms", "tile64_ms"):
                            r[key.replace("ms", "gemm_ms")] = sum(
                                v for n_, v in t.items() if "gemm" in n_)
                    r.update(timer_ms=timer(fns["ms"]),
                             bound_ms=max(ops_ms, bytes_ms),
                             bound_by="operations" if ops_ms > bytes_ms
                             else "bytes", flops=flops)
                    # a profiled time under the bound is a reading at
                    # fault (the profiler missed a launch), not a speed
                    r["unphysical"] = r["gemm_ms"] < r["bound_ms"]
                    log(f"{tag}: {r['ms']:.4f} ms profiled (the tile "
                        f"{r['gemm_ms']:.4f}, its pre-pass the rest; "
                        f"Timer {r['timer_ms']:.4f}); 64-row tile "
                        f"{r['tile64_ms']:.4f} ({r['tile64_gemm_ms']:.4f}), "
                        f"plain {r['plain_ms']:.4f}, library "
                        f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
                        f"by {r['bound_by']}"
                        + (f" (the 6-term split's three more passes "
                           f"{r['split6_extra_ms']:.4f})" if mode == 6
                           else "")
                        + f"; from float64 {e_new:.3e} (64-row tile "
                        f"{e_old:.3e}), bitwise the 64-row tile's"
                        + ("; UNPHYSICAL: under its bound"
                           if r["unphysical"] else ""))
                rows[f"{kind}_{name}"] = r
                del a, w, bias, res, got, old, c_new, c_old, want, prod64
        out[d] = res_d
        torch.cuda.empty_cache()
    log("wide gemm: " + json.dumps({d: {dt: {p: {k: v for k, v in r.items()
                                                   if "err" in k
                                                   or "bitwise" in k}
                                              for p, r in rows.items()}
                                         for dt, rows in v.items()}
                                    for d, v in out.items()}))
    return out


def _shapes_bf16(x, seq, p, pad, n_head, tag):
    """K2 (dropout 0.2, saving) and K3 in their bf16 instantiations at one
    of phase_shapes' towers, two layers ``p``, against the plain bf16 tower
    (K3 at K2's branches), relative Frobenius (K2 on rows with an allowed
    key) at K2_BF16_TOL2 / K3_BF16_TOL, with the f32 instantiations in
    their place, which must fail them; K3 bitwise across launches.  Both
    versions and the f32 instantiation are also read against the plain bf16
    tower in float64 (the same rounding points, float64 sums), and K2 and
    K3 must lie no further from it than BF16_F64_K times the plain
    version.  Returns the readings."""
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import encoder_cuda
    n_layers = p["layers"]["w_qkv"].shape[0]
    kw = dict(idx_pad=pad, n_head=n_head, invert_padding_mask=False,
              dropout=0.2, seed=5, tower=1)
    live = (seq != pad).long().cumsum(1) > 0
    acts = encoder_cuda.saved_buffer(x, n_head, n_layers)
    acts32 = encoder_cuda.saved_buffer(x, n_head, n_layers)
    p64 = params_mod._map(lambda t: t.double(), p)
    with torch.no_grad():
        out = encoder_cuda.encoder_fwd(x, seq, p, saved=acts, bf16=True, **kw)
        out32 = encoder_cuda.encoder_fwd(x, seq, p, saved=acts32, **kw)
        ref = enc.encoder_fwd_plain(x, seq, p, bf16=True, **kw)
        ref64 = enc.encoder_fwd_plain(x.double(), seq, p64, bf16=True, **kw)
    gout = torch.randn(x.shape, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(7))
    got = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts, bf16=True,
                                   **kw)
    again = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts, bf16=True,
                                     **kw)
    got32 = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts32, **kw)
    br = gates.k2_branches(acts, x.shape, n_head, n_layers, kw["tower"])
    want = enc.encoder_bwd_plain(x, seq, gout, p, bf16=True, branches=br,
                                 **kw)
    want64 = enc.encoder_bwd_plain(x.double(), seq, gout.double(), p64,
                                   bf16=True, branches=br, **kw)
    torch.cuda.synchronize()
    e, e32 = _bf16_fro(out, ref, live), _bf16_fro(out32, ref, live)
    f64 = {"k2": _bf16_fro(out, ref64, live),
           "k2_plain": _bf16_fro(ref, ref64, live),
           "k2_f32": _bf16_fro(out32, ref64, live)}
    flat, ref_flat = [got[0]] + list(got[1]), [want[0]] + list(want[1])
    flat64 = [want64[0]] + list(want64[1])
    eb = max(_bf16_fro(a, r) for a, r in zip(flat, ref_flat))
    eb32 = max(_bf16_fro(a, r) for a, r in
               zip([got32[0]] + list(got32[1]), ref_flat))
    f64["k3"] = max(_bf16_fro(a, r) for a, r in zip(flat, flat64))
    f64["k3_plain"] = max(_bf16_fro(a, r) for a, r in zip(ref_flat, flat64))
    log(f"shapes: bf16 encoder {tag} {n_layers} layers p=0.2: fwd relative "
        f"Frobenius {e:.3e} (f32 instantiation {e32:.3e}), bwd worst "
        f"{eb:.3e} ({eb32:.3e}) at K2's branches; against the plain bf16 "
        f"tower in float64: K2 {f64['k2']:.3e}, plain {f64['k2_plain']:.3e}, "
        f"f32 instantiation {f64['k2_f32']:.3e}; K3 {f64['k3']:.3e}, plain "
        f"{f64['k3_plain']:.3e}")
    check(e <= K2_BF16_TOL2 < e32, f"bf16 encoder_fwd {tag}: relative "
          f"Frobenius {e} (f32 instantiation {e32}), limit {K2_BF16_TOL2}")
    check(eb <= K3_BF16_TOL < eb32, f"bf16 encoder_bwd {tag}: relative "
          f"Frobenius {eb} (f32 instantiation {eb32}), limit {K3_BF16_TOL}")
    check(f64["k2"] <= BF16_F64_K * f64["k2_plain"]
          and f64["k3"] <= BF16_F64_K * f64["k3_plain"],
          f"bf16 encoder {tag}: further from float64 than {BF16_F64_K}x the "
          f"plain bf16 tower: {f64}")
    check(all(torch.equal(a, b) for a, b in
              zip(flat, [again[0]] + list(again[1]))),
          f"bf16 encoder_bwd {tag}: two launches differ")
    return {"fwd": e, "fwd_f32_inst": e32, "bwd": eb, "bwd_f32_inst": eb32,
            "float64": f64}


def phase_shapes():
    """K2 (eval, both mask polarities, and train) and K3 at WIDE_TOWERS,
    dropout 0 and 0.2, two layers (at LONG_WIDE_TOWERS also their bf16
    instantiations), and K4/K5 at d 256 and 40 (FK's rows and
    domain A's vocab), against their plain versions; K3, K4 and K5 also
    bitwise against a second launch.  Returns the worst errors."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import encoder_cuda, fused_ce, fused_ce_cuda
    pad = 64093
    worst = {"encoder_fwd": 0.0, "encoder_fwd_rel": 0.0, "encoder_bwd": 0.0,
             "bf16": {}}
    for d, n_head, L in WIDE_TOWERS:
        t0 = time.perf_counter()
        B = 256 if L <= 200 else 64
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
        if (d, n_head, L) in LONG_WIDE_TOWERS:
            worst["bf16"][tag] = _shapes_bf16(x, seq, p, pad, n_head, tag)
        log(f"shapes: encoder {tag} B={B}: {time.perf_counter() - t0:.1f} s")
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


def _step_accuracy(graphs, spec, step):
    """``_tower_accuracy`` of the tower calls of one train step at ``step``
    (LONG_STEP or WIDE_STEP; dropout 0; FK's itemsets and graphs, a seeded
    synthetic batch and seeded params): the reading ``--compare`` takes in
    each checkout, on the same inputs."""
    from c2dsr_tpu_torch.config import Config, DataSpec
    from c2dsr_tpu_torch.data import preprocess, synthetic
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.train import step as step_mod
    cfg = Config(**step).with_(dropout_gnn=0.0, dropout_attn=0.0)
    sp = DataSpec(n_item_a=spec.n_item_a, n_item_b=spec.n_item_b,
                  len_max=cfg.len_max)
    tr = preprocess.preprocess_train(
        synthetic.generate_sequences(sp, 2000, seed=7), sp, seed=1)
    batch = ranker.to_device({k: v[:cfg.batch_size] for k, v in tr.items()},
                             "cuda")
    params = params_mod.init_params(cfg, sp, torch.Generator().manual_seed(3),
                                    "cuda")
    leaves = step_mod.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    calls = []
    _loss_grads(params, leaves, graphs, batch, cfg, sp,
                gates.recording_k2_branches({}, calls))
    out = _tower_accuracy(calls)
    del calls, params, leaves
    torch.cuda.empty_cache()
    return out


LONG_STEP = dict(d_latent=128, n_head=1, len_max=200)   # phase_train_wide's
WIDE_STEP = dict(d_latent=1024, n_head=8, len_max=15)   # long and wide runs
EVAL_USERS_WIDE = 2048   # their full rank's eval users


def phase_train_wide(spec, train, graphs, graphs_host):
    """The training step at FK's itemsets and graphs beyond the default
    shapes, dropout 0: with d_latent 256 (the towers' widest fused-LN
    tiles, K4 and K5 at d 256, K1 at d 256 and 512) at FK's len_max 15 for
    two steps and at EE's 30 for one, then at d 128 with len_max 64 (two
    keys a lane in attention), then at d_latent 512 (BASELINE.json config
    5's width: K4 and K5 at d 512, K5 on its cluster kernels), then the
    long step (LONG_STEP: len_max 200, key chunks and query tiles in K2/K3)
    and the wide one (WIDE_STEP: d 1024, 8 heads, K4's wide kernel and K5's
    cluster kernels), each run with its own params and batches.
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
                               (cfg256.with_(d_latent=512), LEN_MAX, 7),
                               (cfg256.with_(**LONG_STEP),
                                LONG_STEP["len_max"], 8),
                               (cfg256.with_(**WIDE_STEP), LEN_MAX, 9)):
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
    schedule = (0, 0, 1, 2, 3, 4, 5)   # d 256 at len_max 15, 15, 30; d 128
                                       # at 64; d 512 at 15; long; wide
    launches = dict.fromkeys(read_launches(), 0)
    losses = []
    for i, which in enumerate(schedule):
        t0 = time.perf_counter()
        cfg, sp, state, fn, feed = runs[which]
        names = leaf_names(state.params)
        batch = next(feed)
        b = ranker.to_device(batch, "cuda")
        leaves = state.opt_state.leaves
        masks, calls = {}, []
        # the tower calls of the first step and of the long one, for
        # _tower_accuracy
        record = i == 0 or sp.len_max == LONG_STEP["len_max"]
        loss_k, g_k = _loss_grads(state.params, leaves, graphs, b, cfg, sp,
                                  gates.recording_k2_branches(
                                      masks, calls if record else None))
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
        log(f"{tag}: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
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
    del runs, cpu_graphs
    torch.cuda.empty_cache()
    paths = {"training_wide": launches}
    for name, key, kw in (("long", "training_long", LONG_STEP),
                          ("wide", "training_wide_d1024", WIDE_STEP)):
        paths[key] = _long_wide_run(name, Config(**kw), spec, graphs,
                                    graphs_host)
    return paths


def _long_wide_run(name, cfg, spec, graphs, graphs_host):
    """The long or the wide run of phase_train_wide beyond its gated step:
    captured steps bitwise the eager program's (GRAPH_SPE steps: the
    warm-up, the capture and a replay), then a few steps through the
    captured program (the long run through ``train/loop.Experiment``, as
    the JAX package's Python API reaches its towers), then a full rank of
    EVAL_USERS_WIDE eval users (``phase_main``: ranks equal to the plain
    versions' but at near-ties).  Returns the launches of the steps and
    the rank."""
    from c2dsr_tpu_torch.config import DataSpec
    from c2dsr_tpu_torch.data import preprocess, synthetic
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.train import loop
    t0 = time.perf_counter()
    sp = DataSpec(n_item_a=spec.n_item_a, n_item_b=spec.n_item_b,
                  len_max=cfg.len_max)
    tr = preprocess.preprocess_train(
        synthetic.generate_sequences(sp, 2000, seed=11), sp, seed=1)
    ev = preprocess.preprocess_evaluate(
        synthetic.generate_sequences(sp, EVAL_USERS_WIDE, seed=12), sp,
        n_neg_sample=999, seed=2)
    init = params_mod.params_to_numpy(params_mod.init_params(
        cfg, sp, torch.Generator().manual_seed(4), "cpu"))
    batches = [{k: v[i * cfg.batch_size:(i + 1) * cfg.batch_size]
                for k, v in tr.items()} for i in range(GRAPH_SPE)]
    st_c, aux_c, _ = _graph_run(cfg, sp, graphs, init, batches, True)
    st_e, aux_e, _ = _graph_run(cfg, sp, graphs, init, batches, False)
    _bitwise(f"{name} captured steps", _graph_tensors(st_c) + aux_c,
             _graph_tensors(st_e) + aux_e)
    log(f"{name} run (d_latent {cfg.d_latent}, {cfg.n_head} heads, len_max "
        f"{cfg.len_max}): {GRAPH_SPE} captured steps bitwise the eager "
        f"program's, losses {[round(float(a[0]), 5) for a in aux_c]} "
        f"({time.perf_counter() - t0:.1f} s)")
    del st_c, st_e, aux_c, aux_e
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reset_launches()
    if name == "long":
        exp = loop.Experiment(cfg, sp, graphs, tr, ev, ev, device="cuda")
        exp.run_train_epoch()
        steps = len(exp.train_iter)
        mode = exp.train_step.mode
        del exp
    else:
        state, opt = _graph_state(cfg, sp, init)
        from c2dsr_tpu_torch.train import step as step_mod
        fn = step_mod.make_train_step(cfg, sp, graphs, opt, "cuda")
        for b in batches:
            state, aux = fn(state, b)
        torch.cuda.synchronize()
        steps, mode = len(batches), fn.mode
        check(math.isfinite(float(aux["loss"])), f"{name} run: loss")
        del state, opt, fn
    launches = read_launches()
    log(f"{name} run: {steps} steps ({mode}) in "
        f"{time.perf_counter() - t0:.1f} s, launches {launches}")
    check(all(launches[k] > 0 for k in ("spmm_csr", "encoder_fwd",
                                        "encoder_bwd", "ce_fwd", "ce_bwd",
                                        "segsum")),
          f"{name} run: a kernel did not launch: {launches}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serving = phase_main(sp, graphs_host, ev, cfg, label=f"serving {name}")
    log(f"{name} run: full rank {time.perf_counter() - t0:.1f} s")
    for k, v in serving.items():
        launches[k] += v
    torch.cuda.empty_cache()
    return launches


ODD_WIDTHS = ((36, 1), (10, 2))   # (d_latent, n_head) that the JAX package
                                  # trains and the kernels take padded


def phase_odd_widths(spec, train, graphs, graphs_host, eval_data):
    """One FK-geometry train step on the card at each of ODD_WIDTHS,
    dropout 0: K1/K6 and K7 take d % 4, K4/K5 d % 8, so the op-level
    callers zero-pad d (ops/padding); the towers run plain there (head dim
    not a multiple of 8, as in the JAX package).  The loss within 1e-5
    relative and every gradient within GRAD_TOL (max abs over max, per
    tensor) of the same step on the CPU; then the step through the step
    function, with its kernels' launches; then the serving path at that
    width against the plain versions' run (phase_main: ranks equal but at
    near-ties).  Returns the kernels' launches over the steps and serving
    runs."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import spmm
    from c2dsr_tpu_torch.train import optim
    from c2dsr_tpu_torch.train import step as step_mod

    cpu_graphs = c2dsr.Graphs(spmm.device_graph(graphs_host[0], "cpu"),
                              spmm.device_graph(graphs_host[1], "cpu"))
    batch = {k: v[:512] for k, v in train.items()}
    launches = dict.fromkeys(read_launches(), 0)
    for d, n_head in ODD_WIDTHS:
        cfg = Config(d_latent=d, n_head=n_head, dropout_gnn=0.0,
                     dropout_attn=0.0)
        tag = f"odd width d_latent {d} n_head {n_head}"
        params = params_mod.init_params(cfg, spec,
                                        torch.Generator().manual_seed(4),
                                        "cuda")
        opt = optim.make_optimizer(cfg, steps_per_epoch=10)
        state = step_mod.init_state(params, opt)
        leaves = state.opt_state.leaves
        reset_launches()
        loss_k, g_k = _loss_grads(state.params, leaves, graphs,
                                  ranker.to_device(batch, "cuda"), cfg, spec,
                                  contextlib.nullcontext())
        got = read_launches()
        cpu = params_mod.params_from_numpy(
            params_mod.params_to_numpy(state.params), "cpu")
        cpu_leaves = step_mod.param_leaves(cpu)
        for t in cpu_leaves:
            t.requires_grad_(True)
        loss_c, g_c = _loss_grads(cpu, cpu_leaves, cpu_graphs,
                                  ranker.to_device(batch, "cpu"), cfg, spec,
                                  contextlib.nullcontext())
        names = leaf_names(state.params)
        rel = [_rel(a.cpu(), c) if float(c.abs().max()) > 0
               else float(a.abs().max()) for a, c in zip(g_k, g_c)]
        fro, wf = _fro(g_k, g_c)
        wm = int(np.argmax(rel))
        log(f"{tag}: loss {loss_k:.7f} (card) {loss_c:.7f} (CPU); gradients "
            f"worst max-abs rel err {rel[wm]:.3e} ({names[wm]}), worst "
            f"relative Frobenius {fro:.3e} ({names[wf]}); launches of the "
            f"loss and backward {got}")
        check(abs(loss_k - loss_c) <= 1e-5 * abs(loss_c),
              f"{tag}: loss {loss_k} (card) != {loss_c} (CPU)")
        check(rel[wm] <= GRAD_TOL, f"{tag}: gradient {names[wm]} rel err "
              f"{rel[wm]} > {GRAD_TOL}")
        check(got["encoder_fwd"] == 0 and all(
            got[k] > 0 for k in ("spmm_csr", "ce_fwd", "ce_bwd", "segsum")),
            f"{tag}: launches {got}")
        fn = step_mod.make_train_step(cfg, spec, graphs, opt, "cuda")
        reset_launches()
        state, aux = fn(state, batch)
        torch.cuda.synchronize()
        got = read_launches()
        check(math.isfinite(float(aux["loss"])), f"{tag}: step loss")
        per_step = {"spmm_csr": 4 * cfg.n_gnn, "ce_fwd": 2, "ce_bwd": 2,
                    "segsum": LOOKUPS, "encoder_fwd": 0, "encoder_bwd": 0}
        for k, n in per_step.items():
            check(got[k] == n, f"{tag}: {k} launched {got[k]} times in a "
                  f"step, want {n}")
        for k, v in got.items():
            launches[k] += v
        del state, opt, fn, leaves, g_k, g_c
        serving = phase_main(spec, graphs_host, eval_data, cfg,
                             label=f"serving {tag}", fused_towers=False)
        for k, v in serving.items():
            launches[k] += v
    return launches


def _bf16_fro(got, want, rows=None):
    """||got - want|| / ||want|| over ``rows`` (a [B, L] mask) or all."""
    d = got.double() - want.double()
    w = want.double()
    if rows is not None:
        d, w = d[rows], w[rows]
    return float(d.norm()) / max(float(w.norm()), 1e-300)


def _bf16_entry(ms, plain_ms, library_ms, flops, nbytes, peak_bw, err,
                err_f32, **extra):
    """A bf16 instantiation's numbers: its bounds at the bf16 tensor-core
    peak and at one TF32 pass a product (bench/timing), and the bytes'."""
    gpu = torch.cuda.get_device_name(0)
    bound, bound_tf32 = timing.bf16_bounds_ms(flops, nbytes, gpu, peak_bw)
    bound_bytes = nbytes / peak_bw * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_tf32_one_pass_ms": bound_tf32,
            "bound_bytes_ms": bound_bytes,
            "bound_by": "operations" if bound > bound_bytes else "bytes",
            "max_rel_err": err, "f32_instantiation_err": err_f32, **extra}


# The kernels whose instruction mix the SASS check reads (``_mma_sass``):
# (library stem, regex on a mangled kernel name, its groups' names).  The
# bf16 instantiations (a ``bf16`` group of 1, or the towers' ``TERMS`` 1)
# run m16n8k16 bf16 MMAs (HMMA.16816.F32.BF16) and no TF32 one, the f32
# ones the reverse: the CE (K4, K5), the towers' products with a weight
# (K2's GEMM, K3's GEMM and weight gradients) and their attention past L 64
# (K2's encoder_fwd_attn_kernel, K3's attn_bwd_dq_kernel and
# attn_bwd_dkv_kernel).
SASS_KERNELS = (
    ("ce", r"ce_fwd_kernelILi(\d+)ELi0ELb([01])E", ("DT", "bf16")),
    ("ce", r"ce_fwd_wide_kernelILb([01])E", ("bf16",)),
    ("ce", r"ce_bwd_kernelILi(\d+)ELb([01])ELb([01])E",
     ("DT", "dh", "bf16")),
    ("ce", r"ce_bwd_wide_kernelILb([01])ELb([01])E", ("dh", "bf16")),
    ("ce_cluster", r"ce_bwd_cluster_kernelILi(\d+)ELb([01])ELb([01])"
     r"ELb([01])E", ("WS", "dh", "bf16", "gather")),
    ("ce_onepass", r"ce_bwd_onepass_kernelILi(\d+)EE", ("DT",)),
    ("encoder", r"encoder_fwd_gemm_kernelILi(\d+)ELi(\d)ELb([01])E",
     ("NT", "TERMS", "kMap")),
    ("encoder_bwd", r"tc_gemm_kernelILi(\d+)ELb([01])ELi(\d)E",
     ("NT", "kMap", "TERMS")),
    ("encoder_bwd", r"wgrad_kernelILb([01])E", ("bf16",)),
    ("encoder", r"encoder_fwd_attn_kernelILb([01])E", ("bf16",)),
    ("encoder_bwd", r"attn_bwd_dq_kernelILb([01])E", ("bf16",)),
    ("encoder_bwd", r"attn_bwd_dkv_kernelILb([01])E", ("bf16",)),
    ("encoder", r"encoder_fwd_gemm_wgmma_kernelILi(\d)ELb([01])E",
     ("MODE", "kMap")),
    ("encoder_bwd", r"tc_gemm_kernel_wgmmaILi(\d)ELb([01])E",
     ("MODE", "kMap")))
WGMMA_KERNELS = ("encoder_fwd_gemm_wgmma_kernel", "tc_gemm_kernel_wgmma")
ATTN_KERNELS = ("encoder_fwd_attn_kernel", "attn_bwd_dq_kernel",
                "attn_bwd_dkv_kernel")


# The SASS readings (``_mma_sass``) each bf16 entry of the kernels line
# carries: its kernels' bf16 instantiations, by name prefix.
SASS_PREFIXES = {"encoder_fwd_bf16": ("encoder_fwd_gemm_kernel",
                                      "encoder_fwd_attn_kernel"),
                 "encoder_bwd_bf16": ("tc_gemm_kernel", "wgrad_kernel",
                                      "attn_bwd_dq_kernel",
                                      "attn_bwd_dkv_kernel"),
                 "ce_fwd_bf16": ("ce_fwd",), "ce_bwd_bf16": ("ce_bwd",)}


def _mma_sass():
    """The MMAs each kernel of SASS_KERNELS was compiled to, read by
    ``cuobjdump -sass`` from the built libraries: for every instantiation
    its counts of bf16 (``HMMA.16816.F32.BF16``) and TF32
    (``HMMA.1684.F32.TF32``) MMA instructions.  Fails unless every bf16
    instantiation (the resident and wide K4, the resident and wide K5, the
    cluster kernels, K2's GEMM, K3's GEMM and weight gradients at every
    tile width, K2's and K3's attention kernels past L 64) has bf16 MMAs
    and no TF32 one, and every f32 one the reverse, and every f32
    attention kernel is in the listing; the wgmma tile's kernels (K2's and
    K3's products past d 256, WGMMA_KERNELS) have warpgroup MMAs (HGMMA)
    of their type and no mma.sync, and no other kernel has an HGMMA."""
    import shutil
    from c2dsr_tpu_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.path.exists(tool), "cuobjdump not found: the SASS check needs "
          "the CUDA toolkit")
    libs = build.build_all()
    out, seen = {}, set()
    for stem in sorted({k[0] for k in SASS_KERNELS}):
        res = subprocess.run([tool, "-sass", libs[stem]], capture_output=True,
                             text=True, timeout=300)
        check(res.returncode == 0, f"cuobjdump -sass {stem}: "
              f"{res.stderr[-2000:]}")
        # "Function : <mangled name>" opens each kernel's listing
        for part in re.split(r"\n\s*Function : ", res.stdout)[1:]:
            name, _, body = part.partition("\n")
            for lib, pattern, groups in SASS_KERNELS:
                m = re.search(pattern, name)
                if lib != stem or not m:
                    continue
                args = dict(zip(groups, m.groups()))
                key = ",".join(f"{k}={v}" for k, v in args.items())
                kind = pattern.split("I", 1)[0]
                is_bf = args.get("bf16", args.get("TERMS",
                                                  args.get("MODE"))) == "1"
                bf = len(re.findall(r"HMMA\.16816\.F32\.BF16", body))
                tf = len(re.findall(r"HMMA\.\S*TF32", body))
                hg = [ln for ln in body.splitlines() if "HGMMA" in ln]
                hg_bf = sum("BF16" in ln for ln in hg)
                hg_tf = sum("TF32" in ln for ln in hg)
                out[f"{kind}<{key}>"] = {"hmma_bf16": bf, "hmma_tf32": tf,
                                         "hgmma": len(hg)}
                seen.add((kind, args.get("DT", args.get("NT")), is_bf))
                if kind in WGMMA_KERNELS:
                    # wgmma alone: HGMMA of the instantiation's type, no
                    # mma.sync
                    check(bf == tf == 0 and len(hg) > 0
                          and (hg_bf if is_bf else hg_tf) == len(hg),
                          f"SASS {kind} {key}: {len(hg)} HGMMA ({hg_bf} "
                          f"bf16, {hg_tf} TF32), {bf + tf} HMMA (want "
                          f"{'bf16' if is_bf else 'TF32'} HGMMA only)")
                    continue
                # no wgmma where it was not written (the d <= 256 path)
                check(not hg, f"SASS {kind} {key}: {len(hg)} HGMMA")
                if is_bf:
                    check(bf > 0 and tf == 0, f"SASS {kind} {key}: {bf} "
                          f"bf16 and {tf} TF32 MMAs (want bf16 MMAs only)")
                else:
                    check(tf > 0 and bf == 0, f"SASS {kind} {key}: {bf} "
                          f"bf16 and {tf} TF32 MMAs (want TF32 MMAs only)")
    want = ({(k, str(dt), True) for k in ("ce_fwd_kernel", "ce_bwd_kernel",
                                          "encoder_fwd_gemm_kernel",
                                          "tc_gemm_kernel")
             for dt in (64, 128, 256)}
            | {(k, None, True) for k in ("ce_fwd_wide_kernel",
                                         "ce_bwd_wide_kernel",
                                         "ce_bwd_cluster_kernel",
                                         "wgrad_kernel")}
            | {(k, None, bf) for k in ATTN_KERNELS + WGMMA_KERNELS
               for bf in (False, True)}
            | {("ce_bwd_onepass_kernel", str(dt), False) for dt in (64, 128)})
    check(want <= seen, f"SASS: instantiations not in the listing: "
          f"{sorted(want - seen, key=str)}")
    log("sass: " + json.dumps(out))
    return out


def _bf16_spmm(graphs, train, timer, peak_bw):
    """K1 (over A and Aᵀ) and K6 (dest over A, src over Aᵀ with one FK
    batch's flags) in their bf16 instantiations against the plain bf16 hop,
    each over the share (d 128) and A|B (d 256) tables, and the f32
    instantiation against the same plain bf16 hop, which must fail
    SPMM_BF16_TOL; K1 also bitwise across launches.  Summed over the hops."""
    from c2dsr_tpu_torch.ops import spmm, spmm_cuda
    _, (f_share, f_ab) = _flagged_batch(train, 512)
    gen = torch.Generator(device="cuda").manual_seed(12)
    n_rows = 65536
    out = {}
    for kind in ("dense", "flagged"):
        acc = {"ms": 0.0, "plain_ms": 0.0, "nbytes": 0, "flops": 0,
               "err": 0.0, "err_f32": float("inf"), "max_abs_err": 0.0,
               "library_ms": 0.0}
        for name, g, d, flag in (("share", graphs.share, 128, f_share),
                                 ("specific_ab", graphs.specific, 256, f_ab)):
            for mode, graph in (("dest", g), ("src", g.t)):
                x = torch.randn((n_rows, d), generator=gen, device="cuda")
                x[g.n:] = 0.0
                if kind == "flagged":
                    if mode == "src":
                        x = x * flag[:, None]

                    def run(bf16=True):
                        return spmm_cuda.spmm_csr_flagged(graph, x, flag,
                                                          mode, bf16)

                    def plain():
                        return spmm.spmm_reference_flagged(graph, x, flag,
                                                           mode, True)
                else:
                    def run(bf16=True):
                        return spmm_cuda.spmm_csr(graph, x, bf16=bf16)

                    def plain():
                        return spmm.spmm_reference(graph, x, bf16=True)
                got, ref, f32 = run(), plain(), run(False)
                again = run()
                torch.cuda.synchronize()
                err, err32 = _rel(got, ref), _rel(f32, ref)
                tag = f"bf16 spmm {kind} {name} {mode}"
                check(bool(torch.isfinite(got).all()), f"{tag}: non-finite")
                check(err <= SPMM_BF16_TOL, f"{tag}: rel err {err} > "
                      f"{SPMM_BF16_TOL}")
                check(err32 > SPMM_BF16_TOL, f"{tag}: the f32 instantiation "
                      f"passes the bf16 gate ({err32})")
                check(torch.equal(got, again), f"{tag}: two launches differ")
                ms = timer(run)
                plain_ms = timer(plain)
                lib_ms = _sparse_mm_bf16_ms(graph, x, timer)
                acc["library_ms"] = (None if lib_ms is None
                                     or acc["library_ms"] is None
                                     else acc["library_ms"] + lib_ms)
                keep = (flag[(graph.rows if mode == "dest"
                              else graph.cols).long()].bool()
                        if kind == "flagged" else
                        torch.ones_like(graph.cols, dtype=torch.bool))
                nnz = int(keep.sum())
                used = int(torch.unique(graph.cols[keep]).numel())
                acc["nbytes"] += (used * d * 4 + n_rows * d * 4 + nnz * 8
                                  + (g.n + 1) * 4)
                acc["flops"] += 2 * nnz * d
                log(f"{tag}: d={d} kept edges {nnz} rel err {err:.3e} (f32 "
                    f"instantiation {err32:.3e}), two launches bitwise "
                    f"equal; kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
                acc["ms"] += ms
                acc["plain_ms"] += plain_ms
                acc["err"] = max(acc["err"], err)
                acc["err_f32"] = min(acc["err_f32"], err32)
                acc["max_abs_err"] = max(acc["max_abs_err"],
                                         float((got - ref).abs().max()))
        out[kind] = _bf16_entry(acc["ms"], acc["plain_ms"], acc["library_ms"],
                                acc["flops"], acc["nbytes"], peak_bw,
                                acc["err"], acc["err_f32"],
                                max_abs_err=acc["max_abs_err"])
    return out


def _sparse_mm_bf16_ms(graph, x, timer):
    """The library yardstick of a bf16 hop: ``torch.sparse.mm`` of the
    graph's CSR in bf16 by the table in bf16 (dense over every edge, as
    the f32 one; it rounds its output to bf16, which the kernel does not),
    or None where this PyTorch has no bf16 CSR product on the card."""
    n_rows = x.shape[0]
    rowptr = torch.cat([graph.rowptr,
                        graph.rowptr[-1:].expand(n_rows - graph.n)])
    csr = torch.sparse_csr_tensor(rowptr.long(), graph.cols.long(),
                                  graph.vals.to(torch.bfloat16),
                                  size=(n_rows, n_rows),
                                  check_invariants=False)
    xb = x.to(torch.bfloat16)
    try:
        torch.sparse.mm(csr, xb)
    except (RuntimeError, NotImplementedError) as e:
        log(f"bf16 spmm library: torch.sparse.mm refuses bf16 ({e})")
        return None
    return timer(lambda: torch.sparse.mm(csr, xb))


def _bf16_towers(timer, peak_bw):
    """K2 in eval (B 2048) and K2/K3 at a train step's three towers
    (dropout 0.2, K3 from the activations K2 saves) in their bf16
    instantiations against the plain bf16 tower (K3 at K2's branches),
    with the f32 instantiations in their place, which must fail; K2/K3
    bitwise across launches.  d 128, L 15, one head, one layer."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import dropout as drop
    from c2dsr_tpu_torch.ops import encoder_cuda
    d, L, pad = 128, LEN_MAX, 64093
    cfg = Config()
    w_bytes = 4 * (6 * d * d + 10 * d + 2 * d)
    fwd = {"ms": 0.0, "plain_ms": 0.0, "flops": 0, "nbytes": 0, "err": 0.0,
           "err_f32": float("inf"), "max_abs_err": 0.0, "library_ms": 0.0}
    bwd = dict(fwd)
    eval_res = None
    for tower_id, n_seq, dropout in ((0, 2048, 0.0), (0, 1536, 0.2),
                                     (1, 512, 0.2), (2, 512, 0.2)):
        train = dropout > 0
        p = params_mod._map(lambda t: t.cuda(), params_mod.init_encoder_params(
            torch.Generator().manual_seed(30 + tower_id), cfg, L))
        x, seq = _encoder_inputs(n_seq, L, d, pad, seed=40 + tower_id)
        live = seq != pad
        live = live.long().cumsum(1) > 0         # rows with an allowed key
        kw = dict(idx_pad=pad, n_head=1, invert_padding_mask=False,
                  dropout=dropout, seed=drop.seed_tensor(99, "cuda"),
                  tower=tower_id)
        acts = encoder_cuda.saved_buffer(x, 1, 1) if train else None
        acts32 = encoder_cuda.saved_buffer(x, 1, 1) if train else None
        with torch.no_grad():
            out = encoder_cuda.encoder_fwd(x, seq, p, saved=acts, bf16=True,
                                           **kw)
            out2 = encoder_cuda.encoder_fwd(x, seq, p, bf16=True, **kw)
            ref = enc.encoder_fwd_plain(x, seq, p, bf16=True, **kw)
            out32 = encoder_cuda.encoder_fwd(x, seq, p, saved=acts32, **kw)
        err, err32 = _bf16_fro(out, ref, live), _bf16_fro(out32, ref, live)
        tag = f"bf16 encoder tower {tower_id} B={n_seq} p={dropout}"
        check(bool(torch.isfinite(out).all()), f"{tag}: non-finite")
        check(torch.equal(out, out2), f"{tag}: two forward launches differ")
        check(err <= K2_BF16_TOL, f"{tag}: fwd relative Frobenius {err} > "
              f"{K2_BF16_TOL}")
        check(err32 > K2_BF16_TOL, f"{tag}: the f32 instantiation passes "
              f"the bf16 gate ({err32})")
        with torch.no_grad():
            f_ms = timer(lambda: encoder_cuda.encoder_fwd(
                x, seq, p, saved=acts, bf16=True, **kw))
            f_plain = timer(lambda: enc.encoder_fwd_plain(x, seq, p,
                                                          bf16=True, **kw))
        gout = torch.randn(x.shape, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(5))
        f_lib, fb_lib = _bf16_tower_library(p, x, seq, gout, pad, 1, dropout,
                                            timer)
        N = n_seq * L
        f_flops = 12 * N * d * d + 4 * N * L * d
        f_bytes = (8 * N * d + 4 * N + w_bytes
                   + (4 * acts.numel() if train else 0))
        abs_f = float((out - ref)[live].abs().max())
        log(f"{tag}: fwd relative Frobenius {err:.3e} (f32 instantiation "
            f"{err32:.3e}), max abs {abs_f:.3e} (rows with a key); kernel "
            f"{f_ms:.4f} ms plain {f_plain:.4f} ms")
        if not train:
            eval_res = _bf16_entry(f_ms, f_plain, f_lib, f_flops, f_bytes,
                                   peak_bw, err, err32, max_abs_err=abs_f)
            continue
        fwd["max_abs_err"] = max(fwd["max_abs_err"], abs_f)
        fwd["ms"] += f_ms
        fwd["plain_ms"] += f_plain
        fwd["library_ms"] += f_lib
        bwd["library_ms"] += fb_lib
        fwd["flops"] += f_flops
        fwd["nbytes"] += f_bytes
        fwd["err"] = max(fwd["err"], err)
        fwd["err_f32"] = min(fwd["err_f32"], err32)
        got = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts, bf16=True,
                                       **kw)
        again = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts,
                                         bf16=True, **kw)
        got32 = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts32, **kw)
        ref = enc.encoder_bwd_plain(
            x, seq, gout, p, bf16=True, branches=gates.k2_branches(
                acts, x.shape, 1, 1, tower_id), **kw)
        torch.cuda.synchronize()
        flat = [got[0]] + list(got[1])
        flat32 = [got32[0]] + list(got32[1])
        flat_ref = [ref[0]] + list(ref[1])
        errs = [_bf16_fro(a, r) for a, r in zip(flat, flat_ref)]
        errs32 = [_bf16_fro(a, r) for a, r in zip(flat32, flat_ref)]
        check(all(torch.equal(a, b) for a, b in
                  zip(flat, [again[0]] + list(again[1]))),
              f"{tag}: two backward launches differ")
        check(max(errs) <= K3_BF16_TOL, f"{tag}: bwd relative Frobenius "
              f"{max(errs)} > {K3_BF16_TOL}")
        check(max(errs32) > K3_BF16_TOL, f"{tag}: the f32 instantiation's "
              f"backward passes the bf16 gate ({max(errs32)})")
        b_ms = timer(lambda: encoder_cuda.encoder_bwd(
            x, seq, gout, p, saved=acts, bf16=True, **kw))
        b_plain = timer(lambda: enc.encoder_bwd_plain(x, seq, gout, p,
                                                      bf16=True, **kw))
        log(f"{tag}: bwd worst relative Frobenius {max(errs):.3e} (f32 "
            f"instantiation {max(errs32):.3e}), two launches bitwise equal; "
            f"kernel {b_ms:.4f} ms plain {b_plain:.4f} ms")
        bwd["ms"] += b_ms
        bwd["plain_ms"] += b_plain
        bwd["flops"] += 24 * N * d * d + 8 * N * L * d
        bwd["nbytes"] += 12 * N * d + 4 * N + 2 * w_bytes
        bwd["err"] = max(bwd["err"], max(errs))
        bwd["err_f32"] = min(bwd["err_f32"], max(errs32))
        bwd["max_abs_err"] = max([bwd["max_abs_err"]] + [
            float((a - r).abs().max()) for a, r in zip(flat, flat_ref)])
    res = {"eval": eval_res}
    for key, acc in (("train", fwd), ("bwd", bwd)):
        res[key] = _bf16_entry(acc["ms"], acc["plain_ms"], acc["library_ms"],
                               acc["flops"], acc["nbytes"], peak_bw,
                               acc["err"], acc["err_f32"],
                               max_abs_err=acc["max_abs_err"])
    return res


def _bf16_tower_library(p, x, seq, gout, pad, n_head, dropout, timer):
    """The library yardstick of a bf16 tower: ``nn.TransformerEncoder``
    with the same weights in bf16, the same masks, in train mode at
    ``dropout`` (eval at 0): (its forward ms, its forward + backward ms)."""
    from c2dsr_tpu_torch.bench import kernel_bench
    L, d = x.shape[1], x.shape[2]
    tower = kernel_bench.torch_tower(p, d, n_head, 1, dropout=dropout).to(
        torch.bfloat16)
    causal = torch.triu(torch.ones(L, L, dtype=torch.bool, device="cuda"), 1)
    kpm = seq == pad
    xb = x.to(torch.bfloat16)
    xg = xb.clone().requires_grad_(True)
    gb = gout.to(torch.bfloat16)
    params = [xg] + list(tower.parameters())
    with torch.no_grad():
        f_ms = timer(lambda: tower(xb, mask=causal, src_key_padding_mask=kpm))
    fb_ms = timer(lambda: torch.autograd.grad(
        tower(xg, mask=causal, src_key_padding_mask=kpm), params, gb))
    return f_ms, fb_ms


def _bf16_ce(timer, peak_bw):
    """K4 and K5 in their bf16 instantiations at a train step's shapes
    (both domains, N 10,240, d 128) on a bf16 W (the bf16 classifier):
    against the plain bf16 CE, with the f32 instantiations on the f32 W in
    their place, which must fail; bitwise across launches; the bf16 W and
    an f32 W rounded in the pre-pass give the same bits (dW: the f32 one
    rounded).  Summed over the domains."""
    from c2dsr_tpu_torch.bench import kernel_bench
    from c2dsr_tpu_torch.bench.kernel_bench import mm_bf16_f32
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    N, d = 512 * 2 * 10, 128
    fwd = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0,
           "nbytes": 0, "err": 0.0, "err_f32": float("inf"),
           "max_abs_err": 0.0}
    bwd = dict(fwd)
    for dom, V, n_real in (("A", 30720, N_ITEM_A), ("B", 36864, N_ITEM_B)):
        h, w, bm, pad_l, tgt, real, dlse, dt = _ce_inputs(N, d, V, n_real,
                                                          V + 2)
        wb = w.to(torch.bfloat16)
        with torch.no_grad():
            lse, tlog = fused_ce_cuda.ce_fwd(h, wb, bm, pad_l, tgt)
            again = fused_ce_cuda.ce_fwd(h, wb, bm, pad_l, tgt)
            via_f32 = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt, bf16=True)
            rlse, rtlog = fused_ce.ce_fwd_plain(h, wb, bm, pad_l, tgt)
            lse32, tlog32 = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)
            got = fused_ce_cuda.ce_bwd(h, wb, bm, lse, dlse, dt, tgt)
            got2 = fused_ce_cuda.ce_bwd(h, wb, bm, lse, dlse, dt, tgt)
            got_f = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt,
                                         bf16=True)
            want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt,
                                         bf16=True)
            got32 = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
        torch.cuda.synchronize()
        tag = f"bf16 ce {dom} N={N} d={d} V={V}"
        e_f = max(_rel(lse, rlse), _rel(tlog[real], rtlog[real]))
        e_f32 = max(_rel(lse32, rlse), _rel(tlog32[real], rtlog[real]))
        check(e_f <= CE_BF16_TOL, f"{tag}: fwd rel err {e_f} > "
              f"{CE_BF16_TOL}")
        check(e_f32 > CE_BF16_TOL, f"{tag}: the f32 instantiation passes "
              f"the bf16 gate ({e_f32})")
        check(torch.equal(lse, again[0]) and torch.equal(tlog, again[1])
              and torch.equal(lse, via_f32[0])
              and torch.equal(tlog, via_f32[1]),
              f"{tag}: forward launches (bf16 W twice, f32 W rounded) differ")
        check(got[1].dtype == torch.bfloat16, f"{tag}: dW not in W's dtype")
        check(all(torch.equal(a, b) for a, b in zip(got, got2))
              and torch.equal(got[0], got_f[0])
              and torch.equal(got[1], got_f[1].to(torch.bfloat16))
              and torch.equal(got[2], got_f[2]),
              f"{tag}: backward launches (bf16 W twice, f32 W) differ")
        rels = {n: _rel(a, r) for n, a, r in zip(("dh", "dw", "db"), got_f,
                                                 want)}
        rels32 = {n: _rel(a, r) for n, a, r in zip(("dh", "dw", "db"), got32,
                                                   want)}
        check(max(rels.values()) <= CE_BWD_BF16_TOL, f"{tag}: bwd rel err "
              f"{rels} > {CE_BWD_BF16_TOL}")
        check(max(rels32.values()) > CE_BWD_BF16_TOL, f"{tag}: the f32 "
              f"instantiation's backward passes the bf16 gate ({rels32})")
        with torch.no_grad():
            f_ms = timer(lambda: fused_ce_cuda.ce_fwd(h, wb, bm, pad_l, tgt))
            f_plain = timer(lambda: fused_ce.ce_fwd_plain(h, wb, bm, pad_l,
                                                          tgt))
            hb = h.to(torch.bfloat16)
            lib = None
            if mm_bf16_f32(hb[:1], wb[:, :1]) is not None:
                lib = timer(lambda: kernel_bench.ce_fwd_bf16_library(
                    hb, wb, bm, pad_l, tgt))
            b_ms = timer(lambda: fused_ce_cuda.ce_bwd(h, wb, bm, lse, dlse,
                                                      dt, tgt))
            b_plain = timer(lambda: fused_ce.ce_bwd_plain(h, wb, bm, lse,
                                                          dlse, dt, tgt))
        b_lib, lib_errs = _ce_bwd_bf16_library(timer, h, wb, bm, lse, dlse,
                                               dt, tgt)
        log(f"{tag}: fwd rel err {e_f:.3e} (f32 instantiation {e_f32:.3e}); "
            "bwd rel err " + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
            + " (f32 instantiation " + ", ".join(
                f"{k} {v:.3e}" for k, v in rels32.items()) + "); launches "
            f"bitwise equal; fwd kernel {f_ms:.4f} ms plain {f_plain:.4f} "
            f"library {lib} (mm with bf16 operands into f32, logsumexp, "
            f"gather); bwd kernel {b_ms:.4f} ms plain {b_plain:.4f} library "
            f"{b_lib} (kernel_bench.ce_bwd_bf16_library, errors from the "
            f"plain bf16 CE {lib_errs})")
        io = 4 * (N * d + V + 3 * N) + 2 * d * V
        fwd["ms"] += f_ms
        fwd["plain_ms"] += f_plain
        fwd["library_ms"] = (None if lib is None or fwd["library_ms"] is None
                             else fwd["library_ms"] + lib)
        fwd["flops"] += 2 * N * V * d
        fwd["nbytes"] += io + 8 * N
        fwd["err"] = max(fwd["err"], e_f)
        fwd["err_f32"] = min(fwd["err_f32"], e_f32)
        fwd["max_abs_err"] = max(fwd["max_abs_err"],
                                 float((lse - rlse).abs().max()))
        bwd["ms"] += b_ms
        bwd["plain_ms"] += b_plain
        bwd["library_ms"] = (None if b_lib is None or bwd["library_ms"] is None
                             else bwd["library_ms"] + b_lib)
        bwd["flops"] += 4 * N * V * d
        bwd["nbytes"] += 2 * io + 4 * N * d
        bwd["err"] = max(bwd["err"], max(rels.values()))
        bwd["err_f32"] = min(bwd["err_f32"], max(rels32.values()))
        bwd["max_abs_err"] = max([bwd["max_abs_err"]] + [
            float((a - r).abs().max()) for a, r in zip(got_f, want)])
    return {key: _bf16_entry(acc["ms"], acc["plain_ms"], acc["library_ms"],
                             acc["flops"], acc["nbytes"], peak_bw, acc["err"],
                             acc["err_f32"], max_abs_err=acc["max_abs_err"])
            for key, acc in (("fwd", fwd), ("bwd", bwd))}


BF16_TOWERS = ((128, 1, 200, 256), (1024, 8, 15, 256))   # (d, heads, L, B)
BF16_CE_WIDE = 1024
BF16_CE_DS = (256, BF16_CE_WIDE)   # K4/K5 bf16's widths in phase_shapes:
                                   # the resident kernels' widest (a Y tile
                                   # of one k16 step), and K4's wide kernel
                                   # and K5's cluster


def _bf16_shapes(timer, peak_bw):
    """The bf16 instantiations at one long and one wide tower (BF16_TOWERS:
    K2 at dropout 0.2 saving K3's activations, K3 at K2's branches, one
    layer) and K4/K5 at d BF16_CE_DS (``_bf16_ce_width``: domain A's rows
    and vocab, a bf16 W): against the plain bf16 versions at the FK limits,
    the f32 instantiations failing each, bitwise across launches; timed
    beside the plain versions and the library's bf16 calls, with the bounds
    of ``_bf16_entry`` (the towers' work as ``_tower_work`` counts it, the
    CE's as ``_bf16_ce``)."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import dropout as drop
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import encoder_cuda
    pad, out = 64093, {}
    for d, n_head, L, B in BF16_TOWERS:
        p = params_mod._map(lambda t: t.cuda(), params_mod.init_encoder_params(
            torch.Generator().manual_seed(d), Config(d_latent=d,
                                                     n_head=n_head), L))
        x, seq = _encoder_inputs(B, L, d, pad, seed=d + 1)
        live = (seq != pad).long().cumsum(1) > 0
        kw = dict(idx_pad=pad, n_head=n_head, invert_padding_mask=False,
                  dropout=0.2, seed=drop.seed_tensor(99, "cuda"), tower=0)
        acts = encoder_cuda.saved_buffer(x, n_head, 1)
        acts32 = encoder_cuda.saved_buffer(x, n_head, 1)
        with torch.no_grad():
            got = encoder_cuda.encoder_fwd(x, seq, p, saved=acts, bf16=True,
                                           **kw)
            got2 = encoder_cuda.encoder_fwd(x, seq, p, bf16=True, **kw)
            ref = enc.encoder_fwd_plain(x, seq, p, bf16=True, **kw)
            got32 = encoder_cuda.encoder_fwd(x, seq, p, saved=acts32, **kw)
        tag = f"bf16 encoder d={d} n_head={n_head} L={L} B={B}"
        e, e32 = _bf16_fro(got, ref, live), _bf16_fro(got32, ref, live)
        check(torch.equal(got, got2), f"{tag}: two forward launches differ")
        check(e <= K2_BF16_TOL and e32 > K2_BF16_TOL, f"{tag}: fwd relative "
              f"Frobenius {e} (f32 instantiation {e32}), limit {K2_BF16_TOL}")
        gout = torch.randn(x.shape, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(d))
        b = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts, bf16=True,
                                     **kw)
        b2 = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts, bf16=True,
                                      **kw)
        b32 = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts32, **kw)
        rb = enc.encoder_bwd_plain(
            x, seq, gout, p, bf16=True, branches=gates.k2_branches(
                acts, x.shape, n_head, 1, 0), **kw)
        torch.cuda.synchronize()
        flat, ref_flat = [b[0]] + list(b[1]), [rb[0]] + list(rb[1])
        eb = max(_bf16_fro(a, r) for a, r in zip(flat, ref_flat))
        eb32 = max(_bf16_fro(a, r) for a, r in
                   zip([b32[0]] + list(b32[1]), ref_flat))
        check(all(torch.equal(a, c) for a, c in
                  zip(flat, [b2[0]] + list(b2[1]))),
              f"{tag}: two backward launches differ")
        check(eb <= K3_BF16_TOL and eb32 > K3_BF16_TOL, f"{tag}: bwd "
              f"relative Frobenius {eb} (f32 instantiation {eb32}), limit "
              f"{K3_BF16_TOL}")
        with torch.no_grad():
            f_ms = timer(lambda: encoder_cuda.encoder_fwd(
                x, seq, p, saved=acts, bf16=True, **kw))
            f_plain = timer(lambda: enc.encoder_fwd_plain(x, seq, p,
                                                          bf16=True, **kw))
        b_ms = timer(lambda: encoder_cuda.encoder_bwd(
            x, seq, gout, p, saved=acts, bf16=True, **kw))
        b_plain = timer(lambda: enc.encoder_bwd_plain(x, seq, gout, p,
                                                      bf16=True, **kw))
        f_lib, fb_lib = _bf16_tower_library(p, x, seq, gout, pad, n_head,
                                            0.2, timer)
        flops, _, f_bytes, b_bytes = _tower_work(seq, pad, p, acts, n_head)
        fb = _bf16_entry(f_ms, f_plain, f_lib, flops, f_bytes, peak_bw, e,
                         e32)
        bb = _bf16_entry(b_ms, b_plain, fb_lib, 2 * flops, b_bytes, peak_bw,
                         eb, eb32)
        out[f"tower_d{d}_L{L}"] = {
            "fwd_ms": f_ms, "fwd_plain_ms": f_plain, "fwd_library_ms": f_lib,
            "bwd_ms": b_ms, "bwd_plain_ms": b_plain,
            "fwd_bwd_library_ms": fb_lib, "fwd_err": e, "fwd_err_f32": e32,
            "bwd_err": eb, "bwd_err_f32": eb32,
            **{f"{k}_{n}": r[n] for k, r in (("fwd", fb), ("bwd", bb))
               for n in ("bound_ms", "bound_tf32_one_pass_ms",
                         "bound_bytes_ms", "bound_by")}}
        log(f"{tag}: fwd relative Frobenius {e:.3e} (f32 instantiation "
            f"{e32:.3e}), bwd {eb:.3e} ({eb32:.3e}), launches bitwise equal; "
            f"K2 {f_ms:.4f} ms plain {f_plain:.4f} library {f_lib:.4f} bound "
            f"bf16 / one TF32 pass / bytes {fb['bound_ms']:.4f} / "
            f"{fb['bound_tf32_one_pass_ms']:.4f} / "
            f"{fb['bound_bytes_ms']:.4f}; K3 {b_ms:.4f} ms plain "
            f"{b_plain:.4f}, library fwd + bwd {fb_lib:.4f} bound "
            f"{bb['bound_ms']:.4f} / {bb['bound_tf32_one_pass_ms']:.4f} / "
            f"{bb['bound_bytes_ms']:.4f}")
        del acts, acts32, b, b2, b32, rb
        torch.cuda.empty_cache()
    for d in BF16_CE_DS:
        out[f"ce_d{d}"] = _bf16_ce_width(d, timer, peak_bw)
        torch.cuda.empty_cache()
    return out


def _bf16_ce_width(d, timer, peak_bw):
    """K4 and K5 bf16 at width d (domain A's rows and vocab, a bf16 W):
    against the plain bf16 CE at the FK limits, the f32 instantiations
    failing each, bitwise across launches; timed beside the plain versions
    and the library's bf16 calls, with the bounds of ``_bf16_entry``."""
    from c2dsr_tpu_torch.bench import kernel_bench
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    N, V, n_real = 512 * 2 * 10, 30720, N_ITEM_A
    h, w, bm, pad_l, tgt, real, dlse, dt = _ce_inputs(N, d, V, n_real, d)
    wb = w.to(torch.bfloat16)
    reps = 20 if d <= fused_ce_cuda.RESIDENT else 5
    with torch.no_grad():
        lse, tlog = fused_ce_cuda.ce_fwd(h, wb, bm, pad_l, tgt)
        again = fused_ce_cuda.ce_fwd(h, wb, bm, pad_l, tgt)
        rlse, rtlog = fused_ce.ce_fwd_plain(h, wb, bm, pad_l, tgt)
        lse32, tlog32 = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)
        got = fused_ce_cuda.ce_bwd(h, wb, bm, lse, dlse, dt, tgt)
        got2 = fused_ce_cuda.ce_bwd(h, wb, bm, lse, dlse, dt, tgt)
        got_f = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt, bf16=True)
        want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt, bf16=True)
        got32 = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
    torch.cuda.synchronize()
    design = ("K4's and K5's resident kernels" if d <= fused_ce_cuda.RESIDENT
              else "K4's wide kernel, K5's cluster")
    tag = f"bf16 ce N={N} d={d} V={V} ({design})"
    e = max(_rel(lse, rlse), _rel(tlog[real], rtlog[real]))
    e32 = max(_rel(lse32, rlse), _rel(tlog32[real], rtlog[real]))
    eb = max(_rel(a, r) for a, r in zip(got_f, want))
    eb32 = max(_rel(a, r) for a, r in zip(got32, want))
    check(torch.equal(lse, again[0]) and torch.equal(tlog, again[1])
          and all(torch.equal(a, c) for a, c in zip(got, got2)),
          f"{tag}: two launches differ")
    check(e <= CE_BF16_TOL and e32 > CE_BF16_TOL, f"{tag}: fwd rel err {e} "
          f"(f32 instantiation {e32}), limit {CE_BF16_TOL}")
    check(eb <= CE_BWD_BF16_TOL and eb32 > CE_BWD_BF16_TOL, f"{tag}: bwd "
          f"rel err {eb} (f32 instantiation {eb32}), limit "
          f"{CE_BWD_BF16_TOL}")
    with torch.no_grad():
        f_ms = timer(lambda: fused_ce_cuda.ce_fwd(h, wb, bm, pad_l, tgt),
                     reps=reps)
        f_plain = timer(lambda: fused_ce.ce_fwd_plain(h, wb, bm, pad_l, tgt),
                        reps=reps)
        hb = h.to(torch.bfloat16)
        f_lib = (timer(lambda: kernel_bench.ce_fwd_bf16_library(
            hb, wb, bm, pad_l, tgt), reps=reps)
            if kernel_bench.mm_bf16_f32(hb[:1], wb[:, :1]) is not None
            else None)
        b_ms = timer(lambda: fused_ce_cuda.ce_bwd(h, wb, bm, lse, dlse, dt,
                                                  tgt), reps=reps)
        b_plain = timer(lambda: fused_ce.ce_bwd_plain(h, wb, bm, lse, dlse,
                                                      dt, tgt), reps=reps)
    b_lib, lib_errs = _ce_bwd_bf16_library(timer, h, wb, bm, lse, dlse, dt,
                                           tgt, reps=reps)
    io = 4 * (N * d + V + 3 * N) + 2 * d * V
    fb = _bf16_entry(f_ms, f_plain, f_lib, 2 * N * V * d, io + 8 * N, peak_bw,
                     e, e32)
    bb = _bf16_entry(b_ms, b_plain, b_lib, 4 * N * V * d, 2 * io + 4 * N * d,
                     peak_bw, eb, eb32)
    res = {"fwd_ms": f_ms, "fwd_plain_ms": f_plain, "fwd_library_ms": f_lib,
           "bwd_ms": b_ms, "bwd_plain_ms": b_plain, "bwd_library_ms": b_lib,
           "bwd_library_errors": lib_errs, "fwd_err": e, "fwd_err_f32": e32,
           "bwd_err": eb, "bwd_err_f32": eb32,
           "max_abs_err": max(float((a - r).abs().max())
                              for a, r in zip(got_f, want)),
           **{f"{k}_{n}": r[n] for k, r in (("fwd", fb), ("bwd", bb))
              for n in ("bound_ms", "bound_tf32_one_pass_ms",
                        "bound_bytes_ms", "bound_by")}}
    log(f"{tag}: fwd rel err {e:.3e} (f32 instantiation {e32:.3e}), bwd "
        f"{eb:.3e} ({eb32:.3e}), launches bitwise equal; K4 {f_ms:.4f} ms "
        f"plain {f_plain:.4f} library {f_lib} bound bf16 / one TF32 pass / "
        f"bytes {fb['bound_ms']:.4f} / {fb['bound_tf32_one_pass_ms']:.4f} / "
        f"{fb['bound_bytes_ms']:.4f}; K5 {b_ms:.4f} ms plain {b_plain:.4f} "
        f"library {b_lib} (errors from the plain bf16 CE {lib_errs}) bound "
        f"{bb['bound_ms']:.4f} / {bb['bound_tf32_one_pass_ms']:.4f} / "
        f"{bb['bound_bytes_ms']:.4f}")
    return res


def _ce_bwd_bf16_library(timer, h, wb, bm, lse, dlse, dt, tgt, reps=20):
    """(ms, errors) of K5 bf16's library version
    (``kernel_bench.ce_bwd_bf16_library``: mm of bf16 operands into f32,
    the dlogits rounded to bf16, two more such products and a row sum) on
    K5's inputs, gated first against the plain bf16 CE
    (``kernel_bench.LIBRARY_BF16_GRAD_TOL``); (None, None), logged, where
    this PyTorch has no such product."""
    from c2dsr_tpu_torch.bench import kernel_bench
    try:
        ms, errs = kernel_bench.ce_bwd_bf16_library_ms(
            timer, h, wb, bm, lse, dlse, dt, tgt, reps)
    except timing.GateFailure as e:
        raise SmokeFailure(str(e))
    if ms is None:
        log("bf16 ce library: this PyTorch has no mm of bf16 operands into "
            "f32 (torch.mm out_dtype)")
    return ms, errs


def _bf16_step(spec, train, graphs, graphs_host):
    """One FK train step at dropout 0 with both dtypes bf16 on the card,
    against the same step on the CPU (the plain bf16 versions): loss within
    1e-5 relative, every gradient within STEP_BF16_GRAD_TOL (relative
    Frobenius); the f32 step on the card must fail that gate.  The bf16
    instantiations launch, the f32 ones never (no fallback)."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import spmm
    from c2dsr_tpu_torch.train import step as step_mod
    cfg = Config(compute_dtype="bfloat16", classifier_dtype="bfloat16",
                 dropout_gnn=0.0, dropout_attn=0.0)
    cpu_graphs = c2dsr.Graphs(spmm.device_graph(graphs_host[0], "cpu"),
                              spmm.device_graph(graphs_host[1], "cpu"))
    batch = {k: v[:512] for k, v in train.items()}
    params = params_mod.init_params(cfg, spec,
                                    torch.Generator().manual_seed(6), "cuda")
    leaves = step_mod.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    bcuda = ranker.to_device(batch, "cuda")
    reset_launches()
    loss_k, g_k = _loss_grads(params, leaves, graphs, bcuda, cfg, spec,
                              contextlib.nullcontext())
    got, got32 = read_launches_bf16(), read_launches()
    loss_32, g_32 = _loss_grads(params, leaves, graphs, bcuda,
                                cfg.with_(compute_dtype="float32",
                                          classifier_dtype="float32"),
                                spec, contextlib.nullcontext())
    cpu = params_mod.params_from_numpy(params_mod.params_to_numpy(params),
                                       "cpu")
    cpu_leaves = step_mod.param_leaves(cpu)
    for t in cpu_leaves:
        t.requires_grad_(True)
    t0 = time.perf_counter()
    loss_c, g_c = _loss_grads(cpu, cpu_leaves, cpu_graphs,
                              ranker.to_device(batch, "cpu"), cfg, spec,
                              contextlib.nullcontext())
    t_cpu = time.perf_counter() - t0
    names = leaf_names(params)

    def rels(g):
        return [_rel(a.cpu(), c) if float(c.abs().max()) > 0
                else float(a.abs().max()) for a, c in zip(g, g_c)]

    rel, rel32 = rels(g_k), rels(g_32)
    wm, wm32 = int(np.argmax(rel)), int(np.argmax(rel32))
    fro, wf = _fro(g_k, g_c)
    fro32, wf32 = _fro(g_32, g_c)
    log(f"bf16 step (CPU step {t_cpu:.1f} s): loss {loss_k:.7f} (card) "
        f"{loss_c:.7f} (CPU), f32 card step {loss_32:.7f}; gradients worst "
        f"relative Frobenius {fro:.3e} ({names[wf]}), max-abs rel err "
        f"{rel[wm]:.3e} ({names[wm]}); f32 card step's {fro32:.3e} "
        f"({names[wf32]}), {rel32[wm32]:.3e} ({names[wm32]}); bf16 launches "
        f"{got}, f32 launches {got32}")
    check(abs(loss_k - loss_c) <= 1e-5 * abs(loss_c),
          f"bf16 step: loss {loss_k} (card) != {loss_c} (CPU)")
    check(fro <= STEP_BF16_GRAD_TOL, f"bf16 step: gradient {names[wf]} "
          f"relative Frobenius {fro} > {STEP_BF16_GRAD_TOL}")
    check(abs(loss_32 - loss_c) > 1e-5 * abs(loss_c)
          or fro32 > STEP_BF16_GRAD_TOL,
          "bf16 step: the f32 step passes the bf16 step's gate")
    check(all(got[k] > 0 for k in ("spmm_csr", "encoder_fwd", "encoder_bwd",
                                   "ce_fwd", "ce_bwd"))
          and all(got32[k] == 0 for k in ("spmm_csr", "spmm_csr_flagged",
                                          "encoder_fwd", "encoder_bwd",
                                          "ce_fwd", "ce_bwd")),
          f"bf16 step: launches bf16 {got}, f32 {got32}")
    for t in leaves:
        t.requires_grad_(False)
    return {"loss_rel_err": abs(loss_k - loss_c) / abs(loss_c),
            "grad_max_rel_err": rel[wm], "grad_fro_err": fro,
            "f32_step_loss_rel_err": abs(loss_32 - loss_c) / abs(loss_c),
            "f32_step_grad_max_rel_err": rel32[wm32],
            "f32_step_grad_fro_err": fro32, "cpu_step_s": t_cpu}


def phase_bf16(spec, train, graphs, graphs_host, eval_data, timer, peak_bw):
    """The bf16 path (``compute_dtype`` and ``classifier_dtype`` bfloat16):
    every kernel's bf16 instantiation against its plain bf16 version at FK
    shapes, the f32 instantiation in its place failing each limit (K3-K5
    also bitwise across launches); one bf16 FK step at dropout 0 against
    the CPU's; the bf16 main path (a train step, a batch-sparse one, a step
    at d_latent 512 and a serving run, ranks against the plain versions'
    but at near-ties) with its launches; the bf16 step timed against the
    f32 step in turns.
    Returns (kernel results, launches of the bf16 main path, rates)."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.data.pipeline import BatchIterator
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.train import optim
    from c2dsr_tpu_torch.train import step as step_mod
    res = {"spmm": _bf16_spmm(graphs, train, timer, peak_bw)}
    res["towers"] = _bf16_towers(timer, peak_bw)
    res["ce"] = _bf16_ce(timer, peak_bw)
    res["shapes"] = _bf16_shapes(timer, peak_bw)
    torch.cuda.empty_cache()
    res["step"] = _bf16_step(spec, train, graphs, graphs_host)
    torch.cuda.empty_cache()

    # the bf16 main path: a train step, a batch-sparse one, a serving run
    cfg = Config(compute_dtype="bfloat16", classifier_dtype="bfloat16")
    it = BatchIterator(train, cfg.batch_size, shuffle=True, seed=0,
                       drop_last=True)

    def batches():
        while True:
            yield from it.epoch()

    feed = batches()
    fns, states = {}, {}
    for name, c in (("f32", Config()), ("bf16", cfg)):
        params = params_mod.init_params(c, spec,
                                        torch.Generator().manual_seed(0),
                                        "cuda")
        opt = optim.make_optimizer(c, steps_per_epoch=len(it))
        states[name] = step_mod.init_state(params, opt)
        fns[name] = (c, opt, step_mod.make_train_step(c, spec, graphs, opt,
                                                      "cuda"))
    sparse = step_mod.make_train_step(cfg.with_(batch_sparse_gnn=True), spec,
                                      graphs, fns["bf16"][1], "cuda")
    # and a step at d_latent 512 (BASELINE.json config 5's width), whose
    # K5 runs its cluster kernels
    cfg512 = cfg.with_(d_latent=512)
    opt512 = optim.make_optimizer(cfg512, steps_per_epoch=len(it))
    state512 = step_mod.init_state(params_mod.init_params(
        cfg512, spec, torch.Generator().manual_seed(0), "cuda"), opt512)
    step512 = step_mod.make_train_step(cfg512, spec, graphs, opt512, "cuda")
    reset_launches()
    states["bf16"], aux = fns["bf16"][2](states["bf16"], next(feed))
    states["bf16"], aux2 = sparse(states["bf16"], next(feed))
    state512, aux3 = step512(state512, next(feed))
    torch.cuda.synchronize()
    launches = read_launches_bf16()
    f32_launches = read_launches()
    check(all(math.isfinite(float(x["loss"])) for x in (aux, aux2, aux3)),
          "bf16 train step: loss not finite")
    del state512, step512, opt512
    serving = phase_main(spec, graphs_host, eval_data, cfg,
                         label="serving bf16")
    for k, v in serving.items():
        launches[k] += v
    log(f"bf16 main path (a step, a batch-sparse step, a serving run): "
        f"bf16 launches {launches}, f32 launches of the steps "
        f"{f32_launches}")
    check(all(launches[k] > 0 for k in launches)
          and all(f32_launches[k] == 0 for k in launches),
          f"bf16 main path launches: bf16 {launches}, f32 {f32_launches}")

    # the bf16 step against the f32 step, in turns on one card
    def runner(name):
        def run(batch):
            states[name], a = fns[name][2](states[name], batch)
            return a
        return run

    rates = _warm_rates((("f32", runner("f32")), ("bf16", runner("bf16"))),
                        feed, cfg.batch_size)
    k, p = rates["bf16"], rates["f32"]
    diff = k.mean() - p.mean()
    se = math.sqrt(k.var(ddof=1) / len(k) + p.var(ddof=1) / len(p))
    log(f"bf16 step: {k.mean():.1f} (sd {k.std(ddof=1):.1f}) train "
        f"examples/s against the f32 step's {p.mean():.1f} (sd "
        f"{p.std(ddof=1):.1f}), {diff / p.mean():+.2%}, standard error "
        f"{se:.1f}: {'resolved' if abs(diff) > 3 * se else 'unresolved'}")
    res["rates"] = {"bf16_train_examples_per_s": float(k.mean()),
                    "f32_train_examples_per_s": float(p.mean()),
                    "resolved": bool(abs(diff) > 3 * se)}
    return res, launches


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


CE_WIDTHS = (264, 384, 512, 520, 640, 1024, 2048)   # phase_ce_wide's d
CE_BF16_WIDTHS = (512, 1024)   # and its bf16 widths (a bf16 W)
BF16_CE_BWD_FRO = 1e-3   # K5 bf16 against the plain bf16 CE, relative
                         # Frobenius (tests/test_torch_cuda.py's limit)


def _ce_wide_check(d, N, V, n_real):
    """K4 and K5 at width d against the plain versions in float64 (CE_TOL,
    CE_BWD_TOL, K5's dW DW_F64_TOL) and bitwise against a second launch;
    K5 must have run its cluster kernels.  Returns (inputs, lse, fwd err,
    {dh, dw, db}, the float64 backward)."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    h, w, bm, pad_l, tgt, real, dlse, dt = _ce_inputs(N, d, V, n_real, d)
    n0 = fused_ce_cuda.ce_bwd.launches_cluster
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
    tag = f"d={d}"
    check(fused_ce_cuda.ce_bwd.launches_cluster == n0 + 2,
          f"ce_bwd {tag}: the cluster kernels did not run")
    e_f = max(_rel(lse, rlse), _rel(tlog[real], rtlog[real]))
    check(e_f <= CE_TOL, f"ce_fwd {tag}: rel err {e_f} > {CE_TOL}")
    check(torch.equal(lse, lse2) and torch.equal(tlog, tlog2),
          f"ce_fwd {tag}: two launches differ")
    rels = _check_ce_bwd(tag, got, want, again, n_real)
    check(rels["dw"] <= DW_F64_TOL, f"ce_bwd {tag}: dW {rels['dw']} from "
          f"float64 > {DW_F64_TOL}")
    return (h, w, bm, pad_l, tgt, dlse, dt), lse, e_f, rels, want


def _k5_entry(design, h, w, bm, lse, dlse, dt, tgt, bf16=False):
    """(dh, dw, db) by one of K5's designs through its C entry, dw f32
    whatever w's dtype, not counted as launches: past d 256 "cluster"
    (ce_cluster.cu at the port's plan) or "wide" (ce.cu's wide kernels:
    ce_bwd_wide_f32, or ce_bwd_bf16, which runs them past d 256), the
    design of before, timed beside the cluster kernels; up to d 128 "pair"
    (ce.cu's narrow dh and dW passes, ce_bwd_f32 at the port's splits),
    the design of before, timed beside the one pass."""
    from c2dsr_tpu_torch.ops import fused_ce_cuda as fc
    N, d = h.shape
    V = w.shape[1]
    check((d <= fc.ONEPASS_MAX) == (design == "pair"),
          f"K5's {design} entry is not timed at d {d}")
    out = (torch.empty_like(h), torch.empty(w.shape, device=h.device),
           torch.empty_like(bm))
    t32 = tgt.to(torch.int32).contiguous()
    if design == "cluster":
        plan = fc.plan_cluster(N, d, V, bf16)
        entry = "ce_bwd_cluster_bf16" if bf16 else "ce_bwd_cluster_f32"
        splits, extra = (plan.split_h, plan.split_w), (plan.c, plan.w)
    elif design == "pair":
        entry, splits, extra = "ce_bwd_f32", fc.plan_bwd(N, d, V, False), ()
    else:
        entry = "ce_bwd_bf16" if bf16 else "ce_bwd_wide_f32"
        splits, extra = fc.plan_bwd(N, d, V, bf16, wide=True), ()
    run = fc._bwd_bf16 if bf16 else fc._bwd_f32
    err = run(entry, splits, h, w, bm, lse, dlse, dt, t32, *out, extra)
    check(err == 0, f"K5 {design} ({entry}) d={d}: CUDA error {err}")
    return out


def _k5_in_turns(timer, designs, reps, rounds=1):
    """({design: ms}, {design: runs}), each a mean of timer runs in turns,
    ``rounds`` rounds of (A, B, .., B, A); ``designs`` {name: fn}."""
    names = list(designs)
    runs = {n: [] for n in names}
    for n in (names + names[::-1]) * rounds:
        with torch.no_grad():
            runs[n].append(timer(designs[n], reps=reps))
    return {n: float(np.mean(v)) for n, v in runs.items()}, runs


def phase_ce_wide(timer, peak_flops, peak_bw, gpu):
    """K4 and K5 at the widths above 256, at a train step's rows of domain
    A (N 10,240, V 30,720): K4's wide kernel; K5's cluster kernels
    (csrc/ce_cluster.cu).  f32 at CE_WIDTHS: against the plain versions in
    float64 (CE_TOL, CE_BWD_TOL, DW_F64_TOL), as the d 256 card tests hold
    them, and bitwise against a second launch; then timed beside the plain
    versions in f32 and one cuBLAS f32 call (mm + logsumexp, and its
    autograd backward), with K5's dh and dW kernels profiled and the
    bounds; K5's kernels of before (ce.cu's wide kernels), held to the
    same gates, timed against the cluster kernels in turns.  bf16 at
    CE_BF16_WIDTHS
    (a bf16 W): K5's cluster kernels against the plain bf16 CE
    (CE_BWD_BF16_TOL, BF16_CE_BWD_FRO), bitwise, and in turns against its
    kernels of before and the library's composed bf16 backward."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    N, V, n_real = 512 * 2 * 10, 30720, N_ITEM_A
    out = {}
    for d in CE_WIDTHS:
        t0 = time.perf_counter()
        ins, lse, e_f, rels, want64 = _ce_wide_check(d, N, V, n_real)
        h, w, bm, pad_l, tgt, dlse, dt = ins
        reps = 20 if d <= 512 else 5 if d <= 1024 else 3
        with torch.no_grad():
            f_ms = timer(lambda: fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt),
                         reps=reps)
            f_plain = timer(lambda: fused_ce.ce_fwd_plain(h, w, bm, pad_l,
                                                          tgt), reps=reps)
            f_lib = timer(lambda: torch.logsumexp(
                torch.cat([h @ w + bm, pad_l[:, None]], 1), 1), reps=reps)
            b_plain = timer(lambda: fused_ce.ce_bwd_plain(h, w, bm, lse, dlse,
                                                          dt, tgt), reps=reps)
        hg, wg, bg = (t.detach().clone().requires_grad_(True)
                      for t in (h, w, bm))
        lib_out = torch.logsumexp(torch.cat([hg @ wg + bg, pad_l[:, None]],
                                            1), 1)
        b_lib = timer(lambda: torch.autograd.grad(lib_out, [hg, wg, bg], dlse,
                                                  retain_graph=True),
                      reps=reps)
        del lib_out, hg, wg, bg
        # K5's kernels of before, gated as the cluster kernels are
        with torch.no_grad():
            got_e = _k5_entry("wide", h, w, bm, lse, dlse, dt, tgt)
            again_e = _k5_entry("wide", h, w, bm, lse, dlse, dt, tgt)
        errs = {"wide": max(_check_ce_bwd(f"d={d} (wide kernels)", got_e,
                                          want64, again_e, n_real).values())}
        del got_e, again_e
        designs = {"cluster": lambda: fused_ce_cuda.ce_bwd(
            h, w, bm, lse, dlse, dt, tgt),
                   "wide": lambda: _k5_entry("wide", h, w, bm, lse, dlse,
                                             dt, tgt)}
        b_turns, b_runs = _k5_in_turns(
            timer, designs, max(3, reps // 2) if d <= 1024 else 2)
        sub = timing.kernel_times(lambda: fused_ce_cuda.ce_bwd(
            h, w, bm, lse, dlse, dt, tgt), calls=2)[0]
        parts = {"dh": sum(v for k, v in sub.items()
                           if _ce_bwd_pass(k) == "dh"),
                 "dw": sum(v for k, v in sub.items()
                           if _ce_bwd_pass(k) == "dw")}
        flops = 2.0 * N * V * d
        io = 4 * (N * d + d * V + V + 3 * N)
        plan = fused_ce_cuda.plan_cluster(N, d, V, False)
        check(plan.smem == fused_ce_cuda.cluster_smem_card(plan.w, False),
              f"d={d}: the plan's shared memory {plan.smem} is not the "
              "kernel's")
        out[d] = {"fwd_ms": f_ms, "fwd_plain_ms": f_plain,
                  "fwd_library_ms": f_lib,
                  "bwd_ms": b_turns["cluster"], "bwd_plain_ms": b_plain,
                  "bwd_library_ms": b_lib,
                  "bwd_dh_ms": parts["dh"], "bwd_dw_ms": parts["dw"],
                  "bwd_earlier_ms": {k: v for k, v in b_turns.items()
                                     if k != "cluster"},
                  "bwd_runs_in_turns": b_runs,
                  "bwd_earlier_rel_err_f64": errs,
                  "fwd_bound_ms": timing.tc_bound_ms(flops, io, gpu, peak_bw),
                  "fwd_bound_ffma_ms": flops / peak_flops * 1e3,
                  "bwd_bound_ms": timing.tc_bound_ms(2 * flops, 2 * io, gpu,
                                                     peak_bw),
                  "bwd_bound_ffma_ms": 2 * flops / peak_flops * 1e3,
                  "fwd_rel_err_f64": e_f,
                  "bwd_rel_err_f64": max(rels.values()),
                  "bwd_rel_err_f64_by_output": rels,
                  "bwd_max_abs_err_f64": max(
                      float((g.double() - r).abs().max()) for g, r in
                      zip(fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt),
                          want64)),
                  "plan": dataclasses.asdict(plan),
                  "design": {"K4": ("wide" if d > fused_ce_cuda.RESIDENT
                                    else "resident"),
                             "K5": fused_ce_cuda.bwd_route(d)}}
        log(f"ce wide d={d} (kernels {out[d]['design']}, plan {plan}): N={N} "
            f"V={V}: against float64 fwd rel err {e_f:.3e}, bwd "
            + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
            + f" (kernels of before {errs}); two launches of each bitwise "
            f"equal; fwd kernel {f_ms:.4f} ms plain {f_plain:.4f} library "
            f"{f_lib:.4f}; bwd in turns " + ", ".join(
                f"{k} {v:.4f}" for k, v in b_turns.items())
            + f" ms (cluster dh {parts['dh']:.4f} + dW {parts['dw']:.4f}, "
            f"profiled) plain {b_plain:.4f} library {b_lib:.4f}; bounds "
            f"3xTF32 fwd {out[d]['fwd_bound_ms']:.4f} bwd "
            f"{out[d]['bwd_bound_ms']:.4f}, FFMA fwd "
            f"{out[d]['fwd_bound_ffma_ms']:.4f} "
            f"({time.perf_counter() - t0:.1f} s)")
        del ins, h, w, bm, pad_l, tgt, dlse, dt, lse, want64
        torch.cuda.empty_cache()
    for d in CE_BF16_WIDTHS:
        t0 = time.perf_counter()
        out[f"bf16_{d}"] = _ce_wide_bf16(d, N, V, n_real, timer, peak_bw)
        log(f"ce wide bf16 d={d}: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    return out


def _ce_wide_bf16(d, N, V, n_real, timer, peak_bw):
    """K5 bf16 at width d on a bf16 W, the inputs it is timed on: its
    cluster kernels and its kernels of before (ce.cu's wide kernels), each
    through its C entry with dW in f32, against the plain bf16 CE
    (CE_BWD_BF16_TOL max abs over max, BF16_CE_BWD_FRO relative Frobenius)
    and bitwise across launches; the wrapper's outputs are the cluster
    entry's (dW cast to bf16); then in turns, beside the plain bf16 CE and
    the library's composed bf16 backward, with the bf16 bounds
    (``_bf16_entry``)."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    h, w, bm, pad_l, tgt, real, dlse, dt = _ce_inputs(N, d, V, n_real, d)
    wb = w.to(torch.bfloat16)
    n0 = fused_ce_cuda.ce_bwd.launches_cluster_bf16
    with torch.no_grad():
        lse, _ = fused_ce_cuda.ce_fwd(h, wb, bm, pad_l, tgt)
        wrapped = fused_ce_cuda.ce_bwd(h, wb, bm, lse, dlse, dt, tgt)
        # f32 W with bf16=True rounds W to wb: the same function, dW in f32
        want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt, bf16=True)
        runs = {k: [_k5_entry(k, h, wb, bm, lse, dlse, dt, tgt, bf16=True)
                    for _ in range(2)] for k in ("cluster", "wide")}
    torch.cuda.synchronize()
    tag = f"bf16 ce_bwd d={d}"
    check(fused_ce_cuda.ce_bwd.launches_cluster_bf16 == n0 + 1,
          f"{tag}: the cluster kernels did not run")
    raw = runs["cluster"][0]
    check(torch.equal(wrapped[0], raw[0]) and torch.equal(wrapped[2], raw[2])
          and wrapped[1].dtype == torch.bfloat16
          and torch.equal(wrapped[1], raw[1].to(torch.bfloat16)),
          f"{tag}: the wrapper's outputs are not its cluster entry's")
    errs = {}
    for name, (g, g2) in runs.items():
        rel = max(_rel(a, b) for a, b in zip(g, want))
        fro = max(float((a.double() - b.double()).norm())
                  / max(float(b.double().norm()), 1e-30)
                  for a, b in zip(g, want))
        check(all(bool(torch.isfinite(a).all()) for a in g),
              f"{tag} ({name}): non-finite")
        check(rel <= CE_BWD_BF16_TOL and fro <= BF16_CE_BWD_FRO,
              f"{tag} ({name}): rel err {rel} (limit {CE_BWD_BF16_TOL}), "
              f"Frobenius {fro} (limit {BF16_CE_BWD_FRO})")
        check(all(torch.equal(a, b) for a, b in zip(g, g2)),
              f"{tag} ({name}): two launches differ")
        errs[name] = {"rel": rel, "fro": fro}
    max_abs = max(float((a - b).abs().max()) for a, b in zip(raw, want))
    del wrapped, runs, raw
    designs = {"cluster": lambda: fused_ce_cuda.ce_bwd(h, wb, bm, lse, dlse,
                                                       dt, tgt),
               "wide": lambda: _k5_entry("wide", h, wb, bm, lse, dlse, dt,
                                         tgt, bf16=True)}
    turns, runs = _k5_in_turns(timer, designs, 5)
    with torch.no_grad():
        b_plain = timer(lambda: fused_ce.ce_bwd_plain(h, wb, bm, lse, dlse,
                                                      dt, tgt), reps=5)
    b_lib, lib_errs = _ce_bwd_bf16_library(timer, h, wb, bm, lse, dlse, dt,
                                           tgt, reps=5)
    io = 4 * (N * d + V + 3 * N) + 2 * d * V
    bb = _bf16_entry(turns["cluster"], b_plain, b_lib, 4 * N * V * d,
                     2 * io + 4 * N * d, peak_bw, errs["cluster"]["rel"],
                     None)
    plan = fused_ce_cuda.plan_cluster(N, d, V, True)
    check(plan.smem == fused_ce_cuda.cluster_smem_card(plan.w, True),
          f"{tag}: the plan's shared memory {plan.smem} is not the kernel's")
    res = {"bwd_ms": turns["cluster"],
           "bwd_earlier_ms": {"wide": turns["wide"]},
           "bwd_runs_in_turns": runs, "bwd_plain_ms": b_plain,
           "bwd_library_ms": b_lib, "bwd_library_errors": lib_errs,
           "errors_from_plain": errs, "max_abs_err": max_abs,
           "plan": dataclasses.asdict(plan),
           **{f"bwd_{k}": bb[k] for k in ("bound_ms", "bound_tf32_one_pass_ms",
                                          "bound_bytes_ms", "bound_by")}}
    log(f"{tag} (plan {plan}): from the plain bf16 CE {errs}, two launches "
        f"of each bitwise equal; in turns cluster {turns['cluster']:.4f} ms, "
        f"wide {turns['wide']:.4f}; plain {b_plain:.4f}, library "
        f"{b_lib} (errors {lib_errs}); bound bf16 / one TF32 pass / bytes "
        f"{bb['bound_ms']:.4f} / {bb['bound_tf32_one_pass_ms']:.4f} / "
        f"{bb['bound_bytes_ms']:.4f}")
    return res


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
    torch.profiler.  In a process that has run many profiles (and CUDA
    graphs), the profiler loses the first kernels of its window, up to 9
    of them in most runs and all 64 opening fills in one, whatever the
    pause: so the window opens with LEAD fills and closes with LEAD more,
    none of which are counted, and a window counts only if one of its
    opening fills is seen, so that no K7 launch can have been lost.  A
    window that lost them all is measured again, up to K7_WINDOWS times,
    and the check fails if none counts; a count that is not whole logs the
    window's kernels."""
    from torch.profiler import ProfilerActivity, profile
    lead = torch.empty(16 << 20, device="cuda")
    fn()
    torch.cuda.synchronize()
    for attempt in range(K7_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD):
                lead.zero_()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAUSE_S)
            for _ in range(calls):
                fn()
            for _ in range(LEAD):
                lead.zero_()
            torch.cuda.synchronize()
        ms, launches = _k7_by_kernel(prof)
        kernels = sorted((ev.time_range.start, ev.name)
                         for ev in prof.events()
                         if ev.device_type == torch.autograd.DeviceType.CUDA)
        names = ["K7" if "segsum_" in n else "fill" if "Fill" in n
                 else n[:40] for _, n in kernels]
        opening = names[:names.index("K7") if "K7" in names else None]
        if launches % calls or opening.count("fill") < LEAD:
            log(f"K7 profile window {attempt + 1}: {launches} K7 launches in "
                f"{calls} calls; the profiler lost "
                f"{LEAD - opening.count('fill')} of the {LEAD} opening "
                f"fills; {len(names)} kernels, first {names[:4]}, last "
                f"{names[-4:]}")
        if "fill" in opening:
            break
    check("fill" in opening,
          f"K7 profile window: the profiler lost every opening fill in "
          f"{K7_WINDOWS} windows, so it may have lost K7 launches")
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
        log(f"bench headline: {json.dumps(res['line'])}; bf16 step "
            f"{res['details']['bf16_train_examples_per_s']:.1f} train "
            f"examples/s (gate {res['details']['bf16_train_gate']}); eval "
            "full rank "
            f"{res['details']['eval_full_rank_examples_per_s']:.1f} "
            f"examples/s, {res['details']['eval_full_rank_items_per_s']:.4g}"
            f" items/s; gates {res['details']['train_gate']} "
            f"{res['details']['eval_gate']}")
    elif name == "kernels":
        for r in res["results"]:
            other = (f"FFMA {r['bound_ffma_ms']:.4f}" if "bound_ffma_ms" in r
                     else f"one TF32 pass {r['bound_tf32_one_pass_ms']:.4f}")
            log(f"bench kernels {r['kernel']}: {r['ms']:.4f} ms plain "
                f"{r['plain_ms']:.4f} library {r['library_ms']} bound "
                f"{r['bound_ms']:.4f} ({r['bound_by']}, {other}); err "
                f"{r['max_rel_err']:.3e}")
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
        ce = m["fused_ce_bf16w"]
        log(f"bench scaled bf16 classifier: CE d 512 V 2^20 fwd "
            f"{ce['fwd_ms']:.3f} ms fwd+bwd {ce['fwd_bwd_ms']:.3f} ms "
            f"(bounds bf16 {ce['fwd_bound_ms']:.3f} / "
            f"{ce['fwd_bwd_bound_ms']:.3f}); errors rows "
            f"{ce['rows_rel_err']:.3e} grads {ce['grads_rel_err']:.3e}; full "
            f"rank {m['full_rank_bf16w_ms']:.4f} ms (delta "
            f"{m['full_rank_bf16w_max_rank_delta']})")
        for r in res["projected_10m"]:
            log(f"bench scaled projected to 10M items: {json.dumps(r)}")
    elif name == "spmm_sweep":
        for p in res["points"]:
            log(f"bench spmm_sweep heavy_deg {p['heavy_deg']} run_rows "
                f"{p['run_rows']} {p['dtype']}: {p['ms']:.4f} ms ("
                + ", ".join(f"{k} A {r['a']['ms']:.4f} A^T "
                            f"{r['at']['ms']:.4f}, tasks {r['a']['tasks']} / "
                            f"{r['at']['tasks']}" for k, r in p["hops"].items())
                + f"), {p['pct_of_bound']:.1f}% of the byte bound "
                f"{p['bound_ms']:.4f}; err {p['max_rel_err']:.3e}; plans "
                f"{p['plan_build_s']:.2f} s")
        log(f"bench spmm_sweep in turns: "
            f"{json.dumps(res['default_against_fastest_other'])}")
    else:
        for r in res["results"]:
            log(f"bench batches: {json.dumps(r)}")


SPMM_SWEEP = ((32, 32, "float32"), (16, 32, "float32"), (64, 32, "float32"),
              (32, 16, "float32"), (32, 32, "bfloat16"))   # phase_bench's
# points of --spmm-sweep: (heavy_deg, run_rows, gather), the default first


def phase_bench():
    """The port's bench (``python -m c2dsr_tpu_torch.bench``), each mode in
    this process at its real size, with its gates: the headline,
    ``--kernels``, ``--ce-variants``, ``--scaled``, ``--spmm-sweep`` at the
    points SPMM_SWEEP, and ``--batches`` up to 2,048.  Returns ({mode:
    result}, {mode: kernel launches})."""
    import dataclasses
    from c2dsr_tpu_torch.bench import __main__ as bench_main
    from c2dsr_tpu_torch.bench import (ce_variants, kernel_bench, scaled_bench,
                                       spmm_experiments)
    modes = (("headline", bench_main.headline),
             ("kernels", kernel_bench.run),
             ("ce_variants", ce_variants.run),
             ("scaled", scaled_bench.run),
             ("spmm_sweep", lambda: spmm_experiments.run(grid=SPMM_SWEEP)),
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
        launches[name]["bf16"] = read_launches_bf16()
        torch.cuda.empty_cache()
        _bench_logs(name, out[name])
        log(f"bench {name}: {time.perf_counter() - t0:.1f} s, launches "
            f"{launches[name]}")
    bench_main.merge_details({k: v["details"] if k == "headline" else v
                              for k, v in out.items()})
    return out, launches


def phase_cli():
    """``python -m c2dsr_tpu_torch.cli`` on the card in a temporary working
    directory, at the default width, at ``--d_latent 40`` (d % 32 == 8,
    one head: every tower and CE kernel at a ragged width) and at the wide
    shape (``--synthetic 2048 --d_latent 1024 --n_head 8``: K4/K5's wide
    kernels): exit 0, the final result table and a checkpoint."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_DIR] + [p for p in [env.get("PYTHONPATH")] if p])
    for users, extra in ((CLI_USERS, []), (CLI_USERS, ["--d_latent", "40"]),
                         (EVAL_USERS_WIDE, ["--d_latent", "1024", "--n_head",
                                            "8"])):
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [sys.executable, "-m", "c2dsr_tpu_torch.cli", "--synthetic",
                   str(users), "--n_epoch", "1", "--ckpt",
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
    synchronises), and the parts of it in K2's and in K3's kernels
    (KERNEL_FAMILIES)."""
    from torch.profiler import ProfilerActivity, profile
    busy, k2, k3 = [], [], []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
        us = {ev.key: getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0.0))
              for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA}
        busy.append(sum(us.values()) / 1e3)
        k2.append(sum(v for k, v in us.items() if "encoder_fwd_" in k) / 1e3)
        k3.append(sum(v for k, v in us.items()
                      if kernel_family(k) == "K3 encoder_bwd") / 1e3)
    return busy, k2, k3


def _digest(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    import hashlib
    return hashlib.sha256(b"".join(
        t.detach().float().cpu().numpy().tobytes() for t in tensors)
    ).hexdigest()[:16]


def _tower_measures(timer, digests) -> dict:
    """K2 and K3 on seeded inputs made alike in both checkouts: the three
    tower calls of a step (FK: d 128, L 15, one head and layer, 3B, B and
    B sequences at B 512, dropout 0.2, K2 saving K3's activations), K2 at
    the serving tower (B 2,048, eval) and both at the long and wide towers
    BF16_TOWERS (L 200; d 1,024 with 8 heads) and d 512 (4 heads, B 512),
    one layer each: the bf16
    instantiations timed (3 timings each, the median of 20 CUDA-event
    timings; the step's three calls summed), the f32 ones at the step's
    calls, at L 200, at d 512 and 1,024 and at L 64 (d 128, B 512: kSeqL,
    ``l64``) beside them, and digests of every output (K2's, then K3's dx and gradients) in
    f32 and in bf16 at each shape.  Both dtypes' parts are also profiled
    at each training shape (``timing.kernel_times``): K2's GEMMs
    (``k2_gemm_*``), K3's input-gradient GEMMs (``k3_gemm_*``), its weight
    gradients with their merge (``k3_wgrad_*``) and both kernels'
    attention (``k2_attn_*``, ``k3_attn_*``)."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import dropout as drop
    from c2dsr_tpu_torch.ops import encoder_cuda
    pad = 64093
    cases = [("step", 128, 1, LEN_MAX, 3 * 512, 0),
             ("step", 128, 1, LEN_MAX, 512, 1),
             ("step", 128, 1, LEN_MAX, 512, 2),
             ("eval", 128, 1, LEN_MAX, 2048, 0)]
    cases += [(f"l{L}" if L > LEN_MAX else f"d{d}", d, h, L, B, 0)
              for d, h, L, B in BF16_TOWERS]
    cases.append(("d512", 512, 4, LEN_MAX, 512, 0))   # the wgmma tile's
                                                       # other width
    cases.append(("l64", 128, 1, 64, 512, 0))   # kSeqL, the last whole-
                                                # sequence length
    out = {}
    for at, d, n_head, L, B, tower in cases:
        p = params_mod._map(lambda t: t.cuda(), params_mod.init_encoder_params(
            torch.Generator().manual_seed(30 + tower + d),
            Config(d_latent=d, n_head=n_head), L))
        x, seq = _encoder_inputs(B, L, d, pad, seed=40 + tower + d)
        train = at != "eval"
        kw = dict(idx_pad=pad, n_head=n_head, invert_padding_mask=False,
                  dropout=0.2 if train else 0.0,
                  seed=drop.seed_tensor(99, "cuda"), tower=tower)
        gout = torch.randn(x.shape, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(5))
        for bf in (False, True):
            name = "bf16" if bf else "f32"
            acts = encoder_cuda.saved_buffer(x, n_head, 1) if train else None
            with torch.no_grad():
                outs = [encoder_cuda.encoder_fwd(x, seq, p, saved=acts,
                                                 bf16=bf, **kw)]
                if train:
                    dx, grads = encoder_cuda.encoder_bwd(
                        x, seq, gout, p, saved=acts, bf16=bf, **kw)
                    outs += [dx] + list(grads)
                digests[f"k2k3_{name}_{at}_B{B}_tower{tower}"] = _digest(
                    *outs)
                if bf or at in ("step", "l64", f"l{BF16_TOWERS[0][2]}",
                                "d512", "d1024"):
                    k2 = out.setdefault(f"k2_{name}_{at}_ms", [0.0] * 3)
                    k3 = out.setdefault(f"k3_{name}_{at}_ms", [0.0] * 3)
                    for i in range(3):
                        k2[i] += timer(lambda: encoder_cuda.encoder_fwd(
                            x, seq, p, saved=acts, bf16=bf, **kw))
                        if train:
                            k3[i] += timer(lambda: encoder_cuda.encoder_bwd(
                                x, seq, gout, p, saved=acts, bf16=bf, **kw))
                if train:
                    t2, _ = timing.kernel_times(
                        lambda: encoder_cuda.encoder_fwd(
                            x, seq, p, saved=acts, bf16=bf, **kw))
                    t3, _ = timing.kernel_times(
                        lambda: encoder_cuda.encoder_bwd(
                            x, seq, gout, p, saved=acts, bf16=bf, **kw))
                    for part, ms in (
                            ("k2_gemm", [v for k, v in t2.items()
                                         if "encoder_fwd_gemm" in k]),
                            ("k3_gemm", [v for k, v in t3.items()
                                         if "tc_gemm" in k]),
                            ("k3_wgrad", [v for k, v in t3.items()
                                          if "wgrad" in k
                                          or "sum_partials" in k]),
                            ("k2_attn", [v for k, v in t2.items()
                                         if "encoder_fwd_attn" in k]),
                            ("k3_attn", [v for k, v in t3.items()
                                         if "attn_bwd" in k])):
                        acc = out.setdefault(f"{part}_{name}_{at}_ms", [0.0])
                        acc[0] += sum(ms)
            del acts
        del p, x, seq, gout
        torch.cuda.empty_cache()
    return {k: v for k, v in out.items() if any(v)}


def measure_rates() -> dict:
    """Measures of the ``c2dsr_tpu_torch`` first on sys.path, at FK
    geometry with the default Config.  The training step, f32 and then
    bf16 (compute_dtype and classifier_dtype bfloat16): 10 warm-up steps
    (a digest of their losses), 8 runs of 4 steps (train examples/s each,
    and the host's ms a step until the last step is enqueued, before the
    synchronise), then 3 profiled steps (device busy ms, and K2's ms,
    each).  K1 a hop of each table over A and Aᵀ, K7's six calls of one
    step's backward, and K4's and K5's two calls of a step on phase_ce's
    inputs, f32 and bf16 (a bf16 W), K4/K5 bf16 at d 256 and K4 bf16 at d
    1,024 (3 timings each, the median of 20 CUDA-event timings), with
    digests of K4's and K5's outputs at d 128-1,024 in f32 and bf16 (K5's
    cluster kernels past 256): equal digests show two checkouts' kernels
    computing the same bits.  K2 and K3 at a step's
    three towers, f32 and bf16, and in bf16 at the serving tower, L 200
    and d 1,024, with digests of their outputs (``_tower_measures``); the
    bf16 step's K2 and K3 ms profiled; ``_tower_accuracy`` at LONG_STEP
    and at WIDE_STEP (``_step_accuracy``).  K2 alone at the
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

    # A checkout from before the seed followed state.step takes a CPU
    # generator: drop this once no compared checkout predates that.
    gen = ((torch.Generator().manual_seed(cfg.seed),) if "generator" in
           inspect.signature(step_mod.make_train_step).parameters else ())
    step_rates = {}
    digests = {}
    for name, c in (("f32", cfg), ("bf16", cfg.with_(
            compute_dtype="bfloat16", classifier_dtype="bfloat16"))):
        opt = optim.make_optimizer(c, steps_per_epoch=len(it))
        state = step_mod.init_state(params_mod.init_params(
            c, spec, torch.Generator().manual_seed(0), "cuda"), opt)
        fn = step_mod.make_train_step(c, spec, graphs, opt, *gen, "cuda")
        feed = batches()
        losses = []
        for _ in range(10):
            state, aux = fn(state, next(feed))
            losses.append(aux["loss"])
        torch.cuda.synchronize()
        # the first ten losses from one seeded state and feed: equal
        # digests say two checkouts' steps computed the same bits
        digests[f"step_{name}_losses"] = _digest(*losses)
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

        busy, k2, k3 = _busy_ms(one_step)
        check(math.isfinite(float(aux["loss"])),
              f"{name} train loss not finite")
        step_rates[name] = (rates, host, busy, k2, k3)
        del state, opt, fn
    rates, host, busy, k2, _ = step_rates["f32"]

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
    del calls
    # K4 and K5 at a step's shapes (both domains, phase_ce's seeded inputs)
    from c2dsr_tpu_torch.ops import fused_ce_cuda
    ce = {"k4_step_ms": [0.0] * 3, "k5_step_ms": [0.0] * 3}
    for V, n_real in ((30720, N_ITEM_A), (36864, N_ITEM_B)):
        h, w, bm, pad_l, tgt, _, dlse, dt = _ce_inputs(512 * 2 * 10, 128, V,
                                                       n_real, V)
        with torch.no_grad():
            lse, _ = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)
            for i in range(3):
                ce["k4_step_ms"][i] += timer(
                    lambda: fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt))
                ce["k5_step_ms"][i] += timer(
                    lambda: fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt,
                                                 tgt))
    ce["k4_k5_step_ms"] = [a + b for a, b in zip(ce["k4_step_ms"],
                                                 ce["k5_step_ms"])]
    # the bf16 instantiations on a bf16 W (the bf16 classifier): a step's
    # two calls of each, and domain A's at d 256 (K4 and K5) and d 1,024
    # (K4), with their outputs' digests; the f32 kernels' digests at FK
    # and of K5's cluster kernels (f32 and bf16) at d 512 and 1,024
    for key in ("k4_bf16_step_ms", "k5_bf16_step_ms", "k4_bf16_d256_ms",
                "k5_bf16_d256_ms", "k4_bf16_d1024_ms"):
        ce[key] = [0.0] * 3
    for d, V, n_real in ((128, 30720, N_ITEM_A), (128, 36864, N_ITEM_B),
                         (256, 30720, N_ITEM_A), (512, 30720, N_ITEM_A),
                         (1024, 30720, N_ITEM_A)):
        h, w, bm, pad_l, tgt, _, dlse, dt = _ce_inputs(512 * 2 * 10, d, V,
                                                       n_real, V + d)
        wb = w.to(torch.bfloat16)
        at = "step" if d == 128 else f"d{d}"
        with torch.no_grad():
            # K5 on the f32 K4's lse, whose bits two checkouts share where
            # K4 f32 is unchanged, so that K5's digest is its own
            lse32, _ = fused_ce_cuda.ce_fwd(h, w, bm, pad_l, tgt)
            for tag, ww in (("f32", w), ("bf16", wb)):
                digests[f"k4_{tag}_d{d}_V{V}"] = _digest(
                    *fused_ce_cuda.ce_fwd(h, ww, bm, pad_l, tgt))
                digests[f"k5_{tag}_d{d}_V{V}"] = _digest(
                    *fused_ce_cuda.ce_bwd(h, ww, bm, lse32, dlse, dt, tgt))
            lse, _ = fused_ce_cuda.ce_fwd(h, wb, bm, pad_l, tgt)
            for i in range(3):
                if f"k4_bf16_{at}_ms" in ce:
                    ce[f"k4_bf16_{at}_ms"][i] += timer(
                        lambda: fused_ce_cuda.ce_fwd(h, wb, bm, pad_l, tgt))
                if f"k5_bf16_{at}_ms" in ce:
                    ce[f"k5_bf16_{at}_ms"][i] += timer(
                        lambda: fused_ce_cuda.ce_bwd(h, wb, bm, lse, dlse,
                                                     dt, tgt))
        del h, w, wb, lse32
        torch.cuda.empty_cache()
    ce["k4_k5_bf16_step_ms"] = [a + b for a, b in zip(
        ce["k4_bf16_step_ms"], ce["k5_bf16_step_ms"])]
    ce.update(_tower_measures(timer, digests))
    long_accuracy = _step_accuracy(graphs, spec, LONG_STEP)
    wide_accuracy = _step_accuracy(graphs, spec, WIDE_STEP)
    # K4 from float64 on trained-scale logits (deterministic: one reading)
    errs = [_k4_trained_errs(V, n_real)
            for V, n_real in ((30720, N_ITEM_A), (36864, N_ITEM_B))]
    ce["k4_trained_f64"] = [max(e for e, _ in errs)]
    ce["plain_trained_f64"] = [max(p for _, p in errs)]
    kernels.update(ce)
    del timer

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
    serve_busy, serve_k2, _ = _busy_ms(serve)
    bf = step_rates["bf16"]
    return {"rates": rates, "host_ms": host, "busy_ms": busy, "k2_ms": k2,
            "bf16_rates": bf[0], "bf16_host_ms": bf[1], "bf16_busy_ms": bf[2],
            "bf16_k2_ms": bf[3], "bf16_k3_ms": bf[4],
            "digests": digests, "k2_eval_ms": k2_eval,
            "serve_convolve_ms": serve_rates["convolve"][:SERVE_RUNS],
            "serve_sampled_rates": serve_rates["sampled"][:SERVE_RUNS],
            "serve_full_rates": serve_rates["full"][:SERVE_RUNS],
            "serve_busy_ms": serve_busy, "serve_k2_ms": serve_k2,
            "long_step_accuracy": long_accuracy,
            "wide_step_accuracy": wide_accuracy, **kernels}


def compare(other: str, bitwise: bool = False) -> int:
    """This checkout's measure_rates against that of ``other`` (a directory
    holding another version of ``c2dsr_tpu_torch``), each in a process of
    its own, in turns (other, this, this, other), on one card.  For each
    measure, the difference of the means and whether it exceeds 3 standard
    errors; which outputs' digests the two checkouts share.  With
    ``bitwise`` (``--bitwise``, for a change meant to keep every bit), it
    fails where a digest differs, but the towers' past ``WIDE_D``."""
    runs = {other: [], REPO_DIR: []}
    for root in (other, REPO_DIR, REPO_DIR, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--rates", root], capture_output=True,
                             text=True, timeout=600)
        check(out.returncode == 0, f"rates of {root}: {out.stderr[-2000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs[root].append(res)
        log(f"compare {root}: " + "; ".join(
            f"{k} {[round(v, 4) for v in vs]}" for k, vs in res.items()
            if k not in ("digests", "long_step_accuracy",
                         "wide_step_accuracy"))
            + f"; digests {res.get('digests')}")
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
                      ("k7_step_ms", "ms of K7's six calls a step"),
                      ("k4_step_ms", "ms of K4's two calls a step"),
                      ("k5_step_ms", "ms of K5's two calls a step"),
                      ("k4_k5_step_ms", "ms of K4 + K5 a step"),
                      ("bf16_rates", "bf16 train examples/s"),
                      ("bf16_host_ms", "host ms to enqueue a bf16 step"),
                      ("bf16_busy_ms", "ms busy a bf16 train step"),
                      ("bf16_k2_ms", "ms of K2 a bf16 train step"),
                      ("bf16_k3_ms", "ms of K3 a bf16 train step"),
                      ("k2_f32_step_ms", "ms of K2's three calls a step"),
                      ("k3_f32_step_ms", "ms of K3's three calls a step"),
                      ("k2_bf16_step_ms",
                       "ms of K2 bf16's three calls a step"),
                      ("k3_bf16_step_ms",
                       "ms of K3 bf16's three calls a step"),
                      ("k2_bf16_eval_ms", "ms of K2 bf16 at B 2,048 eval"),
                      ("k2_bf16_l200_ms", "ms of K2 bf16 at L 200"),
                      ("k3_bf16_l200_ms", "ms of K3 bf16 at L 200"),
                      ("k2_f32_l200_ms", "ms of K2 at L 200"),
                      ("k3_f32_l200_ms", "ms of K3 at L 200"),
                      ("k2_f32_l64_ms", "ms of K2 at L 64, B 512"),
                      ("k3_f32_l64_ms", "ms of K3 at L 64, B 512"),
                      ("k2_bf16_l64_ms", "ms of K2 bf16 at L 64, B 512"),
                      ("k3_bf16_l64_ms", "ms of K3 bf16 at L 64, B 512"),
                      ("k2_bf16_d1024_ms", "ms of K2 bf16 at d 1,024"),
                      ("k3_bf16_d1024_ms", "ms of K3 bf16 at d 1,024"),
                      ("k2_f32_d1024_ms", "ms of K2 at d 1,024, B 256"),
                      ("k3_f32_d1024_ms", "ms of K3 at d 1,024, B 256"),
                      ("k2_f32_d512_ms", "ms of K2 at d 512, B 512"),
                      ("k3_f32_d512_ms", "ms of K3 at d 512, B 512"),
                      ("k2_bf16_d512_ms", "ms of K2 bf16 at d 512, B 512"),
                      ("k3_bf16_d512_ms", "ms of K3 bf16 at d 512, B 512"),
                      *[(k, "profiled ms of that part of K2 or K3")
                        for k in sorted({k for v in runs.values()
                                         for res in v for k in res})
                        if k.startswith(("k2_gemm_", "k3_gemm_",
                                         "k3_wgrad_", "k2_attn_",
                                         "k3_attn_"))],
                      ("k4_bf16_step_ms", "ms of K4 bf16's two calls a step"),
                      ("k5_bf16_step_ms", "ms of K5 bf16's two calls a step"),
                      ("k4_k5_bf16_step_ms", "ms of K4 + K5 bf16 a step"),
                      ("k4_bf16_d256_ms", "ms of K4 bf16 at d 256"),
                      ("k5_bf16_d256_ms", "ms of K5 bf16 at d 256"),
                      ("k4_bf16_d1024_ms", "ms of K4 bf16 at d 1,024")):
        if any(key not in res for v in runs.values() for res in v):
            log(f"compare {key}: not measured by both checkouts")
            continue
        vals = {k: np.array([r for res in v for r in res[key]])
                for k, v in runs.items()}
        mine, theirs = vals[REPO_DIR], vals[other]
        diff = mine.mean() - theirs.mean()
        se = math.sqrt(sum(r.var(ddof=1) / len(r) for r in vals.values()))
        log(f"compare {key}: this {mine.mean():.4f} against "
            f"{theirs.mean():.4f} {unit} ({diff / theirs.mean():+.2%}), "
            f"standard error {se:.4f}: "
            f"{'resolved' if abs(diff) > 3 * se else 'unresolved'}")
    mine = runs[REPO_DIR][0].get("digests", {})
    theirs = runs[other][0].get("digests", {})
    same = sorted(k for k in mine if theirs.get(k) == mine[k])
    differ = sorted(k for k in mine if k in theirs and theirs[k] != mine[k])
    stable = all(r.get("digests") == v[0].get("digests")
                 for v in runs.values() for r in v)
    log(f"compare digests: bitwise equal {same}; different {differ}; each "
        f"checkout's two runs {'equal' if stable else 'DIFFER'}")
    if bitwise:
        # every output but the towers' past WIDE_D (the wgmma tile's
        # widths, k2k3_*_d<d>_*) must be the other checkout's bits
        from c2dsr_tpu_torch.ops.encoder_cuda import WIDE_D
        kept = [k for k in differ
                if not ((m := re.match(r"k2k3_\w+?_d(\d+)_", k))
                        and int(m.group(1)) > WIDE_D)]
        check(not kept, f"compare --bitwise: outputs not bitwise the other "
              f"checkout's: {kept}")
    for root, v in runs.items():
        for key, step in (("long_step_accuracy", "LONG_STEP"),
                          ("wide_step_accuracy", "WIDE_STEP")):
            log(f"compare {key} {root}: "
                + "; ".join(json.dumps(r.get(key)) for r in v)
                + f" (_tower_accuracy at {step}: relative Frobenius from a "
                "float64 plain tower, worst tower call)")
    if all("wide_step_accuracy" in r for v in runs.values() for r in v):
        for t in ("dx", "w_qkv"):
            mine = max(r["wide_step_accuracy"][t]["k3"]
                       for r in runs[REPO_DIR])
            theirs = max(r["wide_step_accuracy"][t]["k3"]
                         for r in runs[other])
            log(f"compare wide_step_accuracy {t}: this {mine:.3e}, the "
                f"other {theirs:.3e} ({mine / theirs:.3f}x)")
            check(mine <= 1.25 * theirs, f"compare: at WIDE_STEP K3's {t} "
                  f"lies {mine / theirs:.3f}x the other checkout's distance "
                  "from float64 (at most 1.25x)")
    for key in ("k4_trained_f64", "plain_trained_f64"):
        log(f"compare {key}: this "
            f"{[f'{r[key][0]:.3e}' for r in runs[REPO_DIR]]} against "
            f"{[f'{r[key][0]:.3e}' for r in runs[other]]} (each run's, "
            "relative to max |float64|, both domains' largest)")
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
    from c2dsr_tpu_torch.ops import wrappers
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
        wrappers.carry_counters(orig, rec)
        setattr(mod, name, rec)
        saved.append((mod, name, orig))
    try:
        yield
    finally:
        for mod, name, orig in saved:
            wrappers.carry_counters(getattr(mod, name), orig)
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


def _sharded_init(cfg, spec, mesh, dev):
    """This rank's params by ``init_params_sharded`` on the card, from the
    seed the one-process runs take, and what a rank's init costs: the card
    memory it allocated (``max_memory_allocated``, from a reset just
    before), the full tree's bytes, and whether every leaf is bitwise the
    full draw's shard (drawn on the host).  Returns (params, the full tree
    on the host, that record)."""
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.parallel import mesh as mesh_mod
    from c2dsr_tpu_torch.train import step as step_mod
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    params = params_mod.init_params_sharded(
        cfg, spec, torch.Generator().manual_seed(0), mesh, dev)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    whole = params_mod.init_params(cfg, spec,
                                   torch.Generator().manual_seed(0), "cpu")
    want = step_mod.param_leaves(mesh_mod.shard_params(whole, mesh))
    got = step_mod.param_leaves(params)
    return params, whole, {
        "init_card_bytes": int(peak),
        "full_tree_bytes": sum(t.numel() * t.element_size()
                               for t in step_mod.param_leaves(whole)),
        "shard_bytes": sum(t.numel() * t.element_size() for t in got),
        "init_bitwise": len(got) == len(want) and all(
            torch.equal(a.cpu(), b) for a, b in zip(got, want))}


def _init_rank(rank, world, job):
    """One rank of a 1 x world mesh on the one card: its shard-local
    initialisation alone (``_sharded_init``)."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.make_mesh(1, world)
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = Config(mesh_model=world)
    return _sharded_init(cfg, job["spec"], mesh, dev)[2]


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
    params, whole, out = _sharded_init(cfg, spec, mesh, dev)
    n_p = padded_sizes(cfg, spec)[0]
    graphs = c2dsr.Graphs(*(spmm.attach_a2a_plan(spmm.device_graph(g, dev),
                                                 n_p, n_model,
                                                 mesh.model_index)
                            for g in job["graphs"]))
    opt = optim.make_optimizer(cfg, steps_per_epoch=10)
    state = step_mod.init_state(params, opt, mesh)
    fn = step_mod.make_train_step(cfg, spec, graphs, opt, dev, mesh=mesh)
    local = mesh_mod.local_batch(job["batch"], mesh)
    out["setup_s"] = time.perf_counter() - t0

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
        whole = params_mod._map(lambda t: t.to(dev), whole)
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
    geometry and the default Config, each rank initialised shard-locally
    (``_sharded_init``; first on a 1x4 mesh alone).  Gates: each rank's
    params bitwise the full draw's shard, the card memory of its init below
    the full tree's bytes; the step's loss within 1e-5
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

    # shard-local initialisation on a 1x4 mesh (the model axis of a
    # four-card mesh), its ranks sharing the card; the 1x2 and 2x2 runs
    # below initialise the same way
    t0 = time.perf_counter()
    try:
        inits = {"1x4": launch.run_ranks(_init_rank, 4, ({"spec": spec},),
                                         device="cuda", timeout=PAR_TIMEOUT)}
    except (RuntimeError, TimeoutError) as e:
        raise SmokeFailure(f"parallel init 1x4: {e}")
    log(f"parallel init 1x4: {time.perf_counter() - t0:.1f} s")
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
        inits[tag] = res
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
    for tag, res in inits.items():
        for rank, r in enumerate(res):
            log(f"parallel {tag} rank {rank} init_params_sharded: card "
                f"max_memory_allocated {r['init_card_bytes']} B after init "
                f"(its shards: {r['shard_bytes']} B; the full tree: "
                f"{r['full_tree_bytes']} B); bitwise the full draw's shard: "
                f"{r['init_bitwise']}")
            check(r["init_bitwise"], f"parallel {tag} rank {rank}: "
                  "init_params_sharded is not the full draw's shard")
            check(r["init_card_bytes"] < r["full_tree_bytes"],
                  f"parallel {tag} rank {rank}: init allocated "
                  f"{r['init_card_bytes']} B, the full tree is "
                  f"{r['full_tree_bytes']} B")
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


def phase_native():
    """The native data layer (``c2dsr_tpu_torch/native``), built here with
    g++, on a raw directory of synthetic users written as the reference
    lays it out: ``load_or_build_split`` (train, val, test) and
    ``build_graphs_from_file`` hold their deterministic fields and graphs
    bitwise against the Python path, and their random fields (the corrupted
    sequences, the sampled negatives) to the invariants of
    ``tests/test_native.py``; then ``python -m c2dsr_tpu_torch.cli`` trains
    an epoch on the directory.  No kernel is compared here."""
    from c2dsr_tpu_torch import native
    from c2dsr_tpu_torch.config import Config, DataSpec
    from c2dsr_tpu_torch.data import preprocess, raw, synthetic
    from c2dsr_tpu_torch.graph import build as graph_build
    t0 = time.perf_counter()
    native.load()
    log(f"native: {os.path.basename(native.lib_path())} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    spec = DataSpec(n_item_a=NATIVE_ITEMS[0], n_item_b=NATIVE_ITEMS[1],
                    len_max=LEN_MAX)
    cfg = Config()
    na, pad = spec.n_item_a, spec.idx_pad
    with tempfile.TemporaryDirectory() as tmp:
        raw_dir = os.path.join(tmp, "raw")
        synthetic.write_item_lists(spec, raw_dir)
        for i, mode in enumerate(("train", "val", "test")):
            synthetic.write_reference_tsv(
                synthetic.generate_sequences(spec, NATIVE_USERS, seed=20 + i),
                raw.split_path(raw_dir, mode))
        for mode in ("train", "val", "test"):
            t0 = time.perf_counter()
            got = preprocess.load_or_build_split(
                raw_dir, os.path.join(tmp, "cache"), mode, spec,
                cfg.n_neg_sample, cfg.seed)
            secs = time.perf_counter() - t0
            py = preprocess.load_or_build_split(
                raw_dir, None, mode, spec, cfg.n_neg_sample, cfg.seed,
                python_path=True)
            fields = (preprocess.TRAIN_FIELDS[:12] if mode == "train"
                      else preprocess.EVAL_FIELDS[:10])
            for k in fields:
                check(np.array_equal(got[k], py[k]),
                      f"native {mode}: {k} differs from the Python path")
            if mode == "train":
                seq = got["seq_share"]
                neg_a, neg_b = got["seq_share_neg_a"], got["seq_share_neg_b"]
                is_a, is_b = seq < na, (seq >= na) & (seq != pad)
                check(np.array_equal(neg_a[is_a], seq[is_a])
                      and np.array_equal(neg_b[is_b], seq[is_b])
                      and bool(((neg_a[is_b] >= na)
                                & (neg_a[is_b] < pad)).all())
                      and bool(((neg_b[is_a] >= 0)
                                & (neg_b[is_a] < na)).all())
                      and bool((neg_a[seq == pad] == pad).all())
                      and bool((neg_b[seq == pad] == pad).all()),
                      "native train: a corrupted sequence breaks its "
                      "invariants")
                differ = not np.array_equal(neg_a, py["seq_share_neg_a"])
            else:
                negs = got["list_neg"]
                pools = np.where(got["xory_last"] == 0, na, spec.n_item_b)
                check(negs.shape == (got["gt_last"].shape[0],
                                     cfg.n_neg_sample)
                      and bool((np.diff(np.sort(negs, 1), axis=1) > 0).all())
                      and bool(((negs >= 0) & (negs < pools[:, None])).all())
                      and bool((negs != got["gt_last"][:, None]).all()),
                      f"native {mode}: the negatives break their invariants")
                differ = not np.array_equal(negs, py["list_neg"])
            log(f"native {mode}: {got['seq_share'].shape[0]} examples in "
                f"{secs:.2f} s, {len(fields)} deterministic fields equal the "
                f"Python path's, random fields within their invariants "
                f"(and other than the Python path's: {differ})")
        path = raw.split_path(raw_dir, "train")
        for g, p_ in zip(graph_build.build_graphs_from_file(path, spec),
                         graph_build.build_graphs_from_file(
                             path, spec, python_path=True)):
            check(all(np.array_equal(getattr(g, f), getattr(p_, f))
                      for f in ("rows", "cols", "vals")),
                  "native graph differs from the Python path's")
        log("native: both graphs from the raw file equal the Python path's")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO_DIR] + [p for p in [env.get("PYTHONPATH")] if p])
        cmd = [sys.executable, "-m", "c2dsr_tpu_torch.cli", "--path_raw",
               raw_dir, "--path_data", os.path.join(tmp, "cli_data"),
               "--n_epoch", "1"]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                             text=True, timeout=600)
        check(run.returncode == 0, f"native cli exited {run.returncode}: "
              f"{run.stderr[-2000:]}")
        check("[ Test result ]" in run.stdout,
              "native cli printed no final result table")
        check(sorted(os.listdir(os.path.join(tmp, "cli_data")))
              == ["test.std.npz", "train.std.npz", "val.std.npz"],
              "native cli wrote other caches")
        table = run.stdout[run.stdout.rindex("[ Test result ]"):]
        log(f"native cli: one epoch on the raw directory in "
            f"{time.perf_counter() - t0:.1f} s; test result "
            f"{table.splitlines()[2].strip()}")


def phase_scaled_e2e():
    """The composed train step at 1,000,001 item rows
    (``bench/scaled_e2e.py``, the bench's ``--scaled-e2e``) at full width
    with 2 warm-up and 5 timed steps, with its gates: the loss falls, the
    CE probe against float64, full ranks in range and equal to a chunked
    count but at near-ties, every step kernel launched in the window, and
    the step's own recorded calls held against their plain versions (K1
    within SPMM_TOL, K4/K5, K7 bitwise CPU index_add_) and timed.  Returns
    (report, the window's launches by wrapper)."""
    import dataclasses
    from c2dsr_tpu_torch.bench import scaled_e2e
    size = dataclasses.replace(scaled_e2e.FULL, windows=1, steps=5)
    try:
        rep = scaled_e2e.run("cuda", size, log=log)
    except timing.GateFailure as e:
        raise SmokeFailure(f"scaled_e2e: gate failed: {e}")
    window = {name: rep["launches_in_windows"].get(name, 0)
              for name in kernel_wrappers()}
    log(f"scaled_e2e: {timing.card_line()}: step {rep['train_step_ms']:.3f} "
        f"ms, {rep['train_examples_per_s']:.1f} train examples/s, full rank "
        f"{rep['eval_full_rank_examples_per_s']:.1f} examples/s "
        f"({rep['eval_full_rank_items_per_s']:.4g} items/s), peak memory "
        f"{rep['peak_memory_bytes'] / 2**30:.2f} GiB (training "
        f"{rep['peak_memory_train_bytes'] / 2**30:.2f}), launches in "
        f"{size.steps} steps {rep['launches_in_windows']}")
    return rep, window


GRAPH_STEPS = 8          # steps of each captured-against-eager comparison
GRAPH_SPE = 3            # steps an epoch there: two full batches, then a
GRAPH_RAGGED = 300       # ragged one of this many rows; StepLR at lr_step 1
GRAPH_ROUNDS = 6         # rounds of (captured, eager, eager, captured) runs
GRAPH_RUN_STEPS = 8      # steps a timed run
GRAPH_SERVE_ROUNDS = 3   # rounds of timed serving runs, in the same turns


def _graph_batches(train, cfg):
    """GRAPH_STEPS batches in epochs of GRAPH_SPE: full batches, then the
    ragged last one, so each signature runs its warm-up, its capture and
    replays within the run."""
    out, at = [], 0
    for i in range(GRAPH_STEPS):
        n = GRAPH_RAGGED if i % GRAPH_SPE == GRAPH_SPE - 1 else cfg.batch_size
        out.append({k: v[at:at + n] for k, v in train.items()})
        at += n
    return out


def _graph_state(cfg, spec, init):
    """A fresh (state, step function, optimizer) on the card from the numpy
    params ``init``, StepLR's epoch GRAPH_SPE steps."""
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.train import optim
    from c2dsr_tpu_torch.train import step as step_mod
    params = params_mod.params_from_numpy(init, "cuda")
    opt = optim.make_optimizer(cfg, steps_per_epoch=GRAPH_SPE)
    state = step_mod.init_state(params, opt)
    return state, opt


def _graph_tensors(state):
    """Every tensor a step updates: the params, and per leaf the AdamW's
    moments, max second moment and step count, and the lr."""
    from c2dsr_tpu_torch.train import step as step_mod
    opt = state.opt_state
    return (step_mod.param_leaves(state.params)
            + [opt.adamw.state[p][k] for p in opt.leaves
               for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq", "step")]
            + [opt.lr])


def _graph_run(cfg, spec, graphs, init, batches, capture, start=None,
               steps=None):
    """Run ``batches`` (from ``start``, a (state, opt) pair, or fresh from
    ``init``), with the epoch's gradient reset under bug_epoch_grad_accum:
    (state, [aux of each step as one tensor], step function)."""
    from c2dsr_tpu_torch.train import step as step_mod
    state, opt = start or _graph_state(cfg, spec, init)
    fn = step_mod.make_train_step(cfg, spec, graphs, opt, "cuda",
                                  capture=capture)
    auxes = []
    for b in batches[state.step:steps]:
        if cfg.bug_epoch_grad_accum and state.step % GRAPH_SPE == 0:
            opt.reset_grad_accum(state.opt_state)
        state, aux = fn(state, b)
        auxes.append(torch.stack([aux[k] for k in step_mod.AUX_KEYS]))
    torch.cuda.synchronize()
    return state, auxes, fn


def _bitwise(tag, a, b):
    differ = sum(not torch.equal(x, y) for x, y in zip(a, b))
    check(len(a) == len(b) and differ == 0,
          f"{tag}: not bitwise equal ({differ} of {len(a)} tensors differ)")


def _graph_kernels(fn, state, batch, sparse, bf16, label):
    """One replay of ``fn``'s captured step under torch.profiler: every
    step kernel runs, launched by one cudaGraphLaunch (a handful of host
    launches around it: the seed, the lr, aux); with ``sparse`` K6, with
    ``bf16`` the bf16 instantiations.  Returns the kernel names."""
    from torch.profiler import ProfilerActivity, profile
    fn(state, batch)                 # the signature's graph exists after
    torch.cuda.synchronize()
    # the profiler may miss the first kernels of its window (_k7_kernels):
    # LEAD fills and a pause open it, before the replay
    lead = torch.empty(16 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD):
            lead.zero_()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAUSE_S)
        fn(state, batch)
        torch.cuda.synchronize()
    host, timed = {}, []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            n = ev.name.replace("(anonymous namespace)::", "")
            n = n[5:] if n.startswith("void ") else n
            timed.append((ev.time_range.start, n.split("(")[0]))
        else:
            host[ev.name] = host.get(ev.name, 0) + 1
    names = [n for _, n in sorted(timed)]
    while names and "Fill" in names[0]:
        names.pop(0)              # the opening fills and the step's own
    fam = {}
    for n in names:
        f = kernel_family(n)
        if f:
            fam[f] = fam.get(f, 0) + 1

    def bf(prefix):
        return any(n.startswith(prefix) and n.rstrip().endswith("true>")
                   for n in names)

    k6 = sum(n.startswith("spmm_tasks_kernel<") and not
             n.startswith("spmm_tasks_kernel<0") for n in names)
    launches = max(host.get("cudaLaunchKernel", 0)
                   + host.get("cudaLaunchKernelExC", 0) - LEAD, 0)
    log(f"{label}: one replay ran {len(names)} kernels ({fam}; K6 {k6}) "
        f"from {host.get('cudaGraphLaunch', 0)} cudaGraphLaunch and "
        f"{launches} kernel launches by the host")
    check(host.get("cudaGraphLaunch", 0) == 1,
          f"{label}: {host.get('cudaGraphLaunch', 0)} graph launches")
    check(launches <= 8 and len(names) > 10 * max(launches, 1),
          f"{label}: the host launched {launches} kernels itself")
    for f in ("K1/K6 spmm", "K2 encoder_fwd", "K3 encoder_bwd", "K4 ce_fwd",
              "K5 ce_bwd", "K7 segsum"):
        check(fam.get(f, 0) > 0, f"{label}: no {f} kernel in the replay")
    check((k6 > 0) == sparse, f"{label}: {k6} K6 kernels, sparse {sparse}")
    check(any(n.startswith("ce_bwd_onepass_kernel<") for n in names)
          != bf16, f"{label}: K5's one pass {'in' if bf16 else 'not in'} "
          "the replay")
    if bf16:
        for prefix in ("spmm_tasks_kernel<", "encoder_fwd_attn_seq_kernel<",
                       "attn_bwd_seq_kernel<", "ce_fwd_kernel<",
                       "ce_bwd_kernel<"):
            check(bf(prefix), f"{label}: no bf16 {prefix}...> in the replay")
    return names


def _graph_rates(cfg, spec, graphs, init, train, label):
    """The captured step against the eager one in turns, GRAPH_ROUNDS rounds of (a, b, b, a) runs of
    GRAPH_RUN_STEPS full batches: train examples/s; after each run the
    host's ms to enqueue one more step on an empty queue; and profiled
    device busy ms a step."""
    from c2dsr_tpu_torch.data.pipeline import BatchIterator
    from c2dsr_tpu_torch.train import step as step_mod
    it = BatchIterator(train, cfg.batch_size, shuffle=True, seed=0,
                       drop_last=True)

    def feed():
        while True:
            yield from it.epoch()

    batches = feed()
    names = ("captured", "eager")
    fns = {}
    for name in names:
        state, opt = _graph_state(cfg, spec, init)
        fn = step_mod.make_train_step(cfg, spec, graphs, opt, "cuda",
                                      capture=name == "captured")
        for _ in range(3):
            state, _ = fn(state, next(batches))
        fns[name] = [fn, state]
    torch.cuda.synchronize()
    host = {n: [] for n in names}
    rate = {n: [] for n in names}
    a, b = names
    for name in (a, b, b, a) * GRAPH_ROUNDS:
        fn, state = fns[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_RUN_STEPS):
            state, aux = fn(state, next(batches))
        torch.cuda.synchronize()
        rate[name].append(GRAPH_RUN_STEPS * cfg.batch_size
                          / (time.perf_counter() - t0))
        # the host's ms to enqueue one step on an empty queue
        t0 = time.perf_counter()
        state, aux = fn(state, next(batches))
        host[name].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        fns[name][1] = state
        check(math.isfinite(float(aux["loss"])), f"{label}: loss not finite")
    out = {}
    for name in names:
        fn, state = fns[name]
        one = next(batches)

        def three_steps():
            for _ in range(3):
                fn(state, one)
            torch.cuda.synchronize()

        # one profiled window of three steps (each profiler window opened
        # in this process costs later phases' profiles their first events)
        busy = [b / 3 for b in _busy_ms(three_steps, reps=1)[0]]
        out[name] = {"host_ms": float(np.mean(host[name])),
                     "host_ms_sd": float(np.std(host[name], ddof=1)),
                     "examples_per_s": float(np.mean(rate[name])),
                     "examples_per_s_sd": float(np.std(rate[name], ddof=1)),
                     "step_ms": cfg.batch_size / float(np.mean(rate[name]))
                     * 1e3, "busy_ms": float(np.median(busy)),
                     "runs": len(rate[name])}
        log(f"{label} {name}: host {out[name]['host_ms']:.3f} ms a step (sd "
            f"{out[name]['host_ms_sd']:.3f}), "
            f"{out[name]['examples_per_s']:.1f} train examples/s (sd "
            f"{out[name]['examples_per_s_sd']:.1f}, "
            f"{out[name]['step_ms']:.3f} ms a step), device busy "
            f"{out[name]['busy_ms']:.3f} ms a step (profiled over 3 steps)")
    for key in ("examples_per_s", "host_ms"):
        src = rate if key == "examples_per_s" else host
        d, se, ok = timing.se_resolved(src[a], src[b])
        out[f"{key}_diff"] = {"diff": d, "se": se, "resolved": ok}
        log(f"{label}: {a} - {b} {key} {d:+.3f} ({d / np.mean(src[b]):+.2%}),"
            f" standard error {se:.3f}: {'resolved' if ok else 'unresolved'}")
    return out, fns


def phase_graph(spec, train, graphs, eval_data):
    """The train step and the rank step as CUDA graphs (``capture.py``),
    held bitwise against the eager programs (``capture=False``) from the
    same params, at FK geometry with the default Config (dropout 0.2):

    * f32 and bf16, dense and batch-sparse: GRAPH_STEPS steps in epochs of
      two full batches and a ragged one (each signature warmed up eagerly,
      captured, replayed), StepLR moving the lr every epoch (lr_step 1):
      params, AdamW moments, max second moments, step counts, lr and aux
      bitwise; one replay profiled with every step kernel in it;
    * bug_epoch_grad_accum across the epoch boundaries;
    * resume: a checkpoint at step 3, restored into a fresh state and a
      fresh program, run to GRAPH_STEPS: bitwise the uninterrupted run;
    * serving: the captured rank_step's ranks equal the eager one's in
      both domains, sampled and full, the last chunk padded;
    * times, in turns in this process: the captured and eager steps (f32,
      bf16) and serving examples/s of each mode; the capture's seconds and
      the graph pool's bytes.

    Returns (launches of the captured f32 and batch-sparse runs, results).
    """
    from c2dsr_tpu_torch import checkpoint as ckpt_mod
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.train import step as step_mod
    base = Config(lr_step=1)
    init = params_mod.params_to_numpy(params_mod.init_params(
        base, spec, torch.Generator().manual_seed(0), "cpu"))
    batches = _graph_batches(train, base)
    res = {"steps": GRAPH_STEPS, "epoch_steps": GRAPH_SPE,
           "ragged_rows": GRAPH_RAGGED}
    launches = dict.fromkeys(read_launches(), 0)
    lrs = None
    for tag, cfg in (
            ("f32", base), ("f32 batch-sparse", base.with_(
                batch_sparse_gnn=True)),
            ("bf16", base.with_(compute_dtype="bfloat16",
                                classifier_dtype="bfloat16")),
            ("bf16 batch-sparse", base.with_(
                compute_dtype="bfloat16", classifier_dtype="bfloat16",
                batch_sparse_gnn=True))):
        t0 = time.perf_counter()
        eager, aux_e, _ = _graph_run(cfg, spec, graphs, init, batches, False)
        reset_launches()
        capt, aux_c, fn = _graph_run(cfg, spec, graphs, init, batches, True)
        for k, v in read_launches().items():
            launches[k] += v
        stats = fn.program.stats()
        _bitwise(f"graph {tag}: state", _graph_tensors(eager),
                 _graph_tensors(capt))
        _bitwise(f"graph {tag}: aux", aux_e, aux_c)
        check(stats["graphs"] == 2 and sum(stats["replays"]) ==
              GRAPH_STEPS - 2, f"graph {tag}: {stats}")
        lr = float(capt.opt_state.lr)
        check(lr < base.lr, f"graph {tag}: StepLR left the lr at {lr}")
        _graph_kernels(fn, capt, batches[0], cfg.batch_sparse_gnn,
                       cfg.bf16_products(), f"graph {tag}")
        res[tag] = {"capture_s": stats["capture_s"],
                    "pool_bytes": stats["pool_bytes"],
                    "launches_per_replay": stats["launches_per_replay"]}
        log(f"graph {tag}: {GRAPH_STEPS} captured steps bitwise the eager "
            f"ones (params, AdamW state, lr {lr:g}, aux; losses "
            f"{[round(float(a[0]), 4) for a in aux_c]}); graphs "
            f"{stats['graphs']}, capture {stats['capture_s']} s, replays "
            f"{stats['replays']}, pool {stats['pool_bytes'] / 2**20:.1f} MiB, "
            f"launches a replay {stats['launches_per_replay']}; "
            f"{time.perf_counter() - t0:.1f} s")
        del eager, capt, fn
    # the epoch-accumulation quirk
    cfg = base.with_(bug_epoch_grad_accum=True)
    eager, aux_e, _ = _graph_run(cfg, spec, graphs, init, batches, False)
    capt, aux_c, fn = _graph_run(cfg, spec, graphs, init, batches, True)
    same = all(torch.equal(x, y) for x, y in zip(
        _graph_tensors(eager) + aux_e, _graph_tensors(capt) + aux_c))
    log(f"graph grad accum: captured against eager over {GRAPH_STEPS} "
        f"steps: {'bitwise equal' if same else 'NOT bitwise equal'}")
    res["grad accum"] = {"bitwise": same}
    check(same, "graph grad accum: captured != eager")
    # resume: checkpoint at step 3, a fresh state and program, on to the end
    whole, aux_w, _ = _graph_run(base, spec, graphs, init, batches, True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")
        part, _, _ = _graph_run(base, spec, graphs, init, batches, True,
                                steps=3)
        ckpt_mod.save(path, part, block=True)
        fresh = _graph_state(base, spec, init)
        restored = ckpt_mod.restore(path, template=fresh[0])
        resumed, aux_r, _ = _graph_run(base, spec, graphs, init, batches,
                                       True, start=(restored, fresh[1]))
    _bitwise("graph resume: state", _graph_tensors(whole),
             _graph_tensors(resumed))
    _bitwise("graph resume: aux", aux_w[3:], aux_r)
    log(f"graph resume: restored at step 3 into a fresh program, "
        f"{GRAPH_STEPS - 3} steps on: bitwise the uninterrupted run")
    del whole, part, resumed, fresh, restored
    torch.cuda.empty_cache()

    # serving: captured rank_step against eager
    params = params_mod.params_from_numpy(init, "cuda")
    fns = {c: ranker.make_eval_fns(base, spec, graphs, "cuda", capture=c)
           for c in (True, False)}
    hi = fns[True][0](params)
    serve = {}
    for mode in ("sampled", "full"):
        ranks = {c: ranker.evaluate_split(params, hi, eval_data, fns[c][1],
                                          base, mode) for c in (False, True)}
        check(ranks[True] == ranks[False],
              f"graph serving {mode}: captured ranks differ from eager")
        times = {True: [], False: []}
        n = eval_data["gt_last"].shape[0]
        for c in (True, False, False, True) * GRAPH_SERVE_ROUNDS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ranker.evaluate_split(params, hi, eval_data, fns[c][1], base, mode)
            times[c].append(n / (time.perf_counter() - t0))
        d, se, ok = timing.se_resolved(times[True], times[False])
        serve[mode] = {"captured": float(np.mean(times[True])),
                       "eager": float(np.mean(times[False])),
                       "diff": d, "se": se, "resolved": ok}
        log(f"graph serving {mode}: ranks equal over {n} examples; eval "
            f"examples/s captured {np.mean(times[True]):.1f} eager "
            f"{np.mean(times[False]):.1f}, diff {d:+.1f} (se {se:.1f}, "
            f"{'resolved' if ok else 'unresolved'})")
    stats = fns[True][1].program.stats()
    serve["program"] = stats
    log(f"graph serving: {stats['graphs']} rank graphs, capture "
        f"{stats['capture_s']} s, pool {stats['pool_bytes'] / 2**20:.1f} MiB")
    res["serving"] = serve
    del fns, hi, params
    torch.cuda.empty_cache()

    # times: captured against eager (f32, bf16)
    for tag, cfg in (("f32", Config()),
                     ("bf16", Config(compute_dtype="bfloat16",
                                     classifier_dtype="bfloat16"))):
        res[f"rates {tag}"], held = _graph_rates(cfg, spec, graphs, init,
                                                 train, f"graph rates {tag}")
        if tag == "f32":
            st = held["captured"][0].program.stats()
            res["fk_program"] = st
            log(f"graph rates f32: the FK program's capture {st['capture_s']}"
                f" s, pool {st['pool_bytes'] / 2**20:.1f} MiB")
        del held
        torch.cuda.empty_cache()
    return launches, res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    global timing, gates
    if sys.argv[1:2] == ["--rates"]:
        timing = _load_timing()
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        from c2dsr_tpu_torch.bench import gates   # the measured checkout's
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
        return compare(os.path.abspath(sys.argv[2]),
                       bitwise="--bitwise" in sys.argv[3:])
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
    sass = _mma_sass()

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
    k4, k5, k5_pair = phase_ce(timer, peak_flops, peak_bw, name)
    t0 = time.perf_counter()
    wide = phase_shapes()
    tower_times = _tower_times(timer, name, peak_flops, peak_bw)
    log(f"phase shapes: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wide_gemm = phase_wide_gemm(timer, name, peak_bw)
    log(f"phase wide gemm: {time.perf_counter() - t0:.1f} s")
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
    training_paths = phase_train_wide(spec, train, graphs, graphs_host)
    log(f"phase training wide: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    odd_widths = phase_odd_widths(spec, train, graphs, graphs_host, eval_data)
    log(f"phase odd widths: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bf16, bf16_launches = phase_bf16(spec, train, graphs, graphs_host,
                                     eval_data, timer, peak_bw)
    log(f"phase bf16: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reset_launches()
    k7, atomics = phase_determinism(spec, train, graphs, timer, peak_bw)
    determinism = read_launches()
    log(f"phase determinism: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    graph_launches, graph_res = phase_graph(spec, train, graphs, eval_data)
    log("graph results: " + json.dumps(graph_res))
    log(f"phase graph: {time.perf_counter() - t0:.1f} s")
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
    t0 = time.perf_counter()
    phase_native()
    log(f"phase native: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    scaled, scaled_launches = phase_scaled_e2e()
    log(f"phase scaled_e2e: {time.perf_counter() - t0:.1f} s")
    paths = {"serving": serving, "serving_d512": serving_wide,
             "training": training, **training_paths,
             "graph": graph_launches,
             "odd_widths": odd_widths,
             "experiment": experiment, "determinism": determinism,
             **par_launches, "scaled_e2e": scaled_launches,
             **{f"bench_{k}": v for k, v in bench_launches.items()}}
    step_kernels = ("spmm_csr", "encoder_fwd", "encoder_bwd", "ce_fwd",
                    "ce_bwd", "segsum")
    for path, kernels_of_path in (
            ("serving", ("spmm_csr", "encoder_fwd")),
            ("serving_d512", ("spmm_csr", "encoder_fwd")),
            ("training", step_kernels), ("training_wide", step_kernels),
            ("training_long", step_kernels), ("training_wide_d1024",
                                              step_kernels),
            ("graph", ("spmm_csr_flagged",) + step_kernels),
            ("odd_widths", ("spmm_csr", "ce_fwd", "ce_bwd", "segsum")),
            ("experiment", ("spmm_csr_flagged",) + step_kernels),
            ("determinism", step_kernels),
            ("parallel_1x2", step_kernels), ("parallel_2x2", step_kernels),
            ("bench_headline", step_kernels),
            ("bench_kernels", step_kernels + ("spmm_csr_flagged",)),
            ("bench_ce_variants", ("ce_fwd_variant", "ce_fwd")),
            # K5's one pass wherever K5 runs f32 at d <= 128
            ("training", ("ce_bwd_onepass",)),
            ("training_long", ("ce_bwd_onepass",)),
            ("graph", ("ce_bwd_onepass",)),
            ("odd_widths", ("ce_bwd_onepass",)),
            ("experiment", ("ce_bwd_onepass",)),
            ("determinism", ("ce_bwd_onepass",)),
            ("parallel_1x2", ("ce_bwd_onepass",)),
            ("parallel_2x2", ("ce_bwd_onepass",)),
            ("bench_headline", ("ce_bwd_onepass",)),
            ("bench_scaled", ("ce_fwd", "ce_bwd", "segsum")),
            ("bench_spmm_sweep", ("spmm_csr",)),
            ("bench_batches", step_kernels),
            ("scaled_e2e", step_kernels),
            # K5's cluster kernels on the d 512 and d 1,024 steps, and K2's
            # and K3's wgmma tile there and at serving d 512
            ("training_wide", ("ce_bwd_cluster", "encoder_fwd_wide",
                               "encoder_bwd_wide")),
            ("training_wide_d1024", ("ce_bwd_cluster", "encoder_fwd_wide",
                                     "encoder_bwd_wide")),
            ("serving_d512", ("encoder_fwd_wide",))):
        check(all(paths[path][n] > 0 for n in kernels_of_path),
              f"a kernel never launched on the {path} path: {paths[path]}")
    # up to d 256 the towers run the 64-row tile, never the wgmma one
    for path in ("serving", "training", "graph", "experiment",
                 "determinism"):
        check(paths[path]["encoder_fwd_wide"] == 0
              and paths[path]["encoder_bwd_wide"] == 0,
              f"the {path} path (d <= 256) ran the wgmma tile: {paths[path]}")
    by_variant = bench_launches["ce_variants"]["by_variant"]
    check(all(by_variant.get(v, 0) > 0 for v in ("base", "nomatch", "exp2",
                                                  "bf16exp", "matmulonly")),
          f"a CE variant never launched: {by_variant}")

    def counts(name):
        return {"launches": sum(p.get(name, 0) for p in paths.values()),
                "launches_by_path": {k: p[name] for k, p in paths.items()
                                     if p.get(name, 0)}}

    step_hops = {k: k1[k] + k1t[k] for k in ("ms", "plain_ms", "library_ms",
                                               "bound_ms")}

    def at_1m(name):
        """The kernel on the scaled step's own calls at 1M item rows."""
        return {**scaled["kernels"][name],
                "launches_in_window": scaled["launches_in_windows"][name]}

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
         "scaled_e2e": at_1m("spmm_csr"),
         "plan_sweep": {
             f"heavy_deg {p['heavy_deg']} run_rows {p['run_rows']} "
             f"{p['dtype']}": {k: p[k] for k in ("ms", "bound_ms",
                                                 "pct_of_bound")}
             for p in bench["spmm_sweep"]["points"]},
         "note": "the four hops of a train step: over A and over its "
                 "transpose (the hop's backward, spmm_pallas.py:224-225), "
                 "each over the share table (d 128) and A|B (d 256); "
                 "plan_sweep: the same four calls at phase bench's plan "
                 "points (bench/spmm_experiments.py)"},
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
         "long_wide_towers": {k: {n: v for n, v in r.items()
                                  if not n.startswith("bwd")}
                              for k, r in tower_times.items()},
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
         "long_wide_towers": {k: {n: v for n, v in r.items()
                                  if not n.startswith("fwd_") or "bwd" in n}
                              for k, r in tower_times.items()},
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
         "scaled_e2e": at_1m("ce_fwd"),
         "d512": {k: v for k, v in ce_wide[512].items() if "fwd" in k},
         "wide_widths": {d: {k: v for k, v in ce_wide[d].items() if "fwd" in k}
                         for d in CE_WIDTHS if d > 512},
         "note": "both domains of a step: N 10240, d 128, V 30720 + 36864; "
                 "3xTF32 on the tensor cores; bound_ms the 3xTF32 tensor-core "
                 "bound (3*2*N*V*d TF32 FLOPs at 495 TFLOP/s), bound_ffma_ms "
                 "the FP32 FFMA one (2*N*V*d at 67); kernels_ms the "
                 "profiled split"},
        {"name": "ce_bwd", "route": "cuda",
         "source": "c2dsr_tpu_torch/csrc/ce.cu",
         "replaces": "c2dsr_tpu/ops/fused_ce.py:308",
         **counts("ce_bwd"), **k5_pair, "d256_max_rel_err": wide["ce_bwd"],
         "note": "K5's wrapper; at FK (d 128 f32) its route is "
                 "ce_bwd_onepass, and the numbers here are ce.cu's pair of "
                 "kernels it replaced there (dh and dW/db, 3xTF32 on the "
                 "tensor cores), both domains of a step, timed in turns with "
                 "the one pass through their C entry; ce.cu runs K5 in bf16 "
                 "up to d 256 and f32 from d 136 to 256; also replaces "
                 "fused_ce.py:339 and :360; launches every K5 call "
                 "(ce_bwd_onepass's and ce_bwd_cluster's too); bound_ms the "
                 "3xTF32 bound of the products' 4*N*V*d; kernels_ms the "
                 "profiled split; d256_max_rel_err at d 40 (one pass) and 256 "
                 "(pair); past d 256 ce_bwd_cluster"},
        {"name": "ce_bwd_onepass", "route": "cuda",
         "source": "c2dsr_tpu_torch/csrc/ce_onepass.cu",
         "replaces": "c2dsr_tpu/ops/fused_ce.py:308",
         **counts("ce_bwd_onepass"), **k5,
         "shard_widths": [{"mesh": t["mesh"], "N": t["N"], "V": t["V"],
                           **t["bwd"]} for t in par_times],
         "shard_max_rel_err": max(e["ce_bwd"] for e in par_errs.values()),
         "scaled_e2e": at_1m("ce_bwd"),
         "note": "K5 in f32 up to d 128 (its route), one pass: each logit "
                 "tile once for dh, dW and db (3xTF32 mma.sync), both "
                 "domains of a step; ms in turns with ce.cu's pair (ce_bwd), "
                 "against_pair their difference; bound_ms the 3xTF32 bound "
                 "of its 6*N*V*d, bound_products_ms of the products' "
                 "4*N*V*d, bound_ffma_ms 6*N*V*d at 67; kernels_ms the "
                 "profiled split; shard_widths and scaled_e2e (1M items) "
                 "K5's calls there"},
        {"name": "ce_bwd_cluster", "route": "cuda",
         "source": "c2dsr_tpu_torch/csrc/ce_cluster.cu",
         "replaces": "c2dsr_tpu/ops/fused_ce.py:339",
         **counts("ce_bwd_cluster"),
         "max_abs_err": ce_wide[1024]["bwd_max_abs_err_f64"],
         **{k: ce_wide[1024]["bwd_" + k] for k in ("ms", "plain_ms",
                                                    "library_ms",
                                                    "bound_ms")},
         "bound_by": "operations",
         "widths": {d: {k: v for k, v in ce_wide[d].items()
                        if k.startswith("bwd") or k in ("plan", "design")}
                    for d in CE_WIDTHS},
         "note": "K5 past d 256, a thread-block cluster over d (dh and "
                 "dW/db kernels: also replaces fused_ce.py:360), 3xTF32: "
                 "d 1,024 (widths: every width), N 10,240, V 30,720, one "
                 "domain; max_abs_err against float64; ms in turns with "
                 "K5's kernels of before (bwd_earlier_ms: ce.cu's wide "
                 "kernels); bound_ms the 3xTF32 tensor-core "
                 "bound of 4*N*V*d; library cuBLAS f32 (mm, logsumexp) "
                 "under autograd"},
        {"name": "ce_bwd_cluster_bf16", "route": "cuda",
         "source": "c2dsr_tpu_torch/csrc/ce_cluster.cu",
         "replaces": "c2dsr_tpu/ops/fused_ce.py:339",
         "launches": bf16_launches["ce_bwd_cluster"],
         "max_abs_err": ce_wide["bf16_1024"]["max_abs_err"],
         **{k: ce_wide["bf16_1024"]["bwd_" + k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "bound_tf32_one_pass_ms", "bound_bytes_ms")},
         "widths": {d: ce_wide[f"bf16_{d}"] for d in CE_BF16_WIDTHS},
         "note": "the cluster kernels' bf16 instantiation (mma.sync "
                 "m16n8k16 bf16, f32 sums) on a bf16 W: d 1,024, N 10,240, "
                 "V 30,720; max_abs_err against the plain bf16 CE; ms in "
                 "turns with K5 bf16's kernels of before; launches the bf16 "
                 "main path's (its d 512 step); bound_ms at 989 TFLOP/s; "
                 "library the composed cuBLAS bf16 backward "
                 "(kernel_bench.ce_bwd_bf16_library)"},
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
         "scaled_e2e": at_1m("segsum"),
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
    for kname, src, replaces, r, note in (
            ("spmm_csr_bf16", "spmm.cu", "c2dsr_tpu/ops/spmm_pallas.py:175",
             bf16["spmm"]["dense"], "K1's bf16 gather (compute_dtype "
             "bfloat16, spmm_pallas.py:166-172): the four hops of a step, "
             "over A and its transpose, share (d 128) and A|B (d 256)"),
            ("spmm_csr_flagged_bf16", "spmm.cu",
             "c2dsr_tpu/ops/spmm_pallas.py:231-264 via :175",
             bf16["spmm"]["flagged"], "K6's bf16 gather, one FK batch's "
             "flags, dest over A and src over its transpose"),
            ("encoder_fwd_bf16", "encoder.cu",
             "c2dsr_tpu/ops/encoder_pallas.py:444", bf16["towers"]["train"],
             "K2's bf16 instantiation (matmul_dtype bf16): the three towers "
             "of a step at dropout 0.2, saving K3's activations; eval: one "
             "tower at B 2048; errors relative Frobenius on rows with a "
             "key"),
            ("encoder_bwd_bf16", "encoder_bwd.cu",
             "c2dsr_tpu/ops/encoder_pallas.py:477", bf16["towers"]["bwd"],
             "K3's bf16 instantiation, the step's three towers at dropout "
             "0.2; worst relative Frobenius over dx and the gradients"),
            ("ce_fwd_bf16", "ce.cu", "c2dsr_tpu/ops/fused_ce.py:263",
             bf16["ce"]["fwd"], "K4's bf16 instantiation on a bf16 W (the "
             "bf16 classifier), both domains of a step; library: mm of "
             "bf16 operands into f32 and logsumexp, where torch has it"),
            ("ce_bwd_bf16", "ce.cu", "c2dsr_tpu/ops/fused_ce.py:308",
             bf16["ce"]["bwd"], "K5's bf16 instantiation (dh and dW/db "
             "kernels), both domains; also replaces fused_ce.py:339 and "
             ":360")):
        wrapper = kname[:-len("_bf16")]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"c2dsr_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": bf16_launches[wrapper],
            "max_abs_err": r["max_abs_err"],
            **{k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by", "max_rel_err",
                                 "f32_instantiation_err",
                                 "bound_tf32_one_pass_ms",
                                 "bound_bytes_ms")},
            **({"eval": bf16["towers"]["eval"]}
               if kname == "encoder_fwd_bf16" else {}),
            **({"long_wide": {k: v for k, v in bf16["shapes"].items()
                              if k.startswith("tower")}}
               if kname.startswith("encoder") else {}),
            **({f"d{d}": bf16["shapes"][f"ce_d{d}"] for d in BF16_CE_DS}
               if kname.startswith("ce_") else {}),
            **({"sass": {k: v for k, v in sass.items()
                         if k.startswith(SASS_PREFIXES[kname])
                         and ("bf16=1" in k or "TERMS=1" in k)}}
               if kname in SASS_PREFIXES else {}),
            "note": note + "; bound_ms at 989 TFLOP/s bf16 or the bytes at "
                    "3.35 TB/s, bound_tf32_one_pass_ms at 495 TFLOP/s ("
                    + ("the TF32 rate of the design before, on the bf16 "
                       "tensor cores now: sass counts each bf16 "
                       "instantiation's MMAs" if kname in SASS_PREFIXES
                       else "this design's one TF32 pass of bf16 operands")
                    + ("; the towers' attention runs FFMA up to L 64 "
                       "(kSeqL) and bf16 MMAs past it"
                       if kname.startswith("encoder") else "")
                    + "); f32_instantiation_err the f32 kernel's error "
                    "against the same plain bf16 version, which fails the "
                    "gate"})
    # the wgmma tile: K2's four products and K3's dX products past d 256,
    # summed over one layer's products at d 1,024 (phase_wide_gemm), with
    # the tower calls that ran it (_tower_times) beside
    for kind, src, replaces in (
            ("fwd", "encoder.cu", "c2dsr_tpu/ops/encoder_pallas.py:444"),
            ("bwd", "encoder_bwd.cu", "c2dsr_tpu/ops/encoder_pallas.py:477")):
        for dt in ("f32", "bf16"):
            prods = {p: r for p, r in wide_gemm[1024][dt].items()
                     if p.startswith(kind)}
            worst = max(prods.values(), key=lambda r: r["bound_ms"])
            sfx = "_bf16" if dt == "bf16" else ""
            launches = (bf16_launches[f"encoder_{kind}_wide"]
                        if dt == "bf16"
                        else counts(f"encoder_{kind}_wide")["launches"])
            kernels.append({
                "name": f"encoder_{kind}_wgmma{sfx}", "route": "cuda",
                "source": "c2dsr_tpu_torch/csrc/wgmma.cuh",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err_f64"]
                                   for r in prods.values()),
                **{k: sum(r[k] for r in prods.values())
                   for k in ("ms", "gemm_ms", "tile64_ms", "plain_ms",
                             "library_ms", "bound_ms")},
                "split6_extra_ms": sum(r.get("split6_extra_ms", 0.0)
                                       for r in prods.values()),
                "unphysical": any(r["unphysical"] for r in prods.values()),
                "bound_by": worst["bound_by"],
                "products_d1024": prods,
                "products_d512": {p: r for p, r in
                                  wide_gemm[512][dt].items()
                                  if p.startswith(kind)},
                "towers": {k: {n: v for n, v in r.items()
                               if (kind in n or "gemm" in n)
                               and (("bf16" in n) == (dt == "bf16"))}
                           for k, r in tower_times.items()},
                "note": f"K{2 if kind == 'fwd' else 3}'s products with a "
                        "weight past d 256 on the wgmma tile (wgmma from a "
                        "TMA ring, csrc/" + src + "): one layer's products at "
                        "d 1,024 over 7,680 rows (B 512, L 15), summed "
                        "(products_d1024 each, products_d512 at d 512); ms "
                        "profiled device ms at dropout 0.2 under a row map, "
                        "each call with its weight's pre-pass (gemm_ms the "
                        "tile alone); tile64_ms the 64-row mma.sync tile "
                        "on the same inputs; plain the product and "
                        "epilogue in torch ops; library one torch.mm, "
                        "profiled alike; "
                        "bound_ms 3 TF32 passes (f32-accurate work, as "
                        "timing.tc_bound_ms prices it) or one bf16 pass at "
                        "the tensor cores' peak, or the bytes; "
                        "split6_extra_ms the TF32 issue time of the QKV "
                        "product's 6-term split past those 3 passes, a cost "
                        "of its numerics outside the bound; unphysical: "
                        "some product's profiled tile time under its bound; "
                        "every output bitwise the 64-row tile's; max_abs_err "
                        "against float64 at dropout 0; launches the tower "
                        "calls past d 256 of the main paths (the d 512 and "
                        "d 1,024 steps, serving at d 512); towers: the "
                        "tower calls' times at TIMED_TOWERS"})
    log("bf16 step against the CPU's and rates: " + json.dumps(
        {"step": bf16["step"], "rates": bf16["rates"]}))
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
    log("scaled_e2e: " + json.dumps({k: v for k, v in scaled.items()
                                     if k != "kernels"}))
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
