"""``--ce-variants``: K4's experiment variants on the card, the port of the
last TPU kernel, ``bench/ce_experiments.py:105`` ``variant_fn`` (kernel
built by ``_mk_kernel``).

Each variant is the CE forward (a row's lse over ``[h·W + b | pad]`` and
its target logit) with one per-logit operation taken away, timed alone, so
that the differences say what each operation costs:

- ``base``: the production K4 (``csrc/ce_fwd.cuh`` ``ce_fwd_kernel``,
  variant 0), built again in the variants' library: bitwise K4.
- ``nomatch``: no target compare/select; the target logit is 0.
- ``exp2``: K4 works in log2 units, so here the caller pre-scales h, b and
  pad by log2 e and the kernel drops its per-logit scale; the lse comes out
  in log2 units.
- ``bf16exp``: the exponentials of pairs of (logit - max) packed as bf16x2
  through ``ex2.approx.ftz.bf16x2``, the H100's counterpart of the TPU's
  packed bf16 exp.
- ``matmulonly``: the 3xTF32 logit tile and a plain row sum of the logits:
  K4's tensor-core floor.

The kernels are K4's template at DT 128 (``csrc/ce_variants.cu``), run at
``fused_ce_cuda.plan_fwd``'s split count.  :func:`variant_plain` is each
variant's plain PyTorch version.  The TPU-only (bn, bv) sweep of the JAX script does
not carry over.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from c2dsr_tpu_torch.bench import timing
from c2dsr_tpu_torch.bench.timing import GateFailure
from c2dsr_tpu_torch.kernels import build
from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda

VARIANTS = ("base", "nomatch", "exp2", "bf16exp", "matmulonly")
LOG2E = 1.4426950408889634
LN2 = math.log(2.0)
# (N, d, V): the JAX script's own shape (ce_experiments.py:146), then K4's
# two FK vocabularies at a train step's rows
SHAPES = ((10240, 128, 64512), (10240, 128, 30720), (10240, 128, 36864))
# gates against the base variant (max abs error over max |base|), before
# any timing: nomatch and exp2 change no arithmetic of the lse but the
# inputs' log2 e scale; bf16exp rounds each exponent to bf16
GATES = {"nomatch": 1e-6, "exp2": 1e-5, "bf16exp": 1e-2}
# each variant against its plain version (max abs error over max |plain|):
# 3xTF32 products and sums in another order; bf16exp's exponentials are
# rounded at the kernel's running max, the plain version's at the row max
PLAIN_TOL = {"base": 1e-5, "nomatch": 1e-5, "exp2": 1e-5, "bf16exp": 1e-2,
             "matmulonly": 1e-4}


@functools.lru_cache(maxsize=None)
def _fn():
    f = build.library("ce_variants").ce_variant_fwd_f32
    f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def ce_fwd_variant(variant: str, h: torch.Tensor, w: torch.Tensor,
                   b_masked: torch.Tensor, pad: torch.Tensor,
                   targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, target logit) of K4's variant ``variant`` on the card; the
    arguments as ``fused_ce_cuda.ce_fwd``'s, with 64 < d <= 128 (the
    variants are built at DT 128 only).  exp2 takes h, b and pad already
    in log2 units and returns its lse and target logit in them."""
    N, d, V = fused_ce_cuda._check(
        f"ce_fwd_variant {variant}", h, w,
        [(h, tuple(h.shape)), (w, tuple(w.shape)), (b_masked, (w.shape[1],)),
         (pad, (h.shape[0],))], targets)
    if not 64 < d <= 128:
        raise ValueError(f"the CE variants are built at 64 < d <= 128, got "
                         f"d={d}")
    h = fused_ce_cuda._aligned(h)
    tgt = targets.to(torch.int32).contiguous()
    lse = torch.empty(N, dtype=torch.float32, device=h.device)
    tlog = torch.empty_like(lse)
    splits = fused_ce_cuda.plan_fwd(N, d, V, False)
    ws = torch.empty(2 * V * d + 3 * splits * N, dtype=torch.float32,
                     device=h.device)
    err = _fn()(VARIANTS.index(variant), h.data_ptr(), w.data_ptr(),
                b_masked.data_ptr(), pad.data_ptr(), tgt.data_ptr(),
                lse.data_ptr(), tlog.data_ptr(), ws.data_ptr(), splits, N, d,
                V, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ce_fwd_variant {variant} launch failed: CUDA "
                           f"error {err}")
    ce_fwd_variant.launches += 1
    ce_fwd_variant.by_variant[variant] = (
        ce_fwd_variant.by_variant.get(variant, 0) + 1)
    return lse, tlog


ce_fwd_variant.launches = 0
ce_fwd_variant.by_variant = {}          # launches of each variant


def variant_plain(variant: str, h: torch.Tensor, w: torch.Tensor,
                  b_masked: torch.Tensor, pad: torch.Tensor,
                  targets: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of each variant: (lse, target logit), in
    log2 units for exp2 (whose inputs are in them); a target >= V gives a
    target logit of 0."""
    if variant == "base":
        return fused_ce.ce_fwd_plain(h, w, b_masked, pad, targets)
    logits = h @ w + b_masked
    zero = torch.zeros(h.shape[0], dtype=logits.dtype, device=h.device)
    if variant == "matmulonly":
        return logits.sum(1), zero
    if variant == "nomatch":
        return fused_ce.ce_fwd_plain(h, w, b_masked, pad, targets)[0], zero
    V = logits.shape[1]
    tgt = targets.long()
    picked = logits.gather(1, tgt.clamp(max=V - 1)[:, None])[:, 0]
    tlog = torch.where(tgt < V, picked, zero)
    full = torch.cat([logits, pad[:, None]], 1)
    if variant == "exp2":
        m = full.amax(1)
        return m + torch.log2(torch.exp2(full - m[:, None]).sum(1)), tlog
    if variant == "bf16exp":
        full = full * LOG2E
        m = full.amax(1)
        e = torch.exp2((full - m[:, None]).to(torch.bfloat16)).to(h.dtype)
        return (m + torch.log2(e.sum(1))) * LN2, tlog
    raise ValueError(f"unknown variant {variant!r}")


def library_call(variant: str, h, w, b, tgt):
    """A function of PyTorch library calls that computes what ``variant``
    returns at :func:`_inputs`' pad of -1e9 (so that the lse is over h·W + b
    alone), or None for bf16exp, whose bf16 exponentials no library call
    takes: base the lse and the target logit, nomatch the lse alone, exp2
    both in log2 units (its inputs are in them), matmulonly the row sum."""
    if variant == "base":
        def call():
            logits = torch.addmm(b, h, w)
            return torch.logsumexp(logits, 1), logits.gather(1, tgt[:, None])
    elif variant == "nomatch":
        def call():
            return torch.logsumexp(torch.addmm(b, h, w), 1)
    elif variant == "exp2":
        def call():
            logits = torch.addmm(b, h, w)
            return (torch.logsumexp(logits * LN2, 1) / LN2,
                    logits.gather(1, tgt[:, None]))
    elif variant == "matmulonly":
        def call():
            return torch.addmm(b, h, w).sum(1)
    else:
        return None
    return call


def _inputs(N, d, V, seed, device):
    """The JAX script's inputs (ce_experiments.py:147-152): h ~ N(0, 1),
    W ~ 0.02 N(0, 1), a zero bias, uniform targets; pad at -1e9, so that
    the lse is over h·W + b alone, as the JAX variants compute it."""
    rng = np.random.default_rng(seed)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    h = put(rng.normal(size=(N, d)))
    w = put(rng.normal(size=(d, V)) * 0.02)
    b = torch.zeros(V, dtype=torch.float32, device=device)
    pad = torch.full((N,), fused_ce.NEG, dtype=torch.float32, device=device)
    tgt = torch.from_numpy(rng.integers(0, V, size=N)).to(device)
    return h, w, b, pad, tgt


def _scaled(variant, h, b, pad):
    """A variant's h, b and pad: exp2's in log2 units."""
    if variant == "exp2":
        return h * LOG2E, b * LOG2E, pad * LOG2E
    return h, b, pad


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def check_variants(h, w, b, pad, tgt) -> Dict[str, Dict[str, float]]:
    """Every variant's gate, on the card, before any timing: base bitwise
    equal to the production K4; nomatch, exp2 (its lse times ln 2) and
    bf16exp within GATES of base; every variant within PLAIN_TOL of its
    plain version (matmulonly's row sum relative to the plain row sum).
    Raises GateFailure on a failure; returns {variant: errors}."""
    with torch.no_grad():
        k4 = fused_ce_cuda.ce_fwd(h, w, b, pad, tgt)
        out, errs = {}, {}
        for v in VARIANTS:
            hv, bv, pv = _scaled(v, h, b, pad)
            got = ce_fwd_variant(v, hv, w, bv, pv, tgt)
            want = variant_plain(v, hv, w, bv, pv, tgt)
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(t).all()) for t in got):
                raise GateFailure(f"ce variant {v}: non-finite")
            e_plain = max(_rel(got[0], want[0]), _rel(got[1], want[1])
                          if v not in ("nomatch", "matmulonly") else 0.0)
            out[v] = got
            errs[v] = {"plain_rel_err": e_plain,
                       "max_abs_err": float((got[0] - want[0]).abs().max())}
            if e_plain > PLAIN_TOL[v]:
                raise GateFailure(f"ce variant {v}: {e_plain} from its plain "
                                  f"version, tolerance {PLAIN_TOL[v]}")
    base = out["base"]
    if not (torch.equal(base[0], k4[0]) and torch.equal(base[1], k4[1])):
        raise GateFailure("ce variant base differs from the production K4")
    for v, tol in GATES.items():
        lse, tlog = out[v]
        scale = LN2 if v == "exp2" else 1.0
        e = _rel(lse * scale, base[0])
        if v != "nomatch":
            e = max(e, _rel(tlog * scale, base[1]))
        elif bool((tlog != 0).any()):
            raise GateFailure("ce variant nomatch: a target logit is not 0")
        errs[v]["base_rel_err"] = e
        if e > tol:
            raise GateFailure(f"ce variant {v}: {e} from base, tolerance "
                              f"{tol}")
    return errs


def run(device: str = "cuda", shapes=SHAPES) -> Dict:
    """Every variant at every shape: gated (check_variants), then timed.
    Per variant and shape: ms (the call: the production pre-pass, the
    variant's kernel and a merge; the variants share all but the kernel,
    so their differences are the kernels'), the plain version's ms, the
    library's ms where its calls compute the same function
    (:func:`library_call`), the 3xTF32 and FFMA
    bounds, and a flag where a time is below one read of W at the card's
    memory rate."""
    timing.require_cuda(device, "--ce-variants")
    timer = timing.Timer()
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = timing.peaks(name)
    out = {"shapes": [], "card": timing.card_line()}
    for si, (N, d, V) in enumerate(shapes):
        h, w, b, pad, tgt = _inputs(N, d, V, si, device)
        errs = check_variants(h, w, b, pad, tgt)
        flops = 2.0 * N * V * d
        bound_tc = timing.tc_bound_ms(flops, 4.0 * (N * d + d * V + V + 4 * N),
                                      name, peak_bw)
        bound_ffma = flops / peak_flops * 1e3
        floor_ms = 4.0 * d * V / peak_bw * 1e3
        rows = {}
        with torch.no_grad():
            for v in VARIANTS:
                hv, bv, pv = _scaled(v, h, b, pad)
                ms = timer(lambda: ce_fwd_variant(v, hv, w, bv, pv, tgt))
                plain_ms = timer(lambda: variant_plain(v, hv, w, bv, pv, tgt))
                lib = library_call(v, hv, w, bv, tgt)
                rows[v] = {"ms": ms, "plain_ms": plain_ms,
                           "library_ms": timer(lib) if lib else None,
                           "bound_ms": bound_tc, "bound_ffma_ms": bound_ffma,
                           "tflops": flops / ms / 1e9,
                           "unphysical": ms < floor_ms, **errs[v]}
        out["shapes"].append({"N": N, "d": d, "V": V, "variants": rows,
                              "w_read_ms": floor_ms})
    return out
