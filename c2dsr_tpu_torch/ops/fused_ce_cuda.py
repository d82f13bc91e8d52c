"""Wrappers of the fused CE kernels (``csrc/ce.cu``): K4 :func:`ce_fwd` and
K5 :func:`ce_bwd` (a dh kernel and a dW/db kernel).

Replace the fused linear + softmax CE Pallas kernels of the JAX package
(``c2dsr_tpu/ops/fused_ce.py``: ``_fwd_kernel`` for the forward;
``_bwd_merged_kernel``, ``_bwd_dh_kernel`` and ``_bwd_dw_kernel`` for the
backward, whose split the TPU needed only when dh outgrew VMEM).

What bounds them on an H100: operations, which both run on the tensor
cores with products at f32 accuracy (3xTF32: each operand split into a
TF32 part and its remainder, three products a step).  The tensor cores'
accumulator truncates its adds, so no long sum stays in it: each k-step of
a logit is added in f32, and the backward's products sum at most 2,560
vocab columns (dh) or 1,280 rows (dW) a split there, the splits added in
f32 (tests/test_torch_tf32.py emulates the error of each scheme).  The
forward does 2·N·V·d FLOPs: h stays resident, tiles of Wᵀ (split once by
a pre-pass) stream through a ``cp.async`` ring, and each warp keeps a
running (max, sum-exp) per row over one of a few vocab splits; a small
kernel merges the splits in order.  The backward does 4·N·V·d (dh and dW) plus the logits, recomputed by each of
its two kernels, with the same operand plan over (resident, streamed)
operands, h and Wᵀ for dh, Wᵀ and h for dW; the vocab or row splits of its
grid are summed in order by a small kernel.  No logit reaches device
memory, and each output element is written once, with no atomics, for any
N: the results are bitwise repeatable.  Shapes: d % 8 == 0, V % 4 == 0,
W under 2 GiB (d·V·4 < 2^31, or d·V·2 in the bf16 instantiations: the JAX
package's limit).  Above d 256 K4 runs its wide kernel (``csrc/ce.cu``),
which streams h and Wᵀ in chunks of 32 columns, and K5's blocks keep 64
rows of h resident and split the output columns over two blocks
(``csrc/ce_fwd.cuh``); above d 512 K5 runs its wide kernels too, which
split the output columns over ceil(d / 256) blocks, each of which
recomputes the logits.

``bf16=True`` (``compute_dtype="bfloat16"``, and always for a bf16 W)
selects the bf16 instantiations, the JAX kernels' numerics: every product
of bf16-rounded operands (h, W and the dlogits) summed in f32, by one TF32
MMA a k-step where 3xTF32 takes three.  A pre-pass writes h and Wᵀ in bf16
(W read once, at two bytes an element where it is bf16), and the kernels
stage the bf16 rows.  Their launches count apart (``launches_bf16``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from c2dsr_tpu_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _fn(name: str, n_ptr: int, n_int: int = 4):
    f = getattr(build.library("ce"), name)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


@functools.lru_cache(maxsize=64)
def _plan(name: str, N: int, d: int, V: int) -> Tuple[int, int]:
    """The split counts ``ce_fwd_plan`` or ``ce_bwd_plan`` (ce.cu) choose."""
    f = getattr(build.library("ce"), name)
    f.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    err = f(N, d, V, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
    return out[0], out[1]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes (the
    kernels' 16-byte asynchronous copies need that)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


D_MULTIPLE = 8       # the widths the kernels take (ops/fused_ce pads to it)
FWD_RESIDENT = 256   # the widest K4's and K5's resident-X kernels take
BWD_RESIDENT = 512   # (ce.cu kFwdResident, kBwdResident); wider rows run
                     # the wide kernels


def check_shape(name: str, N: int, d: int, V: int, w_bytes: int = 4
                ) -> None:
    """Raise unless the kernels take N rows, width d and V columns: d % 8
    == 0, V % 4 == 0, and W [d, V] of ``w_bytes`` an element under 2 GiB
    (d·V·w_bytes < 2^31), the JAX package's limit
    (``c2dsr_tpu/ops/fused_ce.py`` ``_pick_blocks``)."""
    if d % D_MULTIPLE or d == 0 or V % 4 or V == 0 or N == 0:
        raise ValueError(f"{name} needs d % 8 == 0 and V % 4 == 0; got N={N} "
                         f"d={d} V={V}")
    if d * V * w_bytes >= 2 ** 31:
        raise ValueError(f"{name}: classifier operand d*V = {d}x{V} at "
                         f"{w_bytes} B/elt reaches 2 GiB, the 32-bit "
                         "per-operand addressing limit; use a bfloat16 "
                         "classifier or shard the vocab "
                         "(parallel/sharded_loss.py)")


def _check(name: str, h, w, rows, targets, bf16: bool = False
           ) -> Tuple[int, int, int]:
    if not h.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors only")
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(f"{name} takes h [N, d] and w [d, V], got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
    N, d = h.shape
    V = w.shape[1]
    # the bf16 instantiations multiply a bf16 Wᵀ (rounded by the pre-pass)
    check_shape(name, N, d, V, 2 if bf16 else w.element_size())
    if not (w.dtype == torch.float32
            or (bf16 and w.dtype == torch.bfloat16)):
        raise ValueError(f"{name}: w must be f32 (or bf16 with bf16=True), "
                         f"got {w.dtype}")
    if w.device != h.device or not w.is_contiguous():
        raise ValueError(f"{name}: w must be contiguous on h's device")
    for t, shape in rows:
        if (t.dtype != torch.float32 or t.device != h.device
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"{name}: every float input must be contiguous "
                             f"f32 of shape {shape} on h's device")
    if tuple(targets.shape) != (N,) or targets.device != h.device:
        raise ValueError(f"{name}: targets must be [N] on h's device")
    return N, d, V


def ce_fwd(h: torch.Tensor, w: torch.Tensor, b_masked: torch.Tensor,
           pad: torch.Tensor, targets: torch.Tensor, bf16: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, target logit) per row of softmax over [h·w + b_masked | pad],
    by K4.  h [N, d], b_masked [V], pad [N] f32; w [d, V] f32, or bf16 (the
    bf16 instantiation then, whatever ``bf16`` says); targets [N] int (a
    target >= V gives a target logit of 0).  Above FWD_RESIDENT the wide
    kernel runs."""
    bf16 = bf16 or w.dtype == torch.bfloat16
    N, d, V = _check("ce_fwd", h, w, [(h, tuple(h.shape)),
                                      (b_masked, (w.shape[1],)),
                                      (pad, (h.shape[0],))], targets, bf16)
    h = _aligned(h)
    tgt = targets.to(torch.int32).contiguous()
    lse = torch.empty(N, dtype=torch.float32, device=h.device)
    tlog = torch.empty_like(lse)
    if bf16:
        splits, _ = _plan("ce_fwd_plan_bf16", N, d, V)
        # h and Wᵀ in bf16, then the splits' partials
        ws = torch.empty((N + V) * d // 2 + 3 * splits * N,
                         dtype=torch.float32, device=h.device)
        err = _fn("ce_fwd_bf16", 8, 5)(
            h.data_ptr(), w.data_ptr(), b_masked.data_ptr(), pad.data_ptr(),
            tgt.data_ptr(), lse.data_ptr(), tlog.data_ptr(), ws.data_ptr(),
            int(w.dtype == torch.bfloat16), splits, N, d, V,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"ce_fwd (bf16) launch failed: CUDA error "
                               f"{err}")
        ce_fwd.launches_bf16 += 1
        return lse, tlog
    splits, _ = _plan("ce_fwd_plan", N, d, V)
    # Wᵀ's TF32 split, then the splits' (max, sum, target) partials
    ws = torch.empty(2 * V * d + 3 * splits * N, dtype=torch.float32,
                     device=h.device)
    err = _fn("ce_fwd_f32", 8, 4)(
        h.data_ptr(), w.data_ptr(), b_masked.data_ptr(), pad.data_ptr(),
        tgt.data_ptr(), lse.data_ptr(), tlog.data_ptr(), ws.data_ptr(),
        splits, N, d, V, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ce_fwd launch failed: CUDA error {err}")
    ce_fwd.launches += 1
    return lse, tlog


ce_fwd.launches = 0
ce_fwd.launches_bf16 = 0


def ce_bwd(h: torch.Tensor, w: torch.Tensor, b_masked: torch.Tensor,
           lse: torch.Tensor, dlse: torch.Tensor, dt: torch.Tensor,
           targets: torch.Tensor, bf16: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dh, dw, db) of :func:`ce_fwd` given the gradients dlse, dt of its
    two outputs, by K5 (its dh kernel, then its dW/db kernel); with
    ``bf16`` (or a bf16 w) by its bf16 instantiation, dw in w's dtype.
    Above BWD_RESIDENT the wide kernels run."""
    bf16 = bf16 or w.dtype == torch.bfloat16
    n = (h.shape[0],)
    N, d, V = _check("ce_bwd", h, w, [(h, tuple(h.shape)),
                                      (b_masked, (w.shape[1],)), (lse, n),
                                      (dlse, n), (dt, n)], targets, bf16)
    h = _aligned(h)
    tgt = targets.to(torch.int32).contiguous()
    dh = torch.empty_like(h)
    dw = torch.empty(w.shape, dtype=torch.float32, device=h.device)
    db = torch.empty_like(b_masked)
    if bf16:
        split_h, split_w = _plan("ce_bwd_plan_bf16", N, d, V)
        # h and Wᵀ in bf16, then each pass's partials
        floats = ((N + V) * d // 2
                  + (split_h * N * d if split_h > 1 else 0)
                  + (split_w * (d + 1) * V if split_w > 1 else 0))
        ws = torch.empty(floats, dtype=torch.float32, device=h.device)
        err = _fn("ce_bwd_bf16", 11, 6)(
            h.data_ptr(), w.data_ptr(), b_masked.data_ptr(), lse.data_ptr(),
            dlse.data_ptr(), dt.data_ptr(), tgt.data_ptr(), dh.data_ptr(),
            dw.data_ptr(), db.data_ptr(), ws.data_ptr(),
            int(w.dtype == torch.bfloat16), split_h, split_w, N, d, V,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"ce_bwd (bf16) launch failed: CUDA error "
                               f"{err}")
        ce_bwd.launches_bf16 += 1
        return dh, dw.to(w.dtype), db
    split_h, split_w = _plan("ce_bwd_plan", N, d, V)
    err = _bwd_f32("ce_bwd_f32", (split_h, split_w), h, w, b_masked, lse,
                   dlse, dt, tgt, dh, dw, db)
    if err != 0:
        raise RuntimeError(f"ce_bwd launch failed: CUDA error {err}")
    ce_bwd.launches += 1
    return dh, dw, db


ce_bwd.launches = 0
ce_bwd.launches_bf16 = 0


def _bwd_f32(entry: str, splits, h, w, b_masked, lse, dlse, dt, tgt, dh, dw,
             db) -> int:
    """Runs the f32 backward's C ``entry`` (``ce_bwd_f32``, or
    ``ce_bwd_wide_f32``, the wide kernels at any width, which
    ``chip_smoke.py`` times beside the resident ones at d 512) with
    ``splits`` from its plan; returns its CUDA error code."""
    (split_h, split_w), (N, d), V = splits, h.shape, w.shape[1]
    # Wᵀ and its TF32 split, h's split, then each pass's partials
    floats = (3 * V * d + 2 * N * d + (split_h * N * d if split_h > 1 else 0)
              + (split_w * (d + 1) * V if split_w > 1 else 0))
    ws = torch.empty(floats, dtype=torch.float32, device=h.device)
    return _fn(entry, 11, 5)(
        h.data_ptr(), w.data_ptr(), b_masked.data_ptr(), lse.data_ptr(),
        dlse.data_ptr(), dt.data_ptr(), tgt.data_ptr(), dh.data_ptr(),
        dw.data_ptr(), db.data_ptr(), ws.data_ptr(), split_h, split_w, N, d,
        V, torch.cuda.current_stream().cuda_stream)
