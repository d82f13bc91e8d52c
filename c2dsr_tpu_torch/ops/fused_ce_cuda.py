"""Wrappers of the fused CE kernels (``csrc/ce.cu``): K4 :func:`ce_fwd` and
K5 :func:`ce_bwd` (a dh kernel and a dW/db kernel).

Replace the fused linear + softmax CE Pallas kernels of the JAX package
(``c2dsr_tpu/ops/fused_ce.py``: ``_fwd_kernel`` for the forward;
``_bwd_merged_kernel``, ``_bwd_dh_kernel`` and ``_bwd_dw_kernel`` for the
backward, whose split the TPU needed only when dh outgrew VMEM).

What bounds them on an H100: operations, which both run on the tensor
cores at f32 accuracy (3xTF32: each operand split into a TF32 part and its
remainder, three products a step).  The forward does 2·N·V·d FLOPs: h stays
resident, tiles of Wᵀ (split once by a pre-pass) stream through a
``cp.async`` ring, and each warp keeps a running (max, sum-exp) per row over
one of a few vocab splits; a small kernel merges the splits in order.  The
backward does 4·N·V·d (dh and dW) plus the logits, recomputed by each of
its two kernels, with the same operand plan over (resident, streamed)
operands, h and Wᵀ for dh, Wᵀ and h for dW; the vocab or row splits of its
grid are summed in order by a small kernel.  No logit reaches device
memory, and each output element is written once, with no atomics, for any
N: the results are bitwise repeatable.  Shapes: d % 8 == 0, d <= 256,
V % 4 == 0; d > 256 is refused (ROADMAP §C).
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


def _check(name: str, h, w, rows, targets) -> Tuple[int, int, int]:
    if not h.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors only")
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(f"{name} takes h [N, d] and w [d, V], got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
    N, d = h.shape
    V = w.shape[1]
    if d % 8 or d > 256 or V % 4 or V == 0 or N == 0:
        raise ValueError(f"{name} needs d % 8 == 0, d <= 256 (ROADMAP §C: no "
                         f"wider CE kernel), V % 4 == 0; got N={N} d={d} "
                         f"V={V}")
    for t, shape in rows:
        if (t.dtype != torch.float32 or t.device != h.device
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"{name}: every float input must be contiguous "
                             f"f32 of shape {shape} on h's device")
    if tuple(targets.shape) != (N,) or targets.device != h.device:
        raise ValueError(f"{name}: targets must be [N] on h's device")
    return N, d, V


def ce_fwd(h: torch.Tensor, w: torch.Tensor, b_masked: torch.Tensor,
           pad: torch.Tensor, targets: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, target logit) per row of softmax over [h·w + b_masked | pad],
    by K4.  h [N, d], w [d, V], b_masked [V], pad [N] f32; targets [N] int
    (a target >= V gives a target logit of 0)."""
    N, d, V = _check("ce_fwd", h, w, [(h, tuple(h.shape)), (w, tuple(w.shape)),
                                      (b_masked, (w.shape[1],)),
                                      (pad, (h.shape[0],))], targets)
    h = _aligned(h)
    tgt = targets.to(torch.int32).contiguous()
    lse = torch.empty(N, dtype=torch.float32, device=h.device)
    tlog = torch.empty_like(lse)
    splits, _ = _plan("ce_fwd_plan", N, d, V)
    # Wᵀ's TF32 split, then the splits' (max, sum, target) partials
    ws = torch.empty(2 * V * d + 3 * splits * N, dtype=torch.float32,
                     device=h.device)
    err = _fn("ce_fwd_f32", 8)(h.data_ptr(), w.data_ptr(), b_masked.data_ptr(),
                               pad.data_ptr(), tgt.data_ptr(), lse.data_ptr(),
                               tlog.data_ptr(), ws.data_ptr(), splits, N, d, V,
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ce_fwd launch failed: CUDA error {err}")
    ce_fwd.launches += 1
    return lse, tlog


ce_fwd.launches = 0


def ce_bwd(h: torch.Tensor, w: torch.Tensor, b_masked: torch.Tensor,
           lse: torch.Tensor, dlse: torch.Tensor, dt: torch.Tensor,
           targets: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dh, dw, db) of :func:`ce_fwd` given the gradients dlse, dt of its
    two outputs, by K5 (its dh kernel, then its dW/db kernel)."""
    n = (h.shape[0],)
    N, d, V = _check("ce_bwd", h, w, [(h, tuple(h.shape)), (w, tuple(w.shape)),
                                      (b_masked, (w.shape[1],)), (lse, n),
                                      (dlse, n), (dt, n)], targets)
    h = _aligned(h)
    tgt = targets.to(torch.int32).contiguous()
    dh = torch.empty_like(h)
    dw = torch.empty_like(w)
    db = torch.empty_like(b_masked)
    split_h, split_w = _plan("ce_bwd_plan", N, d, V)
    # Wᵀ and its TF32 split, h's split, then each pass's partials
    floats = (3 * V * d + 2 * N * d + (split_h * N * d if split_h > 1 else 0)
              + (split_w * (d + 1) * V if split_w > 1 else 0))
    ws = torch.empty(floats, dtype=torch.float32, device=h.device)
    err = _fn("ce_bwd_f32", 11, 5)(
        h.data_ptr(), w.data_ptr(), b_masked.data_ptr(), lse.data_ptr(),
        dlse.data_ptr(), dt.data_ptr(), tgt.data_ptr(), dh.data_ptr(),
        dw.data_ptr(), db.data_ptr(), ws.data_ptr(), split_h, split_w, N, d, V,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ce_bwd launch failed: CUDA error {err}")
    ce_bwd.launches += 1
    return dh, dw, db


ce_bwd.launches = 0
