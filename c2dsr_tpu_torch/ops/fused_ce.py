"""Fused linear + softmax cross-entropy: the recommendation heads' loss.

The counterpart of ``c2dsr_tpu/ops/fused_ce.py``.  The recommendation loss
scores every position against the whole domain itemset (trainer.py:131-154):
at Food-Kitchen scale the logits are [10,240, ~30k-37k] per domain and
step.  On a CUDA tensor :func:`fused_ce` runs the hand-written kernels of
``ops/fused_ce_cuda.py`` (forward K4, backward K5), which never write a
logit to device memory.  On a CPU tensor it runs the plain version beside
them, :func:`ce_fwd_plain`: the logits materialised, then ``logsumexp`` over
``[h·W + b_masked | pad]`` and the target gather, differentiated by
autograd; :func:`ce_bwd_plain` is the plain version of K5.

Vocab padding: the caller's bias carries -1e9 on padded columns
(:func:`mask_bias`), so padded classes vanish from the softmax; the
``where`` in ``mask_bias`` blocks the gradient into their bias, as in JAX.
V is taken as stored: the TPU's padding to 1024/2048/3584 columns and its
block-shape rules do not carry over.  The kernels take d % 8 == 0 (the
wide kernels above d 512) with W under 2 GiB, the JAX package's limit:
:func:`ce_kernels` zero-pads h's columns and w's rows to a multiple of 8
(``ops/padding``; zero columns add nothing to h·w), and the gradients come
back sliced through autograd.

``bf16=True`` (``compute_dtype="bfloat16"``), and a bf16 ``w`` (the bf16
classifier, ``parallel/strategy.LocalOps._cls``) whatever ``bf16`` says,
select the JAX kernels' numerics (``fused_ce._dot`` and the backward's
products, ``c2dsr_tpu/ops/fused_ce.py:47-53,107,121,157,183``): h, W and
the dlogits rounded to bf16 before each product, the products summed in
f32, db the f32 sum of the dlogits; a bf16 W gets its gradient rounded to
bf16 (``fused_ce.py:337,392``), an f32 W an f32 one.  On the CPU the plain
versions take ``ops/bf16.matmul``, whose backward rounds the incoming
gradient as the kernels do; on the card K4/K5's bf16 instantiations.
"""

from __future__ import annotations

from typing import Tuple

import torch

from c2dsr_tpu_torch.ops import fused_ce_cuda
from c2dsr_tpu_torch.ops.bf16 import matmul as bf16_matmul, round_bf16
from c2dsr_tpu_torch.ops.padding import pad_width

NEG = -1e9


def mask_bias(b: torch.Tensor, n_real: int) -> torch.Tensor:
    """The bias with -1e9 on the vocab-padding columns (>= n_real)."""
    col = torch.arange(b.shape[0], device=b.device)
    return torch.where(col < n_real, b,
                       torch.full((), NEG, dtype=b.dtype, device=b.device))


def _bf16(w: torch.Tensor, bf16: bool) -> bool:
    """Whether the CE takes bf16 products: asked for, or a bf16 W."""
    return bf16 or w.dtype == torch.bfloat16


def ce_fwd_plain(h: torch.Tensor, w: torch.Tensor, b_masked: torch.Tensor,
                 pad: torch.Tensor, targets: torch.Tensor, bf16: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K4: (lse, target logit) per row of softmax over
    [h·w + b_masked | pad]; a target >= V gives a target logit of 0.  With
    ``bf16`` (or a bf16 w) the logits are the f32 product of bf16-rounded h
    and w, differentiable as the JAX kernels' backward (ops/bf16.py)."""
    if _bf16(w, bf16):
        logits = bf16_matmul(h, w) + b_masked
    else:
        logits = h @ w + b_masked
    V = logits.shape[1]
    lse = torch.logsumexp(torch.cat([logits, pad[:, None]], dim=1), dim=1)
    tgt = targets.long()
    picked = logits.gather(1, tgt.clamp(max=V - 1)[:, None])[:, 0]
    tlog = torch.where(tgt < V, picked, torch.zeros_like(picked))
    return lse, tlog


def ce_bwd_plain(h: torch.Tensor, w: torch.Tensor, b_masked: torch.Tensor,
                 lse: torch.Tensor, dlse: torch.Tensor, dt: torch.Tensor,
                 targets: torch.Tensor, bf16: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K5: (dh, dw, db) from the recomputed softmax,
    dlogits = dlse·p + dt·onehot(target).  With ``bf16`` (or a bf16 w): h,
    w and the dlogits rounded to bf16 before each product, db the f32 sum
    of the dlogits, dw in w's dtype."""
    bf = _bf16(w, bf16)
    if bf:
        h, w_in, w = round_bf16(h.float()), w, round_bf16(w.float())
    logits = h @ w + b_masked
    V = logits.shape[1]
    dlog = dlse[:, None] * torch.exp(logits - lse[:, None])
    tgt = targets.long()
    hit = tgt < V
    rows = torch.arange(h.shape[0], device=h.device)[hit]
    dlog[rows, tgt[hit]] += dt[hit]
    if bf:
        g = round_bf16(dlog)
        return g @ w.T, (h.T @ g).to(w_in.dtype), dlog.sum(dim=0)
    return dlog @ w.T, h.T @ dlog, dlog.sum(dim=0)


class _FusedCE(torch.autograd.Function):
    """Forward by ``fused_ce_cuda.ce_fwd``, backward by ``ce_bwd`` (looked
    up at call time); the pad-class gradient dlse·exp(pad - lse) stays
    elementwise outside the kernels, as in JAX (fused_ce.py:336, 391)."""

    @staticmethod
    def forward(ctx, h, w, b_masked, pad, targets, bf16):
        lse, tlog = fused_ce_cuda.ce_fwd(h, w, b_masked, pad, targets,
                                         bf16=bf16)
        ctx.save_for_backward(h, w, b_masked, pad, targets, lse)
        ctx.bf16 = bf16
        return lse, tlog

    @staticmethod
    def backward(ctx, dlse, dt):
        h, w, b_masked, pad, targets, lse = ctx.saved_tensors
        dlse, dt = dlse.contiguous(), dt.contiguous()
        dh, dw, db = fused_ce_cuda.ce_bwd(h, w, b_masked, lse, dlse, dt,
                                          targets, bf16=ctx.bf16)
        return dh, dw, db, dlse * torch.exp(pad - lse), None, None


def fused_ce(h: torch.Tensor, w: torch.Tensor, b_masked: torch.Tensor,
             pad: torch.Tensor, targets: torch.Tensor, bf16: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (lse, target logit) of softmax over [h·w + b_masked | pad]:
    the kernels (forward and backward) for a CUDA tensor, else the plain
    version under autograd.  h [N, d], w [d, V] (f32, or bf16), b_masked
    [V], pad [N], targets [N] int; ``bf16``: bf16 products (module
    docstring)."""
    if not h.is_cuda:
        return ce_fwd_plain(h, w, b_masked, pad, targets, bf16)
    return ce_kernels(h, w, b_masked, pad, targets, bf16)


def ce_kernels(h: torch.Tensor, w: torch.Tensor, b_masked: torch.Tensor,
               pad: torch.Tensor, targets: torch.Tensor, bf16: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_ce` by K4 and K5 (their bf16 instantiations with
    ``bf16`` or a bf16 w), h's columns and w's rows zero-padded to the
    kernels' multiple of the width; any width (the wide kernels above
    d 512)."""
    h = pad_width(h, fused_ce_cuda.D_MULTIPLE, dim=1)
    w = pad_width(w, fused_ce_cuda.D_MULTIPLE, dim=0)
    args = (h.contiguous(), w.contiguous(), b_masked.contiguous(),
            pad.contiguous(), targets)
    bf16 = _bf16(w, bf16)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in args[:4])):
        return fused_ce_cuda.ce_fwd(*args, bf16=bf16)
    return _FusedCE.apply(*args, bf16)


def fused_rec_ce_rows(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      pad_logit: torch.Tensor, targets: torch.Tensor,
                      n_real: int, bf16: bool = False) -> torch.Tensor:
    """Per-position masked CE terms [B, R], the counterpart of
    ``losses.rec_ce_row_losses`` without materialising logits on the card.

    h [B, R, d]; w [d, V] with V >= n_real (f32, or bf16); b [V];
    pad_logit [B, R, 1] (or [B, R]); targets [B, R], n_real meaning
    "ignored"; ``bf16``: bf16 products (module docstring)."""
    B, R, d = h.shape
    n = B * R
    lse, tlog = fused_ce(h.reshape(n, d), w, mask_bias(b, n_real),
                         pad_logit.reshape(n).to(h.dtype), targets.reshape(n),
                         bf16)
    mask = (targets != n_real).to(lse.dtype)
    return (lse - tlog).reshape(B, R) * mask
