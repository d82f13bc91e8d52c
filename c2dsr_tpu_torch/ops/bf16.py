"""The bf16 products of the JAX package's Pallas kernels, in plain PyTorch.

Under ``compute_dtype="bfloat16"`` the JAX package's kernels round both
operands of every product to bf16 (round to nearest even) and accumulate in
f32: ``fused_ce._dot`` and its backward's products, the tower's ``_mm``,
``_mm_tn``, ``_mm_nt`` and ``_bmm`` with ``matmul_dtype=bf16``
(``c2dsr_tpu/ops/fused_ce.py:47-53``, ``encoder_pallas.py:60-81``).  A
product of two bf16 values is exact in f32, so :func:`matmul` computes the
f32 product of the rounded operands.

Its backward is the Pallas kernels' too: they round the incoming gradient
before each of the two products (``_fused_bwd``, ``_bwd_merged_kernel``),
where autograd through a cast would multiply the unrounded gradient.  So
:func:`matmul` is an autograd Function of its own.  The plain versions of
the kernels (the CE, the tower) build on it; on the card the kernels round
as they load their fragments (``csrc/tc.cuh`` ``round_bf16``).
"""

from __future__ import annotations

from typing import Optional

import torch


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (nearest, ties to even), in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


class _Matmul(torch.autograd.Function):
    """``(bf16(a) @ bf16(b)) * scale`` in f32 (in float64 where an input is
    float64: the same rounding points with float64 sums, a reference for
    the f32 versions); the gradients ``(bf16(g) @ bf16(b)ᵀ) * scale`` and
    ``(bf16(a)ᵀ @ bf16(g)) * scale``, each returned in its input's dtype (a
    bf16 weight gets a bf16 gradient, as ``fused_ce.py:337,392`` casts
    dW)."""

    @staticmethod
    def forward(ctx, a, b, scale):
        wide = torch.float64 in (a.dtype, b.dtype)
        ra = round_bf16(a.float())
        rb = round_bf16(b.float())
        if wide:
            ra, rb = ra.double(), rb.double()
        ctx.save_for_backward(ra, rb)
        ctx.scale = scale
        ctx.dtypes = (a.dtype, b.dtype)
        out = ra @ rb
        return out if scale is None else out * scale

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_bf16(g.float()).to(ra.dtype)
        ga = rg @ rb.transpose(-1, -2)
        if ra.dim() > 2 and rb.dim() == 2:     # a weight shared by the batch
            gb = (ra.reshape(-1, ra.shape[-1]).T
                  @ rg.reshape(-1, rg.shape[-1]))
        else:
            gb = ra.transpose(-1, -2) @ rg
        if ctx.scale is not None:
            ga, gb = ga * ctx.scale, gb * ctx.scale
        return ga.to(ctx.dtypes[0]), gb.to(ctx.dtypes[1]), None


def matmul(a: torch.Tensor, b: torch.Tensor,
           scale: Optional[float] = None) -> torch.Tensor:
    """The f32 product of ``a`` and ``b`` rounded to bf16, times ``scale``
    after the product where given (``_bmm(q, k) * scale``); differentiable,
    the gradient rounded to bf16 before each product.  ``b`` is [k, m] or
    has ``a``'s batch dims."""
    return _Matmul.apply(a, b, scale)
