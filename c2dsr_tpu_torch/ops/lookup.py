"""Table lookups: ``table[ids]`` as ``index_select``, with a backward that
is bitwise repeatable on the card.

On a CUDA table the backward is K7 (``ops/segsum_cuda.segsum``): the ids'
gradient rows summed per id in input order, every table row written once.
``index_select``'s own backward, ``index_add_``, adds with atomics there,
in an order that changes from run to run.  K7 takes d % 4 == 0: a gradient
of another width is zero-padded to it and sliced back (``ops/padding``).
On a CPU table the lookup is
``index_select`` under autograd, whose backward is K7's plain version
(``segsum_cuda.segsum_plain``, ``index_add_`` in index order).  The JAX
package's counterpart is ``jnp.take`` (``c2dsr_tpu/parallel/strategy.py``).
"""

from __future__ import annotations

import torch

from c2dsr_tpu_torch.ops import segsum_cuda
from c2dsr_tpu_torch.ops.padding import on_padded_width


def _segsum(ids: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K7 of the gradient rows g at ids, at g's width padded to K7's
    multiple."""
    return on_padded_width(lambda x: segsum_cuda.segsum(ids, x, n_rows),
                           g.contiguous(), segsum_cuda.D_MULTIPLE)


class _Lookup(torch.autograd.Function):
    """``index_select`` forward; K7 backward (looked up at call time)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return _segsum(ids, g, ctx.n_rows), None


class _LookupAdd(torch.autograd.Function):
    """``a[ids] + b[ids]`` for tables of one row count: both gradients are
    the same segment sum, so K7 (and its sort) runs once for the two."""

    @staticmethod
    def forward(ctx, a, b, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = a.shape[0]
        return a.index_select(0, ids) + b.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            return None, None, None
        grad = _segsum(ids, g, ctx.n_rows)
        return (grad if ctx.needs_input_grad[0] else None,
                grad if ctx.needs_input_grad[1] else None, None)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids]: [*ids.shape, table.shape[1]].  A lookup that needs no
    gradient (eval, inference mode) is ``index_select`` alone."""
    flat = ids.reshape(-1)
    if table.is_cuda and torch.is_grad_enabled() and table.requires_grad:
        rows = _Lookup.apply(table, flat)
    else:
        rows = table.index_select(0, flat)
    return rows.view(*ids.shape, table.shape[1])


def lookup_add(a: torch.Tensor, b: torch.Tensor, ids: torch.Tensor
               ) -> torch.Tensor:
    """a[ids] + b[ids] (tables of one shape): the same values as two
    :func:`lookup` calls and their sum, with one K7 for both gradients on
    the card."""
    if (a.is_cuda and torch.is_grad_enabled()
            and (a.requires_grad or b.requires_grad)):
        if a.shape != b.shape:
            raise ValueError(f"lookup_add takes tables of one shape, got "
                             f"{tuple(a.shape)} and {tuple(b.shape)}")
        rows = _LookupAdd.apply(a, b, ids.reshape(-1))
        return rows.view(*ids.shape, a.shape[1])
    return lookup(a, ids) + lookup(b, ids)
