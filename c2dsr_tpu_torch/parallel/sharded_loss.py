"""Vocab-sharded recommendation cross-entropy: a distributed logsumexp over
the model group (``c2dsr_tpu/parallel/sharded_loss.py:34-196``).

Each model rank holds V/M output columns of a classifier (``parallel/
mesh.py``).  The softmax normaliser combines the ranks' local sums; the
target's logit lives on one rank and is recovered with a masked ``psum``.

:func:`sharded_rec_ce_rows_kernel` runs the fused CE (``ops/fused_ce``, K4
forward and K5 backward on the card, their plain versions on the CPU) on
the rank's vocab slice, as ``sharded_rec_ce_rows_pallas`` runs Pallas
#6-#9 there: no logit is written to device memory.  Each rank's local
(lse, target logit) combine as lse = m + log(psum(exp(lse_s - m))) with
m = pmax(lse_s) under no gradient, and tlog = psum(tlog_s).  The pad class
is folded in on rank 0 only (-1e9 elsewhere) and the bias is -1e9 on the
global vocab padding.  (The JAX package also has an einsum path that
materialises the local logits, where its Pallas CE is not chosen; the port
always runs the fused CE, whose kernels refuse a shard width they do not
take, ``ops/fused_ce_cuda.check_shape``.)  The mean divides the rows' sum by the valid count summed over the
data group (``ops/losses.ce_mean_from_rows``).

Semantics: ``ops/losses.rec_ce_row_losses`` (F.cross_entropy with
ignore_index = n_real over [domain classes | pad class]).  The rows h are
replicated over the model group and each rank multiplies them by its own
slice, so they enter through ``comm.pvary``, whose backward sums the ranks'
partial gradients; so does the pad logit, which only rank 0 uses.
"""

from __future__ import annotations

import torch

from c2dsr_tpu_torch.ops import fused_ce
from c2dsr_tpu_torch.parallel import comm

NEG = -1e9


def sharded_rec_ce_rows_kernel(h: torch.Tensor, w: torch.Tensor,
                               b: torch.Tensor, pad_logit: torch.Tensor,
                               targets: torch.Tensor, n_real: int,
                               group: comm.Group, bf16: bool = False
                               ) -> torch.Tensor:
    """Per-position masked CE terms [B, R] by the fused CE on this rank's
    vocab slice.  h [B, R, d] and pad_logit [B, R, 1] replicated; w [d,
    V/M] and b [V/M] this rank's columns, w f32 or bf16 (the classifier's
    streaming dtype: the shard read at two bytes an element); targets [B,
    R] global ids, n_real ignored; ``bf16``: bf16 products
    (``ops/fused_ce``), as a bf16 w always takes.

    K4/K5 read a target >= V as "no target here" (``fused_ce.ce_fwd_plain``)
    where JAX's local target ``tgt - r * vs`` is negative on later shards,
    so every target outside the slice is mapped to V/M first."""
    B, R, d = h.shape
    n, vs = B * R, w.shape[1]
    col = group.index * vs + torch.arange(vs, device=h.device)
    bm = torch.where(col < n_real, b,
                     torch.full((), NEG, dtype=b.dtype, device=b.device))
    # every rank runs the same operations, so that the collectives of the
    # backward come in one order on all of them
    pad = comm.pvary(pad_logit.reshape(n).to(h.dtype), group)
    on_first = torch.full((), group.index == 0, device=h.device)
    pad = torch.where(on_first, pad,
                      torch.full((), NEG, dtype=pad.dtype, device=h.device))
    t_local = targets.reshape(n).long() - group.index * vs
    t_ok = (t_local >= 0) & (t_local < vs)
    t_local = torch.where(t_ok, t_local, torch.full_like(t_local, vs))
    lse_s, tlog_s = fused_ce.fused_ce(
        comm.pvary(h.reshape(n, d), group), w, bm, pad, t_local, bf16)
    m = comm.pmax(lse_s, group)
    lse = m + torch.log(comm.psum(torch.exp(lse_s - m), group))
    tlog = comm.psum(torch.where(t_ok, tlog_s, torch.zeros_like(tlog_s)),
                     group)
    mask = (targets.reshape(n) != n_real).to(lse.dtype)
    return ((lse - tlog) * mask).reshape(B, R)
