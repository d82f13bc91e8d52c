"""Ranking over the vocab-sharded classifiers
(``c2dsr_tpu/parallel/sharded_eval.py:17-96``).

rank = #(scores > gt score) + 1 (trainer.py:174,179), a count on each
rank's vocab slice summed over the model group: the full score row exists
on no rank.  The shard products stay ``torch.matmul``, as
``LocalOps._scores`` leaves them to cuBLAS (the JAX package computes them
in XLA, outside any Pallas kernel).  No gradient flows here.
"""

from __future__ import annotations

import torch

from c2dsr_tpu_torch.parallel import comm


def _shard_scores(h, w, b, n_real, group: comm.Group):
    Vs = w.shape[1]
    scores = torch.matmul(h, w) + b
    col = group.index * Vs + torch.arange(Vs, device=h.device)
    return torch.where(col < n_real, scores,
                       torch.full((), float("-inf"), device=h.device))


def _owned_pick(scores, ids, group: comm.Group):
    """scores of the global ``ids`` [B, K], summed over the ranks (each id
    is owned by one rank, the others add 0)."""
    Vs = scores.shape[1]
    local = ids.long() - group.index * Vs
    ok = (local >= 0) & (local < Vs)
    s = scores.gather(1, local.clamp(0, Vs - 1))
    return comm.sum_(torch.where(ok, s, torch.zeros_like(s)), group)


def sharded_full_rank(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      gt: torch.Tensor, n_real: int, group: comm.Group
                      ) -> torch.Tensor:
    """h [B, d] replicated; w [d, V/M], b [V/M] this rank's columns; gt [B]
    domain-local ids.  Ranks [B] int32, on every rank."""
    scores = _shard_scores(h, w, b, n_real, group)
    g = _owned_pick(scores, gt[:, None], group)
    cnt = (scores > g).sum(dim=1)
    return comm.sum_(cnt, group).to(torch.int32) + 1


def sharded_gather_scores(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          ids: torch.Tensor, group: comm.Group
                          ) -> torch.Tensor:
    """scores[i, k] = h_i . w[:, ids[i, k]] + b[ids[i, k]] (sampled
    negatives): each rank scores the ids it owns from its shard product."""
    return _owned_pick(torch.matmul(h, w) + b, ids, group)
