"""Parallel op strategy: how the model's table-size-dependent ops execute.

The model and eval code call these ops through a strategy object, as in
``c2dsr_tpu/parallel/strategy.py``.  Only the single-device ``LocalOps``
is ported so far; the table-sharded strategy comes with ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses

import torch

from c2dsr_tpu_torch.config import Config
from c2dsr_tpu_torch.ops import spmm as spmm_mod


@dataclasses.dataclass(frozen=True)
class LocalOps:
    """Single-device implementations."""

    cfg: Config

    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return table[ids]

    def spmm_propagate(self, graph: spmm_mod.CsrDevice, h: torch.Tensor,
                       n_layers: int) -> torch.Tensor:
        return spmm_mod.gcn_propagate(graph, h, n_layers)

    def _scores(self, h, w, b) -> torch.Tensor:
        # a plain [B, d] x [d, V] product, left to cuBLAS as JAX left it to XLA
        dtype = getattr(torch, self.cfg.resolved_classifier_dtype())
        return torch.matmul(h.to(dtype), w.to(dtype)).float() + b

    def full_rank(self, h, w, b, gt, n_real: int) -> torch.Tensor:
        scores = self._scores(h, w, b)
        if scores.shape[-1] > n_real:
            col = torch.arange(scores.shape[-1], device=scores.device)
            scores = torch.where(col < n_real, scores,
                                 torch.full((), float("-inf"),
                                            device=scores.device))
        gt_score = scores.gather(1, gt[:, None])
        return (scores > gt_score).sum(dim=1).to(torch.int32) + 1

    def gather_scores(self, h, w, b, ids) -> torch.Tensor:
        """scores[i, k] = h_i . w[:, ids[i,k]] + b[ids[i,k]]: the full
        [B, V] product, then a gather (cheaper than gathering [B, K, d]
        columns of w)."""
        return self._scores(h, w, b).gather(1, ids)
