"""Parallel op strategy: how the model's table-size-dependent ops execute.

The model, train step and eval code call these ops through a strategy
object, as in ``c2dsr_tpu/parallel/strategy.py``: lookups, the graph
propagation (with train-mode dropout), the recommendation CE rows and the
ranking products.  Only the single-device ``LocalOps`` is ported so far;
the table-sharded strategy comes with ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses

import torch

from c2dsr_tpu_torch.config import Config
from c2dsr_tpu_torch.ops import fused_ce
from c2dsr_tpu_torch.ops import lookup as lookup_mod
from c2dsr_tpu_torch.ops import spmm as spmm_mod


@dataclasses.dataclass(frozen=True)
class LocalOps:
    """Single-device implementations."""

    cfg: Config

    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """table[ids] as ``index_select`` (ops/lookup.py); on the card its
        backward is the ordered segment sum K7, bitwise repeatable, where
        ``index_add_`` adds with atomics in a changing order."""
        return lookup_mod.lookup(table, ids)

    def lookup_add(self, a: torch.Tensor, b: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
        """a[ids] + b[ids]: on the card one K7 serves both gradients."""
        return lookup_mod.lookup_add(a, b, ids)

    def spmm_propagate(self, graph: spmm_mod.CsrDevice, h: torch.Tensor,
                       n_layers: int, dropout: float = 0.0,
                       generator=None, out_flag=None) -> torch.Tensor:
        return spmm_mod.gcn_propagate(graph, h, n_layers, dropout, generator,
                                      out_flag)

    def ce_rows(self, h, w, b, pad_logit, targets, n_real: int
                ) -> torch.Tensor:
        """Masked per-position CE terms: the fused CE kernels on a CUDA
        tensor, the plain version on a CPU one (ops/fused_ce.py)."""
        return fused_ce.fused_rec_ce_rows(h, w, b, pad_logit, targets, n_real)

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
