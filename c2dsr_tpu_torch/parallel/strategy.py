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
from c2dsr_tpu_torch.ops import spmm as spmm_mod


@dataclasses.dataclass(frozen=True)
class LocalOps:
    """Single-device implementations."""

    cfg: Config

    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """table[ids] as ``index_select``, whose backward is one
        ``index_add_``; the backward of ``table[ids]`` sorts the ids and
        walks each repeated id in turn, slow on Zipf-skewed sequences."""
        rows = table.index_select(0, ids.reshape(-1))
        return rows.view(*ids.shape, table.shape[1])

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
