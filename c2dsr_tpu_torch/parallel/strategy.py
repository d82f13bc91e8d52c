"""Parallel op strategy: how the model's table-size-dependent ops execute.

The model, train step and eval code call these ops through a strategy
object, as in ``c2dsr_tpu/parallel/strategy.py``: lookups, the graph
propagation (with train-mode dropout), the recommendation CE rows and the
ranking products.  ``LocalOps`` runs them on one device, and also serves a
data-parallel mesh (``mesh_model`` 1), where the tables are whole on every
rank; ``ShardedOps`` runs them over row-sharded tables and vocab-sharded
classifiers with the collectives of ``parallel/embed.py``,
``sharded_loss.py`` and ``sharded_eval.py``.

A data-parallel mesh also asks three things of the step that GSPMD gives
the JAX package for free, and both strategies answer them:
:meth:`LocalOps.data_sum` sums a count over the data group (the loss's
normalisers are global), :meth:`LocalOps.dropout_rows` places a rank's
rows in the global batch for the towers' dropout hash, and
:meth:`LocalOps.dropout_generator` seeds the GNN dropout alike on the data
replicas of a model shard and apart on the shards.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from c2dsr_tpu_torch.config import Config
from c2dsr_tpu_torch.ops import bf16
from c2dsr_tpu_torch.ops import dropout as drop
from c2dsr_tpu_torch.ops import fused_ce
from c2dsr_tpu_torch.ops import lookup as lookup_mod
from c2dsr_tpu_torch.ops import spmm as spmm_mod
from c2dsr_tpu_torch.parallel import comm, embed, sharded_eval, sharded_loss
from c2dsr_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class LocalOps:
    """Whole tables on this device; with a ``mesh``, one data rank."""

    cfg: Config
    mesh: Optional[Mesh] = None

    @property
    def data_group(self) -> comm.Group:
        return comm.SELF if self.mesh is None else self.mesh.data_group

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A count (no gradient) summed over the data group."""
        return comm.sum_(x, self.data_group)

    def dropout_rows(self, rows: int):
        """The towers' dropout row map of a batch of ``rows`` local rows:
        this rank's place in the global batch (``ops/dropout.row_map``)."""
        g = self.data_group
        return drop.row_map(g.index * rows, rows, g.size * rows)

    def dropout_generator(self, seed: int, device) -> torch.Generator:
        """The GNN dropout's generator of a step: seeded by the step's seed,
        the same on every data replica of the tables."""
        return torch.Generator(device=device).manual_seed(seed)

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
        """The propagation, its gathers in bf16 under
        ``compute_dtype="bfloat16"`` (``c2dsr_tpu/parallel/strategy.py:
        40-48``)."""
        return spmm_mod.gcn_propagate(
            graph, h, n_layers, dropout, generator, out_flag,
            torch.bfloat16 if self.cfg.bf16_products() else torch.float32)

    def _cls(self, w: torch.Tensor) -> torch.Tensor:
        """The classifier in its streaming dtype (``cfg.classifier_dtype``,
        ``c2dsr_tpu/parallel/strategy.py:50-56``): a bf16 cast at each use,
        the master weight staying f32; the cast's backward hands the
        optimizer an f32 gradient."""
        if self.cfg.resolved_classifier_dtype() == "bfloat16":
            return w.to(torch.bfloat16)
        return w

    def ce_rows(self, h, w, b, pad_logit, targets, n_real: int
                ) -> torch.Tensor:
        """Masked per-position CE terms: the fused CE kernels on a CUDA
        tensor, the plain version on a CPU one (ops/fused_ce.py), with bf16
        products under ``compute_dtype="bfloat16"`` or a bf16 classifier."""
        return fused_ce.fused_rec_ce_rows(h, self._cls(w), b, pad_logit,
                                          targets, n_real,
                                          bf16=self.cfg.bf16_products())

    def _scores(self, h, w, b) -> torch.Tensor:
        # a plain [B, d] x [d, V] product, left to cuBLAS as JAX left it to
        # XLA; a bf16 classifier multiplies bf16-rounded operands into f32
        # scores (preferred_element_type=f32 there), exact products summed
        # in f32, so no score is rounded to bf16
        dtype = getattr(torch, self.cfg.resolved_classifier_dtype())
        if dtype == torch.bfloat16:
            return torch.matmul(bf16.round_bf16(h.float()),
                                self._cls(w).float()) + b
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


@dataclasses.dataclass(frozen=True)
class ShardedOps(LocalOps):
    """Row-sharded item tables and vocab-sharded classifiers over the mesh's
    model group, the batch split over its data group
    (``c2dsr_tpu/parallel/strategy.py:90-148``).  Each table argument is
    this rank's shard (``parallel/mesh.shard_params``)."""

    @property
    def model_group(self) -> comm.Group:
        return self.mesh.model_group

    def dropout_generator(self, seed: int, device) -> torch.Generator:
        """Seeded by (step seed, model index): each model shard draws its own
        rows' masks, and the data replicas of a shard draw the same bits, so
        that the replicated tables stay equal."""
        shard = drop.mix32(seed ^ drop.mix32(self.mesh.model_index
                                             + drop.GOLDEN))
        return torch.Generator(device=device).manual_seed(shard)

    def lookup(self, table, ids):
        if self.cfg.lookup_mode == "a2a":
            return embed.a2a_lookup_replicated(table, ids, self.model_group)
        return embed.sharded_lookup(table, ids, self.model_group)

    def lookup_add(self, a, b, ids):
        if self.cfg.lookup_mode == "a2a":
            return self.lookup(a + b, ids)
        return embed.sharded_lookup_add(a, b, ids, self.model_group)

    def spmm_propagate(self, graph, h, n_layers, dropout=0.0,
                       generator=None, out_flag=None):
        # out_flag is ignored: the row-sharded propagation stays dense
        # (values identical either way), as in the JAX package
        if graph.a2a is None:
            raise ValueError("a row-sharded propagation needs the graph's "
                             "all-to-all plan (ops/spmm.attach_a2a_plan)")
        h_sum = h
        cur = h
        for _ in range(n_layers):
            if generator is not None and dropout > 0.0:
                keep = torch.rand(cur.shape, generator=generator,
                                  device=cur.device) >= dropout
                cur = torch.where(keep, cur / (1.0 - dropout),
                                  torch.zeros((), device=cur.device))
            cur = embed.sharded_spmm_a2a(graph.a2a, cur, self.model_group)
            h_sum = h_sum + cur
        return h_sum / (n_layers + 1)

    def ce_rows(self, h, w, b, pad_logit, targets, n_real):
        """K4/K5 on this rank's vocab slice (the plain versions on the CPU),
        as the JAX package runs its Pallas CE inside the shard_map, on the
        classifier in its streaming dtype (``_cls``, strategy.py:134)."""
        return sharded_loss.sharded_rec_ce_rows_kernel(
            h, self._cls(w), b, pad_logit, targets, n_real, self.model_group,
            bf16=self.cfg.bf16_products())

    def full_rank(self, h, w, b, gt, n_real):
        return sharded_eval.sharded_full_rank(h, w, b, gt, n_real,
                                              self.model_group)

    def gather_scores(self, h, w, b, ids):
        return sharded_eval.sharded_gather_scores(h, w, b, ids,
                                                  self.model_group)


def make_ops(cfg: Config, mesh: Optional[Mesh] = None) -> LocalOps:
    """ShardedOps where the mesh shards the tables, else LocalOps (on a
    data-parallel mesh, with it)."""
    if mesh is not None and cfg.mesh_model > 1:
        return ShardedOps(cfg=cfg, mesh=mesh)
    return LocalOps(cfg=cfg, mesh=mesh)
