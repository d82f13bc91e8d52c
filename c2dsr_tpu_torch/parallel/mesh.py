"""The device mesh and its sharding rules (``c2dsr_tpu/parallel/mesh.py:
28-120``), over ``torch.distributed`` ranks.

A 2-D ``(data, model)`` mesh, one rank per device: rank r sits at data
index ``r // n_model`` and model index ``r % n_model``.

* ``data``: batch data parallelism.  The ranks of one model column (one
  model index, every data index) form the data group: each reads its own
  rows of the global batch, and their gradients are summed over it.
* ``model``: the three item tables are sharded by rows and the two
  classifiers by output columns over the ranks of one data row (one data
  index, every model index), the model group.  Those ranks read the same
  rows of the global batch: the slice follows the data index, not the
  process index (a JAX process is a host, a rank here one device).

Everything else (towers, discriminators, the pad classifier, the position
table) is replicated on every rank, and so are the AdamW moments of each
parameter, which follow its parameter's rule (``state_shardings``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from c2dsr_tpu_torch.parallel import comm, distributed

_MODEL_SHARDED_ROWS = ("embed_share", "embed_a", "embed_b")
_MODEL_SHARDED_COLS = ("cls_a_w", "cls_b_w")
_MODEL_SHARDED_VEC = ("cls_a_b", "cls_b_b")


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_data: int
    n_model: int
    rank: int
    data_group: comm.Group     # my model column: the ranks of my model index
    model_group: comm.Group    # my data row: the ranks of my data index

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_data: int = 1, n_model: int = 1) -> Mesh:
    """The mesh of this process group's ranks (``n_data * n_model`` of
    them).  Every rank must call it: it makes one group per data row and
    per model column, in the same order on every rank."""
    world = distributed.process_count()
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} "
                         f"ranks, the process group has {world}")
    rank = distributed.process_index()
    groups = {}
    if n_model > 1:
        for d in range(n_data):
            ranks = [d * n_model + m for m in range(n_model)]
            groups[("model", d)] = (dist.new_group(ranks), ranks)
    if n_data > 1:
        for m in range(n_model):
            ranks = [d * n_model + m for d in range(n_data)]
            groups[("data", m)] = (dist.new_group(ranks), ranks)

    def group(key):
        if key not in groups:
            return comm.SELF
        pg, ranks = groups[key]
        return comm.Group(pg, len(ranks), ranks.index(rank))

    return Mesh(n_data, n_model, rank,
                data_group=group(("data", rank % n_model)),
                model_group=group(("model", rank // n_model)))


# --- sharding rules ---------------------------------------------------------

def shard_dim(name: str) -> Optional[int]:
    """The dim of a parameter sharded over ``model``, by its top-level name
    (``param_spec``): rows of the item tables, columns of the classifier
    weights, the classifier biases; None for a replicated parameter."""
    if name in _MODEL_SHARDED_ROWS or name in _MODEL_SHARDED_VEC:
        return 0
    if name in _MODEL_SHARDED_COLS:
        return 1
    return None


def leaf_names(params, top: Optional[str] = None) -> List[str]:
    """The top-level name of each tensor of a parameter tree, in the order
    of ``train/step.param_leaves`` (keys sorted at every level)."""
    if isinstance(params, dict):
        return [n for k in sorted(params)
                for n in leaf_names(params[k], top or k)]
    return [top]


def shard_range(n: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """This rank's contiguous block [lo, hi) of a sharded dim of size n:
    the whole of it without a mesh or at ``n_model`` 1."""
    if mesh is None or mesh.n_model == 1:
        return 0, n
    size = n // mesh.n_model
    if size * mesh.n_model != n:
        raise ValueError(f"a sharded dim of {n} does not split over "
                         f"{mesh.n_model} model ranks")
    return mesh.model_index * size, (mesh.model_index + 1) * size


def shard_tensor(t: torch.Tensor, dim: Optional[int], mesh: Mesh
                 ) -> torch.Tensor:
    """This rank's shard of a full tensor (a copy), or a copy of the whole
    of a replicated one."""
    if dim is None or mesh.n_model == 1:
        return t.detach().clone()
    lo, hi = shard_range(t.shape[dim], mesh)
    return t.detach().narrow(dim, lo, hi - lo).clone(
        memory_format=torch.contiguous_format)


def unshard_tensor(t: torch.Tensor, dim: Optional[int], mesh: Mesh
                   ) -> torch.Tensor:
    """The full tensor from every model rank's shard (a collective of the
    model group), or ``t`` itself where it is replicated."""
    if dim is None or mesh.n_model == 1:
        return t.detach()
    parts = comm.gather_(t, mesh.model_group)
    return torch.cat(list(parts.unbind(0)), dim=dim)


def _map(params, fn, top=None):
    if isinstance(params, dict):
        return {k: _map(v, fn, top or k) for k, v in params.items()}
    return fn(params, top)


def shard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's parameter tree from a full one."""
    return _map(params, lambda t, name: shard_tensor(t, shard_dim(name),
                                                     mesh))


def unshard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The full parameter tree (on every rank) from the ranks' shards."""
    return _map(params, lambda t, name: unshard_tensor(t, shard_dim(name),
                                                       mesh))


def _map_adamw(sd: Dict[str, Any], names: List[str], fn) -> Dict[str, Any]:
    state = {}
    for i in sorted(sd["state"]):
        dim = shard_dim(names[i])
        state[i] = {k: fn(v, dim) if torch.is_tensor(v) and v.dim() > 0
                    else v for k, v in sd["state"][i].items()}
    return {**sd, "state": state}


def shard_adamw(sd: Dict[str, Any], names: List[str], mesh: Mesh
                ) -> Dict[str, Any]:
    """An ``AdamW.state_dict()`` of full moments, cut to this rank's shards
    by their parameters' rule (``names``: ``leaf_names`` of the params)."""
    return _map_adamw(sd, names, lambda v, dim: shard_tensor(v, dim, mesh))


def unshard_adamw(sd: Dict[str, Any], names: List[str], mesh: Mesh
                  ) -> Dict[str, Any]:
    """The state dict with every moment whole (a collective)."""
    return _map_adamw(sd, names, lambda v, dim: unshard_tensor(v, dim, mesh))


# --- the batch ----------------------------------------------------------------

def _pad_rows(batch: Dict[str, np.ndarray], multiple: int, valid: bool):
    n = next(iter(batch.values())).shape[0]
    pad = (-n) % multiple
    out = dict(batch)
    if valid and "valid" not in out:
        out["valid"] = np.ones(n, np.int32)
    if pad:
        out = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
               for k, v in out.items()}
        if valid:
            out["valid"][n:] = 0
    return out


def _slice(batch, mesh: Mesh):
    m = next(iter(batch.values())).shape[0] // mesh.n_data
    lo = mesh.data_index * m
    return {k: v[lo:lo + m] for k, v in batch.items()}


def local_batch(batch: Dict[str, np.ndarray], mesh: Mesh
                ) -> Dict[str, np.ndarray]:
    """This rank's rows of a global training batch (``global_batch``'s
    counterpart): padded to a multiple of ``n_data`` with ``valid`` 0 rows
    that the loss masks, as ``data/pipeline.BatchIterator`` pads, then the
    data index's contiguous slice."""
    if mesh.n_data == 1:
        return batch
    return _slice(_pad_rows(batch, mesh.n_data, valid=True), mesh)


def eval_slice(chunk: Dict[str, np.ndarray], mesh: Mesh
               ) -> Dict[str, np.ndarray]:
    """This rank's rows of an eval chunk that every rank holds whole: padded
    to a multiple of ``n_data`` by repeating its last row (never cut), then
    the data index's slice.  The ranks gathered over the data group in rank
    order are the padded chunk's (``evaluate/ranker.make_eval_fns``)."""
    if mesh.n_data == 1:
        return chunk
    return _slice(_pad_rows(chunk, mesh.n_data, valid=False), mesh)
