"""Row-sharded item tables: lookups and graph propagation over the model
group (``c2dsr_tpu/parallel/embed.py``).

Each model rank holds the rows [i·S, (i+1)·S) of a table (``parallel/
mesh.py``).  Lookups, two strategies:

* :func:`sharded_lookup` (``lookup_mode="psum"``): every rank gathers the
  ids it owns (zeros elsewhere) and the partial rows are summed over the
  model group.  One ``psum`` of n_ids·d.
* :func:`a2a_lookup_replicated` (``"a2a"``): the ids are split over the
  model ranks, each routes its part to the owners with a fixed capacity a
  destination (:func:`all_to_all_lookup`), and the rows come back with an
  ``all_gather``.  Ids that overflow a bucket are resolved exactly by the
  masked ``psum`` path.

The local gathers are ``ops/lookup.lookup``, whose backward on the card is
K7, the ordered segment sum, so a step stays bitwise repeatable.  A masked
lookup hands K7 the clipped ids with their gradient rows zeroed where the
rank does not own the id; K7 skips zero gradient rows before it orders the
rest (``csrc/segsum.cu``), so the clipped ids make no chain on row 0.

Propagation (``adj @ table``, the table row-sharded, the output too):
:func:`sharded_spmm_a2a`.  A schedule fixed once per graph
(:func:`plan_spmm_a2a`, numpy, the port's own copy; ``ops/spmm.
attach_a2a_plan``) sends each rank only the unique source rows its
destination rows need, in one ``all_to_all`` a hop.  (The JAX package also
has a masked-``psum`` SpMM for a graph without a plan; the port always
attaches the plan, so it has only this path.)

The local sum over a rank's destination rows is K1 on the card
(``ops/spmm_cuda``), over a CSR whose columns index the received buffer
(``ops/spmm.rect_graph``), built once per graph like ``device_graph``'s
plan.
JAX sums them with ``segment_sum``; here the sum must be deterministic,
because the data replicas of one shard compute it redundantly and must
agree bitwise: ``index_add_``'s atomics would let them drift apart.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from c2dsr_tpu_torch.ops import lookup as lookup_mod
from c2dsr_tpu_torch.ops import spmm as spmm_mod
from c2dsr_tpu_torch.parallel import comm


def _owner_local(ids: torch.Tensor, shard_rows: int, index: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(local row clipped into the shard, owned mask) of each id."""
    local = ids - index * shard_rows
    ok = (local >= 0) & (local < shard_rows)
    return local.clamp(0, shard_rows - 1), ok


def _masked(rows: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor,
                   group: comm.Group) -> torch.Tensor:
    """table[ids] of a row-sharded table: ``table`` this rank's [S, d]
    shard, ``ids`` global ids, the same on every rank of ``group``; returns
    [*ids.shape, d] on every rank."""
    local, ok = _owner_local(ids, table.shape[0], group.index)
    return comm.psum(_masked(lookup_mod.lookup(table, local), ok), group)


def sharded_lookup_add(a: torch.Tensor, b: torch.Tensor, ids: torch.Tensor,
                       group: comm.Group) -> torch.Tensor:
    """a[ids] + b[ids] of two tables sharded alike, with one K7 for both
    gradients (``ops/lookup.lookup_add``)."""
    local, ok = _owner_local(ids, a.shape[0], group.index)
    return comm.psum(_masked(lookup_mod.lookup_add(a, b, local), ok), group)


def _a2a_exchange(table: torch.Tensor, flat: torch.Tensor,
                  group: comm.Group, capacity_factor: float) -> torch.Tensor:
    """Rows [n, d] of this rank's ids ``flat`` [n] by the bucket-by-owner
    exchange (``_a2a_exchange_flat`` of the JAX package)."""
    S, d = table.shape
    M = group.size
    n = flat.shape[0]
    cap = max(1, int(-(-n // M) * capacity_factor))
    owner = (flat // S).clamp(0, M - 1)
    onehot = F.one_hot(owner, M)                               # [n, M]
    slot = ((onehot.cumsum(0) - onehot) * onehot).sum(1)       # [n]
    fits = slot < cap

    # requests [M, cap] of local row indices at each owner; ids past a
    # bucket's capacity go to a dump slot that is cut off
    send = torch.zeros(M * cap + 1, dtype=flat.dtype, device=flat.device)
    at = torch.where(fits, owner * cap + slot,
                     torch.full_like(slot, M * cap))
    send[at] = flat - owner * S
    asks = comm.all_to_all(send[:-1].view(M, cap), group)
    rows = lookup_mod.lookup(table, asks.clamp(0, S - 1))      # [M, cap, d]
    rows = comm.all_to_all(rows, group).reshape(M * cap, d)
    got = _masked(lookup_mod.lookup(
        rows, owner * cap + slot.clamp(max=cap - 1)), fits)

    # exact fallback for the ids that missed their bucket: every rank
    # publishes its misses (each in its own slot of [M, n]), the owners fill
    # them, the partials are summed, and each rank reads its own slot
    need = ~fits
    all_ids = comm.gather_(torch.where(need, flat, torch.zeros_like(flat)),
                           group)
    all_need = comm.gather_(need.to(torch.uint8), group).bool()
    local, ok = _owner_local(all_ids, S, group.index)
    fb = _masked(lookup_mod.lookup(table, local), ok & all_need)
    fb = comm.pvary(comm.psum(fb, group), group)               # [M, n, d]
    return got + _masked(fb[group.index], need)


def all_to_all_lookup(table: torch.Tensor, ids: torch.Tensor,
                      group: comm.Group, capacity_factor: float = 2.0
                      ) -> torch.Tensor:
    """DLRM-style exchange: each rank asks for its own ``ids``; returns its
    rows [*ids.shape, d].  Capacity a destination: ceil(n/M) x
    ``capacity_factor``; overflow is resolved exactly."""
    got = _a2a_exchange(table, ids.reshape(-1), group, capacity_factor)
    return got.view(*ids.shape, table.shape[1])


def a2a_lookup_replicated(table: torch.Tensor, ids: torch.Tensor,
                          group: comm.Group, capacity_factor: float = 2.0
                          ) -> torch.Tensor:
    """The towers' lookup by the exchange (``lookup_mode="a2a"``): ``ids``
    the same on every rank of ``group``; each rank asks for its 1/M of them
    (padded with id 0 to a multiple of M), and the rows are all-gathered,
    so the result is [*ids.shape, d] on every rank."""
    flat = ids.reshape(-1)
    n, M = flat.shape[0], group.size
    k = -(-n // M)
    padded = torch.cat([flat, flat.new_zeros(k * M - n)])
    mine = padded[group.index * k:(group.index + 1) * k]
    got = _a2a_exchange(table, mine, group, capacity_factor)
    rows = comm.all_gather(got, group).reshape(k * M, table.shape[1])
    return rows[:n].view(*ids.shape, table.shape[1])


# --- propagation ----------------------------------------------------------------

class SpmmPlan(NamedTuple):
    """The all-to-all schedule of one static adjacency (numpy).

    With M = n_shards, S = n_rows // M, cap = the most unique source rows
    any (dest, src) shard pair exchanges, E = the most edges any dest shard
    owns:

    send_idx [M, M, cap] : send_idx[t, s] = local rows shard t ships to s
    edge_ptr [M, E]      : per dest shard, each edge's source row in the
                           received [M*cap, d] buffer
    edge_dst [M, E]      : per dest shard, the local destination row
    edge_val [M, E]      : edge weights (0 on padding)
    n_edges  [M]         : the real edges of each dest shard (the rest pad)
    """

    send_idx: np.ndarray
    edge_ptr: np.ndarray
    edge_dst: np.ndarray
    edge_val: np.ndarray
    n_edges: np.ndarray
    n_rows: int
    n_shards: int


def plan_spmm_a2a(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                  n_rows: int, n_shards: int) -> SpmmPlan:
    """The exchange schedule (host-side, once per graph): the JAX
    package's ``plan_spmm_a2a``.  ``n_rows`` is the padded table row count,
    divisible by ``n_shards``."""
    if n_rows % n_shards:
        raise ValueError(f"{n_rows} rows do not split over {n_shards} shards")
    M, S = n_shards, n_rows // n_shards
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)

    od = rows // S                              # dest shard per edge
    order = np.lexsort((rows, od))              # by dest shard, then row
    r, c, v, od = rows[order], cols[order], vals[order], od[order]

    # unique (dest shard, source row) pairs, ascending
    key = od * n_rows + c
    uniq, inv = np.unique(key, return_inverse=True)
    u_s = uniq // n_rows
    u_c = uniq % n_rows
    u_t = u_c // S                              # owner of the source row
    st = u_s * M + u_t
    first = np.searchsorted(st, np.arange(M * M))
    counts = np.diff(np.append(first, len(st)))
    cap = max(8, int(-(-max(1, counts.max()) // 8) * 8))
    pos = np.arange(len(u_c)) - first[st]

    send_idx = np.zeros((M, M, cap), np.int32)
    send_idx[u_t, u_s, pos] = (u_c - u_t * S).astype(np.int32)

    nnz_per = np.bincount(od, minlength=M)
    E = max(8, int(-(-max(1, nnz_per.max()) // 8) * 8))
    starts = np.concatenate([[0], np.cumsum(nnz_per)[:-1]])
    within = np.arange(len(r)) - starts[od]
    edge_ptr = np.zeros((M, E), np.int32)
    edge_dst = np.full((M, E), S - 1, np.int32)
    edge_val = np.zeros((M, E), np.float32)
    edge_ptr[od, within] = (u_t[inv] * cap + pos[inv]).astype(np.int32)
    edge_dst[od, within] = (r - od * S).astype(np.int32)
    edge_val[od, within] = v
    return SpmmPlan(send_idx=send_idx, edge_ptr=edge_ptr, edge_dst=edge_dst,
                    edge_val=edge_val, n_edges=nnz_per.astype(np.int64),
                    n_rows=int(n_rows), n_shards=M)


class RankPlan(NamedTuple):
    """One model rank's part of a :class:`SpmmPlan`, on its device: the
    rows it sends to each rank, and the CSR of its destination rows over
    the received buffer (padding edges dropped)."""

    send_idx: torch.Tensor          # int64 [M, cap]
    csr: spmm_mod.CsrDevice         # [S, M*cap]
    n_rows: int
    n_shards: int


def rank_plan(plan: SpmmPlan, index: int, device) -> RankPlan:
    M, _, cap = plan.send_idx.shape
    ne = int(plan.n_edges[index])
    csr = spmm_mod.rect_graph(plan.edge_dst[index, :ne],
                              plan.edge_ptr[index, :ne],
                              plan.edge_val[index, :ne], plan.n_rows // M,
                              M * cap, device)
    send = torch.from_numpy(plan.send_idx[index].astype(np.int64)).to(device)
    return RankPlan(send, csr, plan.n_rows, M)


def sharded_spmm_a2a(plan: RankPlan, table: torch.Tensor,
                     group: comm.Group) -> torch.Tensor:
    """``adj @ table`` by the precomputed schedule: gather the rows each
    rank needs, one ``all_to_all``, then K1 over the local CSR.  table:
    this rank's [S, d] shard; returns its [S, d] rows of the result."""
    if table.shape[0] * plan.n_shards != plan.n_rows:
        raise ValueError(f"a shard of {table.shape[0]} rows does not match "
                         f"the plan's {plan.n_rows} over {plan.n_shards}")
    buf = lookup_mod.lookup(table, plan.send_idx)              # [M, cap, d]
    buf = comm.all_to_all(buf, group)
    return spmm_mod.rect_spmm(plan.csr, buf.reshape(-1, table.shape[1]))
