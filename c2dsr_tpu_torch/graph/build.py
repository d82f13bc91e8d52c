"""Item-item adjacency construction.

Rebuilds the reference's two directed edge sets (utils/graph.py:33-96):

* ``adj_share``   — edges between consecutive items of the *shared* sequence
  (``pre -> d`` for every consecutive pair).
* ``adj_specific``— edges between consecutive items *within the same domain*
  (``source -> d`` for A, ``target -> d`` for B; one matrix holds both
  domains' edges — the reference feeds the same matrix to ``gnn_a`` and
  ``gnn_b``, the separation comes from which table is propagated,
  models/C2DSR.py:61-62).

Parity note (SURVEY.md section 3.4): the reference's dedup set is never
populated (utils/graph.py:59-60 creates keys but nothing inserts), so every
repeated transition accumulates weight in the COO sum.  We reproduce that by
summing duplicate edges, then row-normalizing (D^-1 A, utils/graph.py:10-17).

Output is a dense-array COO representation sorted by row, which
``ops/spmm.device_graph`` turns into the CSR arrays of the CUDA kernel.  No
scipy/torch sparse objects anywhere.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from c2dsr_tpu_torch.config import DataSpec


@dataclasses.dataclass(frozen=True)
class CooGraph:
    """Row-sorted COO adjacency with row-normalized weights.

    rows/cols are int32 [nnz]; vals float32 [nnz]; n is the (square) dim.
    ``rows`` is sorted ascending, making segment reductions cheap.
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    n: int

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def to_dense(self) -> np.ndarray:
        d = np.zeros((self.n, self.n), dtype=np.float32)
        np.add.at(d, (self.rows, self.cols), self.vals)
        return d


def _coalesce_row_normalize(edges: np.ndarray, n: int) -> CooGraph:
    """Sum duplicate directed edges, then row-normalize (D^-1 A)."""
    if edges.size == 0:
        return CooGraph(np.zeros(0, np.int32), np.zeros(0, np.int32),
                        np.zeros(0, np.float32), n)
    keys = edges[:, 0].astype(np.int64) * n + edges[:, 1].astype(np.int64)
    uniq, counts = np.unique(keys, return_counts=True)
    rows = (uniq // n).astype(np.int32)
    cols = (uniq % n).astype(np.int32)
    vals = counts.astype(np.float32)
    rowsum = np.zeros(n, dtype=np.float64)
    np.add.at(rowsum, rows, vals)
    inv = np.zeros(n, dtype=np.float64)
    nz = rowsum > 0
    inv[nz] = 1.0 / rowsum[nz]
    vals = (vals * inv[rows]).astype(np.float32)
    return CooGraph(rows=rows, cols=cols, vals=vals, n=n)


def build_graphs(sequences: List[List[int]], spec: DataSpec
                 ) -> Tuple[CooGraph, CooGraph]:
    """Extract (adj_share, adj_specific) from train sequences.

    Mirrors the walk of utils/graph.py:54-81: per user, thread three cursors
    (``pre`` over the shared sequence, ``source`` over A items, ``target``
    over B items) and append a directed edge per consecutive pair.
    """
    na = spec.n_item_a
    share_edges: List[Tuple[int, int]] = []
    spec_edges: List[Tuple[int, int]] = []
    for seq in sequences:
        source = target = pre = -1
        for d in seq:
            if d < na:
                if source != -1:
                    spec_edges.append((source, d))
                source = d
            else:
                if target != -1:
                    spec_edges.append((target, d))
                target = d
            if pre != -1:
                share_edges.append((pre, d))
            pre = d
    n = spec.n_item
    share = _coalesce_row_normalize(
        np.asarray(share_edges, dtype=np.int64).reshape(-1, 2), n)
    specific = _coalesce_row_normalize(
        np.asarray(spec_edges, dtype=np.int64).reshape(-1, 2), n)
    return share, specific

