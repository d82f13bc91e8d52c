"""Sparse matrix-times-dense-table propagation (the GCN hot op).

The reference runs ``torch.spmm(adj, h)`` over the FULL item table
(models/encoders.py:42-48).  Here the row-sorted COO of ``graph/build.py``
becomes a CSR on the device.  On a CUDA tensor each hop is the row-parallel
CSR kernel (``ops/spmm_cuda.py``, ``csrc/spmm.cu``); on a CPU tensor it is
the plain ``index_select``·vals + ``index_add_`` of :func:`spmm_reference`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from c2dsr_tpu_torch.ops import backend, spmm_cuda


class CsrDevice(NamedTuple):
    """Device-resident graph: CSR for the kernel plus the COO row ids of the
    plain version.  Edges are in the row-sorted order of graph/build.py."""

    rowptr: torch.Tensor   # int32 [n + 1]
    rows: torch.Tensor     # int32 [nnz]
    cols: torch.Tensor     # int32 [nnz]
    vals: torch.Tensor     # float32 [nnz]
    heavy_rows: torch.Tensor   # int32: the rows with more than heavy_deg edges
    heavy_deg: int         # the kernel gives each of those rows a block
    n: int                 # graph dim; tables may carry extra (edge-free) rows


def device_graph(g, device="cuda", heavy_deg: int = spmm_cuda.HEAVY_DEG
                 ) -> CsrDevice:
    """Upload a host CooGraph (graph/build.py) as CSR on ``device``.  Rows
    with more than ``heavy_deg`` edges are listed for the kernel's block
    path; the kernel reads the threshold from the graph, so both paths
    split the rows at the same degree."""
    device = backend.resolve_device(device)
    rows = np.asarray(g.rows, np.int64)
    if rows.size and np.any(np.diff(rows) < 0):
        raise ValueError("CooGraph rows must be sorted ascending")
    counts = np.bincount(rows, minlength=int(g.n))
    rowptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    heavy = np.flatnonzero(counts > heavy_deg)
    return CsrDevice(rowptr=put(rowptr, np.int32), rows=put(rows, np.int32),
                     cols=put(g.cols, np.int32), vals=put(g.vals, np.float32),
                     heavy_rows=put(heavy, np.int32), heavy_deg=int(heavy_deg),
                     n=int(g.n))


def spmm_reference(graph: CsrDevice, h: torch.Tensor) -> torch.Tensor:
    """``adj @ h``, plain: gather the source rows, scale, scatter-add.

    h: [n_rows >= graph.n, d].  Rows past ``graph.n`` have no edges and come
    out zero, as ``spmm_pallas._apply`` gives them."""
    gathered = h.index_select(0, graph.cols) * graph.vals[:, None]
    out = torch.zeros_like(h)
    return out.index_add_(0, graph.rows, gathered)


def gcn_propagate(graph: CsrDevice, h: torch.Tensor, n_layers: int
                  ) -> torch.Tensor:
    """LightGCN-style propagation in eval: mean of all layer outputs incl.
    the input (models/encoders.py:42-48).  Each hop is ``adj @ h`` on the
    device of ``h`` (ops/backend.spmm).  Train-mode dropout before each hop
    comes with the training slice of the port."""
    h_sum = h
    cur = h
    for _ in range(n_layers):
        cur = backend.spmm(graph, cur)
        h_sum = h_sum + cur
    return h_sum / (n_layers + 1)
