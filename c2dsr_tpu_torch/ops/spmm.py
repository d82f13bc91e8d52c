"""Sparse matrix-times-dense-table propagation (the GCN hot op).

The reference runs ``torch.spmm(adj, h)`` over the FULL item table
(models/encoders.py:42-48).  Here the row-sorted COO of ``graph/build.py``
becomes a CSR on the device, together with the CSR of its transpose.  On a
CUDA tensor each hop is the row-parallel CSR kernel (``ops/spmm_cuda.py``,
``csrc/spmm.cu``) inside an autograd Function: forward over A, backward
over Aᵀ.  On a CPU tensor it is the plain ``index_select``·vals +
``index_add_`` of :func:`spmm_reference`, differentiated by autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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
    t: Optional["CsrDevice"] = None   # the transpose (the hop's backward)


def _csr(rows, cols, vals, n: int, heavy_deg: int, device) -> CsrDevice:
    counts = np.bincount(rows, minlength=n)
    rowptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    heavy = np.flatnonzero(counts > heavy_deg)
    return CsrDevice(rowptr=put(rowptr, np.int32), rows=put(rows, np.int32),
                     cols=put(cols, np.int32), vals=put(vals, np.float32),
                     heavy_rows=put(heavy, np.int32), heavy_deg=int(heavy_deg),
                     n=n)


def device_graph(g, device="cuda", heavy_deg: int = spmm_cuda.HEAVY_DEG
                 ) -> CsrDevice:
    """Upload a host CooGraph (graph/build.py) as CSR on ``device``, with
    the CSR of its transpose in ``t``.  Rows with more than ``heavy_deg``
    edges are listed for the kernel's block path, in each CSR apart: the
    transpose of a row-normalised Zipf graph has heavy rows of its own (a
    popular item is everyone's neighbour).  The kernel reads the threshold
    from the graph, so both paths split the rows at the same degree."""
    device = backend.resolve_device(device)
    n = int(g.n)
    rows = np.asarray(g.rows, np.int64)
    cols = np.asarray(g.cols, np.int64)
    vals = np.asarray(g.vals, np.float32)
    if rows.size and np.any(np.diff(rows) < 0):
        raise ValueError("CooGraph rows must be sorted ascending")
    order = np.argsort(cols, kind="stable")
    t = _csr(cols[order], rows[order], vals[order], n, heavy_deg, device)
    return _csr(rows, cols, vals, n, heavy_deg, device)._replace(t=t)


def spmm_reference(graph: CsrDevice, h: torch.Tensor) -> torch.Tensor:
    """``adj @ h``, plain: gather the source rows, scale, scatter-add.

    h: [n_rows >= graph.n, d].  Rows past ``graph.n`` have no edges and come
    out zero, as ``spmm_pallas._apply`` gives them."""
    gathered = h.index_select(0, graph.cols) * graph.vals[:, None]
    out = torch.zeros_like(h)
    return out.index_add_(0, graph.rows, gathered)


def gcn_propagate(graph: CsrDevice, h: torch.Tensor, n_layers: int,
                  dropout: float = 0.0,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """LightGCN-style propagation: mean of all layer outputs incl. the input
    (models/encoders.py:42-48).  Each hop is ``adj @ h`` on the device of
    ``h`` (ops/backend.spmm).  With a ``generator`` (on h's device), train
    mode: dropout before each hop, as ``c2dsr_tpu/ops/spmm.py:131-135``
    has it, kept values divided by (1 - dropout); None is eval."""
    h_sum = h
    cur = h
    for _ in range(n_layers):
        if generator is not None and dropout > 0.0:
            keep = torch.rand(cur.shape, generator=generator,
                              device=cur.device) >= dropout
            cur = torch.where(keep, cur / (1.0 - dropout),
                              torch.zeros((), device=cur.device))
        cur = backend.spmm(graph, cur)
        h_sum = h_sum + cur
    return h_sum / (n_layers + 1)
