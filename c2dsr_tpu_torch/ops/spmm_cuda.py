"""Wrapper of the CSR SpMM kernel (``csrc/spmm.cu``): ``out = A @ h``, and
the hop's autograd Function, whose backward is the same kernel over the
CSR of Aᵀ (``graph.t``).

Replaces the blocked SpMM Pallas kernel of the JAX package
(``c2dsr_tpu/ops/spmm_pallas.py`` ``blocked_spmm_impl`` / ``_kernel``).
That kernel gathered ``h[cols]·vals`` into an [nnz, d] buffer in XLA and
reduced 128-edge chunks into 256-row blocks with a one-hot MXU matmul; both
the chunking and the one-hot reduce are devices of the TPU's matrix unit.
Its backward (``make_blocked_spmm``'s vjp, ``spmm_pallas.py:224-225``) ran
the same kernel over a prepared transpose; here :func:`hop` does the same
with the transpose CSR that ``ops/spmm.device_graph`` packs.

What bounds it on an H100: bytes.  A hop reads each referenced table row
(d·4 bytes) and writes each output row once; the arithmetic (2·nnz·d
FLOPs) is negligible.  Design: a warp accumulates a row's edges in CSR
order, each lane owning 4 contiguous features (one 16-byte gather per edge,
8 gathers in flight), and stores once: no [nnz, d] intermediate, no
atomics, a deterministic result.  Degrees are Zipf-skewed (the FK graph's
largest row has 5,445 edges), so a row with more than ``graph.heavy_deg``
edges (``HEAVY_DEG`` by default) gets a whole block whose 32 warps sum 32
contiguous segments, added in order; ``device_graph`` lists those rows once
per graph, and the threshold travels with the list.
"""

from __future__ import annotations

import ctypes

import torch

from c2dsr_tpu_torch.kernels import build

# default of device_graph's heavy_deg: rows with more edges than this get
# a block each (see csrc/spmm.cu)
HEAVY_DEG = 128
_SIG = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _fn():
    f = build.library("spmm").spmm_csr_f32
    f.argtypes = _SIG
    f.restype = ctypes.c_int
    return f


def spmm_csr(graph, h: torch.Tensor) -> torch.Tensor:
    """``adj @ h`` by the CUDA kernel.  h: [n_rows >= graph.n, d] f32 CUDA,
    contiguous, d % 4 == 0.  Rows past ``graph.n`` come out zero."""
    if not h.is_cuda:
        raise ValueError("spmm_csr takes CUDA tensors only")
    if h.dtype != torch.float32 or h.dim() != 2:
        raise ValueError(f"spmm_csr takes f32 [n, d], got {h.dtype} "
                         f"{tuple(h.shape)}")
    n_rows, d = h.shape
    if d % 4 or d == 0:
        raise ValueError(f"spmm_csr needs d % 4 == 0, got d={d}")
    if n_rows < graph.n:
        raise ValueError(f"table has {n_rows} rows < graph dim {graph.n}")
    for t in (h, graph.rowptr, graph.cols, graph.vals, graph.heavy_rows):
        if t.device != h.device or not t.is_contiguous():
            raise ValueError("h and the graph arrays must be contiguous on "
                             "one device")
    out = torch.empty_like(h)
    err = _fn()(graph.rowptr.data_ptr(), graph.cols.data_ptr(),
                graph.vals.data_ptr(), graph.heavy_rows.data_ptr(),
                h.data_ptr(), out.data_ptr(), graph.heavy_rows.numel(),
                graph.heavy_deg, graph.n, n_rows, d,
                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmm_csr launch failed: CUDA error {err}")
    spmm_csr.launches += 1
    return out


spmm_csr.launches = 0


class _Hop(torch.autograd.Function):
    """``A @ h`` by :func:`spmm_csr`; its backward ``Aᵀ @ g`` by the same
    kernel over ``graph.t``.  Rows of the table past ``graph.n`` have no
    edge in Aᵀ either, so their gradient is zero."""

    @staticmethod
    def forward(ctx, h, graph):
        ctx.graph = graph
        return spmm_csr(graph, h)

    @staticmethod
    def backward(ctx, g):
        return spmm_csr(ctx.graph.t, g.contiguous()), None


def hop(graph, h: torch.Tensor) -> torch.Tensor:
    """One differentiable hop ``A @ h`` on a CUDA tensor."""
    if not (torch.is_grad_enabled() and h.requires_grad):
        return spmm_csr(graph, h)
    if graph.t is None:
        raise ValueError("the graph carries no transpose (device_graph "
                         "packs it)")
    return _Hop.apply(h, graph)
