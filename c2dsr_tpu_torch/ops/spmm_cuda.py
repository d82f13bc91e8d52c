"""Wrappers of the CSR SpMM kernels (``csrc/spmm.cu``): the dense hop
``out = A @ h`` (K1) and the batch-sparse hop (K6), each with the hop's
autograd Function, whose backward is the same kernel over the CSR of Aᵀ
(``graph.t``).

Replaces the blocked SpMM Pallas kernel of the JAX package
(``c2dsr_tpu/ops/spmm_pallas.py`` ``blocked_spmm_impl`` / ``_kernel``).
That kernel gathered ``h[cols]·vals`` into an [nnz, d] buffer in XLA and
reduced 128-edge chunks into 256-row blocks with a one-hot MXU matmul; both
the chunking and the one-hot reduce are devices of the TPU's matrix unit.
Its backward (``make_blocked_spmm``'s vjp, ``spmm_pallas.py:224-225``) ran
the same kernel over a prepared transpose; here :func:`hop` does the same
with the transpose CSR that ``ops/spmm.device_graph`` packs.  The flagged
variant (``make_blocked_spmm_flagged``, ``spmm_pallas.py:231-264``) masked
edges by a row flag, by the output row in the forward and by the gathered
row in the backward; :func:`flagged_hop` does that with K6.

What bounds them on an H100: bytes.  A hop reads each referenced table row
(d·4 bytes) and writes each output row once; the arithmetic (2·nnz·d
FLOPs) is negligible.  Design: ``ops/spmm.plan`` cuts each CSR once into
warp tasks of at most ``graph.heavy_deg`` edges (``HEAVY_DEG`` by default):
a run of up to 32 whole consecutive rows, or a segment of a row with more
edges.  A warp walks its task's edges in CSR order across row ends, with
the gathers of 4 / NC edges in flight a lane (each lane holds NC float4 of
a row: one pass over the edges at any d up to 1,024), and stores each row
once; a split row's segment sums go to scratch rows that a second kernel
adds, a block a row, in an order fixed by the graph.  No [nnz, d]
intermediate, no atomics, a deterministic result.  K6 is the same kernels
instantiated per mode: "dest" writes an unflagged output row as zeros with
no gathers; "src" keeps a 32-edge window's flagged edges by a ballot and
gathers only those.  The bytes it
saves are the gathers of the edges it drops.

``bf16=True`` (``compute_dtype="bfloat16"``) selects the bf16
instantiations of both: the JAX Pallas SpMM's bf16 gather, each product
bf16(bf16(h[col])·bf16(val)) and the sums f32, reading the same f32 table.
Their launches count apart (``launches_bf16``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from c2dsr_tpu_torch.kernels import build

# default of device_graph's heavy_deg: the most edges a warp task sums; a
# row with more is split into segments (see csrc/spmm.cu)
HEAVY_DEG = 32
D_MULTIPLE = 4      # the widths the kernels take (the callers pad to it)
_SIG = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
_FLAGGED_SIG = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                + [ctypes.c_int] + [ctypes.c_void_p] * 4
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_MODES = {"dest": 1, "src": 2}     # csrc/spmm.cu kDest, kSrc


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    f = getattr(build.library("spmm"), name)
    f.argtypes = _FLAGGED_SIG if "flagged" in name else _SIG
    f.restype = ctypes.c_int
    return f


def _check(graph, h: torch.Tensor, name: str, n_out=None):
    """h against what the kernel takes; the graph's arrays are as
    ``ops/spmm.device_graph`` or ``rect_graph`` make them (contiguous, on one
    device, every column a row of h)."""
    if not h.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors only")
    if h.dtype != torch.float32 or h.dim() != 2:
        raise ValueError(f"{name} takes f32 [n, d], got {h.dtype} "
                         f"{tuple(h.shape)}")
    n_rows, d = h.shape
    if d % D_MULTIPLE or d == 0:
        raise ValueError(f"{name} needs d % {D_MULTIPLE} == 0, got d={d}")
    if (n_rows if n_out is None else n_out) < graph.n:
        raise ValueError(f"output of {n_rows if n_out is None else n_out} "
                         f"rows < graph dim {graph.n}")
    if graph.tasks.device != h.device:
        raise ValueError("h and the graph must be on one device")
    if not h.is_contiguous() or h.data_ptr() % 16:
        raise ValueError(f"{name} needs h contiguous and 16-byte aligned")
    return n_rows, d


def _outputs(graph, h: torch.Tensor, n_rows: int):
    """The output [n_rows, d] and the split rows' scratch partial rows, in
    one allocation (the output a view of its first rows)."""
    d = h.shape[1]
    buf = torch.empty((n_rows + graph.n_part, d), dtype=h.dtype,
                      device=h.device)
    return buf[:n_rows], buf[n_rows:]


def _graph_args(graph):
    return (graph.tasks.data_ptr(), graph.tasks.shape[0],
            graph.rowptr.data_ptr(), graph.cols.data_ptr(),
            graph.vals.data_ptr(), graph.heavy_rows.data_ptr(),
            graph.heavy_slots.data_ptr(), graph.heavy_rows.numel())


def spmm_csr(graph, h: torch.Tensor, n_out=None, bf16: bool = False
             ) -> torch.Tensor:
    """``adj @ h`` by the CUDA kernel.  h: [n_rows >= graph.n, d] f32 CUDA,
    contiguous, 16-byte aligned, d % 4 == 0.  The output has ``n_out`` rows
    (h's row count by default; a rectangular graph's rows, ``rect_graph``);
    rows past ``graph.n`` come out zero.  ``bf16``: the bf16 gather."""
    n_rows, d = _check(graph, h, "spmm_csr", n_out)
    n_out = n_rows if n_out is None else n_out
    out, part = _outputs(graph, h, n_out)
    err = _fn("spmm_csr_bf16" if bf16 else "spmm_csr_f32")(
        *_graph_args(graph), h.data_ptr(), out.data_ptr(), part.data_ptr(),
        graph.n, n_out, d, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmm_csr launch failed: CUDA error {err}")
    if bf16:
        spmm_csr.launches_bf16 += 1
    else:
        spmm_csr.launches += 1
    return out


spmm_csr.launches = 0
spmm_csr.launches_bf16 = 0


def spmm_csr_flagged(graph, h: torch.Tensor, flag: torch.Tensor,
                     flag_on: str, bf16: bool = False) -> torch.Tensor:
    """The batch-sparse hop by the CUDA kernel (K6).  h as for
    :func:`spmm_csr`; flag: uint8 [n_rows] 0/1, one entry per table row.

    flag_on="dest": rows of ``adj @ h`` where the flag is set, zeros
    elsewhere.  flag_on="src": ``adj @ h`` over the edges whose gathered row
    is flagged, which is ``adj @ h`` itself where h is zero off the flags.
    ``bf16``: the bf16 gather."""
    n_rows, d = _check(graph, h, "spmm_csr_flagged")
    if flag_on not in _MODES:
        raise ValueError(f"flag_on must be 'dest' or 'src', got {flag_on!r}")
    if (flag.dtype != torch.uint8 or tuple(flag.shape) != (n_rows,)
            or flag.device != h.device or not flag.is_contiguous()):
        raise ValueError(f"flag must be contiguous uint8 [{n_rows}] on h's "
                         f"device, got {flag.dtype} {tuple(flag.shape)}")
    out, part = _outputs(graph, h, n_rows)
    err = _fn("spmm_csr_flagged_bf16" if bf16 else "spmm_csr_flagged_f32")(
        *_graph_args(graph), flag.data_ptr(), h.data_ptr(), out.data_ptr(),
        part.data_ptr(), graph.n, n_rows, d, _MODES[flag_on],
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmm_csr_flagged launch failed: CUDA error "
                           f"{err}")
    if bf16:
        spmm_csr_flagged.launches_bf16 += 1
    else:
        spmm_csr_flagged.launches += 1
    return out


spmm_csr_flagged.launches = 0
spmm_csr_flagged.launches_bf16 = 0


class _Hop(torch.autograd.Function):
    """``A @ h`` by :func:`spmm_csr`; its backward ``Aᵀ @ g`` by the same
    kernel over ``graph.t``, into h's rows.  Rows of the table past
    ``graph.n`` have no edge in Aᵀ either, so their gradient is zero."""

    @staticmethod
    def forward(ctx, h, graph, n_out, bf16):
        ctx.graph = graph
        ctx.n_in = h.shape[0]
        ctx.bf16 = bf16
        return spmm_csr(graph, h, n_out, bf16=bf16)

    @staticmethod
    def backward(ctx, g):
        return (spmm_csr(ctx.graph.t, g.contiguous(), ctx.n_in,
                         bf16=ctx.bf16), None, None, None)


class _FlaggedHop(torch.autograd.Function):
    """The batch-sparse hop: forward K6 over A with ``flag_on="dest"``,
    backward K6 over ``graph.t`` with ``flag_on="src"``.  The incoming
    gradient is zero on the unflagged rows, which the forward wrote as
    zeros and nothing reads, so the backward's masked edges would add
    zeros: the gradient is the dense one.  The flag gets no gradient."""

    @staticmethod
    def forward(ctx, h, flag, graph, bf16):
        ctx.graph = graph
        ctx.bf16 = bf16
        ctx.save_for_backward(flag)
        return spmm_csr_flagged(graph, h, flag, "dest", bf16=bf16)

    @staticmethod
    def backward(ctx, g):
        (flag,) = ctx.saved_tensors
        return (spmm_csr_flagged(ctx.graph.t, g.contiguous(), flag, "src",
                                 bf16=ctx.bf16),
                None, None, None)


def _check_transpose(graph) -> None:
    if graph.t is None:
        raise ValueError("the graph carries no transpose (device_graph "
                         "packs it)")


def hop(graph, h: torch.Tensor, n_out=None, bf16: bool = False
        ) -> torch.Tensor:
    """One differentiable hop ``A @ h`` on a CUDA tensor, into ``n_out``
    rows (h's row count by default); ``bf16``: the bf16 gather, forward and
    backward."""
    if not (torch.is_grad_enabled() and h.requires_grad):
        return spmm_csr(graph, h, n_out, bf16=bf16)
    _check_transpose(graph)
    return _Hop.apply(h, graph, n_out, bf16)


def flagged_hop(graph, h: torch.Tensor, flag: torch.Tensor,
                bf16: bool = False) -> torch.Tensor:
    """One differentiable batch-sparse hop on a CUDA tensor: ``A @ h`` on
    the flagged rows, zeros elsewhere (see :func:`spmm_csr_flagged`);
    ``bf16``: the bf16 gather, forward and backward."""
    if not (torch.is_grad_enabled() and h.requires_grad):
        return spmm_csr_flagged(graph, h, flag, "dest", bf16=bf16)
    _check_transpose(graph)
    return _FlaggedHop.apply(h, flag, graph, bf16)
