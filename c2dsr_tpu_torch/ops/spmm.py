"""Sparse matrix-times-dense-table propagation (the GCN hot op).

The reference runs ``torch.spmm(adj, h)`` over the FULL item table
(models/encoders.py:42-48).  Here the row-sorted COO of ``graph/build.py``
becomes a CSR on the device, together with the CSR of its transpose, each
with the plan of warp tasks its kernel walks (:func:`plan`).  On a CUDA
tensor each hop is the CSR kernel (``ops/spmm_cuda.py``, ``csrc/spmm.cu``)
inside an autograd Function: forward over A, backward over Aᵀ.  On a CPU
tensor it is the plain ``index_select``·vals + ``index_add_`` of
:func:`spmm_reference`, differentiated by autograd.  The batch-sparse hop
(a row flag on the last hop of a training step) is K6 on the card and
:func:`spmm_reference_flagged` on the CPU.

A bf16 gather (``gcn_propagate``'s ``gather_dtype=torch.bfloat16``, under
``compute_dtype="bfloat16"``) is the JAX Pallas SpMM's: each gathered
product bf16(bf16(h[col])·bf16(val)), the sum in f32
(``c2dsr_tpu/ops/spmm_pallas.py:166-172``), in the forward, over Aᵀ in the
backward and in the flagged hop; the JAX package applies it where its
Pallas SpMM runs (d % 128 == 0), the port at every width.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from c2dsr_tpu_torch.ops import backend, spmm_cuda
from c2dsr_tpu_torch.ops.bf16 import round_bf16


class CsrDevice(NamedTuple):
    """Device-resident graph: CSR for the kernel, its plan of warp tasks,
    and the COO row ids of the plain version.  Edges are in the row-sorted
    order of graph/build.py."""

    rowptr: torch.Tensor   # int32 [n + 1]
    rows: torch.Tensor     # int32 [nnz]
    cols: torch.Tensor     # int32 [nnz]
    vals: torch.Tensor     # float32 [nnz]
    heavy_rows: torch.Tensor   # int32: the rows with more than heavy_deg edges
    heavy_deg: int         # the plan's budget, the most edges a warp task
                           # sums: a record of how tasks was made (no kernel
                           # reads it)
    run_rows: int          # its other budget, the most whole rows a task
                           # takes (a record too)
    n: int                 # graph dim; tables may carry extra (edge-free) rows
    tasks: torch.Tensor    # int32 [n_tasks, 4], the plan
    heavy_slots: torch.Tensor  # int32 [len(heavy_rows) + 1]
    n_part: int            # the split rows' partial rows (heavy_slots[-1])
    t: Optional["CsrDevice"] = None   # the transpose (the hop's backward)
    a2a: object = None     # a model rank's exchange schedule
                           # (parallel/embed.RankPlan, attach_a2a_plan)


RUN_ROWS = 32          # default of plan's run_rows: whole rows a task at
                       # most, also its bound: csrc/spmm.cu reads a task's
                       # row ends one a lane of a warp


def plan(rowptr: np.ndarray, budget: int, run_rows: int = RUN_ROWS):
    """The kernel's plan of warp tasks over a CSR (``csrc/spmm.cu``), in row
    order.  A task is (r0, n, e0, e1): rows [r0, r0 + n) whole, up to
    ``run_rows`` of them, whose edges [e0, e1) number at most ``budget``; or
    (r0, -1 - slot, e0, e1): one of the near-equal contiguous segments of a
    row with more than ``budget`` edges, summed into partial row ``slot``.
    Returns (tasks int32 [n_tasks, 4], heavy_rows int32 [h]: the split rows,
    heavy_slots int32 [h + 1]: the first partial row of each, then their
    count).  The kernel adds a split row's partials in 8 contiguous runs,
    each in segment order, then the runs in order."""
    if budget < 1:
        raise ValueError(f"heavy_deg must be >= 1, got {budget}")
    if not 1 <= run_rows <= RUN_ROWS:
        raise ValueError(f"run_rows must be in 1..{RUN_ROWS} (the kernel "
                         f"reads a task's row ends one a lane), got "
                         f"{run_rows}")
    ends = np.asarray(rowptr, np.int64).tolist()
    n = len(ends) - 1
    tasks, heavy, slots = [], [], [0]
    r = 0
    while r < n:
        deg = ends[r + 1] - ends[r]
        if deg > budget:
            k = -(-deg // budget)
            cut = [ends[r] + i * deg // k for i in range(k + 1)]
            tasks += [(r, -1 - (slots[-1] + i), cut[i], cut[i + 1])
                      for i in range(k)]
            heavy.append(r)
            slots.append(slots[-1] + k)
            r += 1
            continue
        r0, edges = r, 0
        while r < n and r - r0 < run_rows:
            deg = ends[r + 1] - ends[r]
            if deg > budget or edges + deg > budget:
                break
            edges += deg
            r += 1
        tasks.append((r0, r - r0, ends[r0], ends[r]))
    return (np.asarray(tasks, np.int32).reshape(-1, 4),
            np.asarray(heavy, np.int32), np.asarray(slots, np.int32))


def _csr(rows, cols, vals, n: int, heavy_deg: int, run_rows: int, device
         ) -> CsrDevice:
    counts = np.bincount(rows, minlength=n)
    rowptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    tasks, heavy, slots = plan(rowptr, heavy_deg, run_rows)
    return CsrDevice(rowptr=put(rowptr, np.int32), rows=put(rows, np.int32),
                     cols=put(cols, np.int32), vals=put(vals, np.float32),
                     heavy_rows=put(heavy, np.int32), heavy_deg=int(heavy_deg),
                     run_rows=int(run_rows), n=n, tasks=put(tasks, np.int32),
                     heavy_slots=put(slots, np.int32), n_part=int(slots[-1]))


def device_graph(g, device="cuda", heavy_deg: int = spmm_cuda.HEAVY_DEG,
                 run_rows: int = RUN_ROWS) -> CsrDevice:
    """Upload a host CooGraph (graph/build.py) as CSR on ``device``, with
    the CSR of its transpose in ``t``, each with the kernel's plan
    (:func:`plan`): warp tasks of at most ``heavy_deg`` edges and
    ``run_rows`` whole rows, and the rows with more edges split into
    segments.  The transpose of a row-normalised Zipf graph has heavy rows
    of its own (a popular item is everyone's neighbour), so each CSR has
    its own plan."""
    device = backend.resolve_device(device)
    n = int(g.n)
    rows = np.asarray(g.rows, np.int64)
    cols = np.asarray(g.cols, np.int64)
    vals = np.asarray(g.vals, np.float32)
    if rows.size and np.any(np.diff(rows) < 0):
        raise ValueError("CooGraph rows must be sorted ascending")
    order = np.argsort(cols, kind="stable")
    t = _csr(cols[order], rows[order], vals[order], n, heavy_deg, run_rows,
             device)
    return _csr(rows, cols, vals, n, heavy_deg, run_rows, device)._replace(
        t=t)


def rect_graph(rows, cols, vals, n_out: int, n_in: int, device="cuda",
               heavy_deg: int = spmm_cuda.HEAVY_DEG,
               run_rows: int = RUN_ROWS) -> CsrDevice:
    """A rectangular [n_out, n_in] CSR (rows ascending), with the CSR of its
    transpose in ``t``, each with K1's plan: the local sum of a sharded
    propagation over a received buffer (``parallel/embed.py``)."""
    device = backend.resolve_device(device)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    if rows.size and (np.any(np.diff(rows) < 0) or rows[-1] >= n_out
                      or cols.max() >= n_in or cols.min() < 0):
        raise ValueError("rect_graph takes ascending rows < n_out and "
                         "columns < n_in")
    order = np.argsort(cols, kind="stable")
    t = _csr(cols[order], rows[order], vals[order], n_in, heavy_deg,
             run_rows, device)
    return _csr(rows, cols, vals, n_out, heavy_deg, run_rows,
                device)._replace(t=t)


def rect_spmm(graph: CsrDevice, h: torch.Tensor) -> torch.Tensor:
    """``A @ h`` into the ``graph.n`` rows of a :func:`rect_graph`: K1 (and
    its backward over ``graph.t``) on a CUDA tensor, the plain version on a
    CPU one.  f32 gathers: the sharded propagation stays f32, as in the JAX
    package (``c2dsr_tpu/parallel/strategy.py:106-127``)."""
    if h.is_cuda:
        return backend.spmm_kernels(graph, h, n_out=graph.n)
    return spmm_reference(graph, h, n_out=graph.n)


def attach_a2a_plan(graph: CsrDevice, n_rows_padded: int, n_shards: int,
                    index: int) -> CsrDevice:
    """The graph with model rank ``index``'s part of the all-to-all
    schedule of the sharded propagation (``c2dsr_tpu/ops/spmm.py:42-53``).
    ``n_rows_padded`` is the padded table row count (config.padded_sizes),
    so that the schedule's row blocks are the tables' shards."""
    from c2dsr_tpu_torch.parallel import embed
    plan = embed.plan_spmm_a2a(graph.rows.cpu().numpy(),
                               graph.cols.cpu().numpy(),
                               graph.vals.cpu().numpy(), n_rows_padded,
                               n_shards)
    return graph._replace(a2a=embed.rank_plan(plan, index,
                                              graph.rows.device))


def _flag_mask(graph: CsrDevice, flag: torch.Tensor, flag_on: str
               ) -> torch.Tensor:
    """The edge weights with the edges masked (0) whose output row
    (``"dest"``) or gathered row (``"src"``) is unflagged."""
    if flag_on not in ("dest", "src"):
        raise ValueError(f"flag_on must be 'dest' or 'src', got {flag_on!r}")
    probe = graph.rows if flag_on == "dest" else graph.cols
    return graph.vals * (flag.index_select(0, probe) != 0)


def _hop_bf16(graph: CsrDevice, h: torch.Tensor, n_out: int,
              vals: torch.Tensor) -> torch.Tensor:
    """The bf16 gather's hop, no autograd: out[row] = the f32 sum of
    bf16(bf16(h[col])·bf16(val)) over the row's edges (the product of two
    bf16 values is exact in f32, then rounded once, as a bf16 multiply)."""
    gathered = round_bf16(round_bf16(h).index_select(0, graph.cols)
                          * round_bf16(vals)[:, None])
    out = h.new_zeros((n_out, h.shape[1]))
    return out.index_add_(0, graph.rows, gathered)


class _Bf16Hop(torch.autograd.Function):
    """The plain bf16 hop ``A @ h`` (flagged "dest" with a flag); its
    backward the same hop over ``graph.t`` ("src" with the flag), whose sum
    stays f32 where autograd through a bf16 gather would sum in bf16: the
    JAX package's backward (``spmm_pallas.py:224-225,259-261``)."""

    @staticmethod
    def forward(ctx, h, graph, n_out, flag):
        ctx.graph, ctx.n_in, ctx.flag = graph, h.shape[0], flag
        vals = graph.vals if flag is None else _flag_mask(graph, flag,
                                                          "dest")
        return _hop_bf16(graph, h, n_out, vals)

    @staticmethod
    def backward(ctx, g):
        t = ctx.graph.t
        if t is None:
            raise ValueError("the graph carries no transpose (device_graph "
                             "packs it)")
        vals = t.vals if ctx.flag is None else _flag_mask(t, ctx.flag, "src")
        return _hop_bf16(t, g, ctx.n_in, vals), None, None, None


def spmm_reference(graph: CsrDevice, h: torch.Tensor, n_out=None,
                   bf16: bool = False) -> torch.Tensor:
    """``adj @ h``, plain: gather the source rows, scale, scatter-add.

    h: [n_rows >= graph.n, d]; the output has ``n_out`` rows (h's by
    default).  Rows past ``graph.n`` have no edges and come out zero, as
    ``spmm_pallas._apply`` gives them.  ``bf16``: the bf16 gather (module
    docstring), summed in h's dtype, its backward over ``graph.t``."""
    n_out = h.shape[0] if n_out is None else n_out
    if bf16:
        return _Bf16Hop.apply(h, graph, n_out, None)
    gathered = h.index_select(0, graph.cols) * graph.vals[:, None]
    out = h.new_zeros((n_out, h.shape[1]))
    return out.index_add_(0, graph.rows, gathered)


def spmm_reference_flagged(graph: CsrDevice, h: torch.Tensor,
                           flag: torch.Tensor, flag_on: str = "dest",
                           bf16: bool = False) -> torch.Tensor:
    """The batch-sparse hop, plain: :func:`spmm_reference` with the edges
    masked (weight 0) whose output row (``flag_on="dest"``) or gathered row
    (``flag_on="src"``) is unflagged, as ``spmm_pallas.blocked_spmm_impl``
    masks them.  flag: 0/1 [n_rows], one entry per table row.

    In "dest" mode unflagged rows come out zero.  Autograd's gradient of the
    "dest" mode is this function in "src" mode over the CSR of Aᵀ: the
    backward of ``make_blocked_spmm_flagged`` (``spmm_pallas.py:259-261``)
    and what K6 computes there.  ``bf16``: the bf16 gather (module
    docstring); "dest" then differentiates by the "src" hop over
    ``graph.t``."""
    if bf16 and flag_on == "dest":
        return _Bf16Hop.apply(h, graph, h.shape[0], flag)
    w = _flag_mask(graph, flag, flag_on)
    if bf16:
        return _hop_bf16(graph, h, h.shape[0], w)
    gathered = h.index_select(0, graph.cols) * w[:, None]
    out = torch.zeros_like(h)
    return out.index_add_(0, graph.rows, gathered)


def gcn_propagate(graph: CsrDevice, h: torch.Tensor, n_layers: int,
                  dropout: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  out_flag: Optional[torch.Tensor] = None,
                  gather_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LightGCN-style propagation: mean of all layer outputs incl. the input
    (models/encoders.py:42-48).  Each hop is ``adj @ h`` on the device of
    ``h`` (ops/backend.spmm).  With a ``generator`` (on h's device), train
    mode: dropout before each hop, as ``c2dsr_tpu/ops/spmm.py:131-135``
    has it, kept values divided by (1 - dropout); None is eval.

    out_flag (training): uint8 [n_rows] 0/1 marker of the rows the caller
    will read from the result, applied to the last hop only, as
    ``c2dsr_tpu/ops/spmm.py:112-118,136-137`` applies it: earlier hops feed
    later hops' gathers at arbitrary rows, so they stay dense.  Unmarked
    rows of the result must not be read; every marked row and every
    gradient equals the dense propagation's.

    gather_dtype (``c2dsr_tpu/ops/spmm.py:98-128``): torch.bfloat16 takes
    every hop's bf16 gather (module docstring), K1/K6's bf16
    instantiations on the card; the hops' sums and the layer mean stay in
    h's dtype."""
    if gather_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gather_dtype must be float32 or bfloat16, got "
                         f"{gather_dtype}")
    bf16 = gather_dtype == torch.bfloat16
    h_sum = h
    cur = h
    for i in range(n_layers):
        if generator is not None and dropout > 0.0:
            keep = torch.rand(cur.shape, generator=generator,
                              device=cur.device) >= dropout
            cur = torch.where(keep, cur / (1.0 - dropout),
                              torch.zeros((), device=cur.device))
        if out_flag is not None and i == n_layers - 1:
            cur = backend.spmm(graph, cur, out_flag, bf16)
        else:
            cur = backend.spmm(graph, cur, bf16=bf16)
        h_sum = h_sum + cur
    return h_sum / (n_layers + 1)
