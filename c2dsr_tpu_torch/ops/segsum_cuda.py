"""Wrapper of the ordered segment sum kernel K7 (``csrc/segsum.cu``): the
backward of a table lookup, summing each id's gradient rows in the ids'
order and writing every table row once.

K7 ports no Pallas kernel.  The JAX package's lookup is ``jnp.take``, whose
gradient XLA computes deterministically; the port's lookup backward was
``index_add_``, which adds with atomics on the card, so a step was not
bitwise repeatable.  K7 adds each table row's non-zero gradient rows in
input order (a zero row is left out, which is exact), so the result is
bitwise that of :func:`segsum_plain` on the CPU, which is ``index_add_``
(it adds in index order).  No sort: one pass at full width marks the
non-zero rows and, for a large table, files each into its id's list of
``LIST_CAP`` slots; a warp a touched table row puts its list back in input
order and sums it, other warps write the untouched rows as zeros, and a
block a heavy row (more than ``LIST_CAP`` non-zero rows) finds its rows in
the marks in order.  A table of at most ``SMALL_ROWS`` rows takes that
block path for every row, with no counts or lists.  Two launches for a
small table, three for a large one.

What bounds it on an H100: bytes, the gradient rows and ids read once and
the table's gradient written once (at FK shapes the 33 MB write of a
64,095 x 128 table, 0.01 ms at 3.35 TB/s), or the longest chain of ordered
adds into one row (:func:`longest_chain`).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from c2dsr_tpu_torch.kernels import build

LIST_CAP = 32        # csrc/segsum.cu kCap: list slots a table row
SMALL_ROWS = 64      # tables up to this many rows take the block path only
_CACHE = 32          # workspaces kept (one per device, stream and shape)
_workspaces: "collections.OrderedDict" = collections.OrderedDict()


@functools.lru_cache(maxsize=None)
def _fn():
    f = build.library("segsum").segsum_f32
    f.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


@functools.lru_cache(maxsize=None)
def _init(device_index: int) -> None:
    """Lets the scan kernel take its shared memory, once a device."""
    with torch.cuda.device(device_index):
        err = build.library("segsum").segsum_init()
    if err != 0:
        raise RuntimeError(f"segsum_init failed: CUDA error {err}")


def workspace(device: torch.device, stream: int, n: int, n_rows: int):
    """The call's workspace, made once per (device, stream, n, n_rows) and
    kept: int32 (keys, counts, lists, heavy, touched, ctr).  keys: the
    marks, n rounded up to 4, the tail -1.  For a large table the counts
    (zero between calls), the lists of ``LIST_CAP`` slots a row, the heavy
    list, the touched list (-1 between calls) and the counters (zero between
    calls); each call leaves them as it found them.  None where the
    small-table path needs none."""
    return _workspace(device, stream, n, n_rows)[0]


def _workspace(device: torch.device, stream: int, n: int, n_rows: int):
    """(workspace, the kernels' pointers into it)."""
    key = (device.index, stream, n, n_rows)
    entry = _workspaces.get(key)
    if entry is not None:
        _workspaces.move_to_end(key)
        return entry

    def ints(size, fill):
        return torch.full((size,), fill, dtype=torch.int32, device=device)

    keys = ints(-(-max(n, 1) // 4) * 4, -1)
    if n_rows <= SMALL_ROWS:
        ws = (keys, None, None, None, None, None)
    else:
        ws = (keys, ints(n_rows, 0),
              torch.empty(n_rows * LIST_CAP, dtype=torch.int32,
                          device=device),
              torch.empty(n // (LIST_CAP + 1) + 1, dtype=torch.int32,
                          device=device),
              ints(max(min(n, n_rows), 1), -1), ints(4, 0))
    entry = ws, tuple(None if t is None else t.data_ptr() for t in ws)
    _workspaces[key] = entry
    while len(_workspaces) > _CACHE:
        _workspaces.popitem(last=False)
    return entry


def segsum_plain(ids: torch.Tensor, g: torch.Tensor, n_rows: int
                 ) -> torch.Tensor:
    """The plain version of K7: zeros [n_rows, d] with ``index_add_`` of g
    [n, d] at the n flat ids (the backward of ``index_select``)."""
    out = torch.zeros((n_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, ids.reshape(-1), g)


def longest_chain(ids: torch.Tensor, g: torch.Tensor, n_rows: int) -> int:
    """The most non-zero gradient rows (sign bits aside) that one table row
    adds in order: the length of K7's longest chain of dependent adds."""
    live = (g.view(torch.int32) & 0x7fffffff).ne(0).any(1)
    flat = ids.reshape(-1)[live].long()
    return int(torch.bincount(flat, minlength=n_rows).max()) if flat.numel() \
        else 0


def segsum(ids: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``segsum_plain(ids, g, n_rows)`` by K7, bitwise.  ids: n ids in
    [0, n_rows) on the card (any shape; int64 is read as it is, another
    integer type is converted first); g: f32 [n, d] on the card, d % 4 ==
    0, contiguous and 16-byte aligned (as autograd's gradients are).  The
    workspace is kept per stream: calls on one stream are ordered, so they
    may share it."""
    if not g.is_cuda:
        raise ValueError("segsum takes CUDA tensors only")
    n = ids.numel()
    if (g.dtype != torch.float32 or g.dim() != 2 or g.shape[0] != n
            or ids.device != g.device):
        raise ValueError(f"segsum takes f32 g [n, d] and n ids on its device, "
                         f"got g {g.dtype} {tuple(g.shape)} and {n} ids")
    d = g.shape[1]
    if d % 4 or d == 0 or n_rows <= 0 or n_rows >= 2 ** 31 - 1 \
            or n >= 2 ** 31:
        raise ValueError(f"segsum needs d % 4 == 0 and int32 counts; got "
                         f"d={d} n={n} n_rows={n_rows}")
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("segsum needs g contiguous and 16-byte aligned")
    flat = ids.reshape(-1).long().contiguous()
    device = g.device
    _init(device.index)
    stream = torch.cuda.current_stream(device).cuda_stream
    _, ptrs = _workspace(device, stream, n, n_rows)
    out = torch.empty((n_rows, d), dtype=torch.float32, device=device)
    err = _fn()(flat.data_ptr(), g.data_ptr(), out.data_ptr(), *ptrs, n,
                n_rows, d, stream)
    if err != 0:
        # a failed launch may leave counts behind: the next call starts anew
        _workspaces.pop((device.index, stream, n, n_rows), None)
        raise RuntimeError(f"segsum launch failed: CUDA error {err}")
    segsum.launches += 1
    return out


segsum.launches = 0
