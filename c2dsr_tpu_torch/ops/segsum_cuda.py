"""Wrapper of the ordered segment sum kernel K7 (``csrc/segsum.cu``): the
backward of a table lookup, summing each id's gradient rows in the ids'
order and writing every table row once.

K7 ports no Pallas kernel.  The JAX package's lookup is ``jnp.take``, whose
gradient XLA computes deterministically; the port's lookup backward was
``index_add_``, which adds with atomics on the card, so a step was not
bitwise repeatable.  :func:`segsum` stable-sorts the ids (``torch.sort``),
then K7 finds each table row's segment of the sorted ids and sums its
gradient rows in sorted order, which the stable sort makes the input order:
the result is bitwise that of :func:`segsum_plain` on the CPU, which is
``index_add_`` (it adds in index order).

What bounds it on an H100: bytes, the gradient rows and ids read once and
the table's gradient written once (at FK shapes the 33 MB write of a
64,094 x 128 table, 0.01 ms at 3.35 TB/s).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from c2dsr_tpu_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _fn():
    f = build.library("segsum").segsum_f32
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def segsum_plain(ids: torch.Tensor, g: torch.Tensor, n_rows: int
                 ) -> torch.Tensor:
    """The plain version of K7: zeros [n_rows, d] with ``index_add_`` of g
    [n, d] at the n flat ids (the backward of ``index_select``)."""
    out = torch.zeros((n_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, ids.reshape(-1), g)


def segsum(ids: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``segsum_plain(ids, g, n_rows)`` by K7, bitwise.  ids: n ids in
    [0, n_rows) on the card (any integer type and shape); g: f32 [n, d] on
    the card, d % 4 == 0."""
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
    g = g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    sorted_ids, perm = torch.sort(ids.reshape(-1).to(torch.int32),
                                  stable=True)
    out = torch.empty((n_rows, d), dtype=torch.float32, device=g.device)
    # row starts (n_rows + 1 ints, rounded up to 16 bytes), then the
    # gradient rows in sorted order
    ws = torch.empty(-(-(n_rows + 1) // 4) * 4 + n * d, dtype=torch.float32,
                     device=g.device)
    err = _fn()(sorted_ids.data_ptr(), perm.data_ptr(), g.data_ptr(),
                out.data_ptr(), ws.data_ptr(), n, n_rows, d,
                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segsum launch failed: CUDA error {err}")
    segsum.launches += 1
    return out


segsum.launches = 0
