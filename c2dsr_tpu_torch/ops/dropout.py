"""Counter-based dropout keep masks, shared by the CUDA kernels and their
plain versions.

The Pallas encoder draws its masks from the TPU's per-core PRNG
(``c2dsr_tpu/ops/encoder_pallas.py`` ``_keep_mask``), a stream that exists
nowhere else.  Here the keep decision is a pure function of
(seed, site, tower, layer, element index):

    key  = mix32(seed ^ mix32(site + 8 * layer + 1024 * tower + GOLDEN))
    bits = mix32((index * GOLDEN mod 2^32) ^ key)
    keep = bits >= min(floor(p * 2^32), 2^32 - 1)

``mix32`` is the 32-bit MurmurHash3 finaliser.  ``csrc/dropout.cuh``
computes the same bits in the kernels, so a kernel and its plain version
draw bit-identical masks, and a backward regenerates its forward's masks
with no mask in device memory.  ``index`` is the row-major flat index of
the element in the site's tensor for one tower call: [B, L, d] for the
input, out-projection and FFN sites, [B, H, L, L] for the attention
probabilities.  Kept values are divided by (1 - p), as ``_dropout`` of
``c2dsr_tpu/ops/encoder.py`` scales them.

A data-parallel step must not draw the same masks on every data rank: with
``index`` the flat index within one tower call, rank r's local row i would
share its bits with every other rank's row i.  So the index is that of the
run's global batch: a ``row_map`` (offset, seg, stride) says that the call's
batch row b is global row (b // seg) * stride + offset + b % seg, and
``index`` is the element's flat index in that row of the global tensor.  A
rank holding rows [offset, offset + m) of a batch of B rows passes
:func:`row_map` (offset, m, B); the shared tower, which stacks three
sequences of a batch row, keeps its stacking, segment by segment.  With the
map, the masks of a data-parallel step are those of the one-process step
over the global batch; None (the identity) is a one-process call.

The torch side works in int64 on values below 2^32 and splits every 32-bit
product into 16-bit halves, so no intermediate reaches 2^63; an index of
2^32 or more wraps as the kernels' 32-bit index does.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B1
_C1, _C2 = 0x85EBCA6B, 0xC2B2AE35

# dropout sites of one post-norm layer (the input site uses layer 0)
SITE_INPUT, SITE_PROBS, SITE_ATTN_OUT, SITE_FFN_RELU, SITE_FFN_OUT = range(5)


def mix32(x: int) -> int:
    """MurmurHash3's 32-bit finaliser on a Python int (the reference)."""
    x &= M32
    x ^= x >> 16
    x = (x * _C1) & M32
    x ^= x >> 13
    x = (x * _C2) & M32
    return x ^ (x >> 16)


def stream_key(seed: int, site: int, tower: int, layer: int) -> int:
    """The 32-bit key of one (seed, site, tower, layer) stream."""
    return mix32((seed & M32) ^ mix32(site + 8 * layer + 1024 * tower
                                      + GOLDEN))


def bits_reference(seed: int, site: int, tower: int, layer: int,
                   index: int) -> int:
    """The random bits of one element, in plain Python integers."""
    key = stream_key(seed, site, tower, layer)
    return mix32(((index * GOLDEN) & M32) ^ key)


def step_seed(base: int, step: int) -> int:
    """The dropout seed of train step ``step`` of a run seeded ``base``: a
    fixed hash of the pair, below 2^31, so that a run resumed at a step
    draws what an uninterrupted run draws there (the JAX package's
    ``fold_in(base_rng, state.step)``)."""
    return mix32(mix32(base) ^ ((step * GOLDEN) & M32)) & 0x7FFFFFFF


def threshold(p: float) -> int:
    """Bits at or above this value keep their element (keep rate 1 - p)."""
    return min(int(p * 2 ** 32), M32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), with 16-bit halves of c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def bits(index: torch.Tensor, seed: int, site: int, tower: int,
         layer: int) -> torch.Tensor:
    """The random bits (int64 in [0, 2^32)) of the elements ``index``."""
    key = stream_key(seed, site, tower, layer)
    return _mix32(_mul32(index.to(torch.int64), GOLDEN) ^ key)


def row_map(offset: int, rows: int, rows_global: int):
    """The row map of a call holding ``rows`` rows at ``offset`` of each
    segment of ``rows_global`` rows; None where that is the identity."""
    if offset == 0 and rows == rows_global:
        return None
    if not 0 <= offset <= rows_global - rows:
        raise ValueError(f"rows [{offset}, {offset + rows}) outside a batch "
                         f"of {rows_global}")
    return (int(offset), int(rows), int(rows_global))


def global_index(shape, rmap, device=None) -> torch.Tensor:
    """The int64 hash index of every element of a site of ``shape`` (its
    first dim the batch) under the row map ``rmap`` (None: row-major)."""
    n = 1
    for k in shape:
        n *= k
    if rmap is None:
        return torch.arange(n, device=device).view(shape)
    offset, seg, stride = rmap
    per_row = n // shape[0]
    b = torch.arange(shape[0], device=device)
    g = (b // seg) * stride + offset + b % seg
    return (g[:, None] * per_row
            + torch.arange(per_row, device=device)).view(shape) & M32


def apply(x: torch.Tensor, p: float, seed: int, site: int, tower: int,
          layer: int, rmap=None) -> torch.Tensor:
    """Dropout of ``x`` at rate ``p``: elements indexed row-major over x's
    shape, in the global batch under the row map ``rmap``, kept ones
    divided by (1 - p).  Identity at p == 0."""
    if p <= 0.0:
        return x
    if x.numel() >= 2 ** 32:
        raise ValueError("dropout site holds 2^32 elements or more")
    index = global_index(x.shape, rmap, x.device)
    keep = bits(index, seed, site, tower, layer) >= threshold(p)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
