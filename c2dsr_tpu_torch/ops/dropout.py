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

The torch side works in int64 on values below 2^32 and splits every 32-bit
product into 16-bit halves, so no intermediate reaches 2^63.
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


def apply(x: torch.Tensor, p: float, seed: int, site: int, tower: int,
          layer: int) -> torch.Tensor:
    """Dropout of ``x`` at rate ``p``: elements indexed row-major over x's
    shape, kept ones divided by (1 - p).  Identity at p == 0."""
    if p <= 0.0:
        return x
    if x.numel() >= 2 ** 32:
        raise ValueError("dropout site holds 2^32 elements or more")
    index = torch.arange(x.numel(), device=x.device).view(x.shape)
    keep = bits(index, seed, site, tower, layer) >= threshold(p)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
