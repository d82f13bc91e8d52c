"""Zero-padding of the feature width d up to what a kernel takes.

K1/K6 (``ops/spmm_cuda``) and K7 (``ops/segsum_cuda``) take d % 4 == 0,
K4/K5 (``ops/fused_ce_cuda``) d % 8 == 0; the JAX package trains at any d
(its SpMM falls back to XLA where d % 128 != 0, ``c2dsr_tpu/ops/spmm.py:
122-127``, and its Pallas CE takes any d).  Every product these kernels
compute sums over d or acts on each column of d alone, so zero columns add
nothing: the op-level callers pad d with zeros, call the kernel, and slice
the output (and, through autograd, the gradient) back.  Where d is already
a multiple, the input is passed on as it is, with no copy and no launch.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def pad_width(x: torch.Tensor, multiple: int, dim: int = -1) -> torch.Tensor:
    """``x`` with zeros appended along ``dim`` up to a multiple of
    ``multiple``; ``x`` itself where its size already is one."""
    extra = -x.shape[dim] % multiple
    if not extra:
        return x
    after = x.dim() - 1 - dim % x.dim()       # dims after ``dim``
    return F.pad(x, [0, 0] * after + [0, extra])


def on_padded_width(fn: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor, multiple: int) -> torch.Tensor:
    """``fn(x)`` for an ``fn`` that maps each column of the last dim on its
    own (a row operation, a sparse product, a segment sum), run at x's width
    padded to ``multiple`` and sliced back; ``fn(x)`` itself where the width
    already is a multiple."""
    xp = pad_width(x, multiple)
    out = fn(xp)
    return out if xp is x else out[..., :x.shape[-1]]
