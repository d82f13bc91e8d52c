"""Kernel choice by device, and the port's device entry check.

A CUDA tensor goes to the hand-written kernel (``ops/*_cuda.py``); a CPU
tensor goes to the kernel's plain PyTorch version.  Nothing else decides:
no config flag, no fallback when a kernel fails to build or launch.  The
graph SpMM and the tower route here; the recommendation CE routes by the
same rule in ``ops/fused_ce.fused_ce``, the name its JAX counterpart has.
"""

from __future__ import annotations

import torch

from c2dsr_tpu_torch.ops import encoder as enc
from c2dsr_tpu_torch.ops import encoder_cuda
from c2dsr_tpu_torch.ops import spmm_cuda


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; raises for CUDA without a card.

    Every entry point (``init_params``, ``params_from_numpy``,
    ``device_graph``, ``make_eval_fns``) calls this.  The port computes in
    full f32, so TF32 is switched off here for both matmuls and cuDNN:
    PyTorch leaves cuDNN convolutions in TF32 by default."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def spmm(graph, h: torch.Tensor) -> torch.Tensor:
    """``adj @ h``: the CSR kernel (forward over A, backward over Aᵀ) for a
    CUDA tensor, else the plain version under autograd."""
    if h.is_cuda:
        return spmm_cuda.hop(graph, h)
    from c2dsr_tpu_torch.ops import spmm as spmm_mod
    return spmm_mod.spmm_reference(graph, h)


def encode_layers(x: torch.Tensor, seq: torch.Tensor, params, *,
                  idx_pad: int, n_head: int, norm_first: bool,
                  invert_padding_mask: bool, dropout: float = 0.0,
                  seed: int = 0, tower: int = 0) -> torch.Tensor:
    """Input dropout, the layers and the final LN (input already
    position-added): the fused encoder kernels (forward and backward) for a
    CUDA tensor, else the plain version under autograd.  The kernels are
    post-norm only, so ``norm_first`` on a CUDA tensor raises."""
    if x.is_cuda:
        if norm_first:
            raise NotImplementedError(
                "the fused encoder kernel is post-norm; norm_first has no "
                "CUDA kernel yet")
        return encoder_cuda.encode(
            x, seq, params, idx_pad=idx_pad, n_head=n_head,
            invert_padding_mask=invert_padding_mask, dropout=dropout,
            seed=seed, tower=tower)
    return enc.encode_layers(x, seq, params, idx_pad=idx_pad, n_head=n_head,
                             norm_first=norm_first,
                             invert_padding_mask=invert_padding_mask,
                             dropout=dropout, seed=seed, tower=tower)
