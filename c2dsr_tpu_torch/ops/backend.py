"""Kernel choice by device, and the port's device entry check.

A CUDA tensor goes to the hand-written kernel (``ops/*_cuda.py``); a CPU
tensor goes to the kernel's plain PyTorch version.  There is no fallback
when a kernel fails to build or launch.  Two configuration choices mirror
the JAX package's: a row flag (``batch_sparse_gnn``) selects the
batch-sparse SpMM, and the tower takes the fused kernels exactly where the
JAX package's Pallas encoder runs (``use_fused_encoder``): a ``norm_first``
tower, or one whose head dim is not a multiple of 8, runs the plain tower
on either device, as the JAX package runs its XLA tower there.  The graph
SpMM and the tower route here; the recommendation CE routes by device in
``ops/fused_ce.fused_ce``, the name its JAX counterpart has.
"""

from __future__ import annotations

from typing import Optional

import torch

from c2dsr_tpu_torch.ops import encoder as enc
from c2dsr_tpu_torch.ops import encoder_cuda
from c2dsr_tpu_torch.ops import spmm_cuda
from c2dsr_tpu_torch.ops.padding import on_padded_width


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


def spmm(graph, h: torch.Tensor, flag: Optional[torch.Tensor] = None,
         bf16: bool = False) -> torch.Tensor:
    """``adj @ h``: the CSR kernel (forward over A, backward over Aᵀ) for a
    CUDA tensor, else the plain version under autograd.  With a row
    ``flag``, the batch-sparse hop: K6 (forward masked by the output row's
    flag, backward by the gathered row's) or its plain version.  ``bf16``:
    the bf16 gather of both (``ops/spmm.spmm_reference``)."""
    if h.is_cuda:
        return spmm_kernels(graph, h, flag, bf16=bf16)
    from c2dsr_tpu_torch.ops import spmm as spmm_mod
    if flag is None:
        return spmm_mod.spmm_reference(graph, h, bf16=bf16)
    return spmm_mod.spmm_reference_flagged(graph, h, flag, "dest", bf16)


def spmm_kernels(graph, h: torch.Tensor, flag: Optional[torch.Tensor] = None,
                 n_out: Optional[int] = None, bf16: bool = False
                 ) -> torch.Tensor:
    """One differentiable hop ``adj @ h`` into ``n_out`` rows (h's by
    default) by K1, or with a row ``flag`` by K6 (their bf16 instantiations
    with ``bf16``), h's width zero-padded to the kernels' multiple
    (``ops/padding``)."""
    def hop(x):
        if flag is None:
            return spmm_cuda.hop(graph, x, n_out, bf16=bf16)
        return spmm_cuda.flagged_hop(graph, x, flag, bf16=bf16)
    return on_padded_width(hop, h, spmm_cuda.D_MULTIPLE)


def fused_encoder_runs(n_head: int, d: int, norm_first: bool) -> bool:
    """Whether the JAX package's fused Pallas encoder takes this tower
    (``c2dsr_tpu/ops/encoder_pallas.supported``, through
    ``c2dsr_tpu/ops/backend.use_fused_encoder``): post-norm, head dim a
    multiple of 8.  Decided from the configuration alone."""
    return (not norm_first) and d % n_head == 0 and (d // n_head) % 8 == 0


def encode_layers(x: torch.Tensor, seq: torch.Tensor, params, *,
                  idx_pad: int, n_head: int, norm_first: bool,
                  invert_padding_mask: bool, dropout: float = 0.0,
                  seed: int = 0, tower: int = 0, row_map=None,
                  bf16: bool = False) -> torch.Tensor:
    """Input dropout, the layers and the final LN (input already
    position-added).  On a CUDA tensor, where the fused Pallas encoder runs
    in the JAX package (:func:`fused_encoder_runs`), the fused encoder
    kernels (forward and backward); they raise for a shape they do not take
    (``encoder_cuda.supported``).  Elsewhere, ``norm_first`` or a head dim
    not a multiple of 8, the plain tower, the counterpart of the JAX
    package's XLA tower.  On a CPU tensor the plain tower under autograd.
    ``bf16`` (``compute_dtype="bfloat16"``) takes the Pallas tower's bf16
    products where it runs, the kernels' bf16 instantiations on the card;
    the XLA tower's counterpart keeps f32 products, as the JAX package's
    XLA tower computes in f32 on an input it has promoted to f32."""
    fused = fused_encoder_runs(n_head, x.shape[-1], norm_first)
    if x.is_cuda and fused:
        return encoder_cuda.encode(
            x, seq, params, idx_pad=idx_pad, n_head=n_head,
            invert_padding_mask=invert_padding_mask, dropout=dropout,
            seed=seed, tower=tower, row_map=row_map, bf16=bf16)
    return enc.encode_layers(x, seq, params, idx_pad=idx_pad, n_head=n_head,
                             norm_first=norm_first,
                             invert_padding_mask=invert_padding_mask,
                             dropout=dropout, seed=seed, tower=tower,
                             row_map=row_map, bf16=bf16 and fused)
