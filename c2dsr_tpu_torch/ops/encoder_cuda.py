"""Wrapper of the fused encoder forward kernel (``csrc/encoder.cu``).

Replaces the fused encoder forward Pallas kernel of the JAX package
(``c2dsr_tpu/ops/encoder_pallas.py`` ``_fused_fwd_impl`` / ``_fwd_kernel``),
in eval: no dropout, one tower per call.  The kernel runs every post-norm
layer and the final LayerNorm; the positional add stays outside, as in JAX
(``encoder_pallas.py:582``).

What bounds it on an H100: operations.  Per layer it does 12·N·d² + 4·N·L·d
FLOPs (N = B·L rows) in f32 FFMA, against the card's FP32 non-tensor-core
peak, and it moves only one read of the input and one write of the output.
Design: one block keeps 64 / L whole sequences in shared memory for the
whole tower, so no activation touches device memory; the weights (393 KB a
layer at d = 128, more than a block's shared memory) stream through shared
memory in 32x64 tiles from L2, where a tower's weights stay for all blocks.
The weights are read in place (stacked over layers at rest, no per-launch
copy); the grid prefetches them into L2 at its start, since in the serving
loop other work evicts them between launches.

Unlike the Pallas kernel, which pads L to a multiple of 16 and averages an
all-masked query row over the padded length, this kernel works on the L
real positions, so such a row is the uniform average over L positions, as
``ops/encoder.py`` in both packages gives it.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict

import torch

from c2dsr_tpu_torch.kernels import build

_NAMES = ("w_qkv", "b_qkv", "w_out", "b_out", "w_ff1", "b_ff1", "w_ff2",
          "b_ff2", "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")
_SIG = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _fn():
    f = build.library("encoder").encoder_fwd_f32
    f.argtypes = _SIG
    f.restype = ctypes.c_int
    return f


def supported(d: int, n_head: int, length: int) -> bool:
    """Shapes the kernel takes: d in {64, 128}, head dim a multiple of 8,
    1 <= L <= 32 (FK/MB L = 15, EE L = 30)."""
    return (d % 64 == 0 and d <= 128 and d % n_head == 0
            and (d // n_head) % 8 == 0 and 1 <= length <= 32)


def tower_weights(params: Dict[str, Any]):
    """The tower's weights in the kernel's argument order: each layer weight,
    stacked over layers at rest (``model/params.py``), then the final LN's
    scale and bias.  No copy: the kernel reads them where they lie."""
    layers = params["layers"]
    return ([layers[name] for name in _NAMES]
            + [params["lnf_scale"], params["lnf_bias"]])


def encoder_fwd(x: torch.Tensor, seq: torch.Tensor, params: Dict[str, Any],
                *, idx_pad: int, n_head: int, invert_padding_mask: bool
                ) -> torch.Tensor:
    """Layers + final LN of one tower by the CUDA kernel, in eval.

    x: [B, L, d] f32 CUDA (positional embedding already added); seq: [B, L]
    int (pad = idx_pad).  Returns [B, L, d] f32."""
    if not x.is_cuda:
        raise ValueError("encoder_fwd takes CUDA tensors only")
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"encoder_fwd takes contiguous f32 [B, L, d], got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, L, d = x.shape
    if not supported(d, n_head, L):
        raise ValueError(f"encoder_fwd does not take d={d}, n_head={n_head},"
                         f" L={L}")
    if tuple(seq.shape) != (B, L) or seq.device != x.device:
        raise ValueError("seq must be [B, L] on x's device")
    seq = seq.to(torch.int32).contiguous()
    weights = tower_weights(params)
    n_layers = weights[0].shape[0]
    per_layer = {"w_qkv": (d, 3 * d), "b_qkv": (3 * d,), "w_out": (d, d),
                 "w_ff1": (d, d), "w_ff2": (d, d)}
    for name, w in zip(_NAMES + ("lnf_scale", "lnf_bias"), weights):
        want = ((n_layers,) + per_layer.get(name, (d,)) if name in _NAMES
                else (d,))
        if (w.dtype != torch.float32 or w.device != x.device
                or not w.is_contiguous() or tuple(w.shape) != want):
            raise ValueError(f"encoder weight {name} must be contiguous f32 "
                             f"{want} on x's device, got {w.dtype} "
                             f"{tuple(w.shape)}")
    out = torch.empty_like(x)
    err = _fn()(x.data_ptr(), seq.data_ptr(),
                *[w.data_ptr() for w in weights], out.data_ptr(),
                B, L, d, n_head, n_layers, int(idx_pad),
                int(bool(invert_padding_mask)),
                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"encoder_fwd launch failed: CUDA error {err}")
    encoder_fwd.launches += 1
    return out


encoder_fwd.launches = 0
