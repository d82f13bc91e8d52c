"""Wrappers of the fused encoder kernels: the tower forward
(``csrc/encoder.cu``) and its backward (``csrc/encoder_bwd.cu``), tied
together by the autograd Function behind :func:`encode`.

The forward replaces the fused encoder forward Pallas kernel of the JAX
package (``c2dsr_tpu/ops/encoder_pallas.py`` ``_fused_fwd_impl`` /
``_fwd_kernel``), the backward its ``_fused_bwd`` / ``_bwd_kernel``.  One
tower per call: ``forward_joint``'s shared tower on the stacked [3B, L]
sequences and the A and B towers are three calls, each keyed by its own
``tower`` index so that their dropout masks are independent.  The kernels
run every post-norm layer and the final LayerNorm; the positional add stays
outside, as in JAX (``encoder_pallas.py:582``).

What bounds them on an H100: operations.  Per layer the forward does
12·N·d² + 4·N·L·d FLOPs (N = B·L rows) and moves one read of the input and
one write of the output; the backward does twice that.  Both are sequences
of kernels over all N rows of the call, every product with a weight on the
tensor cores at f32 accuracy (3xTF32, ``csrc/tc.cuh``; bf16 MMAs in the
bf16 instantiations, below): the forward folds
the bias, ReLU, dropout, residual and (up to d 256) LayerNorm into its
GEMMs' epilogues, the backward dropout, ReLU's mask and the residual;
attention runs up to 8 whole sequences a block up to L 64 (FFMA) and, past
it, a block per head and tile of 64 query (or key) rows on the tensor
cores (q·kᵀ and do·vᵀ in a 6-term TF32 split, the other products in
3xTF32), the other side in chunks of 64; LayerNorm (the forward's above d
256, the backward's) a row
a warp at any width; the weight gradients are reductions over row splits
summed in order.  The forward writes its intermediates into the
saved-activation layout: in training the buffer the backward reads, so the
backward differentiates the very forward the loss saw with no recompute;
in eval a one-layer workspace of the same layout (``csrc/encoder.cu`` and
``csrc/encoder_bwd.cu`` state their launch budgets).

Dropout (training) draws every mask from the counter-based hash of
``ops/dropout.py``; the backward regenerates the forward's masks from the
same (seed, tower).  The kernels read the seed from device memory: a
caller passes an int, or the 0-d int32 tensor that a captured train step
writes before each replay (``train/step.py``), so that each replay draws
its own step's masks.  ``row_map`` (``ops/dropout.row_map``) places a data
rank's rows in the run's global batch, so that a data-parallel step draws
the masks of the one-process step over that batch; None is a one-process
call.  Unlike the Pallas kernel, which pads L to a multiple
of 16 and averages an all-masked query row over the padded length, these
kernels work on the L real positions, so such a row is the uniform average
over L positions, as ``ops/encoder.py`` in both packages gives it.

``bf16=True`` (``compute_dtype="bfloat16"``) selects both kernels' bf16
instantiations, the Pallas kernels' ``matmul_dtype=bf16``: every product's
operands rounded to bf16 (the incoming gradient's included), the sums f32.
The products with a weight, the weight gradients and the attention past L
64 run bf16 MMAs (m16n8k16, operands by ``ldmatrix``: ``csrc/tc.cuh``
``gemm_tile_bf16``, ``csrc/encoder_bwd.cu`` ``wg_tile_bf16``,
``csrc/encoder_common.cuh`` ``attn_qk`` and ``attn_mm``), the weights read
from a bf16 copy that each call makes first into a buffer the wrapper
allocates (``encoder_weights_bf16_elems``).  The saved activations stay
f32.  Their launches count apart (``launches_bf16``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from c2dsr_tpu_torch.kernels import build
from c2dsr_tpu_torch.ops import dropout as drop
from c2dsr_tpu_torch.ops.encoder import _NAMES, tower_params, tower_weights

_DROP_SIG = (ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p,
             ctypes.c_int) + (ctypes.c_uint,) * 3
# ... int bf16, void* w16, void* stream
_FWD_SIG = ((ctypes.c_void_p,) * 18 + (ctypes.c_int,) * 8 + _DROP_SIG
            + (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p))
_BWD_SIG = ((ctypes.c_void_p,) * 19 + (ctypes.c_int,) * 6 + _DROP_SIG
            + (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p))


@functools.lru_cache(maxsize=None)
def _fn(stem: str, name: str, argtypes, restype=ctypes.c_int):
    f = getattr(build.library(stem), name)
    f.argtypes = argtypes
    f.restype = restype
    return f


def supported(d: int, n_head: int, length: int) -> bool:
    """Shapes both kernels take: every tower the JAX package runs through
    its fused Pallas encoder (``c2dsr_tpu/ops/encoder_pallas.supported``:
    head dim a multiple of 8, post-norm, which the caller decides), at any
    width and any L >= 1.  Past L 64 attention passes keys in chunks of
    64, and LayerNorm walks a row in a warp, so neither ties a buffer to d
    or L; ``_check`` adds the guard of 2^31 elements a tower call."""
    return d % n_head == 0 and (d // n_head) % 8 == 0 and length >= 1


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _drop_args(dropout: float, seed, tower: int, row_map, device):
    """(the C entry points' dropout arguments, the device seed they point
    at, which the caller holds until the launch has been enqueued).  The
    kernels read the seed from device memory (``csrc/dropout.cuh``): a
    0-d int32 tensor passes as it is, an int is filled into a new one; in
    eval no seed is read and the pointer is null."""
    on = dropout > 0.0
    seed_t = drop.seed_tensor(seed, device) if on else None
    off, seg, stride = row_map if row_map is not None else (0, 0, 0)
    return (int(on), drop.threshold(dropout) if on else 0,
            float(1.0 - dropout), seed_t.data_ptr() if on else None,
            int(tower), int(off) & drop.M32, int(seg),
            int(stride) & drop.M32), seed_t


def _check(x: torch.Tensor, seq: torch.Tensor, weights, n_head: int,
           name: str) -> Tuple[int, int, int, int]:
    if not x.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors only")
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name} takes contiguous f32 [B, L, d], got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, L, d = x.shape
    if not supported(d, n_head, L):
        raise ValueError(f"{name} does not take d={d}, n_head={n_head}, L={L} "
                         "(head dim d / n_head a multiple of 8, L >= 1)")
    if max(B * L * d, B * n_head * L * L) >= 2 ** 31:
        raise ValueError(f"{name}: a tower call must hold < 2^31 elements")
    if tuple(seq.shape) != (B, L) or seq.device != x.device:
        raise ValueError("seq must be [B, L] on x's device")
    n_layers = weights[0].shape[0]
    per_layer = {"w_qkv": (d, 3 * d), "b_qkv": (3 * d,), "w_out": (d, d),
                 "w_ff1": (d, d), "w_ff2": (d, d)}
    for wname, w in zip(_NAMES + ("lnf_scale", "lnf_bias"), weights):
        want = ((n_layers,) + per_layer.get(wname, (d,)) if wname in _NAMES
                else (d,))
        if (w.dtype != torch.float32 or w.device != x.device
                or not w.is_contiguous() or tuple(w.shape) != want):
            raise ValueError(f"encoder weight {wname} must be contiguous f32 "
                             f"{want} on x's device, got {w.dtype} "
                             f"{tuple(w.shape)}")
    return B, L, d, n_layers


_SAVED_NAMES = ("qkv", "p", "o", "y1", "xhat1", "rstd1", "fr", "fd",
                "xnext", "xhat2", "rstd2")


@functools.lru_cache(maxsize=64)
def _saved_offsets(B: int, L: int, d: int, n_head: int, n_layers: int
                   ) -> Tuple[int, ...]:
    """``encoder_saved_offsets`` (encoder.cu): xin0, layers, per_layer, the
    per-layer offsets of _SAVED_NAMES, xhat_f, rstd_f, total."""
    f = _fn("encoder", "encoder_saved_offsets",
            (ctypes.c_int,) * 5 + (ctypes.c_void_p,), None)
    out = (ctypes.c_longlong * 17)()
    f(B, L, d, n_head, n_layers, ctypes.addressof(out))
    return tuple(out)


def saved_buffer(x: torch.Tensor, n_head: int, n_layers: int
                 ) -> torch.Tensor:
    """An empty buffer for the activations a training forward of x [B, L, d]
    saves for the backward."""
    total = _saved_offsets(*x.shape, n_head, n_layers)[-1]
    return torch.empty(total, dtype=torch.float32, device=x.device)


def saved_views(saved: torch.Tensor, shape, n_head: int, n_layers: int
                ) -> Dict[str, Any]:
    """Views of a saved-activation buffer for a tower input of ``shape``
    [B, L, d]: ``xin0``, ``xhat_f``, ``rstd_f`` and ``layers``, a list of
    {qkv [B, L, 3d], p [head, B, L, L], o, y1, xhat1, fr (ReLU output
    before dropout), fd (after), xnext, xhat2 [B, L, d]; rstd1, rstd2
    [B, L]} per layer."""
    B, L, d = shape
    off = _saved_offsets(B, L, d, n_head, n_layers)

    def view(at, *dims):
        size = 1
        for k in dims:
            size *= k
        return saved[at:at + size].view(*dims)

    in_layer = dict(zip(_SAVED_NAMES, off[3:14]))
    shapes = {"qkv": (B, L, 3 * d), "p": (n_head, B, L, L), "rstd1": (B, L),
              "rstd2": (B, L)}
    per_layer = [{k: view(off[1] + li * off[2] + in_layer[k],
                          *shapes.get(k, (B, L, d))) for k in _SAVED_NAMES}
                 for li in range(n_layers)]
    return {"xin0": view(off[0], B, L, d), "layers": per_layer,
            "xhat_f": view(off[14], B, L, d), "rstd_f": view(off[15], B, L)}


def weights_copy_buffer(d: int, n_layers: int, bf16: bool, device,
                        backward: bool = False):
    """The buffer a call of the forward (or the backward) writes its
    weights' copy into before its products (``encoder_weights_copy_bytes``
    in ``csrc/encoder.cu``): the bf16 instantiation's bf16 copy, or, f32
    past d 256, the TF32 parts the wgmma tile reads; None where the call
    makes none."""
    n = weights_copy_bytes(d, n_layers, bf16, backward)
    return torch.empty(n, dtype=torch.uint8, device=device) if n else None


@functools.lru_cache(maxsize=256)
def weights_copy_bytes(d: int, n_layers: int, bf16: bool,
                       backward: bool) -> int:
    return _fn("encoder", "encoder_weights_copy_bytes", (ctypes.c_int,) * 4,
               ctypes.c_longlong)(d, n_layers, int(bf16), int(backward))


# Past this width the products with a weight run the wgmma tile
# (``csrc/wgmma.cuh``), up to it the 64-row mma.sync tile (``csrc/tc.cuh``
# gemm_tile): ``kWideD`` in ``csrc/encoder_common.cuh``, which routes; here
# it only says which launches ``_count`` counts as wide.
WIDE_D = 256

_GEMM_DROP = _DROP_SIG + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
FWD_EPI = {"bias": 0, "relu": 1, "residual": 2}
BWD_EPI = {"store": 0, "drelu": 1, "res": 2}


def _check_gemm(name, k, m, bf16, *tensors):
    """Raises unless every tensor given is contiguous f32 on the card and
    k, m are widths the tiles take (k % 4, or % 8 in bf16; m % 8)."""
    for t in tensors:
        if t is not None and not (t.is_cuda and t.dtype == torch.float32
                                  and t.is_contiguous()):
            raise ValueError(f"{name} takes contiguous f32 CUDA tensors")
    if k % (8 if bf16 else 4) or m % 8:
        raise ValueError(f"{name} does not take k={k}, m={m}")


def _gemm_drop(dropout, seed, tower, row_map, L, site, device):
    args, seed_t = _drop_args(dropout, seed, tower, row_map, device)
    return args + (int(L), int(site),
                   torch.cuda.current_stream().cuda_stream), seed_t


def gemm_fwd(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
             epi: str, mode: int, wide: bool, res=None, with_c2=False,
             dropout: float = 0.0, seed=0, tower: int = 0, row_map=None,
             L: int = 1, site: int = 0):
    """One of the forward's products on its own, c = A·W + b with its
    epilogue (``FWD_EPI``; relu also writes the dropped copy c2 with
    ``with_c2``; residual adds ``res``), on the wgmma tile (``wide``) or
    on gemm_tile, in ``mode`` (3, 6 or 1: bf16); the dropout stream of
    ``site`` at layer 0, a [B, L, m] site's indices: the card tests'
    handle on the tiles.  Returns (c, c2 or None)."""
    n, k = a.shape
    m = w.shape[1]
    _check_gemm("gemm_fwd", k, m, mode == 1, a, w, bias, res)
    c = torch.empty(n, m, dtype=torch.float32, device=a.device)
    c2 = torch.empty_like(c) if with_c2 else None
    scratch = torch.empty(3 * k * m, dtype=torch.float32, device=a.device)
    drop_args, _seed = _gemm_drop(dropout, seed, tower, row_map, L, site,
                                  a.device)
    err = _fn("encoder", "encoder_gemm_fwd",
              (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + _GEMM_DROP)(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(),
        None if res is None else res.data_ptr(), c.data_ptr(),
        None if c2 is None else c2.data_ptr(), scratch.data_ptr(), n, k, m,
        FWD_EPI[epi], int(mode), int(wide), *drop_args)
    if err != 0:
        raise RuntimeError(f"encoder_gemm_fwd launch failed: CUDA error {err}")
    return c, c2


def gemm_bwd(a: torch.Tensor, w: torch.Tensor, *, epi: str, bf16: bool,
             wide: bool, res=None, aux=None, dropout: float = 0.0, seed=0,
             tower: int = 0, row_map=None, L: int = 1, site: int = 0):
    """One of the backward's products on its own, c = A·Wᵀ with W [m, k]
    and its epilogue (``BWD_EPI``: drelu masks by ``aux`` > 0, res adds
    ``res``, both after the dropout of ``site``), on the wgmma tile
    (``wide``) or on gemm_tile, f32 (3xTF32) or bf16."""
    n, k = a.shape
    m = w.shape[0]
    _check_gemm("gemm_bwd", k, m, bf16, a, w, res, aux)
    c = torch.empty(n, m, dtype=torch.float32, device=a.device)
    scratch = torch.empty(2 * k * m, dtype=torch.float32, device=a.device)
    drop_args, _seed = _gemm_drop(dropout, seed, tower, row_map, L, site,
                                  a.device)
    err = _fn("encoder_bwd", "encoder_gemm_bwd",
              (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + _GEMM_DROP)(
        a.data_ptr(), w.data_ptr(), None if res is None else res.data_ptr(),
        None if aux is None else aux.data_ptr(), c.data_ptr(),
        scratch.data_ptr(), n, k, m, BWD_EPI[epi], int(bf16), int(wide),
        *drop_args)
    if err != 0:
        raise RuntimeError(f"encoder_gemm_bwd launch failed: CUDA error {err}")
    return c


def _check_saved(saved: torch.Tensor, B, L, d, n_head, n_layers) -> None:
    if (saved.dtype != torch.float32 or not saved.is_cuda
            or saved.numel() < _saved_offsets(B, L, d, n_head, n_layers)[-1]
            or saved.data_ptr() % 16):
        raise ValueError("saved must be a buffer from saved_buffer for this "
                         "tower call")


def encoder_fwd(x: torch.Tensor, seq: torch.Tensor, params: Dict[str, Any],
                *, idx_pad: int, n_head: int, invert_padding_mask: bool,
                dropout: float = 0.0, seed: int = 0, tower: int = 0,
                row_map=None, saved: Optional[torch.Tensor] = None,
                bf16: bool = False) -> torch.Tensor:
    """Input dropout, layers and final LN of one tower by the CUDA kernels.

    x: [B, L, d] f32 CUDA (positional embedding already added); seq: [B, L]
    int (pad = idx_pad).  With ``saved`` (from :func:`saved_buffer`) the
    kernels also write the activations :func:`encoder_bwd` reads; without
    it they work in a one-layer workspace of the same layout.  ``bf16``:
    the bf16 instantiation.  Returns [B, L, d] f32."""
    weights = tower_weights(params)
    B, L, d, n_layers = _check(x, seq, weights, n_head, "encoder_fwd")
    seq32 = seq.to(torch.int32).contiguous()
    if saved is not None:
        _check_saved(saved, B, L, d, n_head, n_layers)
        buf = saved
    else:
        buf = torch.empty(_saved_offsets(B, L, d, n_head, 1)[-1],
                          dtype=torch.float32, device=x.device)
    # the kernels' 16-byte asynchronous copies read x and the weights
    x = _aligned(x)
    weights = [_aligned(w) for w in weights]
    out = torch.empty_like(x)
    w16 = weights_copy_buffer(d, n_layers, bf16, x.device)
    drop_args, _seed = _drop_args(dropout, seed, tower, row_map, x.device)
    err = _fn("encoder", "encoder_fwd", _FWD_SIG)(
        x.data_ptr(), seq32.data_ptr(), *[w.data_ptr() for w in weights],
        out.data_ptr(), buf.data_ptr(), int(saved is not None),
        B, L, d, n_head, n_layers, int(idx_pad),
        int(bool(invert_padding_mask)), *drop_args, int(bf16),
        None if w16 is None else w16.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"encoder_fwd launch failed: CUDA error {err}")
    _count(encoder_fwd, d, bf16)
    return out


def _count(wrapper, d: int, bf16: bool) -> None:
    """One launch of ``wrapper``'s kernels, of its bf16 instantiation where
    ``bf16``, and past ``WIDE_D`` one of its products on the wgmma tile
    (``launches_wide``, ``launches_wide_bf16``)."""
    suffix = "_bf16" if bf16 else ""
    setattr(wrapper, "launches" + suffix,
            getattr(wrapper, "launches" + suffix) + 1)
    if d > WIDE_D:
        setattr(wrapper, "launches_wide" + suffix,
                getattr(wrapper, "launches_wide" + suffix) + 1)


encoder_fwd.launches = 0
encoder_fwd.launches_bf16 = 0
encoder_fwd.launches_wide = 0
encoder_fwd.launches_wide_bf16 = 0


@functools.lru_cache(maxsize=64)
def _bwd_sizes(B: int, L: int, d: int, n_head: int, n_layers: int
               ) -> Tuple[int, int, int]:
    """(row splits of the weight gradients, workspace floats, gradient
    floats) of a backward call (``encoder_bwd_grid`` and the sizes in
    encoder_bwd.cu)."""
    grid = _fn("encoder_bwd", "encoder_bwd_grid", (ctypes.c_int,) * 3)(B, L, d)
    ws = _fn("encoder_bwd", "encoder_bwd_workspace_floats",
             (ctypes.c_int,) * 6, ctypes.c_longlong)(B, L, d, n_head,
                                                      n_layers, grid)
    grads = _fn("encoder_bwd", "encoder_bwd_grad_floats",
                (ctypes.c_int,) * 2, ctypes.c_longlong)(d, n_layers)
    return grid, ws, grads


def encoder_bwd(x: torch.Tensor, seq: torch.Tensor, gout: torch.Tensor,
                params: Dict[str, Any], *, idx_pad: int, n_head: int,
                invert_padding_mask: bool, dropout: float = 0.0,
                seed: int = 0, tower: int = 0, row_map=None,
                saved: Optional[torch.Tensor] = None, bf16: bool = False
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Backward of :func:`encoder_fwd` by the CUDA kernels, from the same
    input, dropout and precision arguments: (dx, the gradients of
    ``tower_weights``).  ``saved`` holds the activations that forward
    wrote; without it the forward kernel runs first to write them (one more
    launch of K2)."""
    weights = tower_weights(params)
    B, L, d, n_layers = _check(x, seq, weights, n_head, "encoder_bwd")
    if (gout.shape != x.shape or gout.dtype != torch.float32
            or gout.device != x.device):
        raise ValueError("gout must be f32 of x's shape on x's device")
    kw = dict(idx_pad=idx_pad, n_head=n_head,
              invert_padding_mask=invert_padding_mask, dropout=dropout,
              seed=seed, tower=tower, row_map=row_map, bf16=bf16)
    if saved is None:
        saved = saved_buffer(x, n_head, n_layers)
        encoder_fwd(x, seq, params, saved=saved, **kw)
    _check_saved(saved, B, L, d, n_head, n_layers)
    # the kernels' 16-byte asynchronous copies read gout and the weights
    gout = _aligned(gout.contiguous())
    weights = [_aligned(w) for w in weights]
    grid, ws_floats, grad_floats = _bwd_sizes(B, L, d, n_head, n_layers)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=x.device)
    flat = torch.empty(grad_floats, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    w16 = weights_copy_buffer(d, n_layers, bf16, x.device, backward=True)
    drop_args, _seed = _drop_args(dropout, seed, tower, row_map, x.device)
    err = _fn("encoder_bwd", "encoder_bwd", _BWD_SIG)(
        saved.data_ptr(), gout.data_ptr(), *[w.data_ptr() for w in weights],
        dx.data_ptr(), flat.data_ptr(), ws.data_ptr(), grid, B, L, d, n_head,
        n_layers, *drop_args, int(bf16),
        None if w16 is None else w16.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"encoder_bwd launch failed: CUDA error {err}")
    _count(encoder_bwd, d, bf16)
    grads, at = [], 0
    for w in weights:
        grads.append(flat[at:at + w.numel()].view(w.shape))
        at += w.numel()
    return dx, grads


encoder_bwd.launches = 0
encoder_bwd.launches_bf16 = 0
encoder_bwd.launches_wide = 0
encoder_bwd.launches_wide_bf16 = 0


def dropout_bits(seed, site: int, tower: int, layer: int, n: int
                 ) -> torch.Tensor:
    """The kernels' dropout hash bits of elements 0..n-1 of one stream, as
    int64 on the card (a check against ``ops/dropout.bits_reference``);
    ``seed`` an int or a 0-d int32 tensor on the card, read there as the
    kernels read it."""
    out = torch.empty(n, dtype=torch.int32, device="cuda")
    seed_t = drop.seed_tensor(seed, out.device)
    err = _fn("encoder", "dropout_bits_u32",
              (ctypes.c_void_p,) + (ctypes.c_int,) * 4
              + (ctypes.c_void_p,) * 2)(
        seed_t.data_ptr(), site, tower, layer, n, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout_bits launch failed: CUDA error {err}")
    return out.to(torch.int64) & drop.M32


class _Tower(torch.autograd.Function):
    """One tower call: forward by ``encoder_fwd``, which also saves the
    activations, backward by ``encoder_bwd`` from them (both looked up at
    call time)."""

    @staticmethod
    def forward(ctx, x, seq, kw, *weights):
        ctx.save_for_backward(x, seq, *weights)
        ctx.kw = kw
        ctx.acts = saved_buffer(x, kw["n_head"], weights[0].shape[0])
        return encoder_fwd(x, seq, tower_params(weights), saved=ctx.acts,
                           **kw)

    @staticmethod
    def backward(ctx, gout):
        x, seq, *weights = ctx.saved_tensors
        dx, grads = encoder_bwd(x, seq, gout, tower_params(weights),
                                saved=ctx.acts, **ctx.kw)
        ctx.acts = None
        return (dx, None, None, *grads)


def encode(x: torch.Tensor, seq: torch.Tensor, params: Dict[str, Any], *,
           idx_pad: int, n_head: int, invert_padding_mask: bool,
           dropout: float = 0.0, seed: int = 0, tower: int = 0,
           row_map=None, bf16: bool = False) -> torch.Tensor:
    """:func:`encoder_fwd` with its kernel backward: differentiable in x and
    in every tower weight; ``bf16``: both in their bf16 instantiations."""
    kw = dict(idx_pad=idx_pad, n_head=n_head,
              invert_padding_mask=invert_padding_mask, dropout=dropout,
              seed=seed, tower=tower, row_map=row_map, bf16=bf16)
    weights = tower_weights(params)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in [x] + weights)):
        return encoder_fwd(x.contiguous(), seq, params, **kw)
    return _Tower.apply(x.contiguous(), seq, kw, *weights)
