"""Causal self-attention sequence encoder, plain PyTorch.

Functionally equivalent to the reference's ``SelfAttention`` wrapper around
``nn.TransformerEncoder`` (models/encoders.py:7-33) and to
``c2dsr_tpu/ops/encoder.py`` in eval: learned positional embedding (index
0 = pad slot), then ``n_attn`` post-norm (or pre-norm) transformer layers
with d_ff = d_latent, ReLU, LayerNorm eps=1e-8, and a final LayerNorm, under
a causal mask plus a key-padding mask.  In training, dropout at rate ``p``
applies at the five sites of the JAX encoder: the input after the
positional add, the attention probabilities, the out-projection, the FFN
ReLU output and the FFN output.  Masks come from the counter-based hash of
``ops/dropout.py``, keyed by (seed, site, tower, layer), so the fused
kernels draw the same ones.

Masks are an ADDED finite -1e9 bias, never ``-inf`` or ``masked_fill``: a
query row whose keys are all masked then has logits that all round to
-1e9 and comes out as the uniform average over the L positions, exactly as
in the JAX package.  ``invert_padding_mask=True`` reproduces the
reference's inverted key-padding mask (SURVEY.md quirk 1).

This is the plain version of the fused encoder kernel (``ops/encoder_cuda``);
CPU tensors take it, and the tests and ``chip_smoke.py`` hold the kernel
against it.  Parameters use the JAX layout, ``x @ w`` with w [d_in, d_out],
with each layer weight stacked over layers (``model/params.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from c2dsr_tpu_torch.ops import dropout as drop

_NAMES = ("w_qkv", "b_qkv", "w_out", "b_out", "w_ff1", "b_ff1", "w_ff2",
          "b_ff2", "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")
LN_EPS = 1e-8          # layer_norm_eps of the reference (encoders.py:25-27)
NEG_INF = -1e9         # finite mask value: keeps softmax NaN-free on all-pad rows
# a layer's branches: (ReLU mask, all-masked rows' attention probabilities)
Branches = Tuple[torch.Tensor, torch.Tensor]


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    # statistics in f32 or wider whatever the input dtype, result back in it
    xw = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xw.mean(dim=-1, keepdim=True)
    var = (xw - mean).square().mean(dim=-1, keepdim=True)
    out = (xw - mean) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


def multi_head_attention(x: torch.Tensor, p: Dict[str, torch.Tensor],
                         n_head: int, mask_bias: torch.Tensor,
                         drop_probs=lambda t: t,
                         masked_probs: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Self-attention with additive mask bias [B, 1, L, L]; ``drop_probs``
    applies dropout to the probabilities [B, H, L, L].  ``masked_probs``
    [B, H, L, L], if given, are the probabilities of the all-masked rows
    (the softmax's backward is taken at them)."""
    B, L, d = x.shape
    dh = d // n_head
    qkv = x @ p["w_qkv"] + p["b_qkv"]                     # [B, L, 3d]
    q, k, v = qkv.split(d, dim=-1)

    def heads(t):
        return t.reshape(B, L, n_head, dh).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(dh) + mask_bias
    if masked_probs is not None:
        masked = (logits < 0.5 * NEG_INF).all(-1, keepdim=True)
        logits = torch.where(masked, logits - logits.detach()
                             + torch.log(masked_probs.to(logits.dtype)),
                             logits)
    attn = drop_probs(torch.softmax(logits, dim=-1))
    out = (attn @ v).transpose(1, 2).reshape(B, L, d)
    return out @ p["w_out"] + p["b_out"]


def encoder_layer(x: torch.Tensor, p: Dict[str, Any], *, n_head: int,
                  mask_bias: torch.Tensor, norm_first: bool,
                  dropout: float = 0.0, seed: int = 0, tower: int = 0,
                  layer: int = 0, branches: Optional[Branches] = None
                  ) -> torch.Tensor:
    """One transformer encoder layer, post-norm by default (torch semantics).
    Dropout sites as ``c2dsr_tpu/ops/encoder.py`` has them.  ``branches``,
    if given, is (ReLU mask [B, L, d], all-masked rows' probabilities
    [B, H, L, L]): the layer is taken at those branches instead of its own
    (see :func:`encode_layers`)."""
    def dr(site):
        return lambda t: drop.apply(t, dropout, seed, site, tower, layer)

    relu_mask, probs = branches if branches is not None else (None, None)

    def relu(t):
        return torch.relu(t) if relu_mask is None else t * relu_mask.to(t)

    def mha(h):
        return multi_head_attention(h, p, n_head, mask_bias,
                                    dr(drop.SITE_PROBS), probs)

    if norm_first:
        h = layer_norm(x, p["ln1_scale"], p["ln1_bias"])
        x = x + dr(drop.SITE_ATTN_OUT)(mha(h))
        h = layer_norm(x, p["ln2_scale"], p["ln2_bias"])
        ff = dr(drop.SITE_FFN_RELU)(relu(h @ p["w_ff1"] + p["b_ff1"]))
        return x + dr(drop.SITE_FFN_OUT)(ff @ p["w_ff2"] + p["b_ff2"])
    x = layer_norm(x + dr(drop.SITE_ATTN_OUT)(mha(x)),
                   p["ln1_scale"], p["ln1_bias"])
    ff = dr(drop.SITE_FFN_RELU)(relu(x @ p["w_ff1"] + p["b_ff1"]))
    x = x + dr(drop.SITE_FFN_OUT)(ff @ p["w_ff2"] + p["b_ff2"])
    return layer_norm(x, p["ln2_scale"], p["ln2_bias"])


def attention_mask_bias(seq: torch.Tensor, idx_pad: int,
                        invert_padding_mask: bool,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Additive attention bias [B, 1, L, L]: causal + key-padding.

    Correct polarity masks *pad* keys; the bug-parity mode masks *real* keys
    (reference encoders.py:33 passes ``seq != idx_pad`` where torch expects
    True = ignore).  For float64 logits the bias is NEG_INF·2^29: its
    spacing in float64 is 64, as NEG_INF's is in f32, so a masked logit
    rounds to the steps it takes in f32 and an all-masked row comes out as
    it does there (the uniform average over the L positions)."""
    B, L = seq.shape
    causal = torch.ones((L, L), dtype=torch.bool, device=seq.device).tril()
    is_real = seq != idx_pad
    key_ok = ~is_real if invert_padding_mask else is_real
    ok = causal[None, :, :] & key_ok[:, None, :]
    wide = dtype == torch.float64
    dtype = torch.float64 if wide else torch.float32
    zero = torch.zeros((), dtype=dtype, device=seq.device)
    neg = torch.full((), NEG_INF * 2.0 ** 29 if wide else NEG_INF,
                     dtype=dtype, device=seq.device)
    return torch.where(ok, zero, neg)[:, None, :, :]


def encode_layers(x: torch.Tensor, seq: torch.Tensor, params: Dict[str, Any],
                  *, idx_pad: int, n_head: int, norm_first: bool,
                  invert_padding_mask: bool, dropout: float = 0.0,
                  seed: int = 0, tower: int = 0,
                  branches: Optional[Dict[Tuple[int, int], Branches]] = None
                  ) -> torch.Tensor:
    """Input dropout, the layers and the final LayerNorm, on an input that
    already holds the positional embedding: what the fused kernel computes
    (post-norm).  ``params["layers"]`` holds each layer weight stacked over
    layers.  ``tower`` keys the masks of one tower call apart from the
    others of the same step.

    ``branches`` maps (tower, layer) to the branches another forward took
    (``encoder_layer``): two f32-correct forwards can round a ReLU input
    that sits at zero to opposite signs, or an all-masked row's logits
    (-1e9 + x) to different steps of 64.  The outputs agree to rounding but
    the gradients then differ by whole rows, so a check of the fused
    backward, which differentiates its own forward, takes this tower at the
    fused forward's branches."""
    x = drop.apply(x, dropout, seed, drop.SITE_INPUT, tower, 0)
    bias = attention_mask_bias(seq, idx_pad, invert_padding_mask, x.dtype)
    layers = params["layers"]
    for i in range(layers["w_qkv"].shape[0]):
        x = encoder_layer(x, {k: v[i] for k, v in layers.items()},
                          n_head=n_head, mask_bias=bias, norm_first=norm_first,
                          dropout=dropout, seed=seed, tower=tower, layer=i,
                          branches=None if branches is None
                          else branches[(tower, i)])
    return layer_norm(x, params["lnf_scale"], params["lnf_bias"])


def encode_sequence(seq: torch.Tensor, h_in: torch.Tensor, pos: torch.Tensor,
                    params: Dict[str, Any], *, idx_pad: int, n_head: int,
                    norm_first: bool, invert_padding_mask: bool,
                    dropout: float = 0.0, seed: int = 0, tower: int = 0
                    ) -> torch.Tensor:
    """Full tower: pos-embed add + input dropout + n layers + final LN.

    seq, pos: [B, L] int; h_in: [B, L, d] (embedding already scaled by
    sqrt(d) upstream, models/C2DSR.py:69-71)."""
    return encode_layers(h_in + params["pos_emb"][pos], seq, params,
                         idx_pad=idx_pad, n_head=n_head, norm_first=norm_first,
                         invert_padding_mask=invert_padding_mask,
                         dropout=dropout, seed=seed, tower=tower)


def tower_weights(params: Dict[str, Any]) -> List[torch.Tensor]:
    """A tower's weights in the fused kernels' argument order: each layer
    weight, stacked over layers at rest (``model/params.py``), then the final
    LN's scale and bias.  No copy: the kernels read them where they lie."""
    layers = params["layers"]
    return ([layers[name] for name in _NAMES]
            + [params["lnf_scale"], params["lnf_bias"]])


def tower_params(weights) -> Dict[str, Any]:
    """The inverse of :func:`tower_weights`."""
    return {"layers": dict(zip(_NAMES, weights[:len(_NAMES)])),
            "lnf_scale": weights[-2], "lnf_bias": weights[-1]}


def encoder_fwd_plain(x: torch.Tensor, seq: torch.Tensor,
                      params: Dict[str, Any], *, idx_pad: int, n_head: int,
                      invert_padding_mask: bool, dropout: float = 0.0,
                      seed: int = 0, tower: int = 0, branches=None
                      ) -> torch.Tensor:
    """The plain version of ``encoder_cuda.encoder_fwd`` (post-norm);
    ``branches`` as :func:`encode_layers` takes them."""
    return encode_layers(x, seq, params, idx_pad=idx_pad, n_head=n_head,
                         norm_first=False,
                         invert_padding_mask=invert_padding_mask,
                         dropout=dropout, seed=seed, tower=tower,
                         branches=branches)


def encoder_bwd_plain(x: torch.Tensor, seq: torch.Tensor, gout: torch.Tensor,
                      params: Dict[str, Any], **kw
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The plain version of ``encoder_cuda.encoder_bwd``: autograd through
    :func:`encoder_fwd_plain`, the same masks regenerated from the seed.
    Returns (dx, the gradients of ``tower_weights(params)``)."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_(True)
        ws = [w.detach().requires_grad_(True) for w in tower_weights(params)]
        out = encoder_fwd_plain(xs, seq, tower_params(ws), **kw)
        grads = torch.autograd.grad(out, [xs] + ws, gout)
    return grads[0], list(grads[1:])
