"""The port's plain encoder (the plain version of the fused encoder kernel)
held against the JAX package: ``ops.encoder.encode_sequence`` on every row,
all-pad sequences included, and the fused Pallas forward in interpret mode
(f32 matmuls) on real rows.

Tolerance 1e-5 absolute on LayerNorm outputs of order 1: the same f32
arithmetic in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2dsr_tpu.config import Config as JConfig
from c2dsr_tpu.model import params as jparams
from c2dsr_tpu.ops import encoder as jenc
from c2dsr_tpu.ops import encoder_pallas as jencp
from c2dsr_tpu_torch.model import params as params_mod
from c2dsr_tpu_torch.ops import backend
from c2dsr_tpu_torch.ops import encoder as enc

PAD = 99
D = 32
TOL = 1e-5


def _inputs(b, length, seed):
    """Left-padded sequences of every pad count, all-pad ones included."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 5, size=(b, length)).astype(np.int32)
    pos = np.zeros((b, length), np.int32)
    for i in range(b):
        npad = i % (length + 1)                 # 0 .. length pads
        seq[i, :npad] = PAD
        pos[i, npad:] = np.minimum(np.arange(1, length - npad + 1),
                                   length - 1)
    h = (rng.normal(size=(b, length, D)) * 0.5).astype(np.float32)
    return seq, pos, h


def _params(n_layers, n_head, length, seed=0):
    p = jparams.init_encoder_params(
        jax.random.PRNGKey(seed),
        JConfig(d_latent=D, n_attn=n_layers, n_head=n_head), length)
    return jax.tree.map(np.asarray, p)


def _port(seq, pos, h, p, n_head, invert, norm_first=False):
    tp = params_mod.params_from_numpy(p, device="cpu")
    return enc.encode_sequence(
        torch.from_numpy(seq).long(), torch.from_numpy(h),
        torch.from_numpy(pos).long(), tp, idx_pad=PAD, n_head=n_head,
        norm_first=norm_first, invert_padding_mask=invert).numpy()


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("length", [15, 30])
@pytest.mark.parametrize("n_head,n_layers", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_encoder_matches_jax_all_rows(invert, length, n_head, n_layers):
    p = _params(n_layers, n_head, length)
    seq, pos, h = _inputs(2 * (length + 1), length, seed=length + n_head)
    assert (seq == PAD).all(axis=1).any()          # all-pad sequences present
    got = _port(seq, pos, h, p, n_head, invert)
    want = np.asarray(jenc.encode_sequence(
        jnp.asarray(seq), jnp.asarray(h), jnp.asarray(pos), p, idx_pad=PAD,
        n_head=n_head, dropout=0.2, rng=None, norm_first=False,
        invert_padding_mask=invert))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("invert", [False, True])
def test_pre_norm_matches_jax(invert):
    p = _params(2, 2, 15, seed=4)
    seq, pos, h = _inputs(16, 15, seed=4)
    got = _port(seq, pos, h, p, 2, invert, norm_first=True)
    want = np.asarray(jenc.encode_sequence(
        jnp.asarray(seq), jnp.asarray(h), jnp.asarray(pos), p, idx_pad=PAD,
        n_head=2, dropout=0.0, rng=None, norm_first=True,
        invert_padding_mask=invert))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_all_masked_row_is_uniform_average_over_l():
    """Correct polarity: an all-pad sequence's rows attend nothing; every
    logit is exactly -1e9, so attention is the plain mean of V over the L
    positions (not over any padded length)."""
    length = 15
    bias = enc.attention_mask_bias(torch.full((1, length), PAD), PAD, False)
    assert (bias == -1e9).all()
    logits = torch.randn(1, 1, length, length) * 0.1 + bias
    attn = torch.softmax(logits, dim=-1)
    torch.testing.assert_close(attn, torch.full_like(attn, 1.0 / length),
                               rtol=0, atol=0)


def test_float64_mask_bias_rounds_logits_as_f32_does():
    """In float64 the mask bias is NEG_INF·2^29, whose spacing is 64 as
    NEG_INF's is in f32: a masked logit rounds to the same step of 64
    (ties to even included), so an all-masked row is what it is in f32."""
    seq = torch.full((1, 4), PAD)
    b32 = enc.attention_mask_bias(seq, PAD, False)
    b64 = enc.attention_mask_bias(seq, PAD, False, torch.float64)
    assert b32.dtype == torch.float32 and b64.dtype == torch.float64
    x = torch.linspace(-400, 400, 64001, dtype=torch.float32)
    x = torch.cat([x, torch.arange(-416, 417, 32, dtype=torch.float32)])
    step32 = (x + b32.flatten()[0]) - b32.flatten()[0]
    step64 = (x.double() + b64.flatten()[0]) - b64.flatten()[0]
    assert torch.equal(step32.double(), step64)
    assert set(step32.unique().tolist()) > {-384.0, -64.0, 0.0, 64.0, 384.0}


@pytest.mark.parametrize("invert", [False, True])
def test_plain_tower_in_float64_matches_f32(invert):
    """The plain tower carries float64 through (the exact reference the
    card tests hold the kernels against): the same outputs as in f32 on
    every row, all-masked ones included."""
    p = _params(2, 2, 15, seed=5)
    seq, pos, h = _inputs(32, 15, seed=5)
    tp = params_mod.params_from_numpy(p, device="cpu")
    args = (torch.from_numpy(seq).long(), torch.from_numpy(h),
            torch.from_numpy(pos).long())
    kw = dict(idx_pad=PAD, n_head=2, norm_first=False,
              invert_padding_mask=invert)
    got = enc.encode_sequence(args[0], args[1].double(), args[2],
                              params_mod._map(lambda t: t.double(), tp), **kw)
    want = enc.encode_sequence(*args, tp, **kw)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)


def _layer0_branches(x, seq, tp, n_head):
    """The plain one-layer tower's own branches: its ReLU mask, and its
    all-masked rows' probabilities (uniform at these small logits)."""
    B, L, _ = x.shape
    bias = enc.attention_mask_bias(seq, PAD, False)
    p0 = {k: v[0] for k, v in tp["layers"].items()}
    x1 = enc.layer_norm(x + enc.multi_head_attention(x, p0, n_head, bias),
                        p0["ln1_scale"], p0["ln1_bias"])
    relu = (x1 @ p0["w_ff1"] + p0["b_ff1"] > 0).float()
    return relu, torch.full((B, n_head, L, L), 1.0 / L)


def test_plain_tower_taken_at_given_branches():
    """``branches`` takes the tower at another forward's branches: at its
    own it changes nothing, forward or backward; another ReLU mask or other
    probabilities on all-masked rows move only the rows they touch."""
    n_head, L = 2, 15
    p = _params(1, n_head, L, seed=6)
    seq, pos, h = _inputs(16, L, seed=6)
    tp = params_mod.params_from_numpy(p, device="cpu")
    s, x = torch.from_numpy(seq).long(), torch.from_numpy(h)
    kw = dict(idx_pad=PAD, n_head=n_head, invert_padding_mask=False)
    relu, probs = _layer0_branches(x, s, tp, n_head)
    own = {(0, 0): (relu, probs)}
    base = enc.encoder_fwd_plain(x, s, tp, **kw)
    torch.testing.assert_close(enc.encoder_fwd_plain(x, s, tp, branches=own,
                                                     **kw), base,
                               rtol=0, atol=1e-6)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=h.shape).astype(np.float32))
    for a, b in zip(*[[r[0]] + r[1] for r in (
            enc.encoder_bwd_plain(x, s, g, tp, branches=own, **kw),
            enc.encoder_bwd_plain(x, s, g, tp, **kw))]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    flipped = relu.clone()
    flipped[3, 7, 5] = 1 - flipped[3, 7, 5]
    out = enc.encoder_fwd_plain(x, s, tp, branches={(0, 0): (flipped, probs)},
                                **kw)
    moved = (out != base).any(-1)
    assert moved[3, 7] and int(moved.sum()) == 1
    masked = (s == PAD)                          # left pads: no key allowed
    onehot = torch.zeros_like(probs)
    onehot[..., 0] = 1.0
    out = enc.encoder_fwd_plain(x, s, tp, branches={(0, 0): (relu, onehot)},
                                **kw)
    moved = (out != base).any(-1)
    assert moved.any() and torch.equal(moved & ~masked,
                                       torch.zeros_like(moved))


@pytest.fixture
def _interpret():
    jencp.st_interpret.set(True)
    yield
    jencp.st_interpret.set(False)


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("length,n_head,n_layers", [(15, 1, 1), (30, 2, 2)])
def test_encoder_matches_fused_pallas_on_real_rows(_interpret, invert, length,
                                                   n_head, n_layers):
    """The Pallas kernel averages an all-masked row over its padded length
    (encoder_pallas.py:111-120), so the two agree on rows with an allowed
    key: every real row in the correct polarity, and in the inverted one
    every row of a sequence that holds a pad."""
    p = _params(n_layers, n_head, length, seed=2)
    seq, pos, h = _inputs(16, length, seed=5)
    got = _port(seq, pos, h, p, n_head, invert)
    want = np.asarray(jencp.encode_sequence_fused(
        jnp.asarray(seq), jnp.asarray(h), jnp.asarray(pos), p, idx_pad=PAD,
        n_head=n_head, dropout=0.0, rng=None, invert_padding_mask=invert,
        matmul_dtype=jnp.float32, block_b=8))
    if invert:
        sel = np.broadcast_to((seq == PAD).any(axis=1)[:, None], seq.shape)
    else:
        sel = seq != PAD
    np.testing.assert_allclose(got[sel], want[sel], atol=TOL, rtol=0)


def test_backend_encode_layers_is_plain_on_cpu():
    p = params_mod.params_from_numpy(_params(1, 1, 15), device="cpu")
    seq, pos, h = _inputs(4, 15, seed=1)
    seq_t = torch.from_numpy(seq).long()
    x = torch.from_numpy(h) + p["pos_emb"][torch.from_numpy(pos).long()]
    got = backend.encode_layers(x, seq_t, p, idx_pad=PAD, n_head=1,
                                norm_first=False, invert_padding_mask=False)
    want = enc.encode_layers(x, seq_t, p, idx_pad=PAD, n_head=1,
                             norm_first=False,
                             invert_padding_mask=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("invert", [False, True])
def test_backend_encode_layers_pre_norm_on_cpu(invert):
    """The pre-norm branch has no kernel; on a CPU tensor the backend runs
    the plain version with it, the same function JAX's encoder computes."""
    p = _params(2, 2, 15, seed=6)
    seq, pos, h = _inputs(16, 15, seed=6)
    tp = params_mod.params_from_numpy(p, device="cpu")
    x = torch.from_numpy(h) + tp["pos_emb"][torch.from_numpy(pos).long()]
    got = backend.encode_layers(x, torch.from_numpy(seq).long(), tp,
                                idx_pad=PAD, n_head=2, norm_first=True,
                                invert_padding_mask=invert).numpy()
    want = np.asarray(jenc.encode_sequence(
        jnp.asarray(seq), jnp.asarray(h), jnp.asarray(pos), p, idx_pad=PAD,
        n_head=2, dropout=0.0, rng=None, norm_first=True,
        invert_padding_mask=invert))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
