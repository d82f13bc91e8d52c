"""The port's plain tower (forward ``encoder_fwd_plain`` and backward
``encoder_bwd_plain``: the plain versions of K2 and K3) at the tower shapes
the kernels take beyond d 64 and 128, held against the JAX package.

* (d 96, 2 heads, L 30): d % 64 == 32, EE's length; (d 256, 4 heads, L 15):
  FK's length at d 256; (d 40, 1 head, L 30): d % 32 == 8, a ragged k chunk
  in the kernels' GEMMs; (d 256, 4 heads, L 30): EE's length at d 256;
  (d 512, 4 heads, L 15): the widest tower, two column tiles and the
  LayerNorm kernel in K2; (d 128, 2 heads, L 50) and (d 256, 4 heads,
  L 64): sequences past 32, where a lane of the attention kernels holds
  two keys.
* Against ``c2dsr_tpu.ops.encoder.encode_sequence`` under ``jax.vjp`` on
  every row, all-pad sequences included: 1e-5 relative to each tensor's
  largest value (the same f32 arithmetic in another order).
* Against the fused Pallas tower (``encode_sequence_fused``, interpret mode,
  f32 matmuls) on sequences whose first position is real, so that no query
  row is all-masked (ROADMAP §C): forward 1e-5, gradients 1e-4.
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
from c2dsr_tpu_torch.ops import encoder as enc

PAD = 99
SHAPES = [(96, 2, 30), (256, 4, 15), (40, 1, 30), (256, 4, 30),
          (512, 4, 15), (128, 2, 50), (256, 4, 64)]


def _inputs(b, length, d, seed, first_real):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 5, size=(b, length)).astype(np.int32)
    pos = np.zeros((b, length), np.int32)
    for i in range(b):
        npad = 0 if first_real else i % (length + 1)
        if first_real:                  # pads after a real first position
            seq[i, 1:][rng.random(length - 1) < 0.3] = PAD
        seq[i, :npad] = PAD
        pos[i, npad:] = np.minimum(np.arange(1, length - npad + 1), length - 1)
    h = (rng.normal(size=(b, length, d)) * 0.5).astype(np.float32)
    g = rng.normal(size=(b, length, d)).astype(np.float32)
    return seq, pos, h, g


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _port(seq, pos, h, g, p, n_head):
    """(out, dx, tower-weight grads) of the plain K2 / K3 versions; the
    grads in ``tower_weights`` order (layers stacked, then the final LN)."""
    tp = params_mod.params_from_numpy(p, device="cpu")
    seq_t = torch.from_numpy(seq).long()
    x = torch.from_numpy(h) + tp["pos_emb"][torch.from_numpy(pos).long()]
    kw = dict(idx_pad=PAD, n_head=n_head, invert_padding_mask=False)
    out = enc.encoder_fwd_plain(x, seq_t, tp, **kw)
    dx, grads = enc.encoder_bwd_plain(x, seq_t, torch.from_numpy(g), tp, **kw)
    return out.numpy(), dx.numpy(), [t.numpy() for t in grads]


def _jax_weight_grads(jg):
    """The JAX gradient tree in ``tower_weights`` order."""
    layers = [np.stack([np.asarray(lg[name]) for lg in jg["layers"]])
              for name in enc._NAMES]
    return layers + [np.asarray(jg["lnf_scale"]), np.asarray(jg["lnf_bias"])]


def _check(out, dx, grads, jout, jdh, jg, tol_out, tol_grad):
    _close(out, jout, tol_out, "out")
    _close(dx, jdh, tol_grad, "dx")
    for name, got, want in zip(enc._NAMES + ("lnf_scale", "lnf_bias"),
                               grads, _jax_weight_grads(jg)):
        _close(got, want, tol_grad, name)


@pytest.mark.parametrize("d,n_head,length", SHAPES)
def test_wide_plain_tower_matches_jax_xla(d, n_head, length):
    p = jax.tree.map(np.asarray, jparams.init_encoder_params(
        jax.random.PRNGKey(d), JConfig(d_latent=d, n_attn=2, n_head=n_head),
        length))
    seq, pos, h, g = _inputs(length + 1, length, d, seed=d,
                             first_real=False)
    assert (seq == PAD).all(axis=1).any()              # all-pad sequences
    out, dx, grads = _port(seq, pos, h, g, p, n_head)

    def f(h, p):
        return jenc.encode_sequence(
            jnp.asarray(seq), h, jnp.asarray(pos), p, idx_pad=PAD,
            n_head=n_head, dropout=0.0, rng=None, norm_first=False,
            invert_padding_mask=False)

    jout, vjp = jax.vjp(f, jnp.asarray(h), p)
    jdh, jg = vjp(jnp.asarray(g))
    _check(out, dx, grads, jout, jdh, jg, 1e-5, 1e-5)


@pytest.fixture
def _interpret():
    jencp.st_interpret.set(True)
    yield
    jencp.st_interpret.set(False)


@pytest.mark.parametrize("d,n_head,length", SHAPES)
def test_wide_plain_tower_matches_fused_pallas(_interpret, d, n_head, length):
    p = jax.tree.map(np.asarray, jparams.init_encoder_params(
        jax.random.PRNGKey(d + 1), JConfig(d_latent=d, n_attn=1,
                                           n_head=n_head), length))
    seq, pos, h, g = _inputs(8, length, d, seed=d + 1, first_real=True)
    out, dx, grads = _port(seq, pos, h, g, p, n_head)

    def f(h, p):
        return jencp.encode_sequence_fused(
            jnp.asarray(seq), h, jnp.asarray(pos), p, idx_pad=PAD,
            n_head=n_head, dropout=0.0, rng=None, invert_padding_mask=False,
            matmul_dtype=jnp.float32, block_b=8)

    jout, vjp = jax.vjp(f, jnp.asarray(h), p)
    jdh, jg = vjp(jnp.asarray(g))
    _check(out, dx, grads, jout, jdh, jg, 1e-5, 1e-4)
