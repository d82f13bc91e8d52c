"""The backward of the port's plain tower (the plain version of the fused
encoder backward kernel K3, ``ops/encoder.encoder_bwd_plain``) held
against the JAX package.

* At dropout 0, dx and the gradient of every weight (each layer's and the
  final LN's, and the positional embedding) against ``jax.vjp`` of
  ``c2dsr_tpu.ops.encoder.encode_sequence``, on all rows, all-pad sequences
  included: 1e-5 relative to each tensor's largest value (f32, sums in
  another order).
* Against the fused Pallas tower (``encode_towers_fused``, interpret mode,
  f32 matmuls) with three segments, so that each tower's gradient goes to
  its own weights; the sequences' first position is real, so no query row
  is all-masked (the two JAX paths differ there, ROADMAP §C).
* With dropout, the plain backward regenerates the forward's masks.
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
D = 32
TOL = 1e-5


def _inputs(b, length, seed, first_real=False):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 5, size=(b, length)).astype(np.int32)
    pos = np.zeros((b, length), np.int32)
    for i in range(b):
        npad = i % (length + 1)
        if first_real:
            # pads only after the first position: no all-masked query row
            npad = 0
            seq[i, 1 + i % (length - 1):] = np.where(
                rng.random(length - 1 - i % (length - 1)) < 0.3, PAD,
                seq[i, 1 + i % (length - 1):])
        seq[i, :npad] = PAD
        pos[i, npad:] = np.minimum(np.arange(1, length - npad + 1), length - 1)
    h = (rng.normal(size=(b, length, D)) * 0.5).astype(np.float32)
    g = rng.normal(size=(b, length, D)).astype(np.float32)
    return seq, pos, h, g


def _params(n_layers, n_head, length, seed=0):
    p = jparams.init_encoder_params(
        jax.random.PRNGKey(seed),
        JConfig(d_latent=D, n_attn=n_layers, n_head=n_head), length)
    return jax.tree.map(np.asarray, p)


def _port_grads(seq, pos, h, g, p, n_head, invert, dropout=0.0, seed=0,
                tower=0):
    """(out, dh_in, grads of the JAX tree) of the port's plain tower."""
    tp = params_mod._map(lambda t: t.requires_grad_(True),
                         params_mod.params_from_numpy(p, device="cpu"))
    ht = torch.from_numpy(h).requires_grad_(True)
    out = enc.encode_sequence(
        torch.from_numpy(seq).long(), ht, torch.from_numpy(pos).long(), tp,
        idx_pad=PAD, n_head=n_head, norm_first=False,
        invert_padding_mask=invert, dropout=dropout, seed=seed, tower=tower)
    out.backward(torch.from_numpy(g))
    grads = params_mod.params_to_numpy(params_mod._map(lambda t: t.grad, tp))
    return out.detach().numpy(), ht.grad.numpy(), grads


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _tree_close(got, want, tol=TOL):
    for (path, w), gv in zip(jax.tree_util.tree_leaves_with_path(want),
                             jax.tree.leaves(got)):
        _close(gv, w, tol, jax.tree_util.keystr(path))


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("length,n_head,n_layers", [
    (15, 1, 1), (15, 2, 2), (30, 1, 2), (30, 2, 1)])
def test_tower_backward_matches_jax_vjp(invert, length, n_head, n_layers):
    p = _params(n_layers, n_head, length, seed=length + n_layers)
    seq, pos, h, g = _inputs(length + 1, length, seed=n_head)
    assert (seq == PAD).all(axis=1).any()           # all-pad sequences
    out, dh, grads = _port_grads(seq, pos, h, g, p, n_head, invert)

    def f(h, p):
        return jenc.encode_sequence(
            jnp.asarray(seq), h, jnp.asarray(pos), p, idx_pad=PAD,
            n_head=n_head, dropout=0.0, rng=None, norm_first=False,
            invert_padding_mask=invert)

    want, vjp = jax.vjp(f, jnp.asarray(h), p)
    _close(out, want)
    jdh, jgrads = vjp(jnp.asarray(g))
    _close(dh, jdh, what="dh")
    _tree_close(grads, jgrads)


@pytest.fixture
def _interpret():
    jencp.st_interpret.set(True)
    yield
    jencp.st_interpret.set(False)


@pytest.mark.parametrize("length,n_head,n_layers", [(15, 1, 1), (30, 2, 2)])
def test_three_segments_match_fused_pallas(_interpret, length, n_head,
                                           n_layers):
    """Three towers with their own weights (forward_joint's shared, A and B
    segments) against one multi-tower Pallas call: each segment's dx and
    weight gradients."""
    sizes = (24, 8, 8)
    segs = []
    for t, b in enumerate(sizes):
        seq, pos, h, g = _inputs(b, length, seed=10 + t, first_real=True)
        segs.append((seq, pos, h, g, _params(n_layers, n_head, length,
                                             seed=20 + t)))
    jin = [(jnp.asarray(s), jnp.asarray(h), jnp.asarray(p), pr)
           for s, p, h, _, pr in segs]

    def f(hs, prs):
        return jencp.encode_towers_fused(
            [(s, h, p, pr) for (s, _, p, _), h, pr in zip(jin, hs, prs)],
            idx_pad=PAD, n_head=n_head, dropout=0.0, rng=None,
            invert_padding_mask=False, matmul_dtype=jnp.float32, block_b=8)

    outs, vjp = jax.vjp(f, [x[1] for x in jin], [x[3] for x in jin])
    jdhs, jgrads = vjp([jnp.asarray(x[3]) for x in segs])
    for t, (seq, pos, h, g, p) in enumerate(segs):
        out, dh, grads = _port_grads(seq, pos, h, g, p, n_head, False,
                                     tower=t)
        _close(out, outs[t], what=f"out {t}")
        _close(dh, jdhs[t], 1e-4, what=f"dh {t}")
        _tree_close(grads, jgrads[t], 1e-4)


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_plain_backward_regenerates_forward_masks(dropout):
    """encoder_bwd_plain recomputes the forward from (seed, tower): its
    gradients equal autograd through the same forward call."""
    p = params_mod.params_from_numpy(_params(2, 2, 15, seed=3), "cpu")
    seq, pos, h, g = _inputs(12, 15, seed=4)
    seq_t = torch.from_numpy(seq).long()
    x = torch.from_numpy(h) + p["pos_emb"][torch.from_numpy(pos).long()]
    kw = dict(idx_pad=PAD, n_head=2, invert_padding_mask=False,
              dropout=dropout, seed=99, tower=1)
    ws = [w.clone().requires_grad_(True) for w in enc.tower_weights(p)]
    xs = x.clone().requires_grad_(True)
    out = enc.encoder_fwd_plain(xs, seq_t, enc.tower_params(ws), **kw)
    want = torch.autograd.grad(out, [xs] + ws, torch.from_numpy(g))
    dx, grads = enc.encoder_bwd_plain(x, seq_t, torch.from_numpy(g), p, **kw)
    for a, b in zip([dx] + grads, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dropout_masks_differ_by_tower_and_seed():
    p = params_mod.params_from_numpy(_params(1, 1, 15), "cpu")
    seq, pos, h, _ = _inputs(8, 15, seed=1)
    x = torch.from_numpy(h) + 1.0
    kw = dict(idx_pad=PAD, n_head=1, invert_padding_mask=False, dropout=0.2)
    s = torch.from_numpy(seq).long()
    a = enc.encoder_fwd_plain(x, s, p, seed=1, tower=0, **kw)
    assert torch.equal(a, enc.encoder_fwd_plain(x, s, p, seed=1, tower=0,
                                                **kw))
    assert not torch.equal(a, enc.encoder_fwd_plain(x, s, p, seed=1, tower=1,
                                                    **kw))
    assert not torch.equal(a, enc.encoder_fwd_plain(x, s, p, seed=2, tower=0,
                                                    **kw))
