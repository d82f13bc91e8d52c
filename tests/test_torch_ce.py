"""The port's recommendation CE (``ops/fused_ce.py`` on the CPU: the plain
version of the fused CE kernels K4/K5) held against the JAX package.

* Against ``c2dsr_tpu.ops.losses.rec_ce_row_losses`` under ``jax.vjp``, both
  in f32: rows and the gradients of h, W, b and the pad logit to 1e-5,
  relative to each tensor's largest value (the same arithmetic, summed in
  another order).
* Against the fused Pallas CE (``fused_ce.fused_rec_ce_rows``, interpret
  mode): its products are bf16 with f32 sums, so 2e-2 relative.
* The plain K5 (``ce_bwd_plain``) equals autograd through the plain K4.

Cases: ignored targets, the ignore index equal to V (no vocab padding), and
a padded vocab tail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2dsr_tpu.ops import fused_ce as jfused
from c2dsr_tpu.ops import losses as jlosses
from c2dsr_tpu_torch.ops import fused_ce, losses

B, R = 4, 8


def _case(d, V, n_real, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, R, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) * 0.3).astype(np.float32)
    w[:, n_real:] = 0.0
    b = (rng.normal(size=V) * 0.1).astype(np.float32)
    pad = rng.normal(size=(B, R, 1)).astype(np.float32)
    tgt = rng.integers(0, n_real, size=(B, R)).astype(np.int32)
    tgt[:, :3] = n_real                                 # ignored positions
    g = rng.normal(size=(B, R)).astype(np.float32)
    return h, w, b, pad, tgt, g


def _port(h, w, b, pad, tgt, g, n_real):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (h, w, b, pad)]
    rows = fused_ce.fused_rec_ce_rows(*ts, torch.from_numpy(tgt).long(),
                                      n_real)
    rows.backward(torch.from_numpy(g))
    return rows.detach().numpy(), [t.grad.numpy() for t in ts]


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


CASES = [(32, 300, 280), (32, 96, 96), (64, 520, 500)]


@pytest.mark.parametrize("d,V,n_real", CASES)
def test_plain_ce_and_grads_match_jax_losses(d, V, n_real):
    h, w, b, pad, tgt, g = _case(d, V, n_real, seed=V)
    rows, grads = _port(h, w, b, pad, tgt, g, n_real)

    def f(h, w, b, pad):
        return jlosses.rec_ce_row_losses(
            jnp.einsum("brd,dv->brv", h, w) + b, pad, tgt, n_real)

    want, vjp = jax.vjp(f, h, w, b, pad)
    _close(rows, np.asarray(want), 1e-5)
    assert (rows[:, :3] == 0).all()
    for got, exp in zip(grads, vjp(jnp.asarray(g))):
        _close(got, np.asarray(exp), 1e-5)


@pytest.mark.parametrize("d,V,n_real", CASES)
def test_plain_ce_matches_fused_pallas_interpret(d, V, n_real):
    """bf16 products in the Pallas kernel: 2e-2 relative."""
    h, w, b, pad, tgt, g = _case(d, V, n_real, seed=V + 1)
    rows, grads = _port(h, w, b, pad, tgt, g, n_real)

    def f(h, w, b, pad):
        return jfused.fused_rec_ce_rows(h, w, b, pad, tgt, n_real,
                                        interpret=True)

    want, vjp = jax.vjp(f, h, w, b, pad)
    _close(rows, np.asarray(want), 2e-2)
    for got, exp in zip(grads, vjp(jnp.asarray(g))):
        _close(got, np.asarray(exp), 2e-2)


@pytest.mark.parametrize("d,V,n_real", CASES)
def test_plain_k5_equals_autograd_of_plain_k4(d, V, n_real):
    h, w, b, pad, tgt, _ = _case(d, V, n_real, seed=V + 2)
    n = B * R
    ht = torch.from_numpy(h.reshape(n, d)).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bm = fused_ce.mask_bias(torch.from_numpy(b), n_real).detach()
    bm.requires_grad_(True)
    tg = torch.from_numpy(tgt.reshape(n)).long()
    lse, tlog = fused_ce.ce_fwd_plain(ht, wt, bm, torch.from_numpy(
        pad.reshape(n)), tg)
    real = (tg != n_real).float()
    rng = np.random.default_rng(0)
    dlse = torch.from_numpy(rng.normal(size=n).astype(np.float32)) * real
    dt = torch.from_numpy(rng.normal(size=n).astype(np.float32)) * real
    want = torch.autograd.grad((lse * dlse + tlog * dt).sum(), [ht, wt, bm])
    got = fused_ce.ce_bwd_plain(ht.detach(), wt.detach(), bm.detach(),
                                lse.detach(), dlse, dt, tg)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-6)
    if n_real < V:
        assert (got[2][n_real:] == 0).all()       # padded columns
    assert (tlog.detach()[tg >= V] == 0).all()    # ignore index == V


def test_mask_bias_blocks_padded_gradient():
    b = torch.randn(10, requires_grad=True)
    fused_ce.mask_bias(b, 7).sum().backward()
    assert b.grad[:7].eq(1).all() and b.grad[7:].eq(0).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_bce_and_ce_mean_match_jax(weighted):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(6, 1)).astype(np.float32) * 3
    w = np.array([1, 1, 0, 1, 0, 1], np.float32) if weighted else None
    for one in (True, False):
        got = losses.bce_with_logits(torch.from_numpy(logits), one,
                                     None if w is None else torch.from_numpy(w))
        want = jlosses.bce_with_logits(jnp.asarray(logits), one,
                                       None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    rows = rng.normal(size=(4, 5)).astype(np.float32)
    tgt = rng.integers(0, 4, size=(4, 5))
    got = losses.ce_mean_from_rows(torch.from_numpy(rows),
                                   torch.from_numpy(tgt), 3)
    want = jlosses.ce_mean_from_rows(jnp.asarray(rows), jnp.asarray(tgt), 3)
    for a, e in zip(got, want):
        np.testing.assert_allclose(float(a), float(e), rtol=1e-6)


def test_rec_ce_row_losses_matches_jax():
    h, w, b, pad, tgt, _ = _case(32, 300, 280, seed=9)
    logits = np.einsum("brd,dv->brv", h, w) + b
    got = losses.rec_ce_row_losses(torch.from_numpy(logits),
                                   torch.from_numpy(pad),
                                   torch.from_numpy(tgt), 280)
    want = jlosses.rec_ce_row_losses(jnp.asarray(logits), jnp.asarray(pad),
                                     jnp.asarray(tgt), 280)
    _close(got.numpy(), np.asarray(want), 1e-6)
