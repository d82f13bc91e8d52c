"""The port's CE at d 512, the width the fused CE kernels K4 and K5 now take
(``ops/fused_ce_cuda.check_shape``), held against the JAX package on the
CPU: the plain version (``ops/fused_ce.py``), forward and every gradient.

* Against the fused Pallas CE (``c2dsr_tpu.ops.fused_ce.fused_ce`` through
  ``fused_rec_ce_rows``, interpret mode), whose d 512 backward is the
  split dh / dW kernels (Pallas #8/#9): its products are bf16 with f32
  sums, so 2e-2 relative, as tests/test_torch_ce.py holds it at d <= 64.
* Against ``c2dsr_tpu.ops.losses.rec_ce_row_losses`` under ``jax.vjp`` in
  f32: 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2dsr_tpu.ops import fused_ce as jfused
from c2dsr_tpu.ops import losses as jlosses
from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda

B, R, D = 2, 8, 512


def _case(V, n_real, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, R, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.05).astype(np.float32)
    w[:, n_real:] = 0.0
    b = (rng.normal(size=V) * 0.1).astype(np.float32)
    pad = rng.normal(size=(B, R, 1)).astype(np.float32)
    tgt = rng.integers(0, n_real, size=(B, R)).astype(np.int32)
    tgt[:, :2] = n_real                                 # ignored positions
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


@pytest.mark.parametrize("V,n_real", [(300, 280), (256, 256)])
def test_plain_ce_d512_matches_fused_pallas_interpret(V, n_real):
    h, w, b, pad, tgt, g = _case(V, n_real, seed=V)
    rows, grads = _port(h, w, b, pad, tgt, g, n_real)

    def f(h, w, b, pad):
        return jfused.fused_rec_ce_rows(h, w, b, pad, tgt, n_real,
                                        interpret=True)

    want, vjp = jax.vjp(f, h, w, b, pad)
    _close(rows, np.asarray(want), 2e-2)
    assert (rows[:, :2] == 0).all()
    for got, exp in zip(grads, vjp(jnp.asarray(g))):
        _close(got, np.asarray(exp), 2e-2)


def test_plain_ce_d512_matches_jax_losses():
    h, w, b, pad, tgt, g = _case(300, 280, seed=7)
    rows, grads = _port(h, w, b, pad, tgt, g, 280)

    def f(h, w, b, pad):
        return jlosses.rec_ce_row_losses(
            jnp.einsum("brd,dv->brv", h, w) + b, pad, tgt, 280)

    want, vjp = jax.vjp(f, h, w, b, pad)
    _close(rows, np.asarray(want), 1e-5)
    for got, exp in zip(grads, vjp(jnp.asarray(g))):
        _close(got, np.asarray(exp), 1e-5)


@pytest.mark.parametrize("d", [8, 256, 264, 384, 512, 520, 1024, 2048])
def test_kernels_take_widths_to_512(d):
    """Every width d % 8 == 0 (the wide kernels above d 512)."""
    fused_ce_cuda.check_shape("ce", 10, d, 64)


@pytest.mark.parametrize("d,V", [(516, 64), (36, 64), (0, 64), (512, 66)])
def test_kernels_refuse_other_shapes(d, V):
    with pytest.raises(ValueError, match="d % 8 == 0 and V % 4 == 0"):
        fused_ce_cuda.check_shape("ce", 10, d, V)


@pytest.mark.parametrize("d,V,w_bytes", [(512, 2 ** 20, 4),
                                         (2048, 2 ** 18, 4),
                                         (512, 2 ** 21, 2)])
def test_kernels_refuse_a_classifier_of_2_gib(d, V, w_bytes):
    """d·V·bytes >= 2^31 is refused with the JAX package's reason
    (``c2dsr_tpu/ops/fused_ce.py`` ``_pick_blocks``: a bf16 W counts two
    bytes an element); one column group less is taken."""
    with pytest.raises(ValueError, match="reaches 2 GiB"):
        fused_ce_cuda.check_shape("ce", 10, d, V, w_bytes)
    fused_ce_cuda.check_shape("ce", 10, d, V - 4, w_bytes)
    if w_bytes == 2:
        fused_ce_cuda.check_shape("ce", 10, d, V // 2, 2)
