"""The plain versions of K4's experiment variants
(``c2dsr_tpu_torch/bench/ce_variants.variant_plain``) against the JAX
package's TPU experiment kernels (``bench/ce_experiments.variant_fn``, run
in Pallas interpret mode on the CPU).

The JAX variants multiply in bf16 (``ce_experiments._dot``), so h and W are
rounded to bf16-representable values first, which makes their products
exact in f32 on both sides.  The JAX kernels have no pad class: the port's
pad logit is -1e9 here (scaled by log2 e for exp2), which adds nothing.

Tolerances (max abs error over max |JAX|): base, nomatch and matmulonly
1e-5 (the same arithmetic, summed in another order); bf16exp 1e-2 (each
side rounds its exponents to bf16, at other maxima); exp2 1e-2 after the
ln 2 rescale, the JAX script's own (ce_experiments.py:173-177), since the
JAX side rounds h·log2 e to bf16 again.  The JAX exp2 kernel returns
m + ln(sum 2^(l - m)) (its last block takes a natural log of a sum of
powers of 2), not a lse in log2 units; the test turns it into one, m +
log2(sum 2^(l - m)), with its row max m computed here, before comparing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bench import ce_experiments
from c2dsr_tpu_torch.bench import ce_variants

N, D, V, BN, BV = 16, 8, 256, 8, 128
LN2 = float(np.log(2.0))
TOL = {"base": 1e-5, "nomatch": 1e-5, "matmulonly": 1e-5, "bf16exp": 1e-2,
       "exp2": 1e-2}


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _inputs():
    rng = np.random.default_rng(0)
    h = _bf16(rng.normal(size=(N, D)))
    w = _bf16(rng.normal(size=(D, V)) * 0.5)
    b = (rng.normal(size=V) * 0.1).astype(np.float32)
    tgt = rng.integers(0, V, size=N).astype(np.int32)
    return h, w, b, tgt


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("variant", ce_variants.VARIANTS)
def test_variant_plain_matches_jax_kernel(variant):
    h, w, b, tgt = _inputs()
    scale = ce_variants.LOG2E if variant == "exp2" else 1.0
    hj, bj = h * np.float32(scale), b * np.float32(scale)
    f = ce_experiments.variant_fn(variant, N, D, V, BN, BV)
    with pltpu.force_tpu_interpret_mode():
        lse_j, tlog_j = (np.asarray(a)[:, 0] for a in f(
            jnp.asarray(hj), jnp.asarray(w), jnp.asarray(bj)[None],
            jnp.asarray(tgt)[:, None]))

    th, tb, tp = ce_variants._scaled(variant, torch.from_numpy(h),
                                     torch.from_numpy(b),
                                     torch.full((N,), -1e9))
    lse, tlog = (t.numpy() for t in ce_variants.variant_plain(
        variant, th, torch.from_numpy(w), tb, tp,
        torch.from_numpy(tgt).long()))

    if variant == "exp2":
        # the JAX kernel's m + ln(S) as m + log2(S), m its row max (of its
        # bf16-rounded h·log2 e), then both in natural units
        hb = _bf16(hj).astype(np.float64)
        m = (hb @ w.astype(np.float64) + bj).max(1)
        lse_j = (m + (lse_j - m) / LN2) * LN2
        lse, tlog, tlog_j = lse * LN2, tlog * LN2, tlog_j * LN2
    _close(lse, lse_j, TOL[variant])
    _close(tlog, tlog_j, TOL[variant])
    if variant in ("nomatch", "matmulonly"):
        assert not tlog.any() and not tlog_j.any()


def test_variant_plain_units():
    """exp2 in log2 units is base times 1/ln 2; nomatch's lse is base's;
    matmulonly is the logits' row sum, with no pad."""
    h, w, b, tgt = _inputs()
    args = [torch.from_numpy(a) for a in (h, w, b)]
    pad = torch.randn(N)
    t = torch.from_numpy(tgt).long()
    base = ce_variants.variant_plain("base", *args, pad, t)
    hs, bs, ps = ce_variants._scaled("exp2", args[0], args[2], pad)
    e2 = ce_variants.variant_plain("exp2", hs, args[1], bs, ps, t)
    torch.testing.assert_close(e2[0] * LN2, base[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(e2[1] * LN2, base[1], rtol=0, atol=1e-5)
    nm = ce_variants.variant_plain("nomatch", *args, pad, t)
    assert torch.equal(nm[0], base[0]) and not nm[1].any()
    mo = ce_variants.variant_plain("matmulonly", *args, pad, t)
    torch.testing.assert_close(mo[0], (args[0] @ args[1] + args[2]).sum(1))


@pytest.mark.parametrize("variant", ce_variants.VARIANTS)
def test_library_call_computes_the_variants_function(variant):
    """The bench's library yardstick of each variant computes what the
    variant returns at the bench's pad of -1e9 (bf16exp has none)."""
    h, w, b, tgt = _inputs()
    args = [torch.from_numpy(a) for a in (h, w, b)]
    pad = torch.full((N,), -1e9)
    t = torch.from_numpy(tgt).long()
    hv, bv, pv = ce_variants._scaled(variant, args[0], args[2], pad)
    call = ce_variants.library_call(variant, hv, args[1], bv, t)
    if variant == "bf16exp":
        assert call is None
        return
    want = ce_variants.variant_plain(variant, hv, args[1], bv, pv, t)
    got = call()
    got = got if isinstance(got, tuple) else (got,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    if len(got) > 1:
        torch.testing.assert_close(got[1][:, 0], want[1], rtol=0, atol=1e-5)
