"""The towers' attention products past L 64 on the tensor cores: their order
of summation emulated on the CPU.

K2's ``encoder_fwd_attn_kernel`` and K3's ``attn_bwd_dq_kernel`` /
``attn_bwd_dkv_kernel`` (``csrc/encoder.cu``, ``csrc/encoder_bwd.cu``, on
``csrc/encoder_common.cuh``'s ``attn_qk`` and ``attn_mm``) run six
products on ``mma.sync``, whose f32 accumulators add with truncation
(``tests/test_torch_tf32.py`` ``mma_sum_truncating``):

* q·kᵀ and do·vᵀ, k over the head's columns.  f32: tc.cuh's 6-term form
  (each operand split into three TF32 parts, six products a k8-step from a
  zeroed partial).  bf16: each k16 step's MMA from a zeroed partial.  The
  partials are Kahan-added to the sum in f32.
* p·v, ds·k, dsᵀ·q and drop(p)ᵀ·do, k over the positions of chunks of
  kAttnRows (64) keys or queries.  f32: 3xTF32, each k8-step's three MMAs
  from a zeroed partial added in f32.  bf16: each k16 step's MMA from a
  zeroed partial added in f32, but for K2's p·v, an f32 FMA chain over the
  keys (``fma_chain``): on an H100 the MMA's sums of a sharp softmax's
  products put K2 bf16 further from float64 than the plain bf16 tower.

No chain of MMAs longer than a k-step stays in the truncating
accumulator: with a 64-position chunk's 24 MMAs chained, the four 3xTF32
products lie 2-3x further from float64 than an f32 FMA chain (below), and
on an H100 K3's dx lay past 1.25x the FFMA kernels' distance (PERF.md
§6).

Emulated at head dim 16, 64 and 128 and L 15, 65 and 200 on a causal
softmax's operands against float64 of the same operands, beside the plain
product: the f32 orders within ``test_torch_tf32.TOL`` of float64, the
bf16 ones within 1.25 times the plain bf16 product's distance (the limit
``chip_smoke.py``'s BF16_F64_K puts on the towers) over the shapes, and
within 2.5 times at each.  torch and numpy
only; the card runs the kernels (``tests/test_torch_cuda.py``,
``chip_smoke.py``, ``tests/tower_bf16_seeds.py --seeds 50``, its ``l200``
shape).
"""

import functools
import re

import numpy as np
import pytest
import torch

import test_torch_tf32 as tf32
from c2dsr_tpu_torch.ops.bf16 import round_bf16
from test_torch_ce_cluster import _c_source

HEAD_DIMS = (16, 64, 128)
LENGTHS = (15, 65, 200)
PRODUCTS = ("qk", "dov", "pv", "dsk", "dsq", "pdo")
WIDE = {"qk", "dov"}      # k over the head's columns: 6 terms in f32
F64_K = 1.25
SHORT_K = 2.5       # at one shape (test_bf16_order_per_shape)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small ops, which threads do not speed up."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _constexpr(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


CHUNK = _constexpr(_c_source("encoder_common.cuh"), "kAttnRows")


def _kahan(parts):
    """The partials summed in f32 with Kahan's compensation c, the sum s -
    c (the kernels' ``add_kahan`` and ``attn_sum``)."""
    s = c = None
    for x in parts:
        if s is None:
            s, c = torch.zeros_like(x), torch.zeros_like(x)
        y = x - c
        t = s + y
        c = (t - s) - y
        s = t
    return s - c


def six_terms(a, b):
    """a [K, M]ᵀ·b [K, n] in tc.cuh's 6-term form: a k8-step's mid·mid,
    small·big, big·small, mid·big, big·mid, big·big from a zeroed,
    truncating accumulator, Kahan-added to the sum in f32."""
    def parts(x):
        big = tf32.tf32_rna(x)
        rest = x - big
        mid = tf32.tf32_rna(rest)
        return big, mid, tf32.tf32_trunc(rest - mid)

    (ab, am, as_), (bb, bm, bs) = parts(a), parts(b)
    return _kahan(tf32.mma_sum_truncating(
        [am[k], as_[k], ab[k], am[k], ab[k], ab[k]],
        [bm[k], bb[k], bs[k], bb[k], bm[k], bb[k]])
        for k in (slice(k0, k0 + 8) for k0 in range(0, a.shape[0], 8)))


def three_terms(a, b, step=8):
    """a [K, M]ᵀ·b [K, n] in 3xTF32, each ``step`` of k (small·big,
    big·small, big·big a k8-step) from a zeroed, truncating accumulator,
    added to the sum in f32, in order (step CHUNK: a chunk's chain)."""
    (ab, as_), (bb, bs) = tf32.split(a), tf32.split(b)
    out = torch.zeros(a.shape[1], b.shape[1])
    for k0 in range(0, a.shape[0], step):
        k = slice(k0, k0 + step)
        out = out + tf32.mma_sum_truncating([as_[k], ab[k], ab[k]],
                                            [bb[k], bs[k], bb[k]])
    return out


def bf16_steps(a, b, kahan=False):
    """a [K, M]ᵀ·b [K, n] of bf16 operands, each k16 step's exact products
    from a zeroed, truncating accumulator, added in f32 (with ``kahan``
    Kahan-added: the logits)."""
    steps = (tf32.mma_sum_truncating([a[k0:k0 + 16]], [b[k0:k0 + 16]],
                                     k_step=16)
             for k0 in range(0, a.shape[0], 16))
    if kahan:
        return _kahan(steps)
    out = torch.zeros(a.shape[1], b.shape[1])
    for x in steps:
        out = out + x
    return out


def fma_chain(a, b):
    """a [K, M]ᵀ·b [K, n] as the FFMA kernels sum it: one f32 fused
    multiply-add a k, in order."""
    out = torch.zeros(a.shape[1], b.shape[1])
    for k in range(a.shape[0]):
        out = (out.double() + a[k].double()[:, None]
               * b[k].double()[None, :]).float()
    return out


def _operands(product, dh, L, seed):
    """(a [K, M], b [K, n]) of one head's product on a causal softmax at
    the towers' scales: q, k, v of unit scale, do small, p a causal
    softmax with some all-masked rows, ds = p·(dp - Σ dp·p)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32))

    q, k, v = normal(L, dh), normal(L, dh), normal(L, dh)
    do = normal(L, dh, scale=1e-3)
    logits = q.double() @ k.double().T / np.sqrt(dh)
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    causal[: L // 8] = False                     # all-masked rows: uniform
    p = torch.softmax(torch.where(causal, logits, -1e9 + 0 * logits), -1)
    dp = do.double() @ v.double().T
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).float()
    p = p.float()
    return {"qk": (q.T, k.T), "dov": (do.T, v.T), "pv": (p.T, v),
            "dsk": (ds.T, k), "dsq": (ds, q), "pdo": (p, do)}[product]


def _cases():
    return [(pr, dh, L) for pr in PRODUCTS for dh in HEAD_DIMS
            for L in LENGTHS]


@pytest.mark.parametrize("product,dh,L", _cases())
def test_f32_order_is_f32_accurate(product, dh, L):
    """Each product in the f32 kernels' order lies within TOL (relative to
    the largest element) of float64 of the same operands; the plain f32
    product's distance is printed beside it."""
    a, b = _operands(product, dh, L, seed=dh + L)
    want = a.double().T @ b.double()
    got = (six_terms if product in WIDE else three_terms)(a, b)
    e, e_plain = tf32.rel(got, want), tf32.rel(a.T @ b, want)
    print(f"{product} dh={dh} L={L}: from float64 {e:.3e} (plain f32 "
          f"{e_plain:.3e})")
    assert e <= tf32.TOL, e


def _fro(got, want):
    return float((got.double() - want).norm() / want.norm())


@pytest.mark.parametrize("product", [p for p in PRODUCTS if p not in WIDE])
def test_f32_k_steps_are_as_near_float64_as_an_fma_chain(product):
    """The four 3xTF32 products with each k8-step's partial added in f32
    lie within F64_K times an f32 FMA chain's (the FFMA kernels')
    relative Frobenius distance from float64, summed over the shapes and
    3 seeds; a chunk's 24 MMAs chained in the truncating accumulator lie
    further than twice it."""
    tot = {"steps": 0.0, "chunk": 0.0, "fma": 0.0}
    for dh in (64, 128):
        for L in (65, 200):
            for seed in range(3):
                a, b = _operands(product, dh, L, seed=10 * seed + dh + L)
                want = a.double().T @ b.double()
                tot["steps"] += _fro(three_terms(a, b), want)
                tot["chunk"] += _fro(three_terms(a, b, CHUNK), want)
                tot["fma"] += _fro(fma_chain(a, b), want)
    print(f"{product}: relative Frobenius from float64 {tot}")
    assert tot["steps"] <= F64_K * tot["fma"], tot
    assert tot["chunk"] > 2 * tot["fma"], tot


@functools.lru_cache(maxsize=None)
def _bf16_distances(product, dh, L):
    """(the bf16 kernels' order, the plain bf16 product): distances from
    float64 of the same rounded operands, summed over 3 seeds."""
    kernel = plain = 0.0
    for seed in range(3):
        a, b = (round_bf16(t) for t in _operands(product, dh, L,
                                                   seed=100 * seed + dh + L))
        want = a.double().T @ b.double()
        kernel += tf32.rel(bf16_steps(a, b, kahan=product in WIDE), want)
        plain += tf32.rel(a.T @ b, want)
    print(f"{product} dh={dh} L={L}: from float64 kernel {kernel:.3e}, "
          f"plain {plain:.3e}")
    return kernel, plain


@pytest.mark.parametrize("product", PRODUCTS)
def test_bf16_order_is_as_near_float64_as_plain(product):
    """Each product of bf16-rounded operands in the bf16 kernels' order,
    summed over the head dims and lengths, lies within F64_K times the
    plain bf16 product's distance from float64 of the same rounded
    operands."""
    tot = [sum(x) for x in zip(*(_bf16_distances(product, dh, L)
                                 for dh in HEAD_DIMS for L in LENGTHS))]
    assert tot[0] <= F64_K * tot[1], tot


@pytest.mark.parametrize("product,dh,L", _cases())
def test_bf16_order_per_shape(product, dh, L):
    """At each shape within SHORT_K times the plain distance, a guard
    against a gross fault in one order: at a few ulps a shape's ratio is
    noisy, and where k is at most 16 (head dim 16 for q·kᵀ and do·vᵀ, L 15
    for the others) a product is one m16n8k16, whose truncating sum of 16
    exact products no order can split (up to ~1.9x the plain f32 sum's
    distance over 3 seeds)."""
    kernel, plain = _bf16_distances(product, dh, L)
    assert kernel <= SHORT_K * plain, (kernel, plain)


@pytest.mark.parametrize("order", ["three", "bf16", "bf16_logits"])
def test_zero_padding_changes_nothing(order):
    """Zero-filled positions past L (a chunk's last keys or queries: whole
    k-steps of zeros, added in f32) and head columns past the head dim (at
    most half a bf16 k16 step: the f32 k8-steps end at the head dim, whose
    multiple of 8 they are, so no k-step of zeros reaches a Kahan add)
    leave each order's sums bitwise as they are."""
    logits = order == "bf16_logits"
    a, b = _operands("qk" if logits else "pv", 40, 65, seed=3)
    if order != "three":
        a, b = round_bf16(a), round_bf16(b)
    fn = {"three": three_terms, "bf16": bf16_steps,
          "bf16_logits": lambda x, y: bf16_steps(x, y, kahan=True)}[order]
    pad = 48 - a.shape[0] if logits else CHUNK * 2 - a.shape[0]
    a_pad = torch.cat([a, torch.zeros(pad, a.shape[1])])
    b_pad = torch.cat([b, torch.zeros(pad, b.shape[1])])
    assert torch.equal(fn(a, b), fn(a_pad, b_pad))


def test_the_emulated_chunks_are_the_kernels():
    """The emulation's steps are the kernels': chunks of kAttnRows (64)
    positions, each k8-step's 3xTF32 MMAs from a zeroed partial
    (``mma_tf32_zero``), the head's columns staged kHc at a time and
    zero-filled to a multiple of 32 (attn_ld), each bf16 k16 step from a
    zeroed partial, q·kᵀ and do·vᵀ through attn_qk's 6-term split and
    Kahan adds, the rows of every staged tile an f32 stride of 4 mod 32 or
    an odd count of 16-byte units in bf16."""
    src = _c_source("encoder_common.cuh")
    assert CHUNK == 64 and _constexpr(src, "kHc") == 128
    assert "return (cw + 31) / 32 * 32 + (bf ? 8 : 4);" in src
    assert "for (int k0 = 0; k0 < cw; k0 += 16)" in src
    assert "tc::split_parts<6>" in src
    assert src.count("add_kahan(S[") == 2
    assert "attn_sum(S, Sc);" in _c_source("encoder_bwd.cu")
    # K2 keeps each logit's compensated sum as two parts through its
    # softmax; the emulation's Kahan sum s - c is their sum
    assert "const float lo = (S[j][e] - hi) - Sc[j][e];" in _c_source(
        "encoder.cu")
    assert "tc::mma_tf32_zero(part[j], as, bb[j])" in src
    assert src.count("tc::mma_bf16_zero(part[0]") == 2
    assert "tc::mma_bf16(" not in src
    for cw in (8, 16, 40, 64, 72, 128):
        for bf in (False, True):
            ld = (cw + 31) // 32 * 32 + (8 if bf else 4)
            if bf:
                assert (2 * ld) % 16 == 0 and (2 * ld // 16) % 2 == 1
            else:
                assert ld % 32 == 4
    for name in ("encoder.cu", "encoder_bwd.cu"):
        assert "add_compensated" in _c_source(name)   # whole-sequence
    assert "attn_mm<kBf>" in _c_source("encoder_bwd.cu")
    # K2's p·v: 3xTF32 in f32; an FFMA chain over the keys in bf16
    fwd = _c_source("encoder.cu")
    assert "attn_mm<false>(RegsA{S}, V, ld, cw, acc);" in fwd
    assert "acc[r][m] = fmaf(pk, v[m], acc[r][m]);" in fwd
    assert "attn_qk<kBf>(Q, K" in _c_source("encoder.cu")
    assert "attn_qk<kBf>(G, C" in _c_source("encoder_bwd.cu")
