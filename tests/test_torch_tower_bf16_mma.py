"""The towers' bf16 instantiations (K2's and K3's products with a weight,
K3's weight gradients) on the bf16 tensor cores: their order of summation
emulated on the CPU.

The kernels (``csrc/tc.cuh`` ``gemm_tile_bf16``, ``csrc/encoder_bwd.cu``
``wg_tile_bf16``) multiply bf16 operands by ``mma.sync.m16n8k16`` into f32
accumulators, whose adds truncate (``tests/test_torch_tf32.py``
``mma_sum_truncating``, here with k16 steps).  Each 32-k chunk (a GEMM's
kKc k-steps, a weight gradient's kWgRows rows) sums from a zeroed
accumulator, and the chunk partials are added in f32, to nearest; the
weight gradient's row splits are merged in order (``sum_partials_kernel``).
The kernels before ran m16n8k8 TF32 MMAs of the rounded operands: the
GEMMs in the same chunk partials, the weight gradients with a split's
every row chained in the truncating accumulator.  Emulated at d 40, 128
and 1,024 on a few hundred rows against float64 of the same rounded
operands, beside the plain bf16 product (``ops/bf16.matmul``, which
``tests/test_torch_bf16.py`` holds, in the plain bf16 tower, to the JAX
Pallas tower).  torch and numpy only; the card runs the kernels
(``tests/test_torch_cuda.py``, ``chip_smoke.py``,
``tests/tower_bf16_seeds.py``).
"""

import re

import numpy as np
import pytest
import torch

import test_torch_tf32 as tf32
from c2dsr_tpu_torch.ops import bf16
from c2dsr_tpu_torch.ops.bf16 import round_bf16
from test_torch_ce_cluster import _c_source

WIDTHS = (40, 128, 1024)
ROWS = 320           # rows of the call (a GEMM's n, a weight gradient's k)
COLS = 64            # output columns emulated (each column is independent)
CHUNK = 32           # tc.cuh kKc, encoder_bwd.cu kWgRows
SPLITS = 2           # weight-gradient row splits (wg_splits: one to many)
# the new order's distance from float64, at most this many times the plain
# bf16 product's (the limit chip_smoke.py's BF16_F64_K puts on the towers)
F64_K = 1.25


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small ops, which threads do not speed up."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def chunked(a, b, k_step=16):
    """a [K, M]ᵀ·b [K, n] as the bf16 tiles sum it: each CHUNK of k from a
    zeroed truncating accumulator in k_step steps of exact products (16:
    m16n8k16 bf16; 8: the m16n8k8 TF32 MMAs before), the partials added in
    f32, to nearest, in order."""
    out = torch.zeros(a.shape[1], b.shape[1])
    for k0 in range(0, a.shape[0], CHUNK):
        out = out + tf32.mma_sum_truncating(
            [a[k0:k0 + CHUNK]], [b[k0:k0 + CHUNK]], k_step=k_step)
    return out


def wgrad(x, y, chained=False):
    """xᵀ·y over the rows of x [N, d] and y [N, m] in SPLITS row splits of
    a multiple of CHUNK rows (the kernel's ``per``), merged in order in
    f32: each split in chunks (:func:`chunked`), or with ``chained`` all
    of a split's rows in the truncating accumulator in k8 steps (the TF32
    tile before)."""
    per = -(-x.shape[0] // SPLITS)
    per = -(-per // CHUNK) * CHUNK
    out = torch.zeros(x.shape[1], y.shape[1])
    for r0 in range(0, x.shape[0], per):
        xs, ys = x[r0:r0 + per], y[r0:r0 + per]
        out = out + (tf32.mma_sum_truncating([xs], [ys], k_step=8)
                     if chained else chunked(xs, ys))
    return out


def _case(d, seed):
    """FK-like scales: LayerNorm-scale activations, weights of the towers'
    init, a small incoming gradient."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(ROWS, d)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(d, COLS)) / np.sqrt(d))
                         .astype(np.float32))
    g = torch.from_numpy((rng.normal(size=(ROWS, COLS)) * 1e-3)
                         .astype(np.float32))
    return a, w, g


@pytest.mark.parametrize("d", WIDTHS)
def test_weight_product_order_is_as_near_float64_as_plain(d):
    """A·W (K2's forward products; K3's A·Wᵀ sum the same way) in the bf16
    tile's order lies within F64_K times the plain bf16 product's distance
    from float64 of the same rounded operands, over 3 seeds."""
    tot = {"new": 0.0, "old": 0.0, "plain": 0.0}
    for seed in range(3):
        a, w, _ = _case(d, 100 * d + seed)
        ab, wb = round_bf16(a), round_bf16(w)
        want = ab.double() @ wb.double()
        e = {"new": tf32.rel(chunked(ab.T, wb), want),
             "old": tf32.rel(chunked(ab.T, wb, k_step=8), want),
             "plain": tf32.rel(bf16.matmul(a, w), want)}
        print(f"d={d} seed {seed}: from float64 " + ", ".join(
            f"{k} {v:.3e}" for k, v in e.items()))
        for k in tot:
            tot[k] += e[k]
    assert tot["new"] <= F64_K * tot["plain"], tot


@pytest.mark.parametrize("d", WIDTHS)
def test_weight_gradient_order_is_as_near_float64_as_plain(d):
    """dW = Xᵀ·Y (K3's weight gradients) in the bf16 tile's order (32-row
    stages from a zeroed accumulator, added in f32) lies within F64_K
    times the plain bf16 gradient's distance from float64, over 3 seeds;
    the TF32 tile's order before (a split chained in the truncating
    accumulator) is printed beside it."""
    tot = {"new": 0.0, "chained": 0.0, "plain": 0.0}
    for seed in range(3):
        x, _, y = _case(d, 200 * d + seed)
        xb, yb = round_bf16(x), round_bf16(y)
        want = xb.double().T @ yb.double()
        e = {"new": tf32.rel(wgrad(xb, yb), want),
             "chained": tf32.rel(wgrad(xb, yb, chained=True), want),
             "plain": tf32.rel(xb.T @ yb, want)}
        print(f"d={d} seed {seed}: from float64 " + ", ".join(
            f"{k} {v:.3e}" for k, v in e.items()))
        for k in tot:
            tot[k] += e[k]
    assert tot["new"] <= F64_K * tot["plain"], tot


@pytest.mark.parametrize("pad", [8, 24])
def test_zero_filled_k_steps_change_nothing(pad):
    """At d 40 (k % 16 == 8) the tile's last k16 step takes 8 zero-filled
    k-steps, and the last chunk more: zero-filled columns of A and rows of
    W leave the order's sum bitwise as it was, and so do zero-filled rows
    of a weight gradient's last stage."""
    a, w, g = _case(40, 7)
    ab, wb, gb = round_bf16(a), round_bf16(w), round_bf16(g)
    a_pad = torch.cat([ab, torch.zeros(ROWS, pad)], 1)
    w_pad = torch.cat([wb, torch.zeros(pad, COLS)], 0)
    assert torch.equal(chunked(ab.T, wb), chunked(a_pad.T, w_pad))
    x_pad = torch.cat([ab[:ROWS - pad], torch.zeros(pad, 40)], 0)
    y_pad = torch.cat([gb[:ROWS - pad], torch.zeros(pad, COLS)], 0)
    assert torch.equal(chunked(ab[:ROWS - pad], gb[:ROWS - pad]),
                       chunked(x_pad, y_pad))


def _constexpr(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_the_emulated_chunks_are_the_kernels():
    """The emulation's chunk is the kernels': tc.cuh's kKc and
    encoder_bwd.cu's kWgRows are 32 (two k16 steps), and every bf16 row in
    shared memory (A and W of gemm_tile_bf16, X and Y of wg_tile_bf16) is
    an odd count of 16-byte units, so ldmatrix phases meet each bank
    once."""
    tc, bwd = _c_source("tc.cuh"), _c_source("encoder_bwd.cu")
    kc, rows = _constexpr(tc, "kKc"), _constexpr(bwd, "kWgRows")
    assert kc == CHUNK and rows == CHUNK
    assert "kLda = kKc + 8;" in tc and "KM ? NT + 8 : kKc + 8;" in tc
    assert ("kLdx16 = kWgK + 8;" in bwd and "kLdy16 = kWgM + 8;" in bwd)
    widths = [kc + 8, _constexpr(bwd, "kWgK") + 8, _constexpr(bwd, "kWgM") + 8]
    widths += [nt + 8 for nt in (64, 128, 256)]
    for n in widths:
        assert (2 * n) % 16 == 0 and (2 * n // 16) % 2 == 1, n
