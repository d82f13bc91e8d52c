"""K4's and K5's bf16 instantiations up to d 256 (``csrc/ce.cu``'s resident
kernels on the bf16 tensor cores), their order of summation emulated on
the CPU.

The kernels multiply bf16 operands by ``mma.sync.m16n8k16`` bf16 into f32
accumulators, whose adds truncate (``tests/test_torch_tf32.py``
``mma_sum_truncating``, here with k16 steps).  A logit sums its 32-column
partials (``ce_fwd.cuh`` kLogitSteps k8 steps: two k16 MMAs from a zeroed
accumulator) with Kahan's compensation; a dlogit is expf((logit + b) -
lse), scaled, rounded to bf16 before the products; each Y tile's products
(``BwdCfg`` kBy entities: two k16 MMAs at DT <= 128, one at DT 256) go
into a zeroed accumulator added to the output in f32, the splits of the
plan merged in order; db is the f32 sum of the unrounded dlogits, each
quad's four threads' sums added by the kernel's shuffle tree.  Emulated
at d 64, 128 and 256 against float64 of the same bf16 operands, beside
the plain bf16 CE (``fused_ce.ce_bwd_plain(bf16=True)``, which
``tests/test_torch_bf16.py`` holds to the JAX Pallas kernel) and the
order of the kernel before (four chained m16n8k8 TF32 MMAs a partial,
each k8 step's exact products summed into the accumulator).  torch and
numpy only; the card runs the kernels (``tests/test_torch_cuda.py``,
``chip_smoke.py``, ``tests/ce_bf16_seeds.py``).
"""

import re

import pytest
import torch

import test_torch_tf32 as tf32
from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda as fc
from c2dsr_tpu_torch.ops.bf16 import round_bf16
from test_torch_ce_cluster import (_bf16_case, _bf16_float64, _c_source,
                                   _kahan, bwd_cfg)

WIDTHS = (64, 128, 256)
SLOTS = 132          # the plans' slots: an H100's SMs, one block each
# the logits' distance from float64 in the bf16 MMAs' order, at most this
# many times the order of the kernel before (both take 32-column partials;
# the MMA's alignment of its 16 products to the largest can lose a few
# more low bits than the TF32 MMA's of 8)
LOGIT_K = 1.5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small ops, which threads do not speed up."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def logit_cols():
    """The columns of a logit partial: ``ce_fwd.cuh`` kLogitSteps k8
    steps."""
    m = re.search(r"constexpr int kLogitSteps = (\d+);",
                  _c_source("ce_fwd.cuh"))
    return 8 * int(m.group(1))


def _mma(a, b, k_step=16):
    """a [K, M]·b [K, n] from a zeroed truncating accumulator, k16 steps of
    exact products (m16n8k16 bf16; k_step 8: m16n8k8 TF32)."""
    return tf32.mma_sum_truncating([a], [b], k_step=k_step)


def logits(hb, wb, k_step=16):
    """hb·wb, d's 32-column partials each from a zeroed accumulator, added
    with Kahan's compensation (``logit_tile``)."""
    cols = logit_cols()
    d = hb.shape[1]
    return _kahan([_mma(hb.T[k:k + cols], wb[k:k + cols], k_step)
                   for k in range(0, d, cols)])


def _split_tiles(n_tiles, splits):
    """The tile ranges of a plan's splits (the kernels' ``per``)."""
    per = -(-n_tiles // splits)
    return [range(s * per, min(n_tiles, (s + 1) * per))
            for s in range(splits)]


def _product(x, y, by, splits, k_step=16):
    """Σ over entities k of x[k]ᵀ·y[k] (x [K, M], y [K, n]): each tile of by
    entities into a zeroed accumulator, added to its split's sum in f32,
    the splits merged in order in f32."""
    n_tiles = -(-x.shape[0] // by)
    out = torch.zeros(x.shape[1], y.shape[1])
    for tiles in _split_tiles(n_tiles, splits):
        part = torch.zeros_like(out)
        for i in tiles:
            part = part + _mma(x[i * by:(i + 1) * by], y[i * by:(i + 1) * by],
                               k_step)
        out = out + part
    return out


def _db(dlog, by, splits):
    """db as the dW pass sums it: in each split, thread t of a quad adds the
    rows 8·j + 2t, 8·j + 2t + 1 of each tile in order, the quad's four sums
    meet as (s0 + s1) + (s2 + s3); the splits merged in order."""
    N = dlog.shape[0]
    out = torch.zeros(dlog.shape[1])
    for tiles in _split_tiles(-(-N // by), splits):
        sums = [torch.zeros(dlog.shape[1]) for _ in range(4)]
        for n in range(tiles.start * by, min(N, tiles.stop * by)):
            sums[(n % 8) // 2] = sums[(n % 8) // 2] + dlog[n]
        out = out + ((sums[0] + sums[1]) + (sums[2] + sums[3]))
    return out


def k5_bf16(h, w, bm, lse, dlse, dt, tgt, k_step=16):
    """K5 bf16's (dh, dW, db) at d <= 256 in its order: logits as
    :func:`logits`, dlogits expf((logit + b) - lse) scaled and the target's
    dt added, rounded to bf16 for the products (``ce_bwd.cuh`` dlogits,
    add_py), the dh and dW passes' tiles and splits as the plan gives
    them."""
    N, d = h.shape
    V = w.shape[1]
    hb, wb = round_bf16(h), round_bf16(w)
    s = logits(hb, wb, k_step)
    dlog = dlse[:, None] * torch.exp((s + bm) - lse[:, None])
    hit = tgt < V
    rows = torch.arange(N)[hit]
    dlog[rows, tgt[hit]] += dt[hit]
    g = round_bf16(dlog)
    by = fc.resident_tile(d)[2]
    split_h, split_w = fc.bwd_splits(N, d, V, True, SLOTS)
    dh = _product(g.T, wb.T, by, split_h, k_step)
    dw = _product(hb, g, by, split_w, k_step)
    return dh, dw, _db(dlog, by, split_w)


@pytest.mark.parametrize("d", WIDTHS)
def test_bf16_mma_order_is_no_further_from_float64_than_plain(d):
    """Over 4 seeds at FK's scales, K5 bf16's order on the bf16 tensor
    cores puts dh, dW and db (max abs over max, the worst of the three,
    summed over the seeds) no further from K5 bf16's float64 function than
    the plain bf16 CE; its logits lie within LOGIT_K times the distance
    of the order of the kernel before (TF32 MMAs of k8 steps) from
    float64."""
    totals = {"mma": 0.0, "plain": 0.0}
    for seed in range(4):
        ins = _bf16_case(d, 1000 * d + seed)
        f64 = _bf16_float64(*ins)
        got = k5_bf16(*ins)
        plain = fused_ce.ce_bwd_plain(*ins, bf16=True)
        e_got = max(tf32.rel(a, b) for a, b in zip(got, f64))
        e_plain = max(tf32.rel(a, b) for a, b in zip(plain, f64))
        h, w = ins[0], ins[1]
        hb, wb = round_bf16(h), round_bf16(w)
        want = hb.double() @ wb.double()
        e_new = tf32.rel(logits(hb, wb), want)
        e_old = tf32.rel(logits(hb, wb, k_step=8), want)
        print(f"d={d} seed {seed}: from float64 K5 bf16 {e_got:.3e}, plain "
              f"bf16 {e_plain:.3e}; logits {e_new:.3e} (kernel before "
              f"{e_old:.3e}, plain f32 {tf32.rel(hb @ wb, want):.3e})")
        assert e_new <= LOGIT_K * e_old, (e_new, e_old)
        totals["mma"] += e_got
        totals["plain"] += e_plain
    assert totals["mma"] <= totals["plain"], totals


@pytest.mark.parametrize("d", WIDTHS)
def test_the_emulated_tiles_are_the_kernels(d):
    """The emulation's constants are the source's: ``BwdCfg``'s Y tile
    (kBy: two k16 MMAs a tile up to DT 128, one at 256) and X rows a block
    (kBx) are ``fused_ce_cuda.resident_tile``'s, a logit partial is 32
    columns (two k16 steps), and a bf16 row holds DT + 8 elements, an odd
    number of 16-byte units (``Tile``: ldmatrix phases free of bank
    conflicts)."""
    dt, bx, by = fc.resident_tile(d)
    assert bwd_cfg("kBy", dt) == by and bwd_cfg("kBx", dt) == bx
    assert by % 16 == 0 and logit_cols() == 32
    m = re.search(r"static constexpr int ld = kBf \? DT \+ (\d+) : DT \+ 4;",
                  _c_source("ce_fwd.cuh"))
    row_bytes = 2 * (dt + int(m.group(1)))
    assert row_bytes % 16 == 0 and (row_bytes // 16) % 2 == 1
