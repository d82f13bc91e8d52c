"""K5's cluster kernels past d 256 (``csrc/ce_cluster.cu``), on the CPU: the
order in which they sum a logit, emulated, and the plan the wrapper makes.

A cluster of c = ceil(d / 256) blocks splits d into slices; each block sums
its slice's products in partials added in f32 (32-column 3xTF32 products
in a truncating accumulator, or 16-column exact bf16 products), and every
block adds the c slice sums in rank order.  (a) emulates the f32 order
against float64 beside today's sequential one (``csrc/ce_fwd.cuh``
logit_tile over all of d) and plain f32; (b) the bf16 instantiation's
(exact products, zeroed f32 chunk partials of 16 columns, Kahan sums,
dlogits rounded to bf16) against the plain bf16 CE, each against float64;
(c) the plan (``ops/fused_ce_cuda`` ``cluster_plan``), the plans of
``ce.cu``'s kernels and the cost model they share (``best_splits``), the
route, and the constants the C source shares with them.  torch and numpy
only; the card runs the kernels
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

import test_torch_tf32 as tf32
from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda as fc
from c2dsr_tpu_torch.ops.bf16 import round_bf16

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "c2dsr_tpu_torch", "csrc")

# (a): the cluster order's logits and lse from float64, relative to the
# largest, at most this many times the sequential order's (or plain f32's,
# the larger): both take the same 32-column partials, and the cluster adds
# c slice sums where the sequential order adds the next partial
ORDER_K = 1.5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small ops, which threads do not speed up."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _slices(d):
    """[(first column, last + 1)] of each block of the cluster at width d."""
    c, w = fc.cluster_slices(d)
    return [(r * w, min((r + 1) * w, d)) for r in range(c)]


def _cluster_f32(h, w, d):
    """The f32 cluster kernels' logits h·w: each slice in 32-column 3xTF32
    partials (tf32.mma_sum_partials), the slices added in f32 in rank
    order."""
    (hb, hs), (wb, ws) = tf32.split(h), tf32.split(w)
    out = None
    for k0, k1 in _slices(d):
        s = slice(k0, k1)
        part = tf32.mma_sum_partials([hs.T[s], hb.T[s], hb.T[s]],
                                     [wb[s], ws[s], wb[s]])
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("d", [264, 520, 1024, 2048])
def test_cluster_logit_order_is_as_close_to_float64_as_the_sequential(d):
    """Logits of a trained state's size (|h| ~ 4, |W| ~ 1: the case where
    the tensor cores' truncating accumulator showed, test_torch_tf32) in
    the cluster's order lie within ORDER_K times the distance of today's
    sequential order (one run of 32-column partials over all of d) from
    float64, and so does their lse."""
    rng = np.random.default_rng(d)
    N, V = 32, 96
    h = torch.from_numpy((rng.normal(size=(N, d)) * 4.0).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(d, V)).astype(np.float32))
    want = h.double() @ w.double()
    lse64 = torch.logsumexp(want, 1)
    (hb, hs), (wb, ws) = tf32.split(h), tf32.split(w)
    orders = {"cluster": _cluster_f32(h, w, d),
              "sequential": tf32.mma_sum_partials([hs.T, hb.T, hb.T],
                                                  [wb, ws, wb]),
              "plain": h @ w}
    errs = {k: (tf32.rel(s, want),
                tf32.rel(torch.logsumexp(s.double(), 1), lse64))
            for k, s in orders.items()}
    print(f"d={d} slices {_slices(d)}: logits, lse from float64 {errs}")
    for i in range(2):
        ref = max(errs["sequential"][i], errs["plain"][i])
        assert errs["cluster"][i] <= ORDER_K * ref, errs


def _bf16_case(d, seed):
    """h, w, the masked bias, lse (the plain bf16 forward), dlse, dt and
    targets at width d, FK's scales (``chip_smoke._ce_inputs``)."""
    rng = np.random.default_rng(seed)
    N, V, n_real = 64, 260, 250

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    h = f32(rng.normal(size=(N, d)))
    w_np = rng.normal(size=(d, V)) * 0.05
    w_np[:, n_real:] = 0.0
    w = f32(w_np)
    bm = fused_ce.mask_bias(f32(rng.normal(size=V) * 0.1), n_real)
    pad = f32(rng.normal(size=N))
    tgt_np = rng.integers(0, n_real, size=N)
    tgt_np[::5] = n_real
    tgt = torch.from_numpy(tgt_np)
    real = (tgt != n_real).float()
    dlse = f32(rng.normal(size=N) / N) * real
    dt = f32(rng.normal(size=N) / N) * real
    lse, _ = fused_ce.ce_fwd_plain(h, w, bm, pad, tgt, bf16=True)
    return h, w, bm, lse, dlse, dt, tgt


def _kahan(parts):
    """f32 parts summed in order with Kahan's compensation."""
    s, comp = parts[0], torch.zeros_like(parts[0])
    for p in parts[1:]:
        y = p - comp
        u = s + y
        comp = (u - s) - y
        s = u
    return s


def _cluster_bf16(h, w, bm, lse, dlse, dt, tgt, d):
    """The bf16 cluster kernels, emulated: exact products of bf16-rounded h
    and W, each 16 columns of a slice summed into a zeroed f32 partial, the
    partials and then the slices added with Kahan's compensation; dlogits
    expf(logit + b - lse), rounded to bf16 for the products; each 32-entity
    tile's products summed in f32 and added to the output in f32; db the
    f32 sum of the dlogits."""
    hb, wb = round_bf16(h).double(), round_bf16(w).double()
    slices = [_kahan([(hb[:, k:min(k + 16, k1)] @ wb[k:min(k + 16, k1)])
                      .float() for k in range(k0, k1, 16)])
              for k0, k1 in _slices(d)]
    logits = _kahan(slices)
    V = w.shape[1]
    dlog = dlse[:, None] * torch.exp((logits + bm) - lse[:, None])
    hit = tgt < V
    rows = torch.arange(h.shape[0])[hit]
    dlog[rows, tgt[hit]] += dt[hit]
    g = round_bf16(dlog).double()
    dh = torch.zeros(h.shape)
    for v in range(0, V, 32):
        dh = dh + (g[:, v:v + 32] @ wb[:, v:v + 32].T).float()
    dw = torch.zeros(w.shape)
    for n in range(0, h.shape[0], 32):
        dw = dw + (hb[n:n + 32].T @ g[n:n + 32]).float()
    return dh, dw, dlog.sum(0)


def _bf16_float64(h, w, bm, lse, dlse, dt, tgt):
    """K5 bf16's function in float64 (``tests/ce_bf16_seeds.py``'s): the
    same bf16-rounded h and W, the float64 dlogits rounded to bf16 before
    the products."""
    hb, wb = round_bf16(h).double(), round_bf16(w).double()
    dlog = dlse.double()[:, None] * torch.exp(
        hb @ wb + bm.double() - lse.double()[:, None])
    hit = tgt < w.shape[1]
    rows = torch.arange(h.shape[0])[hit]
    dlog[rows, tgt[hit]] += dt.double()[hit]
    g = round_bf16(dlog)
    return g @ wb.T, hb.T @ g, dlog.sum(0)


@pytest.mark.parametrize("d", [520, 1024])
def test_cluster_bf16_order_is_no_further_from_float64_than_plain(d):
    """Over 4 seeds, the bf16 cluster order's dh, dW and db lie no further
    from K5 bf16's float64 function (max abs over max, summed over the
    seeds) than the plain bf16 CE's: a dlogit near a bf16 rounding
    boundary rounds as float64's does when its logit is as near the exact
    one as the plain f32 product's."""
    totals = {"cluster": 0.0, "plain": 0.0}
    for seed in range(4):
        ins = _bf16_case(d, 100 * d + seed)
        f64 = _bf16_float64(*ins)
        em = _cluster_bf16(*ins, d)
        plain = fused_ce.ce_bwd_plain(*ins, bf16=True)
        e_em = max(tf32.rel(a, b) for a, b in zip(em, f64))
        e_plain = max(tf32.rel(a, b) for a, b in zip(plain, f64))
        print(f"d={d} seed {seed}: from float64 cluster {e_em:.3e}, plain "
              f"bf16 {e_plain:.3e}")
        totals["cluster"] += e_em
        totals["plain"] += e_plain
    assert totals["cluster"] <= totals["plain"], totals


@pytest.mark.parametrize("bf16", [False, True])
def test_cluster_plan_covers_every_width(bf16):
    """At every d % 8 == 0 in 264-2,048: at most 8 blocks, slices of at
    most 256 columns (multiples of 8, the last not empty) summing to d, a
    compile-time width that holds the slice, shared memory within a
    block's 232,448 bytes, and splits that keep the chain caps."""
    N, V = 10240, 30720
    for d in range(264, fc.CLUSTER_MAX + 1, 8):
        c, w = fc.cluster_slices(d)
        widths = [k1 - k0 for k0, k1 in _slices(d)]
        assert 1 < c <= fc.CLUSTER_RANKS and c == -(-d // 256), d
        assert sum(widths) == d and all(0 < x <= 256 and x % 8 == 0
                                        for x in widths), (d, widths)
        plan = fc.cluster_plan(N, d, V, bf16, slots=16)
        assert (plan.c, plan.w) == (c, w)
        assert w <= plan.ws == fc.slice_width(w) and plan.ws % 32 == 0
        assert plan.smem == fc.cluster_smem(w, bf16) <= fc.SMEM_LIMIT, d
        per_h = -(-(-(-V // fc.CLUSTER_TILE)) // plan.split_h)
        per_w = -(-(-(-N // fc.CLUSTER_TILE)) // plan.split_w)
        assert per_h * fc.CLUSTER_TILE <= fc.MAX_CHAIN, (d, plan)
        assert per_w * fc.CLUSTER_TILE <= fc.MAX_ROW_CHAIN, (d, plan)
    # d 264 is two slices of 136 and 128, not 256 + 8
    assert _slices(264) == [(0, 136), (136, 264)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d,wide", [(64, False), (128, False), (256, False),
                                    (256, True), (520, True), (4096, True)])
def test_resident_and_wide_plans_keep_the_chain_caps(d, wide, bf16):
    """The plans of ce.cu's kernels (the resident ones up to RESIDENT, the
    wide ones above it or where asked), at FK's train rows, a 1M-item
    vocab and the card tests' shape: every split of K5's dh pass takes at
    most MAX_CHAIN vocab columns and of its dW pass at most MAX_ROW_CHAIN
    rows, and no split of K5 or of K4 is empty."""
    if d <= fc.RESIDENT and not wide:
        _, bx, by = fc.resident_tile(d)
        fwd_by = by
    else:
        bx, by, fwd_by = fc.WIDE_ROWS, fc.WIDE_BWD_TILE, fc.WIDE_FWD_TILE
    assert bx % 16 == 0 and by % 8 == 0

    def per(tiles, splits):
        """Tiles a split takes, after checking none is empty."""
        p = -(-tiles // splits)
        assert 1 <= splits <= tiles and -(-tiles // p) == splits
        return p

    for N, V in ((10240, 30720), (10240, 501760), (300, 1028)):
        for slots in (1, 132, 264):
            split_h, split_w = fc.bwd_splits(N, d, V, bf16, slots, wide)
            assert per(-(-V // by), split_h) * by <= fc.MAX_CHAIN
            assert per(-(-N // by), split_w) * by <= fc.MAX_ROW_CHAIN
            if not wide:
                per(-(-V // fwd_by), fc.fwd_splits(N, d, V, bf16, slots))


@pytest.mark.parametrize("d", [64, 128, 256, 1024])
def test_bf16_plans_fill_whole_waves(d):
    """The bf16 instantiations' plans at FK's train rows, each domain's
    vocab and one or two blocks an SM: K4's and K5's splits keep the chain
    caps, and the resident kernels' fill at least 90% of the waves they
    take (the merge's reads grow beside a bf16 tile, priced at the bf16
    MMA's rate, so fewer splits can win)."""
    N = 10240
    for V in (30720, 36864):
        for slots in (132, 264):
            split_f = fc.fwd_splits(N, d, V, True, slots)
            if d > fc.RESIDENT:
                tiles = -(-V // fc.WIDE_FWD_TILE)
                assert 1 <= split_f <= tiles
                continue
            _, bx, by = fc.resident_tile(d)
            split_h, split_w = fc.bwd_splits(N, d, V, True, slots)
            assert -(-(-(-V // by)) // split_h) * by <= fc.MAX_CHAIN
            assert -(-(-(-N // by)) // split_w) * by <= fc.MAX_ROW_CHAIN
            for x_tiles, splits in ((-(-N // bx), split_f),
                                    (-(-N // bx), split_h),
                                    (-(-V // bx), split_w)):
                blocks = x_tiles * splits
                waves = -(-blocks // slots)
                assert blocks >= 0.9 * waves * slots, (V, slots, splits)


def test_plans_fill_whole_waves():
    """best_splits, every plan's cost model: with no chain cap binding, the
    split count that fills the slots in whole waves wins, and a cap raises
    the count to it."""
    # 10 X tiles, 64 Y tiles, 40 slots: 4 splits fill them in one wave
    assert fc.best_splits(10, 64, 40, 1.0, 0.0) == 4
    # at least 20 splits where 20 are asked for, and none empty: 64 tiles
    # in 20 or 21 splits of 4 would fill only 16
    got = fc.best_splits(10, 64, 40, 1.0, 0.0, min_splits=20)
    assert got >= 22 and -(-64 // -(-64 // got)) == got


@pytest.mark.parametrize("d,route", [
    (8, "onepass"), (256, "narrow"), (264, "cluster"), (512, "cluster"),
    (520, "cluster"), (2048, "cluster"), (2056, "wide"), (4096, "wide")])
def test_route_depends_on_d_alone(d, route):
    """K5's route by width (f32): the one pass up to ONEPASS_MAX, the
    narrow kernels up to RESIDENT, the cluster kernels up to CLUSTER_MAX,
    the wide ones above; the C entries ce_bwd_f32 / ce_bwd_bf16 run the
    resident kernels up to the same RESIDENT and the wide ones above it."""
    assert fc.bwd_route(d) == route
    assert (fc.RESIDENT == fc.CLUSTER_SLICE
            < fc.CLUSTER_MAX == fc.CLUSTER_RANKS * fc.CLUSTER_SLICE)
    if route == "cluster":
        fc.cluster_plan(300, d, 1028, False, slots=1)
    else:
        with pytest.raises(ValueError):
            fc.cluster_plan(300, d, 1028, False, slots=1)


def test_plan_refuses_what_the_card_cannot_launch():
    """No cluster on the card (cudaOccupancyMaxActiveClusters 0) raises:
    the route never falls back to another kernel; nor does a width off
    the multiple of 8."""
    with pytest.raises(RuntimeError, match="no cluster"):
        fc.cluster_plan(300, 1024, 1028, True, slots=0)
    with pytest.raises(ValueError):
        fc.cluster_plan(300, 1020, 1028, True, slots=16)


def _c_source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _c_ternary(expr, **names):
    """A C expression of ternaries and comparisons (``BwdCfg``'s), its
    value at the given names."""
    m = re.fullmatch(r"\s*(.+?)\s*\?\s*(.+?)\s*:\s*(.+?)\s*", expr)
    if m:
        return (_c_ternary(m.group(2), **names)
                if eval(m.group(1), {}, names)
                else _c_ternary(m.group(3), **names))
    return eval(expr, {}, names)


def bwd_cfg(name, dt):
    """``BwdCfg<DT>::name`` of ``csrc/ce_fwd.cuh`` at DT = dt."""
    text = _c_source("ce_fwd.cuh")
    m = re.search(rf"static constexpr int {name} = ([^;]+);", text)
    assert m, name
    expr = m.group(1).split("//")[0]
    names = {"DT": dt}
    if "kWarps" in expr:
        names["kWarps"] = bwd_cfg("kWarps", dt)
    if "kThreads" in expr:
        names["kThreads"] = bwd_cfg("kThreads", dt)
    if "kMt" in expr:
        names["kMt"] = bwd_cfg("kMt", dt)
    return _c_ternary(expr, **names)


def _c_int(path, name):
    text = open(os.path.join(CSRC, path)).read()
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, (path, name)
    return eval(m.group(1), {}, {"kCBy": fc.CLUSTER_TILE})


def test_the_plan_and_the_c_source_share_their_constants():
    """The Python plans and the kernels read the same numbers: the
    cluster's tile shape, size and exchange stride, the wide kernels' tile
    shape, the resident limit, and the compile-time slice widths."""
    pairs = {("ce_cluster.cu", "kCBx"): fc.CLUSTER_ROWS,
             ("ce_cluster.cu", "kCBy"): fc.CLUSTER_TILE,
             ("ce_cluster.cu", "kCMaxRanks"): fc.CLUSTER_RANKS,
             ("ce_cluster.cu", "kXld"): fc.EXCHANGE_LD,
             ("ce.cu", "kResident"): fc.RESIDENT,
             ("ce.cu", "kWBx"): fc.WIDE_ROWS,
             ("ce.cu", "kWFwdBy"): fc.WIDE_FWD_TILE,
             ("ce.cu", "kWBwdBy"): fc.WIDE_BWD_TILE,
             ("ce.cu", "kWCols"): fc.WIDE_COLS}
    for (path, name), want in pairs.items():
        assert _c_int(path, name) == want, (path, name)
    # the resident kernels' tiles (ce_fwd.cuh BwdCfg), shared by f32 and
    # bf16, are resident_tile's
    for dt in (64, 128, 256):
        assert fc.resident_tile(dt) == (dt, bwd_cfg("kBx", dt),
                                        bwd_cfg("kBy", dt))
    # a multiply-add in the plans' TF32 FLOPs: 3xTF32 takes three TF32
    # products, ce.cu's bf16 instantiations one bf16 MMA at twice the TF32
    # rate; the cluster's bf16 tile its measured cost
    assert fc._flops(False) == 6 * fc._flops(True) == 6.0
    assert fc._flops(True) < fc.CLUSTER_BF16_FLOPS < fc._flops(False)
    text = open(os.path.join(CSRC, "ce_cluster.cu")).read()
    m = re.search(r"constexpr int slice_width\(int w\) \{\s*return ([^;]+);",
                  text)
    assert [int(x) for x in re.findall(r"\? (\d+)", m.group(1))] + [
        int(m.group(1).rsplit(":", 1)[1])] == list(fc.CLUSTER_WIDTHS)
