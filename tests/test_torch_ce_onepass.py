"""K5's one pass (``csrc/ce_onepass.cu``): each logit tile computed once for
dh, dW and db, in f32 up to d 128.

On the CPU (torch and numpy only): K5's route takes it in f32 up to d 128;
the plan (``ops/fused_ce_cuda.onepass_plan``) keeps the chain caps at FK,
at a 1M-item vocab and at the mesh's shard widths, fills its waves, leaves
to the pair the shapes whose dW partials pass their cap, and the workspace
the wrapper allocates covers every offset the kernel's layout writes; the
constants and the shared-memory layout (evaluated from the source's text)
agree with the plan's and fit a block.  On the card (``python -m pytest
--noconftest tests/test_torch_ce_onepass.py``): the one pass against the
plain version, float64 and a second launch.
"""

import os
import re

import numpy as np
import pytest
import torch

from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda as fc
from test_torch_ce_cluster import _c_source, bwd_cfg

SRC = os.path.join(os.path.dirname(fc.__file__), os.pardir, "csrc",
                   "ce_onepass.cu")


def _const(name: str) -> str:
    with open(SRC) as f:
        m = re.search(rf"constexpr int {name} = ([^;]+);", f.read())
    assert m, name
    return m.group(1)


def _per(tiles: int, splits: int) -> int:
    """Tiles a split takes, after checking none is empty."""
    p = -(-tiles // splits)
    assert 1 <= splits <= tiles and -(-tiles // p) == splits
    return p


# (N, V): FK's train rows and domains, a 1M-item vocab, the mesh's shards
# (a 2x2 mesh: half the rows, half of each domain's vocab), ragged shapes
PLAN_SHAPES = ((10240, 30720), (10240, 36864), (10240, 500000),
               (10240, 501760), (5120, 15360), (5120, 18432), (300, 1028),
               (2100, 5636), (1, 4))


@pytest.mark.parametrize("d", [8, 40, 64, 128])
@pytest.mark.parametrize("N,V", PLAN_SHAPES)
def test_onepass_plan_keeps_the_chain_caps(N, V, d):
    """Every vocab split of the one pass takes at most MAX_CHAIN columns
    (dh's chain in the accumulator) and none is empty; dW's chain there is
    a block's rows (at most MAX_ROW_CHAIN), a block and a dW partial for
    each 256 rows, at whatever blocks the card holds."""
    for slots in (1, 16, 33, 132):
        plan = fc.onepass_plan(N, d, V, slots)
        assert plan is not None
        assert _per(-(-V // fc.ONEPASS_TILE), plan.split_h) \
            * fc.ONEPASS_TILE <= fc.MAX_CHAIN
        assert fc.ONEPASS_ROWS <= fc.MAX_ROW_CHAIN
        assert plan.row_blocks == -(-N // fc.ONEPASS_ROWS)


@pytest.mark.parametrize("slots", [132, 114])
def test_onepass_plan_at_fk_fills_whole_waves(slots):
    """At FK's rows (40 blocks of 256) and the blocks an H100 holds at once
    (SXM 132, PCIe 114), each domain's plan takes within 3% of the tiles a
    block would walk if the blocks spread them evenly over the SMs."""
    for V in (30720, 36864):
        plan = fc.onepass_plan(10240, 128, V, slots)
        assert plan.row_blocks == 40
        per = -(-(V // 32) // plan.split_h)
        steps = -(-(plan.row_blocks * plan.split_h) // slots) * per
        even = 40 * (V // 32) / slots
        assert steps <= 1.03 * even, (plan, steps, even)


@pytest.mark.parametrize("N,V", PLAN_SHAPES + ((10240, 2000000),
                                              (40960, 501760)))
def test_onepass_plan_caps_the_dw_partials(N, V):
    """A plan writes at most ONEPASS_PARTIAL_BYTES of dW partials, and
    where the shape would need more there is none (K5 runs the pair): at
    FK and at 1M items each 256-row block writes its own partial, at V
    2,000,000 or four times FK's rows the pair runs."""
    plan = fc.onepass_plan(N, 128, V, 132)
    blocks = -(-N // fc.ONEPASS_ROWS)
    part = 4 * blocks * 129 * V if blocks > 1 else 0
    assert (plan is None) == (part > fc.ONEPASS_PARTIAL_BYTES)
    if N == 10240 and V <= 501760:
        assert plan.row_blocks == 40
    if V == 2000000 or N == 40960:
        assert plan is None


@pytest.mark.parametrize("N,V", PLAN_SHAPES)
def test_onepass_workspace_covers_the_layout(N, V):
    """The wrapper's workspace (``onepass_workspace``) is what
    ``ce_bwd_onepass_f32`` lays out: Wᵀ's TF32 parts, dh's partials
    [split_h][N][d] where split_h > 1, dW's [row block][d][V] and db's
    [row block][V] where there is more than one row block; the last
    element each part writes lies inside it."""
    d = 128
    plan = fc.onepass_plan(N, d, V, 16)
    floats = fc.onepass_workspace(N, d, V, plan)
    nb = plan.row_blocks
    part_h = 2 * V * d
    part_w = part_h + (plan.split_h * N * d if plan.split_h > 1 else 0)
    part_b = part_w + (nb * V * d if nb > 1 else 0)
    end = part_b + (nb * V if nb > 1 else 0)
    assert floats == end
    if plan.split_h > 1:
        assert part_h + (plan.split_h - 1) * N * d + (N - 1) * d + d - 1 \
            < part_w
    if nb > 1:
        assert part_w + ((nb - 1) * d + d - 1) * V + V - 1 < part_b
        assert part_b + (nb - 1) * V + V - 1 < floats


def test_onepass_constants_match_the_source():
    """The plan's constants are the kernel's (read from the source)."""
    assert int(_const("kORows")) == fc.ONEPASS_ROWS
    assert int(_const("kOBy")) == fc.ONEPASS_TILE
    assert _const("kPTld") == "kORows + 8"
    # the pair's tiles: 256 rows, 32 entities, 256 threads (ce_fwd.cuh)
    dt, rows, tile = fc.resident_tile(128)
    assert (rows, tile) == (fc.ONEPASS_ROWS, fc.ONEPASS_TILE)


def _onepass_cfg(dt: int) -> dict:
    """``OnePass<DT>``'s constants, evaluated from the source's text, with
    the f32 ``Tile<DT, false>`` and ``BwdCfg<DT>`` of ``csrc/ce_fwd.cuh``."""
    cfg_names = {f"B_{n}": bwd_cfg(n, dt)
                 for n in ("kBx", "kBy", "kStages", "kThreads")}

    def ev(expr, names):
        expr = " ".join(expr.split())
        expr = (expr.replace("static_cast<int>(sizeof(T))", "4")
                .replace("BwdCfg<DT>::", "B_").replace("L::", "L_"))
        expr = re.sub(r"\((\w+) \? (\w+) : (\w+)\)", r"(\2 if \1 else \3)",
                      expr)
        return eval(expr.replace("/", "//"), {}, names)

    names = {"DT": dt, **cfg_names}
    tile, in_tile = _c_source("ce_fwd.cuh").split("struct Tile {", 1)[1], {}
    for name, expr in re.findall(r"static constexpr int (\w+) =\s*([^;]+);",
                                 tile.split("};", 1)[0]):
        expr = re.sub(r"^kBf \? [^:]+: ", "", expr.split("//")[0].strip())
        in_tile[name] = names["L_" + name] = ev(expr, {**names, **in_tile})
    src = open(SRC).read()
    for name in ("kORows", "kOBy", "kPTld"):
        names[name] = ev(_const(name).split("//")[0], names)
    body = src.split("struct OnePass {", 1)[1].split("};", 1)[0]
    for name, expr in re.findall(
            r"static constexpr (?:int|bool) (\w+) =\s*([^;]+);", body):
        names[name] = ev(expr, names)
    return names


@pytest.mark.parametrize("d", [8, 64, 72, 128])
def test_onepass_fits_a_block(d):
    """A block's shared memory (``OnePass<DT>::kSmem``, evaluated from the
    source) within the 227 KB a block may take, the bound the source's
    static_assert holds at build time, one block an SM; at DT 128 Pᵀ
    [32][264] takes its stage's two Y parts [2][32][132] exactly, at DT
    64 a buffer of its own."""
    dt = 64 if d <= 64 else 128
    c = _onepass_cfg(dt)
    assert f"static_assert(kSmem <= {fc.SMEM_LIMIT}," in open(SRC).read()
    assert c["kSmem"] <= fc.SMEM_LIMIT < 2 * c["kSmem"]
    assert c["kStageBytes"] % 16 == 0
    assert c["kPInStage"] == (dt == 128)
    if dt == 128:
        assert c["kPTBytes"] == 4 * 2 * c["kOBy"] * c["ld"]
    assert c["kSmem"] == (c["kXBytes"] + c["kStages"] * c["kStageBytes"]
                          + (0 if c["kPInStage"] else c["kPTBytes"])
                          + 4 * 8 * c["kOBy"])


@pytest.mark.parametrize("d,bf16,route", [
    (8, False, "onepass"), (40, False, "onepass"), (128, False, "onepass"),
    (136, False, "narrow"), (256, False, "narrow"), (8, True, "narrow"),
    (128, True, "narrow"), (264, False, "cluster"), (264, True, "cluster")])
def test_onepass_route(d, bf16, route):
    """K5 takes the one pass in f32 up to ONEPASS_MAX; bf16 and wider rows
    keep the pair of kernels (or the cluster's)."""
    assert fc.bwd_route(d, bf16) == route
    assert fc.ONEPASS_MAX == 128 < fc.RESIDENT


def test_onepass_plan_refuses_what_it_cannot_launch():
    with pytest.raises(ValueError, match="d <= 128"):
        fc.onepass_plan(300, 136, 1028, 16)
    with pytest.raises(RuntimeError, match="no block"):
        fc.onepass_plan(300, 128, 1028, 0)


# ---------------------------------------------------------------- card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("d", [40, 64, 128])
@pytest.mark.parametrize("N,V,n_real", [(300, 1028, 1000),
                                        (2100, 5636, 5600)])
def test_onepass_matches_plain_and_float64(cuda, N, V, n_real, d):
    """The one pass (``ce_bwd``'s route at these widths) against the plain
    version (2e-5 of its largest element, CE_BWD_TOL), dW against float64
    (1e-5, DW_F64_TOL), two launches bitwise equal: ignored rows (every
    5th, target V's ignore index), a ragged last vocab tile, a padded
    vocab tail, nine row blocks and several vocab splits at N 2,100."""
    rng = np.random.default_rng(N + d)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    h = put(rng.normal(size=(N, d)))
    w_np = rng.normal(size=(d, V)) * 0.05
    w_np[:, n_real:] = 0.0
    w = put(w_np)
    bm = fused_ce.mask_bias(put(rng.normal(size=V) * 0.1), n_real)
    tgt_np = rng.integers(0, n_real, size=N)
    tgt_np[::5] = V
    tgt = torch.from_numpy(tgt_np).to(cuda)
    real = (tgt != V).float()
    lse, _ = fc.ce_fwd(h, w, bm, put(rng.normal(size=N)), tgt)
    dlse = put(rng.normal(size=N) / N) * real
    dt = put(rng.normal(size=N) / N) * real
    n0 = fc.ce_bwd.launches_onepass
    got = fc.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
    again = fc.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
    assert fc.ce_bwd.launches_onepass == n0 + 2
    want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt)
    f64 = fused_ce.ce_bwd_plain(h.double(), w.double(), bm.double(),
                                lse.double(), dlse.double(), dt.double(),
                                tgt)
    torch.cuda.synchronize()
    for name, g, r, g2, r64 in zip(("dh", "dw", "db"), got, want, again,
                                   f64):
        assert torch.isfinite(g).all(), name
        assert _rel(g, r) <= 2e-5, (name, _rel(g, r))
        assert torch.equal(g, g2), name
        if name == "dw":
            assert _rel(g, r64) <= 1e-5, _rel(g, r64)
    assert (got[1][:, n_real:] == 0).all() and (got[2][n_real:] == 0).all()
    plan = fc.plan_onepass(N, d, V)
    if N == 2100:
        assert plan.row_blocks >= 2 and plan.split_h >= 2, plan
