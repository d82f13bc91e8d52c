"""The towers' products with a weight past d 256: the wgmma tile
(``csrc/wgmma.cuh`` ``wg::tile``) that K2's four products (QKV, the
out-projection, FF1, FF2) and K3's dX = dY·Wᵀ run above ``WIDE_D``.

On the CPU (torch and numpy): which tile runs at which d and the launch
counts that show it, the ring's shared memory (read from the C source)
against the card's 227 KB a block, the route's width shared with it,
the weight pre-pass's K-major parts, and the tile's f32 order of summation
emulated against float64 at k 1,024 and 3,072: 3xTF32 with each k8-step's
three products in the tensor cores' truncating accumulator (the 64-row
tile's order), the QKV product's six products a k8-step from a zeroed
accumulator added in f32.  On the card (skipped here, the ``cuda``
fixture): the tile against today's 64-row tile and float64, every epilogue,
dropout 0 and 0.2 with and without the row map, at d 264-1,024 in both
dtypes, and K2 and K3 against the plain tower.
"""

import re

import numpy as np
import pytest
import torch

import test_torch_tf32 as tf32
from c2dsr_tpu_torch.bench import gates
from c2dsr_tpu_torch.config import Config
from c2dsr_tpu_torch.model import params as params_mod
from c2dsr_tpu_torch.ops import encoder as enc
from c2dsr_tpu_torch.ops import encoder_cuda as ec
from test_torch_ce_cluster import _c_source, _c_ternary

NARROW = (8, 40, 64, 128, 256)
WIDE = (264, 512, 520, 1024)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small ops, which threads do not speed up."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------- CPU ----

@pytest.mark.parametrize("d", NARROW + WIDE)
@pytest.mark.parametrize("bf16", [False, True])
def test_plan_routes_by_width(d, bf16):
    """The tile is chosen by d alone (``const bool wide = d > kWideD`` in
    both kernels' files): up to d 256 the 64-row tile, past it the wgmma
    tile, in both dtypes.  The launch counts that show which tile ran
    (``encoder_cuda._count``, read by the smoke's path checks) follow the
    same route: each call counts a launch of its dtype, and past d 256 a
    wide one too."""
    def wrapper():
        pass
    for c in ("launches", "launches_bf16", "launches_wide",
              "launches_wide_bf16"):
        setattr(wrapper, c, 0)
    ec._count(wrapper, d, bf16)
    sfx = "_bf16" if bf16 else ""
    want = {"launches", "launches_bf16", "launches_wide",
            "launches_wide_bf16"}
    counted = {c for c in want if getattr(wrapper, c)}
    assert counted == ({"launches" + sfx, "launches_wide" + sfx}
                       if d in WIDE else {"launches" + sfx})
    for f in (ec.encoder_fwd, ec.encoder_bwd):
        assert all(hasattr(f, c) for c in want)


def _constexpr(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _wg_cfg(mode):
    """``wg::Cfg<mode>``'s constants, evaluated from ``csrc/wgmma.cuh``'s
    text: the namespace's constants in order, then the struct's."""
    src = _c_source("wgmma.cuh")
    names = {"MODE": mode}
    top, cfg = src.split("struct Cfg {", 1)
    cfg = cfg.split("};", 1)[0]
    for text, pat in ((top, r"^constexpr int (\w+) = ([^;]+);"),
                      (cfg, r"static constexpr int (\w+) = ([^;]+);")):
        for name, expr in re.findall(pat, text, re.M):
            names[name] = _c_ternary(expr.replace("/", "//"), **names)
    return names


@pytest.mark.parametrize("mode", [1, 3, 6])
def test_ring_fits_the_cards_shared_memory(mode):
    """Each instantiation's ring, its alignment and its barriers
    (``wg::Cfg<MODE>::kSmem``, read from the source) fit a block's 227 KB
    (one block an SM), with room for no second block, the bound the
    source's static_assert holds at build time; each stage holds whole
    128-byte swizzle rows (32 f32 k-steps, or 64 bf16 ones of B beside
    two 32-step A boxes) and each part of B starts on the swizzle's
    1,024-byte period."""
    c = _wg_cfg(mode)
    smem_per_block = 227 * 1024
    assert f"static_assert(kSmem <= {smem_per_block}," in _c_source(
        "wgmma.cuh")
    assert c["kSmem"] <= smem_per_block < 2 * c["kSmem"]
    assert c["kParts"] == {6: 3, 3: 2, 1: 1}[mode]
    assert c["kStages"] >= 3
    assert c["kStageK"] * (2 if mode == 1 else 4) == 128
    assert c["kABytes"] % 1024 == 0 and c["kBPart"] % 1024 == 0
    assert c["kThreads"] == 32 * c["kConsumerWarps"] + 32
    assert c["kRows"] == 16 * c["kConsumerWarps"]


def test_the_plan_is_the_sources():
    """The width past which wg::tile runs is one constant of the C source
    (encoder_common.cuh kWideD), both files route on it, and the Python
    side's ``WIDE_D`` (which ``_count`` reads) is that constant."""
    assert _constexpr(_c_source("encoder_common.cuh"), "kWideD") == ec.WIDE_D
    for f in ("encoder.cu", "encoder_bwd.cu"):
        assert "const bool wide = d > kWideD;" in _c_source(f)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_product_handles_refuse_what_the_tiles_do_not_take(which):
    """``gemm_fwd`` / ``gemm_bwd`` raise before any launch on tensors off
    the card, and on k or m the tiles do not take."""
    a, w = torch.zeros(4, 8), torch.zeros(8, 8)
    call = ((lambda a, w: ec.gemm_fwd(a, w, torch.zeros(w.shape[1]),
                                      epi="bias", mode=3, wide=True))
            if which == "fwd" else
            (lambda a, w: ec.gemm_bwd(a, w, epi="store", bf16=False,
                                      wide=True)))
    with pytest.raises(ValueError, match="CUDA"):
        call(a, w)
    with pytest.raises(ValueError, match="does not take"):
        ec._check_gemm("gemm", 6, 8, False)
    with pytest.raises(ValueError, match="does not take"):
        ec._check_gemm("gemm", 12, 8, True)


def split3(x: torch.Tensor):
    """The 6-term split: big, mid, small (tc.cuh split_parts<6>)."""
    big = tf32.tf32_rna(x)
    rest = x - big
    mid = tf32.tf32_rna(rest)
    return big, mid, tf32.tf32_trunc(rest - mid)


@pytest.mark.parametrize("transpose", [True, False])
def test_prepass_parts_are_k_major_and_exact(transpose):
    """The pre-pass (wgmma.cuh split_weights) writes each weight's parts
    K-major: the forward's W [k, m] transposed, the backward's [m, k] as it
    lies; big is TF32, and the parts add back to W exactly (3xTF32's two,
    up to the bits the tensor core drops of small; the 6-term's three)."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(40, 24)).astype(np.float32))
    km = w.T.contiguous() if transpose else w
    big, small = tf32.split(km)
    assert torch.equal(tf32.tf32_rna(big), big)
    assert float((big.double() + small.double() - km.double()).abs().max()) \
        <= 2.0 ** -21 * float(km.abs().max())
    b3, m3, s3 = split3(km)
    err = (b3.double() + m3.double() + s3.double() - km.double()).abs().max()
    assert float(err) <= 2.0 ** -30 * float(km.abs().max())
    assert big.shape == (24, 40) if transpose else (40, 24)


def six_term(a: torch.Tensor, b: torch.Tensor, k_step: int = 8):
    """The QKV product's order: per k8-step the six products down to
    mid·mid in a zeroed truncating accumulator, added to the sum in f32,
    to nearest.  a [M, K], b [K, n]."""
    (ab, am, as_), (bb, bm, bs) = split3(a), split3(b)
    terms = ([am.T, as_.T, ab.T, am.T, ab.T, ab.T],
             [bm, bb, bs, bb, bm, bb])
    out = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], k_step):
        part = slice(k0, k0 + k_step)
        out = out + tf32.mma_sum_truncating([t[part] for t in terms[0]],
                                            [t[part] for t in terms[1]])
    return out


@pytest.mark.parametrize("k", [1024, 3072])
def test_f32_order_is_f32_accurate_at_long_k(k):
    """At the towers' k past d 256 (d, and 3·d for K3's QKV product), on
    activations of LayerNorm size and weights of the init's, max abs error
    over max |float64|: the 3xTF32 order (three products a k8-step in the
    truncating accumulator, k chained through the whole product, as the
    64-row tile sums) within 3e-5 (read: 1.1e-5 at k 1,024, 2.3e-5 at
    3,072); the 6-term order within twice plain f32's (read: 1.0x, 1.8x);
    one-pass TF32 beyond 1e-4 (read: 3e-4)."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.normal(size=(16, k)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(k, 16)) * k ** -0.5)
                         .astype(np.float32))
    want = a.double() @ b.double()
    (ab, as_), (bb, bs) = tf32.split(a), tf32.split(b)
    three = tf32.mma_sum_truncating([as_.T, ab.T, ab.T], [bb, bs, bb])
    six = six_term(a, b)
    plain = tf32.rel(a @ b, want)
    e3, e6 = tf32.rel(three, want), tf32.rel(six, want)
    e1 = tf32.rel(tf32.mma_sum_truncating([ab.T], [bb]), want)
    print(f"k {k}: from float64, 3xTF32 {e3:.3e}, 6-term {e6:.3e}, plain f32 "
          f"{plain:.3e}, one-pass TF32 {e1:.3e}")
    assert e3 <= 3e-5
    assert e6 <= 2 * plain
    assert e1 > 1e-4


# ---------------------------------------------------------------- card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _gen(cuda, seed):
    return torch.Generator(cuda).manual_seed(seed)


def _rel(a, b):
    """max |a - b| over max |b|."""
    return float((a.double() - b.double()).abs().max()) / max(
        float(b.double().abs().max()), 1e-30)


B, L = 23, 15            # n = 345 rows: a multiple of neither 64 nor 128
ROW_MAP = (5, 23, 40)    # this call's rows at 5.. of each 40 of the run's


@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("epi,dropout,row_map,qkv", [
    ("bias", 0.0, None, True), ("bias", 0.0, None, False),
    ("relu", 0.0, None, False), ("relu", 0.2, None, False),
    ("relu", 0.2, ROW_MAP, False), ("residual", 0.0, None, False),
    ("residual", 0.2, None, False), ("residual", 0.2, ROW_MAP, False)])
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_forward_product_matches_the_64_row_tile(cuda, d, epi, dropout,
                                                      row_map, qkv, bf16):
    """One forward product on the wgmma tile against the 64-row tile and
    float64 (of the bf16-rounded operands in bf16): bitwise the 64-row
    tile's outputs, its dropout masks included, in both dtypes (both round
    the same operands and sum the same k-steps in the same order), and as
    near float64 as it within 1.25x."""
    gen = _gen(cuda, d)
    m = 3 * d if qkv else d
    a = torch.randn(B * L, d, device=cuda, generator=gen)
    w = torch.randn(d, m, device=cuda, generator=gen) * d ** -0.5
    bias = torch.randn(m, device=cuda, generator=gen) * 0.1
    res = torch.randn(B * L, m, device=cuda, generator=gen)
    mode = 1 if bf16 else 6 if qkv else 3
    kw = dict(epi=epi, mode=mode, res=res if epi == "residual" else None,
              with_c2=epi == "relu", dropout=dropout, seed=11, tower=1,
              row_map=row_map, L=L, site=3 if epi == "relu" else 2)
    c, c2 = ec.gemm_fwd(a, w, bias, wide=True, **kw)
    c_old, c2_old = ec.gemm_fwd(a, w, bias, wide=False, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(c).all()
    if bf16:
        a64 = a.bfloat16().double()
        w64 = w.bfloat16().double()
    else:
        a64, w64 = a.double(), w.double()
    want = a64 @ w64 + bias.double()
    if epi == "relu":
        want = want.clamp_min(0)
    for got, old in ((c, c_old), (c2, c2_old)):
        if got is not None:
            assert torch.equal(got, old)
    if not dropout:
        if epi == "residual":
            want = want + res.double()
        e_new, e_old = _rel(c, want), _rel(c_old, want)
        assert e_new <= 1.25 * e_old + 1e-7, (e_new, e_old)


@pytest.mark.parametrize("d,k", [(264, 264), (520, 520), (512, 1536),
                                 (1024, 1024), (1024, 3072)])
@pytest.mark.parametrize("epi,dropout,row_map", [
    ("store", 0.0, None), ("drelu", 0.0, None), ("drelu", 0.2, None),
    ("drelu", 0.2, ROW_MAP), ("res", 0.0, None), ("res", 0.2, ROW_MAP)])
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_backward_product_matches_the_64_row_tile(cuda, d, k, epi,
                                                       dropout, row_map,
                                                       bf16):
    """K3's dX = dY·Wᵀ on the wgmma tile (k = d, or 3·d for the QKV
    product) bitwise the 64-row tile's, and against float64, every
    epilogue."""
    gen = _gen(cuda, d + k)
    a = torch.randn(B * L, k, device=cuda, generator=gen)
    w = torch.randn(d, k, device=cuda, generator=gen) * k ** -0.5
    res = torch.randn(B * L, d, device=cuda, generator=gen)
    aux = torch.randn(B * L, d, device=cuda, generator=gen)
    kw = dict(epi=epi, bf16=bf16, res=res, aux=aux, dropout=dropout, seed=9,
              tower=2, row_map=row_map, L=L, site=3)
    c = ec.gemm_bwd(a, w, wide=True, **kw)
    c_old = ec.gemm_bwd(a, w, wide=False, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(c).all()
    assert torch.equal(c, c_old)
    if epi == "store":
        a64, w64 = ((a.bfloat16().double(), w.bfloat16().double()) if bf16
                    else (a.double(), w.double()))
        want = a64 @ w64.T
        assert _rel(c, want) <= 1.25 * _rel(c_old, want) + 1e-7


@pytest.mark.parametrize("d,n_head", [(264, 1), (512, 4), (520, 1),
                                      (1024, 8)])
@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_wide_towers_match_plain(cuda, d, n_head, dropout):
    """K2 and K3 past d 256 (every product on the wgmma tile) against the
    plain tower: K2 within 2e-5 of max |plain| on rows with an allowed
    key, K3's dx and gradients within 1e-4 of the plain backward at K2's
    branches (its ReLU masks and probabilities: at d 1,024 an input of a
    ReLU at zero flips between any two f32 runs and moves a gradient row)."""
    cfg = Config(d_latent=d, n_head=n_head, n_attn=1)
    p = params_mod.init_encoder_params(torch.Generator().manual_seed(d), cfg,
                                       L)
    p = params_mod.params_from_numpy(params_mod.params_to_numpy(p), cuda)
    rng = np.random.default_rng(d)
    seq = rng.integers(0, 50, size=(B, L))
    seq[::4, :5] = 999
    x = torch.from_numpy(rng.normal(size=(B, L, d)).astype(np.float32)
                         ).to(cuda)
    seq = torch.from_numpy(seq).to(cuda)
    kw = dict(idx_pad=999, n_head=n_head, invert_padding_mask=False,
              dropout=dropout, seed=7, tower=1)
    acts = ec.saved_buffer(x, n_head, 1)
    out = ec.encoder_fwd(x, seq, p, saved=acts, **kw)
    ref = enc.encoder_fwd_plain(x, seq, p, **kw)
    live = (seq != 999).long().cumsum(1) > 0
    assert _rel(out[live], ref[live]) <= 2e-5
    gout = torch.randn(x.shape, device=cuda, generator=_gen(cuda, d))
    dx, grads = ec.encoder_bwd(x, seq, gout, p, saved=acts, **kw)
    rdx, rgrads = enc.encoder_bwd_plain(
        x, seq, gout, p, branches=gates.k2_branches(acts, x.shape, n_head, 1,
                                                    1), **kw)
    torch.cuda.synchronize()
    assert _rel(dx, rdx) <= 1e-4
    for g, r in zip(grads, rgrads):
        assert _rel(g, r) <= 1e-4
