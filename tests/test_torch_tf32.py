"""The numerics of K5's tensor-core products (3xTF32), emulated on the CPU.

K5 (``csrc/ce.cu``) splits each f32 operand x into big = TF32(x), rounded
to nearest (``cvt.rna.tf32.f32``: 10 mantissa bits, the low 13 of the f32
cleared), and small = x - big, which the tensor core reads truncated to
TF32.  A product is small·big + big·small + big·big, each an ``mma`` of
eight k-steps whose sum is added to an f32 accumulator.  Emulated here in
torch at FK magnitudes (|h| ~ 1, |W| ~ 0.05, d 128, dlogits from a softmax
over the vocab): the logit product (k over d), the dh product (k over the
vocab) and the dW product (k over thousands of rows) stay within 1e-5,
relative to the largest value, of float64; one-pass TF32 (big·big alone)
does not.  This is the argument for running K5 at f32 accuracy without a
precision flag; the card tests hold the kernel itself to 2e-5.  The
accumulator's adds are modelled as exact and rounded to nearest there; with
them truncated (mma_sum_truncating), the longest sum the bench gave K5,
dW over 10,240 rows in one chain, reproduces the error the card showed.
The kernels' remedies are emulated last: dW over chains of at most 1,280
rows (``csrc/ce.cu`` kMaxRowChain) whose partials are added in f32, and a
logit tile whose k-steps go four at a time into a partial from a zero
accumulator that an f32 add rounds into the sum (``csrc/ce_fwd.cuh``
logit_tile).
"""

import functools

import numpy as np
import pytest
import torch

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The emulations are thousands of small ops, which threads do not
    speed up; beside other test processes on the same cores, a thread
    pool's waits made one of them take minutes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 rounded to nearest, ties away from zero (the magnitude's
    bits plus half a unit of the 13 dropped bits, then cleared)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 by dropping the low 13 bits (how the tensor core reads
    an operand that is not already TF32)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_trunc(x - big)


def mma_sum(a_terms, b_terms, k_step: int = 8) -> torch.Tensor:
    """sum over products (a_i, b_i) of a_i @ b_i, k in steps of k_step: each
    step's exact (float64) sum added to an f32 accumulator, product by
    product in the kernel's order."""
    M, K = a_terms[0].shape
    acc = torch.zeros(M, b_terms[0].shape[1], dtype=torch.float32)
    for k0 in range(0, K, k_step):
        for a, b in zip(a_terms, b_terms):
            part = a[:, k0:k0 + k_step].double() @ b[k0:k0 + k_step].double()
            acc = (acc.double() + part).float()
    return acc


def three_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ab, as_ = split(a)
    bb, bs = split(b)
    return mma_sum([as_, ab, ab], [bb, bs, bb])


def one_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mma_sum([tf32_rna(a)], [tf32_rna(b)])


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def _fk_case(n_rows: int, d: int, V: int, seed: int):
    """h [n, d], W [d, V], and dlogits P [n, V] = dlse·softmax(h·W + b) +
    dt·onehot(target), at FK's scales (dlse, dt ~ 1/N)."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.normal(size=(n_rows, d)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(d, V)) * 0.05).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=V) * 0.1).astype(np.float32))
    logits = h.double() @ w.double() + b.double()
    p = torch.softmax(logits, dim=1)
    dlse = torch.from_numpy(rng.normal(size=n_rows)) / 10240
    dt = torch.from_numpy(rng.normal(size=n_rows)) / 10240
    P = dlse[:, None] * p
    P[torch.arange(n_rows), torch.from_numpy(rng.integers(0, V, n_rows))] += dt
    return h, w, P.float()


def test_split_is_exact_and_big_is_tf32():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32)) * 10.0 ** torch.arange(
                             -4, 4).repeat(512)
    big = tf32_rna(x)
    assert torch.equal(big + (x - big), x)           # the split loses nothing
    assert (big.view(torch.int32) & 0x1FFF == 0).all()
    assert float(((x - big).abs() / x.abs()).max()) <= 2.0 ** -11
    assert torch.equal(tf32_rna(torch.tensor([1.0 + 2.0 ** -11])),
                       torch.tensor([1.0 + 2.0 ** -10]))  # ties away from 0


@pytest.mark.parametrize("product", ["logits", "dh", "dw"])
def test_3xtf32_is_f32_accurate_and_one_pass_is_not(product):
    h, w, P = _fk_case(n_rows=2048, d=128, V=1024, seed=1)
    if product == "logits":          # h·W: k over d
        a, b = h[:64], w
    elif product == "dh":            # P·Wᵀ: k over the vocab
        a, b = P[:64], w.T.contiguous()
    else:                            # hᵀ·P: k over 2048 rows
        a, b = h.T.contiguous(), P[:, :64].contiguous()
    want = a.double() @ b.double()
    e3, e1 = rel(three_tf32(a, b), want), rel(one_tf32(a, b), want)
    assert e3 <= TOL, e3
    assert e1 > TOL, e1
    assert e1 > 20 * e3


def _k4_lse(h, w, b, pad, tgt, split, tile: int = 32, splits: int = 3):
    """K4's arithmetic: logits by ``split`` (3xTF32 or one-pass) plus the
    bias; per row and vocab split a running (max, sum-exp) over tiles of
    ``tile`` columns in f32, the splits merged in order with the pad class
    folded in; and the target logit."""
    s = split(h, w) + b
    V = s.shape[1]
    per = -(-V // splits)
    ms, ss = [], []
    for k in range(splits):
        m = torch.full((s.shape[0],), -1e30)
        acc = torch.zeros(s.shape[0])
        for c0 in range(k * per, min(V, (k + 1) * per), tile):
            t = s[:, c0:min(c0 + tile, (k + 1) * per, V)]
            m_new = torch.maximum(m, t.max(dim=1).values)
            acc = acc * torch.exp(m - m_new) + torch.exp(
                t - m_new[:, None]).sum(dim=1)
            m = m_new
        ms.append(m)
        ss.append(acc)
    m = torch.stack(ms).max(dim=0).values
    acc = sum(a * torch.exp(mk - m) for a, mk in zip(ss, ms))
    m_fin = torch.maximum(m, pad)
    lse = m_fin + torch.log(acc * torch.exp(m - m_fin) + torch.exp(pad - m_fin))
    return lse, s.gather(1, tgt[:, None])[:, 0]


def test_k4_tile_3xtf32_lse_is_f32_accurate_and_one_pass_is_not():
    """K4's forward (logits in 3xTF32, a running max and sum-exp over column
    tiles, vocab splits merged in order, the pad class folded in) against
    float64 at FK magnitudes: lse and the target logit within 1e-6 relative
    to the largest value; one-pass TF32 logits are not."""
    rng = np.random.default_rng(2)
    h, w, _ = _fk_case(n_rows=256, d=128, V=2048, seed=3)
    b = torch.from_numpy((rng.normal(size=2048) * 0.1).astype(np.float32))
    pad = torch.from_numpy(rng.normal(size=256).astype(np.float32))
    tgt = torch.from_numpy(rng.integers(0, 2048, size=256))
    logits = h.double() @ w.double() + b.double()
    want_lse = torch.logsumexp(torch.cat([logits, pad.double()[:, None]], 1),
                               dim=1)
    want_t = logits.gather(1, tgt[:, None])[:, 0]
    errs = {}
    for name, fn in (("3xtf32", three_tf32), ("one-pass", one_tf32)):
        lse, tl = _k4_lse(h, w, b, pad, tgt, fn)
        errs[name] = max(rel(lse, want_lse), rel(tl, want_t))
    assert errs["3xtf32"] <= 1e-6, errs
    assert errs["one-pass"] > 1e-6, errs
    assert errs["one-pass"] > 20 * errs["3xtf32"], errs


def _rz(x: torch.Tensor) -> torch.Tensor:
    """float64 -> f32 rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def mma_sum_truncating(a_terms, b_terms, extra_bits: int = 3,
                       k_step: int = 8) -> torch.Tensor:
    """mma_sum with the tensor core's accumulation modelled as truncating:
    each k-step's eight products are exact, then they and the accumulator
    are aligned to the largest of them, keeping ``extra_bits`` bits below
    the f32 significand of that one and truncating the rest, summed, and
    the sum truncated to f32.  a_terms are [K, M] (k first), b_terms
    [K, n]; returns [M, n]."""
    K, M = a_terms[0].shape
    acc = torch.zeros(M, b_terms[0].shape[1], dtype=torch.float32)
    for k0 in range(0, K, k_step):
        for a, b in zip(a_terms, b_terms):
            prods = (a[k0:k0 + k_step].double().T[:, :, None]
                     * b[k0:k0 + k_step].double()[None, :, :])
            add = torch.cat([acc.double()[:, None, :], prods], 1)
            top = add.abs().amax(1)
            e = torch.floor(torch.log2(torch.where(top > 0, top,
                                                   torch.ones_like(top))))
            q = torch.pow(2.0, e - 23 - extra_bits)[:, None, :]
            acc = _rz((torch.trunc(add / q) * q).sum(1))
    return acc


@functools.lru_cache(maxsize=None)
def _bench_dw_case():
    """``bench/kernel_bench.py``'s K4+K5 inputs (its numpy draws: N 10,240,
    d 128, V 65,536, the loss's own dlogits p - onehot) at 64 columns: the
    48 with the most target rows and 16 others.  Returns the 3xTF32 splits
    of the dlogits P [N, 64] and of h [N, d], P, h, and Pᵀ·h in float64."""
    N, d, V = 10240, 128, 65536
    n_real = V - 1024
    rng = np.random.default_rng(0)          # kernel_bench.bench_ce's draws
    h = torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(d, V)) * 0.02).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=V) * 0.02).astype(np.float32))
    b[n_real:] = -1e9
    pad = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    tgt = torch.from_numpy(rng.integers(0, n_real, size=N))
    # the lse, in chunks of the vocab, each chunk's in f32, combined in
    # float64
    parts = [pad.double()[:, None]] + [
        torch.logsumexp(h @ w[:, c0:c0 + 4096] + b[c0:c0 + 4096], 1)
        .double()[:, None] for c0 in range(0, V, 4096)]
    lse = torch.logsumexp(torch.cat(parts, 1), 1)
    cols = torch.cat([torch.bincount(tgt, minlength=V).topk(48).indices,
                      torch.from_numpy(rng.choice(n_real, 16, replace=False))])
    p = torch.exp((h @ w[:, cols] + b[cols]).double() - lse[:, None])
    P = (p - (tgt[:, None] == cols[None, :]).double()).float()   # [N, cols]
    return split(P), split(h), P, h, P.double().T @ h.double()


@functools.lru_cache(maxsize=None)
def _bench_dw_one_chain() -> torch.Tensor:
    """dW at the bench's case summed over all its rows in one truncating
    accumulator."""
    (pb, ps), (hb, hs), _, _, _ = _bench_dw_case()
    return mma_sum_truncating([ps, pb, pb], [hb, hs, hb])


def test_k5_dw_error_at_the_kernel_bench_shape_is_the_accumulators():
    """Why K5's dW at ``bench/kernel_bench.py``'s K4+K5 shape (N 10,240,
    d 128, V 65,536, the loss's own dlogits p - onehot) lay 3.67e-5 of
    its largest element from float64 on the H100 (``--kernels``; plain
    f32 on the card: 2.5e-6) while ce_bwd_plan gave the dW kernel one row
    split there: a block added all 10,240 rows into one tensor-core
    accumulator, 3 MMAs a k-step of 8 rows.  Emulated on the bench's own
    inputs (its numpy draws), at the columns with the most target rows:
    the same 3xTF32 products added with round-to-nearest stay near plain
    f32 (~1.7e-6), while a truncating accumulator (mma_sum_truncating)
    gives ~4e-5, above the 2e-5 gate and below 1e-4; one-pass TF32
    products land above 1e-4."""
    (pb, ps), (hb, hs), P, h, want = _bench_dw_case()
    nearest = mma_sum([ps.T, pb.T, pb.T], [hb, hs, hb])
    truncating = _bench_dw_one_chain()
    one_pass = mma_sum_truncating([tf32_rna(P)], [tf32_rna(h)])
    e_near, e_trunc, e_one = (rel(x, want) for x in
                              (nearest, truncating, one_pass))
    print(f"dW emulation: nearest {e_near:.3e} truncating {e_trunc:.3e} "
          f"one-pass {e_one:.3e}")
    assert e_near < 5e-6, e_near
    assert 2e-5 < e_trunc < 1e-4, e_trunc
    assert e_one > 1e-4, e_one


def test_k5_dw_in_row_chains_of_1280_is_f32_accurate_at_the_bench_shape():
    """K5's remedy for its dW (``csrc/ce.cu`` kMaxRowChain): the plan gives
    the dW kernel at least one row split per 1,280 rows, so a truncating
    tensor-core accumulator sums at most 1,280 rows, and ce_merge_kernel
    adds the splits' partials in f32, in split order.  At the bench's
    shape this is within 1e-5 of float64 (the card's target); one chain of
    all 10,240 rows, the scheme it replaces, is not, nor are chains of
    2,560."""
    (pb, ps), (hb, hs), _, _, want = _bench_dw_case()

    def chained(rows):
        acc = torch.zeros(want.shape, dtype=torch.float32)
        for r0 in range(0, pb.shape[0], rows):
            part = slice(r0, r0 + rows)
            acc = acc + mma_sum_truncating([ps[part], pb[part], pb[part]],
                                           [hb[part], hs[part], hb[part]])
        return rel(acc, want)

    e_1280, e_2560 = chained(1280), chained(2560)
    e_one = rel(_bench_dw_one_chain(), want)
    print(f"dW emulation: chains of 1,280 rows {e_1280:.3e}, of 2,560 "
          f"{e_2560:.3e}, one chain {e_one:.3e}")
    assert e_1280 <= TOL, e_1280
    assert e_2560 > TOL and e_one > TOL, (e_2560, e_one)


def mma_sum_partials(a_terms, b_terms, steps: int = 4,
                     k_step: int = 8) -> torch.Tensor:
    """K4's logit tile (``csrc/ce_fwd.cuh`` logit_tile): the products of
    ``steps`` k-steps (kLogitSteps) go into a zeroed, truncating accumulator
    (mma_sum_truncating over those k-steps alone), which an f32 add rounds
    into the sum.  a_terms [K, M], b_terms [K, n]."""
    acc = torch.zeros(a_terms[0].shape[1], b_terms[0].shape[1])
    for k0 in range(0, a_terms[0].shape[0], steps * k_step):
        part = slice(k0, k0 + steps * k_step)
        acc = acc + mma_sum_truncating([a[part] for a in a_terms],
                                       [b[part] for b in b_terms])
    return acc


def test_logit_tile_partials_of_4_k_steps_are_as_close_as_plain_f32():
    """Logits of a trained state's size (|h| ~ 4, |W| ~ 1, d 128: logits up
    to ~200, the softmax sharp): summed over d's 16 k-steps in one
    truncating accumulator (the tile before the remedy), the logits and
    their lse drift several times further from float64 than plain f32;
    with partials of 4 k-steps (kLogitSteps) added in f32 they come within
    plain f32's error, and so do partials of 1 and 2."""
    rng = np.random.default_rng(5)
    N, d, V = 64, 128, 4096
    h = torch.from_numpy((rng.normal(size=(N, d)) * 4.0).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(d, V)).astype(np.float32))
    want = h.double() @ w.double()
    (hb, hs), (wb, ws) = split(h), split(w)
    terms = ([hs.T, hb.T, hb.T], [wb, ws, wb])
    lse64 = torch.logsumexp(want, 1)

    def errs(s):
        return rel(s, want), rel(torch.logsumexp(s.double(), 1), lse64)

    one_chain = errs(mma_sum_truncating(*terms))
    plain = errs(h @ w)
    for steps in (4, 2, 1):
        partials = errs(mma_sum_partials(*terms, steps=steps))
        print(f"logits, lse from float64: one chain {one_chain}, partials of "
              f"{steps} k-steps {partials}, plain f32 {plain}")
        for e_part, e_plain in zip(partials, plain):
            assert e_part <= e_plain, (steps, partials, plain)
    for e_chain, e_plain in zip(one_chain, plain):
        assert e_chain > 2 * e_plain, (one_chain, plain)
