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
precision flag; the card tests hold the kernel itself to 2e-5.
"""

import numpy as np
import pytest
import torch

TOL = 1e-5


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
