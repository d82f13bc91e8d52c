"""The counter-based dropout hash of the port (``ops/dropout.py``), the one
mask function that the encoder kernels and their plain versions share.

The torch hash equals reference values computed in plain Python integers
(the same values ``chip_smoke.py`` holds the CUDA hash against); its keep
rate is within 4 standard deviations of 1 - p over 10^6 draws, kept values
are scaled by 1/(1 - p), the same key gives the same mask, and masks of
other sites, layers, towers or seeds are uncorrelated.
"""

import math

import numpy as np
import pytest
import torch

from c2dsr_tpu_torch.ops import dropout as drop

P = 0.2
N = 1 << 20


def _keep(seed, site, tower, layer, n=N):
    bits = drop.bits(torch.arange(n), seed, site, tower, layer)
    return (bits >= drop.threshold(P)).numpy()


@pytest.mark.parametrize("seed,site,tower,layer", [
    (0, 0, 0, 0), (12345, 1, 2, 0), (2 ** 31 - 1, 4, 1, 3)])
def test_torch_hash_equals_integer_reference(seed, site, tower, layer):
    idx = list(range(300)) + [2 ** 32 - 1 - i for i in range(100)]
    got = drop.bits(torch.tensor(idx), seed, site, tower, layer).tolist()
    want = [drop.bits_reference(seed, site, tower, layer, i) for i in idx]
    assert got == want
    assert all(0 <= v < 2 ** 32 for v in got)


def test_mix32_is_murmur3_finaliser():
    # fmix32 of MurmurHash3 on known inputs
    assert drop.mix32(0) == 0
    assert drop.mix32(1) == 0x514E28B7
    assert drop.mix32(0xFFFFFFFF) == 0x81F16F39


def test_keep_rate_within_four_sigma():
    keep = _keep(7, drop.SITE_PROBS, 0, 0)
    sigma = math.sqrt(P * (1 - P) / N)
    assert abs(keep.mean() - (1 - P)) <= 4 * sigma


def test_kept_values_scaled_and_dropped_zero():
    x = torch.rand(64, 15, 32) + 0.5
    y = drop.apply(x, P, 3, drop.SITE_INPUT, 1, 0)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / (1 - P), rtol=0, atol=0)
    assert 0.7 < kept.float().mean() < 0.9
    assert drop.apply(x, 0.0, 3, drop.SITE_INPUT, 1, 0) is x


def test_same_key_same_mask():
    x = torch.ones(8, 15, 15)
    a = drop.apply(x, P, 11, drop.SITE_FFN_OUT, 2, 1)
    b = drop.apply(x, P, 11, drop.SITE_FFN_OUT, 2, 1)
    assert torch.equal(a, b)


@pytest.mark.parametrize("other", [
    (11, 1, 0, 0), (11, 0, 1, 0), (11, 0, 0, 1), (12, 0, 0, 0)])
def test_other_streams_uncorrelated(other):
    """Another site, tower, layer or seed: the masks agree as often as two
    independent Bernoulli(0.8) masks do, and their correlation is within 4
    standard deviations of 0."""
    a = _keep(11, 0, 0, 0).astype(np.float64)
    b = _keep(*other).astype(np.float64)
    corr = np.corrcoef(a, b)[0, 1]
    assert abs(corr) <= 4 / math.sqrt(N)


def test_neighbouring_elements_uncorrelated():
    a = _keep(5, drop.SITE_ATTN_OUT, 0, 0).astype(np.float64)
    corr = np.corrcoef(a[:-1], a[1:])[0, 1]
    assert abs(corr) <= 4 / math.sqrt(N)
