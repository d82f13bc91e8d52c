"""The lookup's backward, K7's plain version (``ops/segsum_cuda.segsum_plain``:
``index_add_`` on the CPU, which sums each id's rows in index order),
against the JAX package's lookup, ``jnp.take``, differentiated by
``jax.grad``: within 1e-6 absolute (f32 sums in another order), on
Zipf-skewed ids with repeats, ids absent from the batch, and one heavy id
(the padding id of a batch of short sequences).  Also the port's lookup
(``ops/lookup.lookup``) on the CPU: ``table[ids]`` forward and the plain
version's gradient, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2dsr_tpu_torch.ops import lookup, segsum_cuda


def _ids(n_rows, shape, zipf, seed):
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.zipf(zipf, size=shape) - 1, n_rows - 1)
    ids[rng.random(shape) < 0.3] = n_rows - 1           # a heavy pad id
    return ids


CASES = [(500, (32, 15), 1.3, 16), (64, (64, 15), 1.1, 8), (3000, (8, 30),
                                                            1.6, 36)]


@pytest.mark.parametrize("n_rows,shape,zipf,d", CASES)
def test_segsum_plain_matches_jax_grad_of_take(n_rows, shape, zipf, d):
    ids = _ids(n_rows, shape, zipf, seed=n_rows)
    rng = np.random.default_rng(1)
    table = rng.normal(size=(n_rows, d)).astype(np.float32)
    g = rng.normal(size=shape + (d,)).astype(np.float32)
    counts = np.bincount(ids.ravel(), minlength=n_rows)
    assert counts.max() > 1 and (counts == 0).any()     # repeats, absences

    want = jax.grad(lambda t: jnp.sum(jnp.take(t, ids, axis=0) * g))(table)
    got = segsum_cuda.segsum_plain(torch.from_numpy(ids),
                                   torch.from_numpy(g.reshape(-1, d)), n_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert not got.numpy()[counts == 0].any()


@pytest.mark.parametrize("n_rows,shape,zipf,d", CASES)
def test_lookup_on_cpu_is_take_with_the_plain_backward(n_rows, shape, zipf,
                                                       d):
    ids = torch.from_numpy(_ids(n_rows, shape, zipf, seed=n_rows + 1))
    table = torch.randn(n_rows, d, requires_grad=True)
    rows = lookup.lookup(table, ids)
    assert torch.equal(rows, table.detach()[ids])
    g = torch.randn(rows.shape)
    (grad,) = torch.autograd.grad(rows, table, g)
    assert torch.equal(grad, segsum_cuda.segsum_plain(
        ids, g.reshape(-1, d), n_rows))


def test_segsum_kernel_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA"):
        segsum_cuda.segsum(torch.zeros(3, dtype=torch.long),
                           torch.zeros(3, 4), 5)
