"""The backward of the port's graph hop held against the JAX package.

On a CPU tensor the hop is the plain version under autograd; on the card
it is K1 over the CSR of Aᵀ that ``device_graph`` packs.  Both are held
here against ``jax.vjp`` of ``c2dsr_tpu.ops.spmm.spmm`` and of the blocked
Pallas SpMM (``make_blocked_spmm``, interpret mode), on tables with rows
past ``graph.n``; and the plain hop over the transpose CSR (what the
kernel's backward computes) equals the autograd gradient.  Tolerance 1e-5
relative to the largest value: f32 sums of a few row-normalised terms in
another order.  Train-mode dropout before a hop keeps 1 - p of the
entries and scales them by 1/(1 - p).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2dsr_tpu.ops import spmm as jspmm
from c2dsr_tpu.ops import spmm_pallas
from c2dsr_tpu_torch.config import DataSpec
from c2dsr_tpu_torch.data import synthetic
from c2dsr_tpu_torch.graph import build
from c2dsr_tpu_torch.ops import backend, spmm

SPEC = DataSpec(n_item_a=40, n_item_b=60, len_max=10)


@pytest.fixture(scope="module")
def graphs():
    seqs = synthetic.generate_sequences(SPEC, 400, seed=3)
    return build.build_graphs(seqs, SPEC)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("extra_rows,d", [(0, 16), (27, 128)])
def test_hop_gradient_matches_jax(graphs, which, extra_rows, d):
    g = graphs[which]
    rng = np.random.default_rng(which + d)
    h = rng.normal(size=(g.n + extra_rows, d)).astype(np.float32)
    gout = rng.normal(size=h.shape).astype(np.float32)
    dev = spmm.device_graph(g, "cpu")
    ht = torch.from_numpy(h).requires_grad_(True)
    (dh,) = torch.autograd.grad(backend.spmm(dev, ht), ht,
                                torch.from_numpy(gout))
    jdev = jspmm.device_graph(g, blocked=True)
    _, vjp = jax.vjp(lambda x: jspmm.spmm(jdev, x), jnp.asarray(h))
    _close(dh.numpy(), vjp(jnp.asarray(gout))[0])
    hop = spmm_pallas.make_blocked_spmm(jdev.bk_fwd, jdev.bk_bwd,
                                        interpret=True)
    _, pvjp = jax.vjp(hop, jnp.asarray(h))
    _close(dh.numpy(), pvjp(jnp.asarray(gout))[0])
    # the kernel path's backward: the same hop over the transpose CSR
    _close(spmm.spmm_reference(dev.t, torch.from_numpy(gout)).numpy(),
           dh.numpy())
    assert (dh[g.n:] == 0).all()


def test_transpose_csr_layout(graphs):
    g = graphs[0]
    dev = spmm.device_graph(g, "cpu", heavy_deg=3)
    t = dev.t
    assert t.n == dev.n and t.t is None and t.heavy_deg == 3
    np.testing.assert_array_equal(np.diff(t.rowptr.numpy()),
                                  np.bincount(g.cols, minlength=g.n))
    dense = np.zeros((g.n, g.n), np.float32)
    dense[g.rows, g.cols] = g.vals
    dense_t = np.zeros_like(dense)
    dense_t[t.rows.numpy(), t.cols.numpy()] = t.vals.numpy()
    np.testing.assert_array_equal(dense_t, dense.T)
    assert np.all(np.diff(t.rows.numpy()) >= 0)
    deg = np.diff(t.rowptr.numpy())
    np.testing.assert_array_equal(t.heavy_rows.numpy(),
                                  np.flatnonzero(deg > 3))


def test_propagate_dropout_keep_rate_and_scale(graphs):
    """The hop's input on a table of ones: in train mode 1 - p of its
    entries kept, each 1/(1 - p); in eval the table itself."""
    dev = spmm.device_graph(graphs[0], "cpu")
    h = torch.ones(dev.n, 64)
    gen = torch.Generator().manual_seed(0)
    kept = []
    orig = backend.spmm
    try:
        backend.spmm = (lambda graph, x, *a, **kw:
                        kept.append(x) or orig(graph, x, *a, **kw))
        spmm.gcn_propagate(dev, h, 1, 0.2, gen)
        spmm.gcn_propagate(dev, h, 1, 0.2, None)
    finally:
        backend.spmm = orig
    train, evals = kept
    assert torch.equal(evals, h)                  # eval: no dropout
    nz = train[train != 0]
    torch.testing.assert_close(nz, torch.full_like(nz, 1 / 0.8))
    rate = (train != 0).float().mean().item()
    sigma = (0.2 * 0.8 / train.numel()) ** 0.5
    assert abs(rate - 0.8) <= 4 * sigma
