"""The port's graph propagation (plain version of the CSR SpMM kernel) held
against the JAX package: its XLA ``spmm`` / ``gcn_propagate`` and the
blocked SpMM Pallas kernel in interpret mode.

Tolerance 1e-5 absolute: f32 sums of a few row-normalised terms of O(1)
values, taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2dsr_tpu.config import DataSpec as JSpec
from c2dsr_tpu.graph import build as jbuild
from c2dsr_tpu.ops import spmm as jspmm
from c2dsr_tpu.ops import spmm_pallas
from c2dsr_tpu_torch.config import DataSpec
from c2dsr_tpu_torch.data import synthetic
from c2dsr_tpu_torch.graph import build
from c2dsr_tpu_torch.ops import backend, spmm, spmm_cuda

SPEC = dict(n_item_a=40, n_item_b=60, len_max=10)
TOL = 1e-5


@pytest.fixture(scope="module")
def graphs():
    seqs = synthetic.generate_sequences(DataSpec(**SPEC), 400, seed=3)
    return build.build_graphs(seqs, DataSpec(**SPEC)), seqs


def _table(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_port_graph_build_matches_jax(graphs):
    (share, specific), seqs = graphs
    jshare, jspecific = jbuild.build_graphs(seqs, JSpec(**SPEC))
    for g, jg in ((share, jshare), (specific, jspecific)):
        assert g.n == jg.n
        np.testing.assert_array_equal(g.rows, jg.rows)
        np.testing.assert_array_equal(g.cols, jg.cols)
        np.testing.assert_array_equal(g.vals, jg.vals)


def test_device_graph_csr_layout(graphs):
    (share, _), _ = graphs
    g = spmm.device_graph(share, "cpu", heavy_deg=3)
    rowptr = g.rowptr.numpy()
    assert rowptr[0] == 0 and rowptr[-1] == share.nnz
    assert len(rowptr) == share.n + 1
    deg = np.diff(rowptr)
    np.testing.assert_array_equal(deg, np.bincount(share.rows,
                                                   minlength=share.n))
    np.testing.assert_array_equal(g.heavy_rows.numpy(), np.flatnonzero(deg > 3))
    assert g.heavy_deg == 3
    assert spmm.device_graph(share, "cpu").heavy_deg == spmm_cuda.HEAVY_DEG
    assert g.rowptr.dtype == g.cols.dtype == torch.int32


@pytest.mark.parametrize("which", ["share", "specific"])
@pytest.mark.parametrize("extra_rows", [0, 5])
def test_spmm_reference_matches_jax_and_pallas(graphs, which, extra_rows):
    """d = 128 so the Pallas kernel takes the table (lane-aligned dims)."""
    (share, specific), _ = graphs
    g = share if which == "share" else specific
    dev = spmm.device_graph(g, "cpu")
    h = _table(g.n + extra_rows, 128, seed=extra_rows)
    got = spmm.spmm_reference(dev, torch.from_numpy(h)).numpy()
    jdev = jspmm.device_graph(g)
    want = np.asarray(jspmm.spmm(jdev, jnp.asarray(h)))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    pallas = np.asarray(spmm_pallas._apply(jdev.bk_fwd, jnp.asarray(h),
                                           interpret=True))
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=0)
    np.testing.assert_array_equal(got[g.n:], 0.0)
    np.testing.assert_allclose(got[:g.n], g.to_dense() @ h[:g.n], atol=TOL)


def test_spmm_reference_matches_blocked_kernel_impl(graphs):
    (share, _), _ = graphs
    bk = spmm_pallas.prep(share.rows, share.cols, share.vals, int(share.n))
    h = _table(share.n, 128, seed=9)
    want = np.asarray(spmm_pallas.blocked_spmm_impl(bk, jnp.asarray(h),
                                                    interpret=True))
    got = backend.spmm(spmm.device_graph(share, "cpu"), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("d,extra_rows", [(32, 0), (64, 7)])
def test_gcn_propagate_matches_jax(graphs, n_layers, d, extra_rows):
    (_, specific), _ = graphs
    h = _table(specific.n + extra_rows, d, seed=n_layers)
    got = spmm.gcn_propagate(spmm.device_graph(specific, "cpu"),
                             torch.from_numpy(h), n_layers)
    want = jspmm.gcn_propagate(jspmm.device_graph(specific, blocked=False),
                               jnp.asarray(h), n_layers, 0.2, rng=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)

