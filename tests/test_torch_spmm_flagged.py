"""The port's batch-sparse graph hop held against the JAX package.

On a CPU tensor the flagged hop is the plain ``spmm_reference_flagged``
under autograd; on the card it is K6 (``csrc/spmm.cu``): over A with the
edges of unflagged output rows masked, and in the backward over the CSR of
Aᵀ with the edges of unflagged gathered rows masked.  Both are held here
against ``make_blocked_spmm_flagged`` (the Pallas kernel in interpret mode)
on both graphs, on tables with rows past ``graph.n``:

* the forward on every row, unflagged rows being zero on both sides;
* the VJP of a loss that reads only flagged rows;
* the plain "src" mode over the Aᵀ CSR (what K6 computes in the backward)
  equals the autograd gradient;
* ``gcn_propagate(out_flag=...)`` against the JAX package's at one and two
  hops, dropout 0, on the flagged rows.

Tolerance 1e-5 relative to the largest value: f32 sums of a few
row-normalised terms in another order.  d = 128, the width the Pallas
SpMM takes (``spmm_pallas.supports``).
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
D = 128


@pytest.fixture(scope="module")
def graphs():
    seqs = synthetic.generate_sequences(SPEC, 400, seed=5)
    return build.build_graphs(seqs, SPEC)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _flag(n_rows, seed):
    """A batch's row marker: a third of the graph's rows, the pad id too."""
    rng = np.random.default_rng(seed)
    f = np.zeros(n_rows, np.uint8)
    f[rng.choice(SPEC.n_item, SPEC.n_item // 3, replace=False)] = 1
    f[SPEC.idx_pad] = 1
    return f


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("extra_rows", [0, 27])
def test_flagged_hop_matches_jax(graphs, which, extra_rows):
    g = graphs[which]
    n_rows = g.n + extra_rows
    rng = np.random.default_rng(which * 10 + extra_rows)
    h = rng.normal(size=(n_rows, D)).astype(np.float32)
    flag = _flag(n_rows, which + extra_rows)
    # a loss that reads only the flagged rows
    w = rng.normal(size=h.shape).astype(np.float32) * flag[:, None]

    dev = spmm.device_graph(g, "cpu")
    ht = torch.from_numpy(h).requires_grad_(True)
    ft = torch.from_numpy(flag)
    out = backend.spmm(dev, ht, ft)
    (dh,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ht)

    jdev = jspmm.device_graph(g, blocked=True)
    hop = spmm_pallas.make_blocked_spmm_flagged(jdev.bk_fwd, jdev.bk_bwd,
                                                interpret=True)
    jout, vjp = jax.vjp(hop, jnp.asarray(h), jnp.asarray(flag, jnp.float32))
    _close(out.detach().numpy(), jout)
    assert (out[torch.from_numpy(flag == 0)] == 0).all()
    _close(dh.numpy(), vjp(jnp.asarray(w))[0])
    # the kernel path's backward: the "src" mode over the transpose CSR
    _close(spmm.spmm_reference_flagged(dev.t, torch.from_numpy(w), ft,
                                       "src").numpy(), dh.numpy())
    # flagged rows equal the dense hop's
    dense = spmm.spmm_reference(dev, ht.detach())
    sel = torch.from_numpy(flag != 0)
    _close(out.detach()[sel].numpy(), dense[sel].numpy())
    assert (dh[g.n:] == 0).all()


@pytest.mark.parametrize("n_gnn", [1, 2])
def test_gcn_propagate_out_flag_matches_jax(graphs, n_gnn):
    g = graphs[0]
    n_rows = g.n + 11
    rng = np.random.default_rng(n_gnn)
    h = rng.normal(size=(n_rows, D)).astype(np.float32)
    flag = _flag(n_rows, 7 + n_gnn)
    dev = spmm.device_graph(g, "cpu")
    got = spmm.gcn_propagate(dev, torch.from_numpy(h), n_gnn,
                             out_flag=torch.from_numpy(flag))
    jdev = jspmm.device_graph(g, blocked=True)
    want = jspmm.gcn_propagate(jdev, jnp.asarray(h), n_gnn, 0.0, None,
                               backend="pallas", interpret=True,
                               out_flag=jnp.asarray(flag, jnp.float32))
    sel = flag != 0
    _close(got.numpy()[sel], np.asarray(want)[sel])
    dense = spmm.gcn_propagate(dev, torch.from_numpy(h), n_gnn)
    _close(got.numpy()[sel], dense.numpy()[sel])


def test_flagged_plain_refuses_unknown_mode(graphs):
    dev = spmm.device_graph(graphs[0], "cpu")
    h = torch.zeros(dev.n, 4)
    with pytest.raises(ValueError, match="flag_on"):
        spmm.spmm_reference_flagged(dev, h, torch.ones(dev.n, dtype=torch.uint8),
                                    "both")
