"""K1/K6's plan of warp tasks (``ops/spmm.plan``, built by ``device_graph``
for ``csrc/spmm.cu``), checked on the CPU: it covers every edge once, each
row's edges in CSR order, and a split row's segments in order; and the
kernels' sums, emulated in numpy in the order the plan gives them (a task's
edges walked in CSR order; a split row's partial rows added in contiguous
runs, each in segment order, and the runs in order) are within the
kernels' tolerance of ``spmm_reference`` (itself held against the JAX
package's SpMM in ``tests/test_torch_spmm.py``), densely and in K6's two
modes; at the plan parameters ``bench/spmm_experiments.py`` sweeps too
(``heavy_deg``, ``run_rows``).

Tolerance 1e-5 of the largest output: f32 sums of row-normalised terms
taken in another order (a split row's partials), as on the card.
"""

import numpy as np
import pytest
import torch

from c2dsr_tpu_torch.config import DataSpec
from c2dsr_tpu_torch.data import synthetic
from c2dsr_tpu_torch.graph import build
from c2dsr_tpu_torch.ops import spmm, spmm_cuda

SPEC = DataSpec(n_item_a=300, n_item_b=400, len_max=15)
TOL = 1e-5
COMBINE_WARPS = 8       # csrc/spmm.cu kWarps: a split row's runs of partials


@pytest.fixture(scope="module")
def graphs():
    seqs = synthetic.generate_sequences(SPEC, 3000, seed=0)
    share, specific = build.build_graphs(seqs, SPEC)
    return {"share": share, "specific": specific}


def _check_plan(rowptr, tasks, heavy, slots, budget, run_rows):
    deg = np.diff(rowptr)
    n = deg.size
    np.testing.assert_array_equal(heavy, np.flatnonzero(deg > budget))
    assert slots[0] == 0 and slots.size == heavy.size + 1
    covered = np.zeros(rowptr[-1], np.int64)
    next_row, next_slot = 0, 0
    for r0, y, e0, e1 in tasks.tolist():
        if y > 0:                                  # a run of whole rows
            assert r0 == next_row and y <= run_rows
            assert e0 == rowptr[r0] and e1 == rowptr[r0 + y]
            assert e1 - e0 <= budget and (deg[r0:r0 + y] <= budget).all()
            next_row = r0 + y
        else:                                      # a segment of a split row
            slot = -1 - y
            assert slot == next_slot
            k = int(np.searchsorted(heavy, r0))
            assert heavy[k] == r0 and slots[k] <= slot < slots[k + 1]
            if slot == slots[k]:
                assert r0 == next_row and e0 == rowptr[r0]
            else:
                assert e0 == prev_e1               # contiguous, in order
            if slot == slots[k + 1] - 1:
                assert e1 == rowptr[r0 + 1]
                next_row = r0 + 1
            assert 0 < e1 - e0 <= budget
            prev_e1 = e1
            next_slot += 1
        covered[e0:e1] += 1
    assert next_row == n and next_slot == slots[-1]
    assert (covered == 1).all()                    # every edge once


def emulate(g, h, flag=None, mode="dense"):
    """The kernels' result in their order: fma(v, x, acc) a float32 chain
    from +0.0 per task row or segment; then each split row's partials cut
    into COMBINE_WARPS contiguous runs, each run added in order, and the
    runs' sums added in run order.  mode "dest" drops the edges of
    unflagged rows and "src" those of unflagged gathered rows, as K6
    does."""
    rowptr, cols, vals = (t.numpy() for t in (g.rowptr, g.cols, g.vals))
    tasks, heavy, slots = (t.numpy() for t in (g.tasks, g.heavy_rows,
                                               g.heavy_slots))
    out = np.zeros_like(h)
    part = np.zeros((g.n_part, h.shape[1]), np.float32)

    def chain(e0, e1, row):
        acc = np.zeros(h.shape[1], np.float32)
        for e in range(e0, e1):
            if mode == "dest" and not flag[row]:
                continue
            if mode == "src" and not flag[cols[e]]:
                continue
            acc = (vals[e].astype(np.float64) * h[cols[e]] + acc).astype(
                np.float32)
        return acc

    for r0, y, e0, e1 in tasks.tolist():
        if y > 0:
            for r in range(r0, r0 + y):
                out[r] = chain(rowptr[r], rowptr[r + 1], r)
        else:
            part[-1 - y] = chain(e0, e1, r0)
    for k, r in enumerate(heavy.tolist()):
        n_part = slots[k + 1] - slots[k] if mode != "dest" or flag[r] else 0
        per = -(-n_part // COMBINE_WARPS)
        acc = np.zeros(h.shape[1], np.float32)
        for s0 in range(0, n_part, max(per, 1)):     # a warp's run, in order
            run = np.zeros(h.shape[1], np.float32)
            for s in range(s0, min(s0 + per, n_part)):
                run = run + part[slots[k] + s]
            acc = acc + run
        out[r] = acc
    return out


@pytest.mark.parametrize("which", ["share", "specific"])
@pytest.mark.parametrize("budget", [1, 3, 8, 64, 128])
@pytest.mark.parametrize("run_rows", [8, 16, 32])
def test_plan_covers_each_edge_once_in_order(graphs, which, budget,
                                             run_rows):
    """Every task at most ``run_rows`` whole rows and ``budget`` edges (the
    sweep's plan parameters, bench/spmm_experiments.py)."""
    g = spmm.device_graph(graphs[which], "cpu", heavy_deg=budget,
                          run_rows=run_rows)
    for csr in (g, g.t):
        _check_plan(csr.rowptr.numpy(), csr.tasks.numpy(),
                    csr.heavy_rows.numpy(), csr.heavy_slots.numpy(), budget,
                    run_rows)
        assert csr.n_part == int(csr.heavy_slots[-1])
        assert (csr.heavy_deg, csr.run_rows) == (budget, run_rows)


def test_plan_of_a_graph_without_edges():
    tasks, heavy, slots = spmm.plan(np.zeros(70, np.int32), 64)
    np.testing.assert_array_equal(tasks[:, 1], [32, 32, 5])
    assert heavy.size == 0 and slots.tolist() == [0]
    np.testing.assert_array_equal(
        spmm.plan(np.zeros(70, np.int32), 64, run_rows=8)[0][:, 1],
        [8] * 8 + [5])
    with pytest.raises(ValueError, match="heavy_deg"):
        spmm.plan(np.zeros(3, np.int32), 0)


@pytest.mark.parametrize("run_rows", [0, 33])
def test_plan_refuses_runs_past_a_warp(run_rows):
    """The kernel reads a task's row ends one a lane of a warp."""
    with pytest.raises(ValueError, match="run_rows"):
        spmm.plan(np.zeros(3, np.int32), 8, run_rows)


@pytest.mark.parametrize("budget", [3, spmm_cuda.HEAVY_DEG])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("run_rows", [8, 16, 32])
def test_emulated_k1_matches_plain(graphs, budget, transpose, run_rows):
    g = spmm.device_graph(graphs["share"], "cpu", heavy_deg=budget,
                          run_rows=run_rows)
    if transpose:
        g = g.t
    assert g.heavy_rows.numel() > 0
    h = np.random.default_rng(budget).normal(size=(g.n + 7, 12)).astype(
        np.float32)
    got = emulate(g, h)
    want = spmm.spmm_reference(g, torch.from_numpy(h)).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    assert (got[g.n:] == 0).all()


@pytest.mark.parametrize("mode", ["dest", "src"])
def test_emulated_k6_matches_plain(graphs, mode):
    """K6's masks over the same plan: dest rows of unflagged outputs zero,
    flagged ones the dense emulation's bits; src on a table zero off the
    flags equal to the dense emulation."""
    g = spmm.device_graph(graphs["specific"], "cpu", heavy_deg=8)
    if mode == "src":
        g = g.t
    rng = np.random.default_rng(1)
    flag = (rng.random(g.n + 3) < 0.3).astype(np.uint8)
    flag[g.heavy_rows.numpy()[::2]] = 1
    h = rng.normal(size=(g.n + 3, 8)).astype(np.float32)
    if mode == "src":
        h = h * flag[:, None]
    got = emulate(g, h, flag, mode)
    want = spmm.spmm_reference_flagged(g, torch.from_numpy(h),
                                       torch.from_numpy(flag), mode).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    dense = emulate(g, h)
    if mode == "dest":
        sel = flag.astype(bool)
        np.testing.assert_array_equal(got[sel], dense[sel])
        assert (got[~sel] == 0).all()
    else:
        np.testing.assert_array_equal(got, dense)
