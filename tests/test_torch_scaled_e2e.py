"""The port's ``--scaled-e2e`` (``bench/scaled_e2e.py``) and ``--ablation``
(``bench/step_ablation.py``) on the CPU at a tiny size, through the plain
versions.

* The synthetic 1M-row graph generator is the JAX script's for a seed.
* ``scaled_e2e.run`` passes its gates (the loss falls, the CE probe rows
  and gradients against the float64 oracle, full ranks in range and equal
  to a chunked count) and reports the keys the card's run reports.
* ``--ablation`` runs every variant, reports wall ms for each and the
  attribution against ``full``, and leaves no stub behind.
* ``--scaled-e2e`` has no CPU form.
"""

import json

import numpy as np
import pytest

from c2dsr_tpu_torch.bench import __main__ as bench_main
from c2dsr_tpu_torch.bench import scaled_e2e, step_ablation

@pytest.fixture(autouse=True)
def one_thread():
    """The tiny steps are a few hundred small ops each: one thread runs
    them fastest, and leaves the other test workers their cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = scaled_e2e.Size(n_a=300, n_b=400, d=16, batch=32, n_edges=2000,
                       n_users=200, n_eval=64, n_neg=50, warmup=1, windows=2,
                       steps=4, n_probe=16, n_rank_rows=8)
TINY_FK = bench_main.Spec(n_item_a=200, n_item_b=250, n_users=300, batch=16,
                          steps=1, warmup=1, cache=False)


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_graph_is_the_jax_scripts(seed):
    from bench import scaled_e2e as jax_e2e
    got = scaled_e2e._synthetic_graph(5000, 20000, seed)
    want = jax_e2e._synthetic_graph(5000, 20000, seed)
    assert got.n == want.n
    for name in ("rows", "cols", "vals"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_scaled_e2e_on_cpu_passes_its_gates():
    r = scaled_e2e.run("cpu", TINY, log=lambda *_: None)
    for key in ("train_step_ms", "train_examples_per_s", "window_step_ms",
                "loss_first_step", "loss_after_timing",
                "eval_full_rank_examples_per_s", "eval_full_rank_items_per_s",
                "launches_in_windows", "peak_memory_bytes",
                "peak_memory_train_bytes", "ce_oracle_rows_rel_err",
                "ce_oracle_grads_rel_err", "full_rank_max_rank_delta",
                "device_graph_s", "device"):
        assert key in r, key
    assert r["n_item"] == TINY.n_a + TINY.n_b + 1
    assert r["loss_after_timing"] < r["loss_first_step"]
    assert len(r["window_step_ms"]) == TINY.windows
    assert r["ce_oracle_rows_rel_err"] <= scaled_e2e.CE_TOL
    assert r["ce_oracle_grads_rel_err"] <= scaled_e2e.GRAD_TOL
    assert set(r["full_rank_max_rank_delta"]) == {"a", "b"}
    assert r["eval_examples"] > 0 and r["eval_full_rank_items_per_s"] > 0
    # on the CPU no kernel launches and no device memory is read
    assert set(r["launches_in_windows"]) == set(scaled_e2e.step_wrappers())
    assert not any(r["launches_in_windows"].values())
    assert r["device"] == "cpu" and r["peak_memory_bytes"] is None
    json.dumps(r)


def test_ablation_on_cpu_runs_every_variant(capsys, monkeypatch, tmp_path):
    from c2dsr_tpu_torch.ops import backend
    from c2dsr_tpu_torch.parallel import strategy
    monkeypatch.setattr(bench_main, "DETAILS", str(tmp_path / "details.json"))
    ce_rows, fused = strategy.LocalOps.ce_rows, backend.fused_encoder_runs
    assert bench_main.main(["--ablation", "--device", "cpu"],
                           spec=TINY_FK) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "step_breakdown" and line["device"] == "cpu"
    assert strategy.LocalOps.ce_rows is ce_rows
    assert backend.fused_encoder_runs is fused
    with open(bench_main.DETAILS) as f:
        out = json.load(f)["step_breakdown"]
    assert list(out["variants"]) == ["full", "no_ce", "no_spmm",
                                     "plain_encoder", "no_dropout"]
    assert all(v["step_ms"] > 0 and np.isfinite(v["loss"])
               and v["busy_ms"] is None for v in out["variants"].values())
    assert set(out["attribution_ms"]) == set(out["variants"]) - {"full"}
    assert out["attribution_busy_ms"] is None
    assert out["train_gate"]["rel_err"] == 0.0
    # the stubs took effect: without the CE the loss is another number
    assert out["variants"]["no_ce"]["loss"] != out["variants"]["full"]["loss"]
    assert "f32_compute" in out


def test_ablation_stubs_route_around_the_kernels():
    """Each stub changes what the step computes, and is undone after."""
    import torch
    from c2dsr_tpu_torch.ops import backend
    from c2dsr_tpu_torch.parallel import strategy
    with step_ablation._no_ce():
        h = torch.ones(2, 3, 4)
        rows = strategy.LocalOps(cfg=None).ce_rows(h, None, None, None, None,
                                                   0)
        assert torch.equal(rows, torch.full((2, 3), 1e-3))
    with step_ablation._plain_encoder():
        assert backend.fused_encoder_runs(1, 128, False) is False
    assert backend.fused_encoder_runs(1, 128, False) is True


def test_scaled_e2e_has_no_cpu_mode():
    with pytest.raises(ValueError, match="no CPU mode"):
        bench_main.main(["--scaled-e2e", "--device", "cpu"])


@pytest.mark.parametrize("fault", [None, "ce_bwd", "segsum"])
def test_hold_recorded_holds_each_call_against_its_plain_version(
        monkeypatch, fault):
    """The card's check of the step's recorded K1/K4/K5/K7 calls, run here
    with the plain versions standing in for the kernels: they pass against
    themselves (K4/K5 against float64), and a call whose recorded result
    is off (K5's dW by 1e-3 of its largest element, one element of
    K7's) fails."""
    import torch
    from c2dsr_tpu_torch.bench import timing
    from c2dsr_tpu_torch.ops import (fused_ce, fused_ce_cuda, segsum_cuda,
                                     spmm, spmm_cuda)
    monkeypatch.setattr(fused_ce_cuda, "ce_fwd", fused_ce.ce_fwd_plain)
    monkeypatch.setattr(fused_ce_cuda, "ce_bwd", fused_ce.ce_bwd_plain)
    monkeypatch.setattr(spmm_cuda, "spmm_csr", spmm.spmm_reference)
    monkeypatch.setattr(segsum_cuda, "segsum", segsum_cuda.segsum_plain)
    monkeypatch.setattr(timing, "sm_clock_hz", lambda: 1.98e9)
    gen = torch.Generator().manual_seed(0)
    g = spmm.device_graph(scaled_e2e._synthetic_graph(500, 2000, 0), "cpu")
    h = torch.randn(512, 16, generator=gen)
    N, d, V = 64, 16, 304
    hh = torch.randn(N, d, generator=gen)
    w = torch.randn(d, V, generator=gen) * 0.05
    bm = fused_ce.mask_bias(torch.zeros(V), 290)
    pad = torch.zeros(N)
    tgt = torch.randint(0, 290, (N,), generator=gen)
    lse, tl = fused_ce.ce_fwd_plain(hh, w, bm, pad, tgt)
    dl, dt = torch.full((N,), 1.0 / N), torch.full((N,), -1.0 / N)
    dh, dw, db = fused_ce.ce_bwd_plain(hh, w, bm, lse, dl, dt, tgt)
    ids = torch.randint(0, 50, (100,), generator=gen)
    gg = torch.randn(100, 16, generator=gen)
    k7 = segsum_cuda.segsum_plain(ids, gg, 60)
    if fault == "ce_bwd":
        dw = dw + 1e-3 * dw.abs().max()
    elif fault == "segsum":
        k7 = k7.clone()
        k7.view(-1)[int(k7.abs().argmax())] = torch.nextafter(
            k7.abs().max(), torch.tensor(float("inf")))
    calls = [("spmm_csr", (g, h, None), spmm.spmm_reference(g, h)),
             ("ce_fwd", (hh, w, bm, pad, tgt), (lse, tl)),
             ("ce_bwd", (hh, w, bm, lse, dl, dt, tgt), (dh, dw, db)),
             ("segsum", (ids, gg, 60), k7)]

    def timer(fn, reps=20, warmup=3):
        fn()
        return 1.0

    if fault is None:
        out = scaled_e2e.hold_recorded(calls, timer, "H100 SXM", 3.35e12)
        assert set(out) == {"spmm_csr", "ce_fwd", "ce_bwd", "segsum"}
        for k, r in out.items():
            assert len(r["calls"]) == 1 and r["bound_ms"] > 0, k
            assert r["max_rel_err"] <= scaled_e2e.CE_TOL, k
        assert out["segsum"]["max_abs_err"] == 0.0
        assert out["spmm_csr"]["library_ms"] == 1.0
    else:
        with pytest.raises(timing.GateFailure, match={
                "ce_bwd": "K5", "segsum": "K7"}[fault]):
            scaled_e2e.hold_recorded(calls, timer, "H100 SXM", 3.35e12)
