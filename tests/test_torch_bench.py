"""The port's bench (``c2dsr_tpu_torch/bench``) on the CPU.

* Its FK corpus builder (``bench/fk_graph.py``) at a small user count gives
  arrays exactly equal to those the JAX package's ``data.synthetic``,
  ``data.preprocess`` and ``graph.build`` give at that count (the JAX
  bench's ``bench/fk_graph.py`` builds its corpus from them).
* The headline and ``--batches`` run with ``--device cpu`` at a tiny spec,
  pass their gates (the plain versions against themselves on the CPU) and
  print a last JSON line with the headline's keys.
* The headline's train gate holds the gradients as well as the loss: a
  fault that leaves the loss exact and moves only the gradients fails it.
* The kernel modes have no CPU form: they raise.
* ``--scaled``'s projection to 10M items is the JAX bench's formula, and
  ``--kernels``' library version of K5 bf16 composes the plain bf16 CE's
  steps (with an exact product in place of ``mm``'s bf16 one, which the
  CPU lacks: then bitwise the plain version).
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from c2dsr_tpu.config import DataSpec as JDataSpec
from c2dsr_tpu.data import preprocess as jpreprocess
from c2dsr_tpu.data import synthetic as jsynthetic
from c2dsr_tpu.graph import build as jbuild
from c2dsr_tpu_torch.bench import __main__ as bench_main
from c2dsr_tpu_torch.bench import fk_graph

TINY = bench_main.Spec(n_item_a=200, n_item_b=250, n_users=300, batch=16,
                       steps=2, eval_users=48, eval_chunk=16, eval_reps=1,
                       batches=(8, 16), batch_examples=16, cache=False)


@pytest.mark.parametrize("n_users", [150, 400])
def test_fk_corpus_equals_the_jax_packages(n_users):
    sp = fk_graph.spec(300, 350, 15)
    jsp = JDataSpec(n_item_a=300, n_item_b=350, len_max=15)
    seqs = jsynthetic.generate_sequences(jsp, n_users, seed=0)
    want = jpreprocess.preprocess_train(seqs, jsp, seed=0)
    got = fk_graph.load_train(sp, n_users, cache=False)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    gs, gp = jbuild.build_graphs(seqs, jsp)
    g = fk_graph.load_or_build(sp, n_users, cache=False)
    for prefix, jg in (("s", gs), ("p", gp)):
        for name in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(g[f"{prefix}_{name}"],
                                          getattr(jg, name))
    assert int(g["n"]) == jsp.n_item


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_headline_on_cpu(capsys):
    assert bench_main.main(["--device", "cpu"], spec=TINY) == 0
    line = _last_json(capsys.readouterr().out)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert line["metric"] == "train_examples_per_s_cpu"
    assert line["unit"] == "examples/s" and line["value"] > 0
    assert line["device"] == "cpu" and line["vs_baseline"] is None


def test_batches_on_cpu(capsys):
    assert bench_main.main(["--batches", "--device", "cpu"], spec=TINY) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(x) for x in lines[:-1]]
    assert [r["batch"] for r in rows] == [8, 16]
    assert all(r["examples_per_s"] > 0 and r["gate_rel_err"] <= 1e-5
               and r["gate_grad_rel_err"] <= 1e-4 for r in rows)
    assert json.loads(lines[-1])["metric"] == "batch_scaling"


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the gradient by 1 + 1e-3."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * (1 + 1e-3)


@pytest.mark.parametrize("faulty", [False, True])
def test_train_gate_holds_the_gradients(monkeypatch, faulty):
    """The gate at a tiny spec on the CPU: the plain versions against
    themselves pass; a plain CE whose lse is exact and whose gradient is
    1e-3 off (a fault the loss alone cannot show) fails it."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import fused_ce
    from c2dsr_tpu_torch.train import optim
    from c2dsr_tpu_torch.train import step as step_mod
    sp, train, graphs = bench_main.setup(TINY, "cpu")
    cfg = Config(batch_size=TINY.batch)
    params = params_mod.init_params(cfg, sp, torch.Generator().manual_seed(0),
                                    "cpu")
    leaves = step_mod.init_state(
        params, optim.make_optimizer(cfg, steps_per_epoch=4)).opt_state.leaves
    batch = ranker.to_device(bench_main._batches(train, TINY.batch, 1)[0],
                             "cpu")
    if faulty:
        exact, plain = fused_ce.ce_fwd_plain, bench_main.gates.plain_versions

        def off(*args):
            lse, tlog = exact(*args)
            return _ScaleGrad.apply(lse), tlog

        @contextlib.contextmanager
        def faulty_plain(branches=None):
            with plain(branches):
                monkeypatch.setattr(fused_ce, "ce_fwd_plain", off)
                try:
                    yield
                finally:
                    monkeypatch.setattr(fused_ce, "ce_fwd_plain", exact)

        monkeypatch.setattr(bench_main.gates, "plain_versions", faulty_plain)
        with pytest.raises(bench_main.timing.GateFailure, match="gradient"):
            bench_main.train_gate(cfg, sp, graphs, leaves, params, batch)
    else:
        gate = bench_main.train_gate(cfg, sp, graphs, leaves, params, batch)
        assert gate["rel_err"] == 0.0 and gate["grad_rel_err"] == 0.0
        assert gate["n_grads"] == len(leaves)


@pytest.mark.parametrize("mode", ["--kernels", "--ce-variants", "--scaled",
                                  "--spmm-sweep"])
def test_kernel_modes_need_the_card(mode):
    with pytest.raises(ValueError, match="no CPU mode"):
        bench_main.main([mode, "--device", "cpu"])


@pytest.mark.parametrize("argv", [[], ["--batches"]])
def test_card_modes_raise_without_a_card(argv):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the mode would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_main.main(argv, spec=TINY)


def test_projection_to_10m_is_the_jax_benchs():
    """``scaled_bench.project_10m`` against the JAX bench's projection
    (bench/scaled_bench.py:263-276): its keys, its shard counts, and each
    time scaled by (V_FULL / M) / V_BF16 (the JAX bench rounds to 0.01)."""
    from bench import scaled_bench as jax_scaled
    from c2dsr_tpu_torch.bench import scaled_bench
    assert (scaled_bench.V_FULL, scaled_bench.V_BF16) == (jax_scaled.V_FULL,
                                                          jax_scaled.V_BF16)
    ce_ms, rank_ms = 137.913, 11.261
    rows = scaled_bench.project_10m(ce_ms, rank_ms)
    assert [r["shards"] for r in rows] == [8, 16, 32]
    for r in rows:
        m = r["shards"]
        scale = (jax_scaled.V_FULL / m) / jax_scaled.V_BF16
        assert set(r) == {"shards", "vocab_per_device", "classifier",
                          "ce_fwd_bwd_ms", "full_rank_ms_per_256"}
        assert r["vocab_per_device"] == jax_scaled.V_FULL // m
        assert r["classifier"] == "bf16_at_rest"
        assert r["ce_fwd_bwd_ms"] == pytest.approx(ce_ms * scale, rel=1e-15)
        assert round(r["ce_fwd_bwd_ms"], 2) == round(
            ce_ms / 1e3 * 1e3 * scale, 2)
        assert r["full_rank_ms_per_256"] == pytest.approx(rank_ms * scale,
                                                          rel=1e-15)


def test_k5_bf16_library_version_composes_the_plain_bf16_ce(monkeypatch):
    """``kernel_bench.ce_bwd_bf16_library`` (and the forward beside it),
    with an exact f32 product of the bf16 operands in place of ``mm``'s bf16
    -> f32 one: bitwise the plain bf16 CE's (lse, target logit) and (dh, dW,
    db), and its gate passes; a version that leaves dlogits unrounded fails
    the gate."""
    from c2dsr_tpu_torch.bench import kernel_bench
    from c2dsr_tpu_torch.ops import fused_ce
    monkeypatch.setattr(kernel_bench, "mm_bf16_f32",
                        lambda a, b: a.float() @ b.float())
    rng = np.random.default_rng(4)
    N, d, V, n_real = 96, 24, 160, 150

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    h = put(rng.normal(size=(N, d)))
    w = put(rng.normal(size=(d, V)) * 0.3)
    bm = fused_ce.mask_bias(put(rng.normal(size=V) * 0.1), n_real)
    pad = put(rng.normal(size=N))
    tgt = torch.from_numpy(rng.integers(0, n_real, size=N))
    dlse, dt = put(rng.normal(size=N)), put(rng.normal(size=N))
    hb, wb = h.to(torch.bfloat16), w.to(torch.bfloat16)
    lse, tlog = kernel_bench.ce_fwd_bf16_library(hb, wb, bm, pad, tgt)
    want = fused_ce.ce_fwd_plain(h, wb, bm, pad, tgt)
    assert torch.equal(lse, want[0]) and torch.equal(tlog, want[1])
    got = kernel_bench.ce_bwd_bf16_library(hb, wb, bm, lse, dlse, dt, tgt)
    want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt, bf16=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    errs = kernel_bench.check_ce_bwd_bf16_library(h, w, bm, lse, dlse, dt,
                                                  tgt)
    assert max(errs.values()) == 0.0

    def unrounded(hb, wb, bm, lse, dlse, dt, tgt):
        dlog = (torch.exp(hb.float() @ wb.float() + bm - lse[:, None])
                * dlse[:, None])
        dlog.scatter_add_(1, tgt[:, None], dt[:, None])
        return (dlog @ wb.float().T, hb.float().T @ dlog, dlog.sum(0))

    monkeypatch.setattr(kernel_bench, "ce_bwd_bf16_library", unrounded)
    with pytest.raises(bench_main.timing.GateFailure, match="library"):
        kernel_bench.check_ce_bwd_bf16_library(h, w, bm, lse, dlse, dt, tgt)
