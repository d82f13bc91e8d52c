"""The port's experiment loop (``train/loop.Experiment``) held against the
JAX package's, end to end on a tiny synthetic corpus: the same initial
params (the JAX initialisation, copied into the port's state), the same
shuffle seed, dropout 0, three epochs of ``run()``.

* The per-epoch train losses agree within 1e-4 relative (f32 sums in other
  orders, compounded over the epochs' optimizer steps).
* The validation ranks agree at every eval, up to near-ties: an example's
  ranks may differ by at most its number of candidates whose port score
  lies within 1e-5 of its ground truth's (relative to the largest score).
* Model selection follows the same logic: the same final epoch, and the
  best-validation improvement and the kept test metrics within 1e-3
  absolute (metrics of a few dozen ranks).
* The same with ``bug_epoch_grad_accum`` (the gradient runs over the
  epoch, reset at each epoch's start).
"""

import jax
import numpy as np
import pytest
import torch

from c2dsr_tpu.config import Config as JConfig, DataSpec as JSpec
from c2dsr_tpu.model import c2dsr as jc2dsr
from c2dsr_tpu.ops import spmm as jspmm
from c2dsr_tpu.train.loop import Experiment as JExperiment
from c2dsr_tpu_torch.config import Config, DataSpec
from c2dsr_tpu_torch.data import preprocess, synthetic
from c2dsr_tpu_torch.evaluate import ranker
from c2dsr_tpu_torch.graph import build
from c2dsr_tpu_torch.model import c2dsr
from c2dsr_tpu_torch.model import params as params_mod
from c2dsr_tpu_torch.ops import spmm
from c2dsr_tpu_torch.parallel.strategy import LocalOps
from c2dsr_tpu_torch.train import step
from c2dsr_tpu_torch.train.loop import Experiment

SPEC = dict(n_item_a=50, n_item_b=70, len_max=15)
CFG = dict(d_latent=32, batch_size=32, batch_size_eval=64, len_rec=5,
           n_neg_sample=20, dropout_gnn=0.0, dropout_attn=0.0,
           vocab_pad_multiple=64, n_epoch=3, es_patience=1)
TIE_TOL = 1e-5


@pytest.fixture(scope="module")
def data():
    spec = DataSpec(**SPEC)
    seqs = synthetic.generate_sequences(spec, 300, seed=1)
    train = preprocess.preprocess_train(seqs, spec, seed=1)
    n = train["seq_share"].shape[0] // 32 * 32     # full batches only
    train = {k: v[:n] for k, v in train.items()}
    val = preprocess.preprocess_evaluate(
        synthetic.generate_sequences(spec, 80, seed=2), spec,
        n_neg_sample=20, seed=2)
    test = preprocess.preprocess_evaluate(
        synthetic.generate_sequences(spec, 80, seed=3), spec,
        n_neg_sample=20, seed=3)
    return spec, seqs, train, val, test


def _near_ties(exp, data):
    """Per domain: each example's count of candidates other than the gt
    whose score is within TIE_TOL (relative) of the gt score."""
    cfg, spec, params = exp.cfg, exp.spec, exp.state.params
    pops = LocalOps(cfg=cfg)
    out = {}
    with torch.no_grad():
        hi = exp.convolve_eval(params)
        for dom, group in ranker.partition_by_domain(data).items():
            b = ranker.to_device(group, "cpu")
            h = ranker._last_hidden(params, hi, b, cfg, spec, dom, pops)
            ids = torch.cat([b["gt_last"][:, None], b["list_neg"]], dim=1)
            s = pops.gather_scores(h, params[f"cls_{dom}_w"],
                                   params[f"cls_{dom}_b"], ids)
            tol = TIE_TOL * float(s.abs().max())
            out[dom] = ((s[:, 1:] - s[:, :1]).abs() <= tol).sum(1).numpy()
    return out


def _record(exp, ties_of=None):
    """Wrap exp's run_train_epoch and run_eval to record their results."""
    rec = {"losses": [], "ranks": [], "ties": []}
    train_epoch, run_eval = exp.run_train_epoch, exp.run_eval

    def train_and_record():
        out = train_epoch()
        rec["losses"].append(out)
        return out

    def eval_and_record(d):
        out = run_eval(d)
        rec["ranks"].append(out)
        if ties_of is not None:
            rec["ties"].append(ties_of(exp, d))
        return out

    exp.run_train_epoch, exp.run_eval = train_and_record, eval_and_record
    return rec


@pytest.mark.parametrize("accum", [False, True])
def test_experiment_matches_jax(data, accum):
    spec, seqs, train, val, test = data
    gs, gp = build.build_graphs(seqs, spec)
    jexp = JExperiment(JConfig(**CFG, bug_epoch_grad_accum=accum),
                       JSpec(**SPEC),
                       jc2dsr.Graphs(jspmm.device_graph(gs, blocked=False),
                                     jspmm.device_graph(gp, blocked=False)),
                       train, val, test)
    exp = Experiment(Config(**CFG, bug_epoch_grad_accum=accum), spec,
                     c2dsr.Graphs(spmm.device_graph(gs, "cpu"),
                                  spmm.device_graph(gp, "cpu")), train,
                     val, test, device="cpu")
    init = params_mod.params_from_numpy(
        jax.tree.map(np.asarray, jexp.state.params), "cpu")
    with torch.no_grad():
        for t, v in zip(step.param_leaves(exp.state.params),
                        step.param_leaves(init)):
            t.copy_(v)
    jrec, rec = _record(jexp), _record(exp, _near_ties)
    jout, out = jexp.run(), exp.run()

    np.testing.assert_allclose(rec["losses"], jrec["losses"], rtol=1e-4)
    assert len(rec["ranks"]) == len(jrec["ranks"]) >= 2
    for (ra, rb), (ja, jb), ties in zip(rec["ranks"], jrec["ranks"],
                                        rec["ties"]):
        for r, j, t in ((ra, ja, ties["a"]), (rb, jb, ties["b"])):
            assert (np.abs(np.asarray(r) - np.asarray(j)) <= t).all()
    assert out["epoch"] == jout["epoch"]
    np.testing.assert_allclose(out["imp_val_best"], jout["imp_val_best"],
                               atol=1e-3)
    np.testing.assert_allclose(out["res_test"], jout["res_test"], atol=1e-3)


def _tiny_experiment(data, **kw):
    spec, seqs, train, val, test = data
    gs, gp = build.build_graphs(seqs, spec)
    return Experiment(Config(**dict(CFG, **kw)), spec,
                      c2dsr.Graphs(spmm.device_graph(gs, "cpu"),
                                   spmm.device_graph(gp, "cpu")),
                      train, val, test, device="cpu")


def test_profile_dir_traces_the_first_epoch_only(data, tmp_path):
    exp = _tiny_experiment(data, profile_dir=str(tmp_path / "prof"))
    exp.run_train_epoch()
    trace = tmp_path / "prof" / "train_epoch.json"
    assert trace.stat().st_size > 0
    stamp = trace.stat().st_mtime_ns
    exp.run_train_epoch()
    assert trace.stat().st_mtime_ns == stamp


def test_debug_nans_fails_fast(data):
    exp = _tiny_experiment(data, debug_nans=True)
    try:
        assert torch.is_anomaly_enabled()
        with torch.no_grad():
            exp.state.params["cls_pad_b"].fill_(float("nan"))
        with pytest.raises((FloatingPointError, RuntimeError),
                           match="nan|non-finite"):
            exp.run_train_epoch()
    finally:
        torch.autograd.set_detect_anomaly(False)
