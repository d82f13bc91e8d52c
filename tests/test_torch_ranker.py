"""The port's ranking (serving) path held against the JAX package, end to
end on a tiny synthetic split: same params (JAX init, converted), same
graphs, same eval split.

convolve_graph and the three towers match to 1e-5 absolute (f32, another
summation order).  Ranks are equal except at near-ties, where a candidate
scores within 1e-5 of the ground truth; the test counts those and requires
every rank difference to be explained by one.
"""

import jax
import numpy as np
import pytest
import torch

from c2dsr_tpu.config import Config as JConfig, DataSpec as JSpec
from c2dsr_tpu import metrics as jmetrics
from c2dsr_tpu.evaluate import ranker as jranker
from c2dsr_tpu.model import c2dsr as jc2dsr
from c2dsr_tpu.model import params as jparams
from c2dsr_tpu.ops import spmm as jspmm
from c2dsr_tpu_torch import metrics
from c2dsr_tpu_torch.config import Config, DataSpec
from c2dsr_tpu_torch.data import preprocess, synthetic
from c2dsr_tpu_torch.evaluate import ranker
from c2dsr_tpu_torch.graph import build
from c2dsr_tpu_torch.model import c2dsr
from c2dsr_tpu_torch.model import params as params_mod
from c2dsr_tpu_torch.ops import spmm

SPEC = dict(n_item_a=50, n_item_b=70, len_max=15)
TOL = 1e-5
TIE = 1e-5


def _cfgs(**kw):
    base = dict(d_latent=32, batch_size_eval=32, n_neg_sample=20, n_gnn=2,
                vocab_pad_multiple=64)
    base.update(kw)
    return Config(**base), JConfig(**base)


@pytest.fixture(scope="module")
def setup():
    spec, jspec = DataSpec(**SPEC), JSpec(**SPEC)
    share, specific = build.build_graphs(
        synthetic.generate_sequences(spec, 300, seed=1), spec)
    data = preprocess.preprocess_evaluate(
        synthetic.generate_sequences(spec, 150, seed=2), spec,
        n_neg_sample=20, seed=3)
    cfg, jcfg = _cfgs()
    jp = jparams.init_params(jax.random.PRNGKey(0), jcfg, jspec)
    np_params = jax.tree.map(np.asarray, jp)
    port = dict(
        graphs=c2dsr.Graphs(spmm.device_graph(share, "cpu"),
                            spmm.device_graph(specific, "cpu")),
        params=params_mod.params_from_numpy(np_params, device="cpu"))
    jax_side = dict(
        graphs=jc2dsr.Graphs(jspmm.device_graph(share, blocked=False),
                             jspmm.device_graph(specific, blocked=False)),
        params=jp)
    return dict(spec=spec, jspec=jspec, data=data, port=port, jax=jax_side,
                cfg=cfg, jcfg=jcfg)


def test_convolve_graph_matches_jax(setup):
    s = setup
    hi = c2dsr.convolve_graph(s["port"]["params"], s["port"]["graphs"],
                              s["cfg"], s["spec"])
    jhi = jc2dsr.convolve_graph(s["jax"]["params"], s["jax"]["graphs"],
                                s["jcfg"], s["jspec"], rng=None)
    for got, want in zip(hi, jhi):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("invert", [False, True])
def test_forward_towers_match_jax(setup, invert):
    s = setup
    cfg, jcfg = _cfgs(bug_inverted_padding_mask=invert)
    hi = c2dsr.convolve_graph(s["port"]["params"], s["port"]["graphs"], cfg,
                              s["spec"])
    jhi = jc2dsr.convolve_graph(s["jax"]["params"], s["jax"]["graphs"], jcfg,
                                s["jspec"], rng=None)
    d = s["data"]
    names = ("seq_share", "seq_share_a", "seq_share_b", "pos", "pos_a",
             "pos_b")
    got = c2dsr.forward(s["port"]["params"], hi,
                        *[torch.from_numpy(d[k]).long() for k in names],
                        cfg, s["spec"])
    want = jc2dsr.forward(s["jax"]["params"], jhi, *[d[k] for k in names],
                          jcfg, s["jspec"], rng=None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


def _near_ties(s, mode):
    """Per domain: candidates other than the gt within TIE of the gt score
    (port's scores)."""
    cfg, spec, p = s["cfg"], s["spec"], s["port"]["params"]
    hi = c2dsr.convolve_graph(p, s["port"]["graphs"], cfg, spec)
    out = {}
    for dom, group in ranker.partition_by_domain(s["data"]).items():
        b = ranker.to_device(group, "cpu")
        h = ranker._last_hidden(p, hi, b, cfg, spec, dom)
        w, bias = p[f"cls_{dom}_w"], p[f"cls_{dom}_b"]
        n_real = spec.n_item_a if dom == "a" else spec.n_item_b
        scores = h @ w + bias
        gt = scores.gather(1, b["gt_last"][:, None])
        if mode == "sampled":
            out[dom] = ((scores.gather(1, b["list_neg"]) - gt).abs()
                        <= TIE).sum(1).numpy()
        else:
            out[dom] = ((scores[:, :n_real] - gt).abs() <= TIE).sum(1).numpy() - 1
    return out


@pytest.mark.parametrize("mode", ["sampled", "full"])
def test_evaluate_split_ranks_match_jax(setup, mode):
    s = setup
    conv, rank_step = ranker.make_eval_fns(s["cfg"], s["spec"],
                                           s["port"]["graphs"], device="cpu")
    hi = conv(s["port"]["params"])
    ranks = ranker.evaluate_split(s["port"]["params"], hi, s["data"],
                                  rank_step, s["cfg"], mode)
    jconv, jrank = jranker.make_eval_fns(s["jcfg"], s["jspec"],
                                         s["jax"]["graphs"])
    jhi = jconv(s["jax"]["params"])
    jranks = jranker.evaluate_split(s["jax"]["params"], jhi, s["data"], jrank,
                                    s["jcfg"], mode)
    ties = _near_ties(s, mode)
    n_diff = 0
    for i, dom in enumerate(("a", "b")):
        got, want = np.asarray(ranks[i]), np.asarray(jranks[i])
        assert got.shape == want.shape and got.shape[0] > 32   # >1 batch
        n_diff += int((got != want).sum())
        assert (np.abs(got - want) <= ties[dom]).all()
        hi_rank = 21 if mode == "sampled" else (
            s["spec"].n_item_a if dom == "a" else s["spec"].n_item_b)
        assert got.min() >= 1 and got.max() <= hi_rank
    assert n_diff <= sum(int((t > 0).sum()) for t in ties.values())
    score = metrics.cal_score(*ranks, s["cfg"].benchmark)
    jscore = jmetrics.cal_score(*jranks, s["jcfg"].benchmark)
    # each rank that differs moves a metric by at most 1 / (domain size)
    bound = n_diff / min(len(ranks[0]), len(ranks[1])) + 1e-12
    np.testing.assert_allclose(score[1:], jscore[1:], rtol=0, atol=bound)
    if n_diff == 0:
        assert score[0] == pytest.approx(jscore[0], abs=1e-12)
    assert all(np.isfinite(score))


def test_metrics_copy_matches_jax():
    rng = np.random.default_rng(0)
    ra = rng.integers(1, 40, size=200).tolist()
    rb = rng.integers(1, 40, size=150).tolist()
    bench = Config().benchmark
    assert metrics.cal_score(ra, rb, bench) == jmetrics.cal_score(ra, rb, bench)
    assert metrics.cal_metrics([]) == jmetrics.cal_metrics([])


def test_batches_repeat_pad_and_partition(setup):
    groups = ranker.partition_by_domain(setup["data"])
    jgroups = jranker.partition_by_domain(setup["data"])
    for dom in ("a", "b"):
        chunks = list(ranker._batches(groups[dom], 32))
        jchunks = list(jranker._batches(jgroups[dom], 32))
        assert [n for _, n in chunks] == [n for _, n in jchunks]
        for (c, _), (jc, _) in zip(chunks, jchunks):
            for k in c:
                np.testing.assert_array_equal(c[k], jc[k])
