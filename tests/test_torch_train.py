"""The port's training step held against the JAX package's, end to end on
a tiny synthetic split: the same params (JAX init, converted), graphs and
batches, dropout 0.

* ``loss_fn``: loss, loss_rec and loss_mi within 1e-5 relative, and the
  gradient of every parameter within 1e-4 of each leaf's largest value
  (f32, sums in other orders), with and without the ``valid`` mask.
* Three ``train_step``s against three JAX steps: the loss at each step
  within 1e-4 relative.
* The pad embedding row gets no gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2dsr_tpu.config import Config as JConfig, DataSpec as JSpec
from c2dsr_tpu.model import c2dsr as jc2dsr
from c2dsr_tpu.model import params as jparams
from c2dsr_tpu.ops import spmm as jspmm
from c2dsr_tpu.train import optim as joptim
from c2dsr_tpu.train import step as jstep
from c2dsr_tpu_torch.config import Config, DataSpec
from c2dsr_tpu_torch.data import preprocess, synthetic
from c2dsr_tpu_torch.data.pipeline import BatchIterator
from c2dsr_tpu_torch.evaluate import ranker
from c2dsr_tpu_torch.graph import build
from c2dsr_tpu_torch.model import c2dsr
from c2dsr_tpu_torch.model import params as params_mod
from c2dsr_tpu_torch.ops import spmm
from c2dsr_tpu_torch.train import optim, step

SPEC = dict(n_item_a=50, n_item_b=70, len_max=15)
CFG = dict(d_latent=32, batch_size=16, len_rec=5, dropout_gnn=0.0,
           dropout_attn=0.0, vocab_pad_multiple=64)


@pytest.fixture(scope="module")
def setup():
    spec, jspec = DataSpec(**SPEC), JSpec(**SPEC)
    cfg, jcfg = Config(**CFG), JConfig(**CFG)
    seqs = synthetic.generate_sequences(spec, 300, seed=1)
    train = preprocess.preprocess_train(seqs, spec, seed=1)
    share, specific = build.build_graphs(seqs, spec)
    jp = jparams.init_params(jax.random.PRNGKey(0), jcfg, jspec)
    return dict(
        spec=spec, jspec=jspec, cfg=cfg, jcfg=jcfg, train=train, jp=jp,
        np_params=jax.tree.map(np.asarray, jp),
        graphs=c2dsr.Graphs(spmm.device_graph(share, "cpu"),
                            spmm.device_graph(specific, "cpu")),
        jgraphs=jc2dsr.Graphs(jspmm.device_graph(share, blocked=False),
                              jspmm.device_graph(specific, blocked=False)))


def _batch(s, valid):
    if not valid:
        return {k: v[:16] for k, v in s["train"].items()}
    sub = {k: v[:13] for k, v in s["train"].items()}
    it = BatchIterator(sub, batch_size=16, shuffle=False, pad_to_multiple=8)
    return next(iter(it.epoch()))


@pytest.mark.parametrize("valid", [False, True])
def test_loss_fn_and_grads_match_jax(setup, valid):
    s = setup
    batch = _batch(s, valid)
    assert ("valid" in batch) == valid

    @jax.jit
    def jgrad(p, b):
        return jax.value_and_grad(jstep.loss_fn, has_aux=True)(
            p, s["jgraphs"], b, jax.random.PRNGKey(1), s["jcfg"], s["jspec"])

    (jloss, jaux), jgrads = jgrad(s["jp"], {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    params = params_mod.params_from_numpy(s["np_params"], "cpu")
    for t in step.param_leaves(params):
        t.requires_grad_(True)
    loss, aux = step.loss_fn(params, s["graphs"],
                             ranker.to_device(batch, "cpu"), None,
                             s["cfg"], s["spec"])
    loss.backward()
    for k in ("loss", "loss_rec", "loss_mi", "n_examples"):
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   rtol=1e-5,
                                   err_msg=k)
    grads = params_mod.params_to_numpy(params_mod._map(lambda t: t.grad,
                                                       params))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                                 jax.tree.leaves(grads)):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))
    spec = s["spec"]
    for name in ("embed_share", "embed_a", "embed_b"):
        g = grads[name]
        assert (g[spec.idx_pad] == 0).all()        # padding_idx semantics
        assert np.abs(g).sum() > 0


@pytest.mark.parametrize("valid", [False, True])
def test_loss_fn_in_float64_matches_jax(setup, valid):
    """The plain path carries float64 end to end (the card tests hold the
    kernels against it): float64 params give a float64 loss and float64
    gradients, within the f32 test's tolerances of the JAX package's."""
    s = setup
    batch = _batch(s, valid)
    (jloss, _), jgrads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        s["jp"], s["jgraphs"], {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1), s["jcfg"], s["jspec"])
    params = params_mod._map(
        lambda t: t.double().requires_grad_(True),
        params_mod.params_from_numpy(s["np_params"], "cpu"))
    loss, _ = step.loss_fn(params, s["graphs"],
                           ranker.to_device(batch, "cpu"), None,
                           s["cfg"].with_(compute_dtype="float64"),
                           s["spec"])
    loss.backward()
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = params_mod.params_to_numpy(params_mod._map(lambda t: t.grad,
                                                       params))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                                 jax.tree.leaves(grads)):
        assert got.dtype == np.float64
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_three_train_steps_match_jax(setup):
    s = setup
    batches = [{k: v[16 * i:16 * (i + 1)] for k, v in s["train"].items()}
               for i in range(3)]
    jopt = joptim.make_optimizer(s["jcfg"], steps_per_epoch=2)
    jfn = jstep.make_train_step(s["jcfg"], s["jspec"], s["jgraphs"], jopt,
                                jax.random.PRNGKey(7))
    jstate = jstep.init_state(s["jp"], jopt)
    jlosses = []
    for b in batches:
        jstate, aux = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(aux["loss"]))

    params = params_mod.params_from_numpy(s["np_params"], "cpu")
    opt = optim.make_optimizer(s["cfg"], steps_per_epoch=2)
    state = step.init_state(params, opt)
    fn = step.make_train_step(s["cfg"], s["spec"], s["graphs"], opt, "cpu")
    losses = []
    for b in batches:
        state, aux = fn(state, b)
        losses.append(float(aux["loss"]))
    assert state.step == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[0] != losses[2]                 # the params moved


def test_train_step_with_dropout_is_finite_and_seeded(setup):
    """Dropout on (GNN and towers): two runs from the same ``cfg.seed`` give
    the same losses; another seed gives other ones."""
    s = setup
    cfg = s["cfg"].with_(dropout_gnn=0.2, dropout_attn=0.2)
    batch = _batch(s, False)

    def run(seed):
        params = params_mod.params_from_numpy(s["np_params"], "cpu")
        opt = optim.make_optimizer(cfg, steps_per_epoch=10)
        state = step.init_state(params, opt)
        fn = step.make_train_step(cfg.with_(seed=seed), s["spec"],
                                  s["graphs"], opt, "cpu")
        out = []
        for _ in range(2):
            state, aux = fn(state, batch)
            out.append(float(aux["loss"]))
        return out

    a, b, c = run(1), run(1), run(2)
    assert np.isfinite(a).all()
    assert a == b and a != c
