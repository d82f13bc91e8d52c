"""The port's training loss with batch-sparse propagation
(``batch_sparse_gnn=True``): the last hop of each propagation runs only for
the rows the step reads, flagged from the batch's lookup ids.

* Against the port's dense ``loss_fn``: the same loss within 1e-6 relative
  and every gradient within 1e-5 of its largest value (the flagged rows sum
  the same edges in the same order; the masked backward drops edges that
  add zeros, so only sums over rows differ in order).
* Against the JAX package's XLA ``loss_fn`` with the same params: within
  the tolerances of ``tests/test_torch_train.py`` (loss 1e-5 relative,
  gradients 1e-4 of each leaf's largest value).  The XLA path ignores the
  flag; ``tests/test_train.py`` shows the JAX flagged step equals its dense
  step.
* The row flags mark exactly the looked-up ids, the pad id among them.
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
from c2dsr_tpu.train import step as jstep
from c2dsr_tpu_torch.config import Config, DataSpec
from c2dsr_tpu_torch.data import preprocess, synthetic
from c2dsr_tpu_torch.evaluate import ranker
from c2dsr_tpu_torch.graph import build
from c2dsr_tpu_torch.model import c2dsr
from c2dsr_tpu_torch.model import params as params_mod
from c2dsr_tpu_torch.ops import spmm
from c2dsr_tpu_torch.train import step

SPEC = dict(n_item_a=50, n_item_b=70, len_max=15)
CFG = dict(d_latent=32, batch_size=16, len_rec=5, dropout_gnn=0.0,
           dropout_attn=0.0, vocab_pad_multiple=64)


@pytest.fixture(scope="module")
def setup():
    spec = DataSpec(**SPEC)
    seqs = synthetic.generate_sequences(spec, 300, seed=4)
    train = preprocess.preprocess_train(seqs, spec, seed=1)
    share, specific = build.build_graphs(seqs, spec)
    jcfg = JConfig(**CFG)
    jp = jparams.init_params(jax.random.PRNGKey(2), jcfg, JSpec(**SPEC))
    return dict(
        spec=spec, train=train, jcfg=jcfg, jp=jp,
        np_params=jax.tree.map(np.asarray, jp),
        batch={k: v[:16] for k, v in train.items()},
        graphs=c2dsr.Graphs(spmm.device_graph(share, "cpu"),
                            spmm.device_graph(specific, "cpu")),
        jgraphs=jc2dsr.Graphs(jspmm.device_graph(share, blocked=False),
                              jspmm.device_graph(specific, blocked=False)))


def _port_grads(s, cfg):
    params = params_mod.params_from_numpy(s["np_params"], "cpu")
    for t in step.param_leaves(params):
        t.requires_grad_(True)
    loss, aux = step.loss_fn(params, s["graphs"],
                             ranker.to_device(s["batch"], "cpu"), None, cfg,
                             s["spec"])
    loss.backward()
    return aux, params


def test_sparse_loss_fn_equals_dense(setup):
    s = setup
    aux_d, p_d = _port_grads(s, Config(**CFG))
    aux_s, p_s = _port_grads(s, Config(**CFG, batch_sparse_gnn=True))
    for k in ("loss", "loss_rec", "loss_mi"):
        np.testing.assert_allclose(float(aux_s[k].detach()),
                                   float(aux_d[k].detach()), rtol=1e-6,
                                   err_msg=k)
    for a, b in zip(step.param_leaves(p_s), step.param_leaves(p_d)):
        a, b = a.grad, b.grad
        scale = max(float(b.abs().max()), 1e-30)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


def test_sparse_loss_fn_matches_jax(setup):
    s = setup
    jbatch = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    jcfg = s["jcfg"].with_(batch_sparse_gnn=True)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.loss_fn(p, s["jgraphs"], b, jax.random.PRNGKey(1),
                                   jcfg, JSpec(**SPEC)),
        has_aux=True))(s["jp"], jbatch)
    aux, params = _port_grads(s, Config(**CFG, batch_sparse_gnn=True))
    for k in ("loss", "loss_rec", "loss_mi"):
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    grads = params_mod.params_to_numpy(params_mod._map(lambda t: t.grad,
                                                       params))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                                 jax.tree.leaves(grads)):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_row_flags_mark_the_looked_up_ids(setup):
    s = setup
    b = ranker.to_device(s["batch"], "cpu")
    seq3 = torch.cat([b["seq_share"], b["seq_share_neg_a"],
                      b["seq_share_neg_b"]])
    f_share, f_ab = step.row_flags(seq3, b["seq_share_a"], b["seq_share_b"],
                                   200)
    assert f_share.dtype == torch.uint8 and f_share.shape == (200,)
    want = np.zeros(200, np.uint8)
    want[np.unique(seq3.numpy())] = 1
    np.testing.assert_array_equal(f_share.numpy(), want)
    want = np.zeros(200, np.uint8)
    want[np.unique(np.concatenate([s["batch"]["seq_share_a"].ravel(),
                                   s["batch"]["seq_share_b"].ravel()]))] = 1
    np.testing.assert_array_equal(f_ab.numpy(), want)
    assert f_share[s["spec"].idx_pad] == 1 and f_ab[s["spec"].idx_pad] == 1
