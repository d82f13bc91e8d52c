"""The port's data x model mesh through the step, the optimizer, the eval
and checkpoints, held against the port's one-process run on the CPU.

The ranks are gloo processes on the CPU (``parallel/launch``, one spawn a
world size), running the jobs of ``tests/test_torch_parallel_step.py``'s
worker on the tiny synthetic run of that module (JAX's init, converted).

* Dropout: a 2x1 step at dropout 0.2 gives the one-process step's loss
  (1e-5 relative) and gradients (``GRAD_TOL``): the towers' masks are the
  one-process masks over the global batch (the row map of
  ``ops/dropout.py``), and the GNN's are drawn alike on both data ranks.
  Without the row map (every rank's row i drawing one mask) the loss is not
  the one-process loss: the gate can fail.
* Two steps at dropout 0.2 on 2x2: the data replicas of each model shard
  hold bitwise equal parameters.
* AMSGrad: after one update on 1x2, every moment (gathered) within
  ``GRAD_TOL`` of the one-process optimizer's, and the same step count;
  also with the gradient clip at a global norm the clip acts on.
* Eval on 2x2 with ``batch_size_eval`` 7, which the two data ranks do not
  divide: every example's rank, sampled and full, equals the one-process
  rank; the JAX package's ``to_global``, which keeps b // n_data rows a
  rank, loses examples and fails the same comparison.
* Checkpoints: one taken on 1x2 restores on one process bitwise (params,
  moments, step), and a one-process checkpoint restores into the 1x2
  ranks' shards bitwise.
"""

import numpy as np
import pytest

import test_torch_parallel_step as base

DROP = dict(dropout_gnn=0.2, dropout_attn=0.2)
EVAL = dict(batch_size_eval=7, n_neg_sample=20)
CLIP = dict(apply_grad_clip=True, max_grad_norm=0.5)


def _eval_data():
    from c2dsr_tpu_torch.config import DataSpec
    from c2dsr_tpu_torch.data import preprocess, synthetic
    spec = DataSpec(**base.SPEC)
    seqs = synthetic.generate_sequences(spec, 40, seed=5)
    return preprocess.preprocess_evaluate(seqs, spec, n_neg_sample=20,
                                          seed=5)


def _one_process_step(np_params, batches, cfg_kw):
    """The port's one-process steps: (losses, state)."""
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.train import optim, step
    cfg, spec, graphs, _ = base.setup_port(cfg_kw)
    opt = optim.make_optimizer(cfg, steps_per_epoch=10)
    state = step.init_state(params_mod.params_from_numpy(np_params, "cpu"),
                            opt)
    fn = step.make_train_step(cfg, spec, graphs, opt, "cpu")
    losses = []
    for b in batches:
        state, aux = fn(state, b)
        losses.append(float(aux["loss"]))
    return losses, state


def _grads(state):
    from c2dsr_tpu_torch.model import params as params_mod
    return params_mod.params_to_numpy(
        params_mod._map(lambda t: t.grad, state.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from c2dsr_tpu_torch import checkpoint as ckpt
    from c2dsr_tpu_torch.parallel import launch
    _, np_params = base.jax_params()
    _, _, _, train = base.setup_port({})
    b1 = {k: v[:16] for k, v in train.items()}
    b2 = {k: v[16:32] for k, v in train.items()}
    tmp = tmp_path_factory.mktemp("ckpt")
    _, one = _one_process_step(np_params, [b1], {})
    ckpt.save(str(tmp / "one"), one, meta={"epoch": 1}, block=True)
    jobs2 = [
        ("amsgrad", "job_steps", dict(mesh_shape=(1, 2), cfg_kw={},
                                      np_params=np_params, batches=[b1])),
        ("clip", "job_steps", dict(mesh_shape=(1, 2), cfg_kw=CLIP,
                                   np_params=np_params, batches=[b1])),
        ("ckpt", "job_ckpt", dict(mesh_shape=(1, 2), np_params=np_params,
                                  batch=b1, save_to=str(tmp / "mesh"),
                                  load_from=str(tmp / "one"))),
        ("dropout", "job_steps", dict(mesh_shape=(2, 1), cfg_kw=DROP,
                                      np_params=np_params, batches=[b1])),
        # last: it takes the row map away for the rest of the process
        ("no_row_map", "job_steps", dict(mesh_shape=(2, 1), cfg_kw=DROP,
                                         np_params=np_params, batches=[b1],
                                         no_row_map=True)),
    ]
    jobs4 = [
        ("replicas", "job_steps", dict(mesh_shape=(2, 2), cfg_kw=DROP,
                                       np_params=np_params,
                                       batches=[b1, b2])),
        ("eval", "job_eval", dict(mesh_shape=(2, 2), cfg_kw=EVAL,
                                  np_params=np_params, data=_eval_data())),
    ]
    out = {}
    for world, jobs in ((2, jobs2), (4, jobs4)):
        for r in launch.run_ranks(base.worker, world, (jobs,), timeout=120):
            for name, v in r.items():
                out.setdefault(name, []).append(v)
    return out, np_params, b1, tmp


def test_data_parallel_dropout_draws_the_one_process_masks(runs):
    out, np_params, b1, _ = runs
    losses, state = _one_process_step(np_params, [b1], DROP)
    want = base.flat(_grads(state))
    for r in out["dropout"]:
        np.testing.assert_allclose(r["losses"][0], losses[0], rtol=base.TOL)
        got = base.flat(r["grads"])
        for path, w in want.items():
            base.close(got[path], w, base.GRAD_TOL, path)


def test_without_the_row_map_the_masks_repeat_and_the_gate_fails(runs):
    out, np_params, b1, _ = runs
    losses, _ = _one_process_step(np_params, [b1], DROP)
    got = out["no_row_map"][0]["losses"][0]
    assert abs(got - losses[0]) > 1e-3 * abs(losses[0])


def test_data_replicas_hold_bitwise_equal_parameters(runs):
    out, *_ = runs
    ranks = out["replicas"]
    assert ranks[0]["losses"] == ranks[3]["losses"]
    for a, b in ((0, 2), (1, 3)):            # one model index, two data
        fa, fb = base.flat(ranks[a]["own"]), base.flat(ranks[b]["own"])
        for path in fa:
            np.testing.assert_array_equal(fa[path], fb[path], err_msg=path)
    fa, fb = base.flat(ranks[0]["own"]), base.flat(ranks[1]["own"])
    assert not np.array_equal(fa["embed_share"], fb["embed_share"])


@pytest.mark.parametrize("job", ["amsgrad", "clip"])
def test_amsgrad_state_after_one_update_is_the_one_process_state(runs, job):
    """Also with the global-norm clip (``clip``), whose norm sums each
    sharded gradient's squares over the model group: the clipped moments
    are not the unclipped ones."""
    out, np_params, b1, _ = runs
    _, state = _one_process_step(np_params, [b1],
                                 CLIP if job == "clip" else {})
    want = state.opt_state.adamw.state_dict()["state"]
    if job == "clip":
        assert not np.allclose(out["clip"][0]["adamw"][0]["exp_avg"],
                               out["amsgrad"][0]["adamw"][0]["exp_avg"])
    for r in out[job]:
        got = r["adamw"]
        assert sorted(got) == sorted(want)
        for i in want:
            for k, w in want[i].items():
                w = w.numpy()
                if k == "step":
                    np.testing.assert_array_equal(got[i][k], w)
                else:
                    base.close(got[i][k], w, base.GRAD_TOL, f"{i} {k}")


@pytest.mark.parametrize("mode", ["sampled", "full"])
def test_every_eval_example_keeps_its_one_process_rank(runs, mode):
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import params as params_mod
    out, np_params, _, _ = runs
    cfg, spec, graphs, _ = base.setup_port(EVAL)
    params = params_mod.params_from_numpy(np_params, "cpu")
    convolve, rank_step = ranker.make_eval_fns(cfg, spec, graphs, "cpu")
    data = _eval_data()
    want = ranker.evaluate_split(params, convolve(params), data, rank_step,
                                 cfg, mode)
    # chunks of 7 rows: the two data ranks divide none of them
    assert len(want[0]) == int((data["xory_last"] == 0).sum()) > 7
    for r in out["eval"]:
        assert r[mode] == want
        assert r[mode + "_cut"] != want


def test_a_mesh_checkpoint_resumes_on_one_process_and_back(runs):
    from c2dsr_tpu_torch import checkpoint as ckpt
    from c2dsr_tpu_torch.parallel import mesh as mesh_mod
    out, np_params, b1, tmp = runs
    _, template = _one_process_step(np_params, [], {})
    restored = ckpt.restore(str(tmp / "mesh"), template=template)
    assert restored.step == 1
    r0 = out["ckpt"][0]
    got, want = base.flat(base._np_tree(restored.params)), base.flat(
        r0["params"])
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    for i, st in restored.opt_state.adamw.state_dict()["state"].items():
        for k, v in st.items():
            np.testing.assert_array_equal(v.numpy(), r0["adamw"][i][k])
    # a one-process checkpoint cut into the 1x2 ranks' shards
    _, one = _one_process_step(np_params, [b1], {})
    whole = base.flat(base._np_tree(one.params))
    for r, ranks in enumerate(out["ckpt"]):
        assert ranks["restored_step"] == 1
        own = base.flat(ranks["restored_own"])
        for path, w in whole.items():
            dim = mesh_mod.shard_dim(path.split("/")[0])
            if dim is not None:
                w = np.split(w, 2, axis=dim)[r]
            np.testing.assert_array_equal(own[path], w, err_msg=path)
