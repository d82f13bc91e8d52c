"""The port's sharded training step held against the JAX package's sharded
``loss_fn`` and against the port's one-process step.

One ``loss_fn`` and backward at dropout 0, with every gradient, on a 1x2
and a 2x2 mesh (psum lookups) and a 2x2 mesh with the a2a lookups, as
``tests/test_parallel.py:281-327`` holds the JAX sharded step against its
local one.  The same numpy inputs (JAX's init, a synthetic split from a
seed) go through the JAX ``loss_fn`` on the conftest's virtual CPU mesh
and through the port in gloo ranks on the CPU (``parallel/launch``; one
spawn a world size).  The ranks sum their gradients over the data group
(``train/step.sum_grads``) and gather the sharded ones over the model group;
the parent compares: the loss parts within 1e-5 relative, every gradient
within ``GRAD_TOL`` (1e-4) of its largest value.

The ranks import torch and the port only (this module imports JAX inside
its tests); ``tests/test_torch_parallel_train.py`` runs its jobs through
the same worker.
"""

import numpy as np
import pytest

SPEC = dict(n_item_a=150, n_item_b=200, len_max=15)
CFG = dict(data="fk", d_latent=32, len_rec=5, vocab_pad_multiple=128,
           dropout_gnn=0.0, dropout_attn=0.0)
N_USERS, SEED = 120, 11
GRAD_TOL = 1e-4
TOL = 1e-5


# --- the ranks' side (torch and the port only) ---------------------------------

def setup_port(cfg_kw, device="cpu"):
    """(cfg, spec, graphs, train split) of the tiny synthetic run."""
    from c2dsr_tpu_torch.config import Config, DataSpec
    from c2dsr_tpu_torch.data import preprocess, synthetic
    from c2dsr_tpu_torch.graph import build
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.ops import spmm
    spec = DataSpec(**SPEC)
    seqs = synthetic.generate_sequences(spec, N_USERS, seed=SEED)
    train = preprocess.preprocess_train(seqs, spec, seed=SEED)
    share, specific = build.build_graphs(seqs, spec)
    graphs = c2dsr.Graphs(spmm.device_graph(share, device),
                          spmm.device_graph(specific, device))
    return Config(**{**CFG, **cfg_kw}), spec, graphs, train


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _sharded_run(mesh_shape, cfg_kw, np_params):
    """(mesh, cfg, spec, graphs, train, state, optimizer, pops) of one rank:
    the full params cut to its shards, the graphs with its a2a plans."""
    from c2dsr_tpu_torch.config import padded_sizes
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import spmm
    from c2dsr_tpu_torch.parallel import mesh as mesh_mod, strategy
    from c2dsr_tpu_torch.train import optim, step
    n_data, n_model = mesh_shape
    mesh = mesh_mod.make_mesh(n_data, n_model)
    cfg, spec, graphs, train = setup_port(
        dict(cfg_kw, mesh_data=n_data, mesh_model=n_model))
    if n_model > 1:
        n_p = padded_sizes(cfg, spec)[0]
        graphs = c2dsr.Graphs(*(spmm.attach_a2a_plan(g, n_p, n_model,
                                                     mesh.model_index)
                                for g in graphs))
    params = mesh_mod.shard_params(
        params_mod.params_from_numpy(np_params, "cpu"), mesh)
    opt = optim.make_optimizer(cfg, steps_per_epoch=10)
    state = step.init_state(params, opt, mesh)
    return (mesh, cfg, spec, graphs, train, state, opt,
            strategy.make_ops(cfg, mesh))


def _whole_grads(state, mesh):
    """Every gradient whole, on every rank: summed over the data group and
    gathered over the model group, as a params-shaped tree of numpy."""
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.parallel import mesh as mesh_mod
    from c2dsr_tpu_torch.train import step
    step.sum_grads(state.opt_state.leaves, mesh.data_group)
    grads = params_mod._map(lambda t: t.grad, state.params)
    return params_mod.params_to_numpy(mesh_mod.unshard_params(grads, mesh))


def job_loss_grads(mesh_shape, cfg_kw, np_params, batch):
    """One loss_fn and backward at dropout 0 on this rank's rows of
    ``batch``: the global loss parts and every whole gradient."""
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.parallel import comm, mesh as mesh_mod
    from c2dsr_tpu_torch.train import step
    mesh, cfg, spec, graphs, _, state, _, pops = _sharded_run(
        mesh_shape, cfg_kw, np_params)
    b = ranker.to_device(mesh_mod.local_batch(batch, mesh), "cpu")
    loss, aux = step.loss_fn(state.params, graphs, b, None, cfg, spec, pops)
    loss.backward()
    out = {k: float(comm.sum_(aux[k].detach(), mesh.data_group))
           for k in ("loss", "loss_rec", "loss_mi")}
    out["n_examples"] = float(aux["n_examples"])
    out["grads"] = _whole_grads(state, mesh)
    return out


def job_steps(mesh_shape, cfg_kw, np_params, batches, no_row_map=False):
    """train_step over ``batches`` (global): the losses, this rank's own
    parameter shards after the last step, and the whole params and AdamW
    state.  ``no_row_map`` takes the towers' dropout back to the index
    within the rank's own call (the fault the row map repairs)."""
    from c2dsr_tpu_torch.parallel import mesh as mesh_mod, strategy
    from c2dsr_tpu_torch.train import step
    if no_row_map:
        strategy.LocalOps.dropout_rows = lambda self, rows: None
    mesh, cfg, spec, graphs, _, state, opt, _ = _sharded_run(
        mesh_shape, cfg_kw, np_params)
    fn = step.make_train_step(cfg, spec, graphs, opt, "cpu", mesh=mesh)
    losses = []
    for batch in batches:
        state, aux = fn(state, mesh_mod.local_batch(batch, mesh))
        losses.append(float(aux["loss"]))
    out = _whole_state(state, mesh)
    out["losses"] = losses
    out["own"] = _np_tree(state.params)
    return out


def _whole_state(state, mesh):
    """The whole params, gradients (as the step left them: summed over the
    data group) and AdamW moments, gathered over the model group."""
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.parallel import mesh as mesh_mod
    names = mesh_mod.leaf_names(state.params)
    adamw = mesh_mod.unshard_adamw(state.opt_state.adamw.state_dict(), names,
                                   mesh)
    grads = params_mod._map(lambda t: t.grad, state.params)
    return {"params": _np_tree(mesh_mod.unshard_params(state.params, mesh)),
            "grads": params_mod.params_to_numpy(
                mesh_mod.unshard_params(grads, mesh)),
            "adamw": {i: {k: v.numpy() for k, v in st.items()}
                      for i, st in adamw["state"].items()}}


def job_eval(mesh_shape, cfg_kw, np_params, data):
    """The ranks of every example of ``data``, sampled and full, through
    ``evaluate_split`` with ``mesh.eval_slice``; and (``*_cut``) with the
    JAX package's ``to_global``, which keeps b // n_data rows a rank."""
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.parallel import mesh as mesh_mod
    mesh, cfg, spec, graphs, _, state, _, _ = _sharded_run(
        mesh_shape, cfg_kw, np_params)
    convolve, rank_step = ranker.make_eval_fns(cfg, spec, graphs, "cpu",
                                               mesh=mesh)
    hi = convolve(state.params)

    def cut(chunk):
        m = chunk["seq_share"].shape[0] // mesh.n_data
        lo = mesh.data_index * m
        return {k: v[lo:lo + m] for k, v in chunk.items()}

    out = {}
    for mode in ("sampled", "full"):
        out[mode] = ranker.evaluate_split(
            state.params, hi, data, rank_step, cfg, mode,
            to_global=lambda c: mesh_mod.eval_slice(c, mesh))
        out[mode + "_cut"] = ranker.evaluate_split(
            state.params, hi, data, rank_step, cfg, mode, to_global=cut)
    return out


def job_ckpt(mesh_shape, np_params, batch, save_to, load_from):
    """One step at dropout 0, a checkpoint of it under ``save_to`` (rank 0
    writes) and its whole state; then a one-process checkpoint under
    ``load_from`` restored into this rank's shards."""
    from c2dsr_tpu_torch import checkpoint as ckpt
    from c2dsr_tpu_torch.parallel import mesh as mesh_mod
    from c2dsr_tpu_torch.train import step
    mesh, cfg, spec, graphs, _, state, opt, _ = _sharded_run(
        mesh_shape, {}, np_params)
    fn = step.make_train_step(cfg, spec, graphs, opt, "cpu", mesh=mesh)
    state, _ = fn(state, mesh_mod.local_batch(batch, mesh))
    ckpt.save(save_to, state, meta={"epoch": 1}, block=True, mesh=mesh)
    out = _whole_state(state, mesh)
    state = ckpt.restore(load_from, template=state, mesh=mesh)
    out["restored_step"] = state.step
    out["restored_own"] = _np_tree(state.params)
    out["restored_adamw"] = {
        i: {k: v.numpy() for k, v in st.items()}
        for i, st in state.opt_state.adamw.state_dict()["state"].items()}
    return out


def job_init_sharded(mesh_shape, kw):
    """``init_params_sharded`` on this rank against the full draw cut
    (``tests/test_torch_parallel_ops._init_sharded``)."""
    import test_torch_parallel_ops as ops_test
    from c2dsr_tpu_torch.parallel import mesh as mesh_mod
    return ops_test._init_sharded(mesh_mod.make_mesh(*mesh_shape), kw)


def worker(rank, world, jobs):
    """Run each (name, job function name, kwargs) in order; {name: result}."""
    import sys
    mod = sys.modules[__name__]
    return {name: getattr(mod, fn)(**kw) for name, fn, kw in jobs}


# --- the parent's side ------------------------------------------------------------

def jax_params():
    import jax
    from c2dsr_tpu.config import Config as JConfig, DataSpec as JSpec
    from c2dsr_tpu.model import params as jparams
    jp = jparams.init_params(jax.random.PRNGKey(0), JConfig(**CFG),
                             JSpec(**SPEC))
    return jp, jax.tree.map(np.asarray, jp)


def local_loss_grads(np_params, batch, cfg_kw=None):
    """The port's one-process loss_fn (LocalOps) at dropout 0."""
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.train import step
    cfg, spec, graphs, _ = setup_port(cfg_kw or {})
    params = params_mod.params_from_numpy(np_params, "cpu")
    for t in step.param_leaves(params):
        t.requires_grad_(True)
    loss, aux = step.loss_fn(params, graphs, ranker.to_device(batch, "cpu"),
                             None, cfg, spec)
    loss.backward()
    out = {k: float(aux[k].detach()) for k in ("loss", "loss_rec",
                                               "loss_mi", "n_examples")}
    out["grads"] = params_mod.params_to_numpy(
        params_mod._map(lambda t: t.grad, params))
    return out


def close(got, want, tol, msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=msg)


def flat(tree, prefix=""):
    """{path: array} of a tree of dicts and lists (JAX's layer lists)."""
    if isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): np.asarray(tree)}


INIT_KW = dict(cfg=dict(d_latent=36, shared_item_embed=False, d_bias=True,
                       vocab_pad_multiple=128),
               spec=dict(n_item_a=150, n_item_b=300, len_max=15), seed=6)
MESHES = {"1x2": ((1, 2), {}), "2x2": ((2, 2), {}),
          "2x2_a2a": ((2, 2), {"lookup_mode": "a2a"})}


def global_batch():
    _, _, _, train = setup_port({})
    return {k: v[:16] for k, v in train.items()}


@pytest.fixture(scope="module")
def runs():
    from c2dsr_tpu_torch.parallel import launch
    _, np_params = jax_params()
    batch = global_batch()
    out = {}
    for world in (2, 4):
        jobs = [(name, "job_loss_grads",
                 dict(mesh_shape=shape, cfg_kw=kw, np_params=np_params,
                      batch=batch))
                for name, (shape, kw) in MESHES.items()
                if shape[0] * shape[1] == world]
        if world == 2:
            jobs.append(("init_1x2", "job_init_sharded",
                         dict(mesh_shape=(1, 2), kw=INIT_KW)))
        res = launch.run_ranks(worker, world, (jobs,), timeout=120)
        for r in res:
            for name, v in r.items():
                out.setdefault(name, []).append(v)
    return out, batch, np_params


def _jax_loss_grads(mesh_shape, cfg_kw, batch):
    import jax
    import jax.numpy as jnp
    from c2dsr_tpu.config import Config as JConfig, DataSpec as JSpec
    from c2dsr_tpu.config import padded_sizes
    from c2dsr_tpu.data import synthetic
    from c2dsr_tpu.graph import build
    from c2dsr_tpu.model import c2dsr
    from c2dsr_tpu.ops import spmm
    from c2dsr_tpu.parallel import mesh as mesh_mod, strategy
    from c2dsr_tpu.train import step as step_mod
    n_data, n_model = mesh_shape
    jp, _ = jax_params()
    spec = JSpec(**SPEC)
    cfg = JConfig(**CFG, **cfg_kw, mesh_data=n_data, mesh_model=n_model)
    mesh = mesh_mod.make_mesh(n_data, n_model,
                              jax.devices()[:n_data * n_model])
    seqs = synthetic.generate_sequences(spec, N_USERS, seed=SEED)
    gs, gp = build.build_graphs(seqs, spec)
    n_p = padded_sizes(cfg, spec)[0]
    graphs = c2dsr.Graphs(
        share=spmm.attach_a2a_plan(spmm.device_graph(gs), n_p, n_model),
        specific=spmm.attach_a2a_plan(spmm.device_graph(gp), n_p, n_model))
    pops = strategy.make_ops(cfg, mesh)
    params = jax.device_put(jp, mesh_mod.params_shardings(jp, mesh))
    b = {k: jax.device_put(jnp.asarray(v), mesh_mod.batch_sharding(mesh))
         for k, v in batch.items()}
    (_, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, bb: step_mod.loss_fn(p, graphs, bb, jax.random.PRNGKey(5),
                                       cfg, spec, pops), has_aux=True))(
        params, b)
    return ({k: float(aux[k]) for k in ("loss", "loss_rec", "loss_mi",
                                        "n_examples")},
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_loss_and_grads_match_jax_sharded_loss_fn(runs, name):
    out, batch, _ = runs
    shape, kw = MESHES[name]
    want, jgrads = _jax_loss_grads(shape, kw, batch)
    for r in out[name]:
        for k in ("loss", "loss_rec", "loss_mi", "n_examples"):
            np.testing.assert_allclose(r[k], want[k], rtol=TOL, err_msg=k)
        got = flat(r["grads"])
        for path, w in flat(jgrads).items():
            close(got[path], w, GRAD_TOL, f"{name} {path}")


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_loss_and_grads_match_the_local_step(runs, name):
    out, batch, np_params = runs
    want = local_loss_grads(np_params, batch)
    wgrads = flat(want["grads"])
    for r in out[name]:
        for k in ("loss", "loss_rec", "loss_mi", "n_examples"):
            np.testing.assert_allclose(r[k], want[k], rtol=TOL, err_msg=k)
        got = flat(r["grads"])
        assert set(got) == set(wgrads)
        for path, w in wgrads.items():
            close(got[path], w, GRAD_TOL, f"{name} {path}")


def test_shard_local_init_at_1x2_is_the_full_draw_cut(runs):
    """init_params_sharded on the two ranks of a 1x2 mesh, checked as
    tests/test_torch_parallel_ops.py checks its 1x4 mesh."""
    import test_torch_parallel_ops as ops_test
    out, _, _ = runs
    ops_test.check_init_sharded(out["init_1x2"], INIT_KW, 2)
