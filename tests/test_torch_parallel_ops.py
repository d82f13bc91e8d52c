"""The port's sharded ops (``c2dsr_tpu_torch/parallel/``) held against the
JAX package's (``c2dsr_tpu/parallel/``), op by op, with their gradients.

The same numpy inputs, made from a seed, go through the JAX function on the
conftest's virtual CPU mesh (model axis 4) and through the port's function
in 4 gloo ranks on the CPU (``parallel/launch.run_ranks``, one spawn for
the whole module).  The ranks import torch and the port only: this module
imports JAX inside its tests, never at the top, because each rank imports
it to find its worker.  Gradients are taken against one fixed cotangent.

Tolerances: lookups bitwise; SpMM and CE 1e-5 relative to the largest
value; gradients ``GRAD_TOL`` (1e-4) of the largest; ranks equal.  The
port has one sharded SpMM (the all-to-all plan's) and one sharded CE (the
fused CE on each vocab shard, its plain version on the CPU); each is held
against both of the JAX package's paths: the SpMM against the masked-psum
and the all-to-all SpMM, the CE rows at 1e-5 against the f32 (einsum)
sharded CE at two vocab sizes and at 2e-2 against the Pallas sharded CE in
interpret mode, whose products are bf16 (as ``tests/test_torch_ce.py``
holds the one-device CE), and the CE mean as the step takes it
(``ops/losses.ce_mean_from_rows``) against ``sharded_rec_cross_entropy``.

Two checks show the gates can fail: a lookup whose ``psum`` all-reduces
the gradient (as ``torch.distributed.nn.functional.all_reduce`` does) gives
gradients M times too large, and the GRAD_TOL check refuses them.
"""

import numpy as np
import pytest
import torch

M = 4
D = 16
GRAD_TOL = 1e-4
TOL = 1e-5


# --- the ranks' side (torch and the port only) ---------------------------------

class _PsumAllReduceBwd(torch.autograd.Function):
    """A psum whose backward all-reduces: the fault the port must not have."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group.pg)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group.pg)
        return g, None


def _shard(a, dim, index):
    size = a.shape[dim] // M
    return torch.from_numpy(np.ascontiguousarray(
        np.take(a, np.arange(index * size, (index + 1) * size), axis=dim)))


def _leaf(a):
    return a.clone().requires_grad_(True)


def _np(t):
    return t.detach().numpy()


def _graph(rows, cols, vals, n):
    from c2dsr_tpu_torch.graph.build import CooGraph
    from c2dsr_tpu_torch.ops import spmm
    return spmm.device_graph(CooGraph(rows, cols, vals, n), "cpu")


def _case(g, name, kw):
    from c2dsr_tpu_torch.ops import losses, spmm
    from c2dsr_tpu_torch.parallel import comm, embed, sharded_eval
    from c2dsr_tpu_torch.parallel import sharded_loss
    i = g.index
    if name in ("lookup", "lookup_wrong"):
        t = _leaf(_shard(kw["table"], 0, i))
        ids = torch.from_numpy(kw["ids"]).long()
        saved = comm.psum
        if name == "lookup_wrong":
            comm.psum = lambda x, grp: _PsumAllReduceBwd.apply(x, grp)
        try:
            rows = embed.sharded_lookup(t, ids, g)
        finally:
            comm.psum = saved
        (rows * torch.from_numpy(kw["cot"])).sum().backward()
        return {"out": _np(rows), "grad": _np(t.grad)}
    if name in ("a2a", "a2a_overflow"):
        t = _leaf(_shard(kw["table"], 0, i))
        n = kw["ids"].shape[0] // M
        ids = torch.from_numpy(kw["ids"][i * n:(i + 1) * n]).long()
        rows = embed.all_to_all_lookup(t, ids, g, kw["capacity"])
        (rows * torch.from_numpy(kw["cot"][i * n:(i + 1) * n])).sum().backward()
        return {"out": _np(rows), "grad": _np(t.grad)}
    if name == "a2a_replicated":
        t = _leaf(_shard(kw["table"], 0, i))
        rows = embed.a2a_lookup_replicated(
            t, torch.from_numpy(kw["ids"]).long(), g)
        (rows * torch.from_numpy(kw["cot"])).sum().backward()
        return {"out": _np(rows), "grad": _np(t.grad)}
    if name.startswith("spmm"):
        graph = _graph(kw["rows"], kw["cols"], kw["vals"], kw["n"])
        t = _leaf(_shard(kw["table"], 0, i))
        graph = spmm.attach_a2a_plan(graph, kw["n"], M, i)
        out = embed.sharded_spmm_a2a(graph.a2a, t, g)
        (out * _shard(kw["cot"], 0, i)).sum().backward()
        return {"out": _np(out), "grad": _np(t.grad)}
    if name in ("ce_xla", "ce_kernel"):
        h, pad = _leaf(torch.from_numpy(kw["h"])), _leaf(
            torch.from_numpy(kw["pad"]))
        w, b = _leaf(_shard(kw["w"], 1, i)), _leaf(_shard(kw["b"], 0, i))
        rows = sharded_loss.sharded_rec_ce_rows_kernel(
            h, w, b, pad, torch.from_numpy(kw["tgt"]).long(), kw["n_real"],
            g)
        (rows * torch.from_numpy(kw["cot"])).sum().backward()
        return {"out": _np(rows), "h": _np(h.grad), "pad": _np(pad.grad),
                "w": _np(w.grad), "b": _np(b.grad)}
    if name == "ce_mean":
        h = _leaf(torch.from_numpy(kw["h"]))
        w = _leaf(_shard(kw["w"], 1, i))
        tgt = torch.from_numpy(kw["tgt"]).long()
        rows = sharded_loss.sharded_rec_ce_rows_kernel(
            h, w, _shard(kw["b"], 0, i), torch.from_numpy(kw["pad"]), tgt,
            kw["n_real"], g)
        mean, n_valid = losses.ce_mean_from_rows(rows, tgt, kw["n_real"])
        mean.backward()
        return {"out": _np(mean), "n": _np(n_valid), "w": _np(w.grad),
                "h": _np(h.grad)}
    h = torch.from_numpy(kw["h"])
    w, b = _shard(kw["w"], 1, i), _shard(kw["b"], 0, i)
    if name == "full_rank":
        return {"out": _np(sharded_eval.sharded_full_rank(
            h, w, b, torch.from_numpy(kw["gt"]).long(), kw["n_real"], g))}
    if name == "gather_scores":
        return {"out": _np(sharded_eval.sharded_gather_scores(
            h, w, b, torch.from_numpy(kw["ids"]).long(), g))}
    raise ValueError(name)


def _worker(rank, world, cases):
    from c2dsr_tpu_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.make_mesh(1, world)
    return {name: _case(mesh.model_group, name, kw) for name, kw in cases}


# --- the inputs --------------------------------------------------------------------

def _rng(seed):
    return np.random.default_rng(seed)


def _coo(n, nnz, seed, skewed=False):
    rng = _rng(seed)
    if skewed:       # every edge into dest shard 0, from source shard 3
        rows = np.sort(rng.integers(0, n // M, nnz)).astype(np.int32)
        cols = rng.integers(3 * n // M, n, nnz).astype(np.int32)
    else:
        rows = np.sort(rng.integers(0, n, nnz)).astype(np.int32)
        cols = rng.integers(0, n, nnz).astype(np.int32)
    return rows, cols, rng.normal(size=nnz).astype(np.float32)


def _ce_inputs(V_p, n_real, seed, B=8, R=4, scale=1.0):
    rng = _rng(seed)
    tgt = rng.integers(0, n_real + 1, size=(B, R)).astype(np.int32)
    tgt[0, :2] = n_real
    return dict(h=rng.normal(size=(B, R, D)).astype(np.float32),
                w=(rng.normal(size=(D, V_p)) * scale).astype(np.float32),
                b=(rng.normal(size=V_p) * scale).astype(np.float32),
                pad=rng.normal(size=(B, R, 1)).astype(np.float32),
                tgt=tgt, n_real=n_real,
                cot=rng.normal(size=(B, R)).astype(np.float32))


def _inputs():
    cases = {}
    rng = _rng(0)
    table = rng.normal(size=(64, D)).astype(np.float32)
    ids = rng.integers(0, 64, size=40)
    ids = np.concatenate([ids, ids[:10]])              # duplicates add up
    cot = rng.normal(size=(50, D)).astype(np.float32)
    cases["lookup"] = dict(table=table, ids=ids, cot=cot)
    cases["lookup_wrong"] = cases["lookup"]
    ids = _rng(2).integers(0, 64, size=64)
    cases["a2a"] = dict(table=table, ids=ids, capacity=2.0,
                        cot=_rng(3).normal(size=(64, D)).astype(np.float32))
    cases["a2a_overflow"] = dict(table=table, ids=np.full(32, 3),
                                 capacity=0.25,
                                 cot=_rng(4).normal(size=(32, D)).astype(
                                     np.float32))
    cases["a2a_replicated"] = dict(
        table=table, ids=_rng(5).integers(0, 64, size=(6, 8)),
        cot=_rng(6).normal(size=(6, 8, D)).astype(np.float32))
    for name, seed, skew in (("spmm", 12, False), ("spmm_a2a", 13, False),
                             ("spmm_a2a_skewed", 14, True)):
        rows, cols, vals = _coo(64, 200, seed, skew)
        cases[name] = dict(rows=rows, cols=cols, vals=vals, n=64,
                           table=_rng(seed + 100).normal(size=(64, D)).astype(
                               np.float32),
                           cot=_rng(seed + 200).normal(size=(64, D)).astype(
                               np.float32))
    cases["ce_xla"] = _ce_inputs(32, 29, 4)
    cases["ce_kernel"] = _ce_inputs(1024, 1000, 8, scale=0.1)
    cases["ce_mean"] = _ce_inputs(32, 29, 5)
    rng = _rng(6)
    ev = dict(h=rng.normal(size=(16, D)).astype(np.float32),
              w=rng.normal(size=(D, 32)).astype(np.float32),
              b=rng.normal(size=32).astype(np.float32), n_real=30)
    cases["full_rank"] = dict(ev, gt=rng.integers(0, 30, size=16))
    cases["gather_scores"] = dict(ev, ids=rng.integers(0, 30, size=(16, 9)))
    return cases


@pytest.fixture(scope="module")
def run():
    from c2dsr_tpu_torch.parallel import launch
    cases = _inputs()
    out = launch.run_ranks(_worker, M, (list(cases.items()),), timeout=120)
    return cases, out


# --- the JAX side -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jmesh():
    import jax
    from c2dsr_tpu.parallel import mesh as jmesh_mod
    return jmesh_mod.make_mesh(1, M, jax.devices()[:M])


def _put(mesh, a, *spec):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(*spec)))


def _vjp(fn, args, cot):
    import jax

    def both(args, cot):
        out, pull = jax.vjp(fn, *args)
        return out, pull(cot)

    out, grads = jax.jit(both)(list(args), cot)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _cat(out, name, key, axis=0):
    return np.concatenate([r[name][key] for r in out], axis=axis)


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# --- the tests ----------------------------------------------------------------------

def test_sharded_lookup_is_the_jax_lookup_bitwise(run, jmesh):
    from c2dsr_tpu.parallel import embed as jembed
    cases, out = run
    kw = cases["lookup"]
    want, (gt,) = _vjp(lambda t: jembed.sharded_lookup(t, kw["ids"], jmesh),
                       [_put(jmesh, kw["table"], "model", None)], kw["cot"])
    for r in out:
        np.testing.assert_array_equal(r["lookup"]["out"], want)
    _close(_cat(out, "lookup", "grad"), gt, GRAD_TOL)


def test_a_psum_that_all_reduces_its_gradient_fails_the_gate(run):
    """The fault of torch.distributed.nn.functional.all_reduce: every
    sharded gradient M times too large, which GRAD_TOL refuses."""
    cases, out = run
    good, bad = _cat(out, "lookup", "grad"), _cat(out, "lookup_wrong", "grad")
    np.testing.assert_allclose(bad, M * good, rtol=1e-6, atol=1e-6)
    with pytest.raises(AssertionError):
        _close(bad, good, GRAD_TOL)


@pytest.mark.parametrize("name", ["a2a", "a2a_overflow"])
def test_all_to_all_lookup_is_the_jax_exchange(run, jmesh, name):
    """Each rank's own ids; the overflow case sends every id to one owner
    at capacity 0.25, so all but a few take the exact psum fallback."""
    from c2dsr_tpu.parallel import embed as jembed
    cases, out = run
    kw = cases[name]
    want, (gt,) = _vjp(
        lambda t, i=_put(jmesh, kw["ids"].astype(np.int32), "model"):
        jembed.all_to_all_lookup(t, i, jmesh,
                                 capacity_factor=kw["capacity"]),
        [_put(jmesh, kw["table"], "model", None)], kw["cot"])
    np.testing.assert_array_equal(_cat(out, name, "out"), want)
    np.testing.assert_array_equal(want, kw["table"][kw["ids"]])
    _close(_cat(out, name, "grad"), gt, GRAD_TOL)


def test_a2a_lookup_replicated_is_the_jax_lookup(run, jmesh):
    from jax.sharding import PartitionSpec as P
    from c2dsr_tpu.parallel import embed as jembed
    cases, out = run
    kw = cases["a2a_replicated"]
    want, (gt,) = _vjp(
        lambda t: jembed.a2a_lookup_replicated(
            t, kw["ids"].astype(np.int32), jmesh, batch_spec=P()),
        [_put(jmesh, kw["table"], "model", None)], kw["cot"])
    for r in out:
        np.testing.assert_array_equal(r["a2a_replicated"]["out"], want)
    _close(_cat(out, "a2a_replicated", "grad"), gt, GRAD_TOL)


@pytest.mark.parametrize("name", ["spmm", "spmm_a2a", "spmm_a2a_skewed"])
def test_sharded_spmm_is_the_jax_spmm(run, jmesh, name):
    """The port's all-to-all SpMM against the JAX package's masked-psum
    SpMM ("spmm") and its all-to-all SpMM (the others)."""
    import jax.numpy as jnp
    from c2dsr_tpu.parallel import embed as jembed
    cases, out = run
    kw = cases[name]
    table = _put(jmesh, kw["table"], "model", None)
    if name == "spmm":
        def fn(t):
            return jembed.sharded_spmm(jnp.asarray(kw["rows"]),
                                       jnp.asarray(kw["cols"]),
                                       jnp.asarray(kw["vals"]), t, jmesh)
    else:
        plan = jembed.plan_spmm_a2a(kw["rows"], kw["cols"], kw["vals"],
                                    kw["n"], M)

        def fn(t):
            return jembed.sharded_spmm_a2a(plan, t, jmesh)
    want, (gt,) = _vjp(fn, [table], kw["cot"])
    _close(_cat(out, name, "out"), want, TOL)
    _close(_cat(out, name, "grad"), gt, GRAD_TOL)


def _jax_ce(kw, jmesh, pallas=False):
    from c2dsr_tpu.parallel import sharded_loss as jloss
    w = _put(jmesh, kw["w"], None, "model")
    b = _put(jmesh, kw["b"], "model")

    def fn(h, w_, b_, pad):
        if pallas:
            return jloss.sharded_rec_ce_rows_pallas(
                h, w_, b_, pad, kw["tgt"], kw["n_real"], jmesh,
                interpret=True)
        return jloss.sharded_rec_ce_rows(h, w_, b_, pad, kw["tgt"],
                                         kw["n_real"], jmesh)
    return _vjp(fn, [kw["h"], w, b, kw["pad"]], kw["cot"])


@pytest.mark.parametrize("name", ["ce_xla", "ce_kernel"])
def test_sharded_ce_rows_are_the_jax_rows(run, jmesh, name):
    """The port's fused-CE rows against the JAX package's f32 sharded rows,
    at V 32 (ce_xla: n_real 29, the last shard part padding) and V 1024."""
    cases, out = run
    kw = cases[name]
    want, (gh, gw, gb, gp) = _jax_ce(kw, jmesh)
    for r in out:
        _close(r[name]["out"], want, TOL)
        _close(r[name]["h"], gh, GRAD_TOL)
        _close(r[name]["pad"], gp, GRAD_TOL)
    _close(_cat(out, name, "w", axis=1), gw, GRAD_TOL)
    _close(_cat(out, name, "b"), gb, GRAD_TOL)


def test_sharded_ce_kernel_path_is_the_jax_pallas_path(run, jmesh):
    """Against the Pallas CE on each vocab shard (interpret mode, bf16
    products): 2e-2 relative."""
    cases, out = run
    kw = cases["ce_kernel"]
    want, grads = _jax_ce(kw, jmesh, pallas=True)
    _close(out[0]["ce_kernel"]["out"], want, 2e-2)
    _close(out[0]["ce_kernel"]["h"], grads[0], 2e-2)
    _close(_cat(out, "ce_kernel", "w", axis=1), grads[1], 2e-2)


def test_sharded_cross_entropy_is_the_jax_mean(run, jmesh):
    import jax
    from c2dsr_tpu.parallel import sharded_loss as jloss
    cases, out = run
    kw = cases["ce_mean"]
    b = _put(jmesh, kw["b"], "model")

    def fn(h, w):
        return jloss.sharded_rec_cross_entropy(
            h, w, b, kw["pad"], kw["tgt"], kw["n_real"], jmesh)[0]
    w = _put(jmesh, kw["w"], None, "model")
    mean, n_valid = jax.jit(lambda h, w_: jloss.sharded_rec_cross_entropy(
        h, w_, b, kw["pad"], kw["tgt"], kw["n_real"], jmesh))(kw["h"], w)
    gh, gw = jax.jit(jax.grad(fn, argnums=(0, 1)))(kw["h"], w)
    for r in out:
        _close(r["ce_mean"]["out"], np.asarray(mean), TOL)
        assert float(r["ce_mean"]["n"]) == float(n_valid)
        _close(r["ce_mean"]["h"], np.asarray(gh), GRAD_TOL)
    _close(_cat(out, "ce_mean", "w", axis=1), np.asarray(gw), GRAD_TOL)


@pytest.mark.parametrize("name", ["full_rank", "gather_scores"])
def test_sharded_ranking_is_the_jax_ranking(run, jmesh, name):
    from c2dsr_tpu.parallel import sharded_eval as jeval
    cases, out = run
    kw = cases[name]
    w = _put(jmesh, kw["w"], None, "model")
    b = _put(jmesh, kw["b"], "model")
    if name == "full_rank":
        want = np.asarray(jeval.sharded_full_rank(
            kw["h"], w, b, kw["gt"].astype(np.int32), kw["n_real"], jmesh))
        for r in out:
            np.testing.assert_array_equal(r[name]["out"], want)
    else:
        want = np.asarray(jeval.sharded_gather_scores(
            kw["h"], w, b, kw["ids"].astype(np.int32), jmesh))
        for r in out:
            _close(r[name]["out"], want, TOL)
