"""The port's bf16 path (``compute_dtype="bfloat16"``, ``classifier_dtype=
"bfloat16"``) held against the JAX package's Pallas numerics on the CPU.

The JAX package's Pallas kernels round both operands of every product to
bf16 and sum in f32; the port's plain versions do the same
(``c2dsr_tpu_torch/ops/bf16.py``), and its kernels' bf16 instantiations on
the card are held against those plain versions (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase bf16).  Each JAX function runs as its own tests run
it: the Pallas kernels in interpret mode, ``encoder_pallas.st_interpret``
set for the tower and reset in a ``finally``.

Each tolerance is set between two readings taken on these inputs: the
bf16 path's (which must pass) and the same comparison with the port at
``compute_dtype="float32"`` (which must fail, so that each test tells the
bf16 path from the f32 one).  Where both sides round an f32 value to bf16,
a value that the two sums (taken in different orders) put on either side
of a rounding boundary goes to different bf16 neighbours, 2^-8 apart; in
the tower that moves its row through the layers after it, so the tower is
measured by relative Frobenius norm, the rest by max |port - JAX| over
max |JAX| per tensor.  The readings (this file's inputs, a CPU):

* the ranking scores under a bf16 classifier: full and sampled ranks equal
  the JAX package's (0 of 256 differ); the bf16-rounded scores the port
  computed before its repair differ beyond the near-ties (170 of 256 full
  ranks, by up to 6 places);
* the CE (``fused_rec_ce_rows``), bf16 and f32 W: rows 9.1e-8, gradients
  <= 8.4e-6 (dW of a bf16 W, itself rounded to bf16); f32: rows 5.8e-4,
  gradients >= 3.7e-4; ``CE_TOL`` 5e-5;
* the tower (``encode_towers_fused``, two layers, two heads), Frobenius,
  over seeds 3-7: output <= 1.1e-4 and gradients <= 1.0e-3 (seed 4, the
  worst, which the test takes; seeds 3, 5-7: <= 1.2e-7 and 8.8e-5); f32:
  output >= 1.6e-3, the worst gradient >= 4.3e-2; ``TOWER_TOL`` 5e-4,
  ``TOWER_GRAD_TOL`` 1e-2;
* the SpMM and its flagged hop (``make_blocked_spmm[_flagged]`` with
  ``gather_dtype=bf16``), forward and over Aᵀ: bf16 <= 2.0e-8; f32 >=
  1.8e-3; ``SPMM_TOL`` 1e-5;
* the step (``train.step.loss_fn``, jitted, d 128 so that the JAX SpMM
  takes its Pallas path on both tables): loss 8.6e-8 relative, the worst
  gradient 1.3e-3 of its leaf's largest value (attn_a's w_qkv: tower
  inputs rounded to the other bf16 neighbour after the SpMM's f32 sums in
  another order); f32: loss 2.8e-4, worst gradient 0.22;
  ``STEP_LOSS_TOL`` 1e-5, ``STEP_GRAD_TOL`` 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2dsr_tpu.config import Config as JConfig, DataSpec as JSpec
from c2dsr_tpu.model import c2dsr as jc2dsr
from c2dsr_tpu.model import params as jparams
from c2dsr_tpu.ops import encoder_pallas as jencp
from c2dsr_tpu.ops import fused_ce as jfused_ce
from c2dsr_tpu.ops import spmm as jspmm
from c2dsr_tpu.ops import spmm_pallas
from c2dsr_tpu.parallel import strategy as jstrategy
from c2dsr_tpu.train import step as jstep
from c2dsr_tpu_torch.bench import gates
from c2dsr_tpu_torch.config import Config, DataSpec
from c2dsr_tpu_torch.data import preprocess, synthetic
from c2dsr_tpu_torch.evaluate import ranker
from c2dsr_tpu_torch.graph import build
from c2dsr_tpu_torch.model import c2dsr
from c2dsr_tpu_torch.model import params as params_mod
from c2dsr_tpu_torch.ops import encoder as enc
from c2dsr_tpu_torch.ops import fused_ce, spmm
from c2dsr_tpu_torch.parallel.strategy import LocalOps
from c2dsr_tpu_torch.train import step

CE_TOL = 5e-5
TOWER_TOL = 5e-4
TOWER_GRAD_TOL = 1e-2
SPMM_TOL = 1e-5
STEP_LOSS_TOL = 1e-5
STEP_GRAD_TOL = 1e-2
PAD = 99


@pytest.fixture(autouse=True)
def _one_thread():
    """The file's budget is set single-threaded (the tier-1 run has six
    workers beside it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _fro(got, want) -> float:
    """||got - want|| / ||want||: the tower's measure, where a value one
    side rounds to the other bf16 neighbour moves its row (module
    docstring)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------- scores ----

def _score_case(seed=0, B=256, d=64, V=5000, n_real=4900):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) / np.sqrt(d)).astype(np.float32)
    b = (rng.normal(size=V) * 0.1).astype(np.float32)
    gt = rng.integers(0, n_real, size=B).astype(np.int64)
    ids = np.concatenate([gt[:, None], rng.integers(0, n_real, (B, 99))], 1)
    return h, w, b, gt, ids, n_real


def _unexplained(ranks, want, scores, gt_score, band):
    """Ranks that differ from ``want`` by more than the example's count of
    near-ties: candidates (``scores``, the gt's among them) whose score
    lies within ``band`` of the gt's (``bench/gates.near_ties``, the band
    from the reference's own error against float64)."""
    ties = (np.abs(scores - gt_score[:, None]) <= band[:, None]).sum(1) - 1
    return int((np.abs(np.asarray(ranks) - np.asarray(want)) > ties).sum())


@pytest.mark.parametrize("mode", ["full", "sampled"])
def test_bf16_classifier_ranks_match_jax(mode):
    """Under ``classifier_dtype="bfloat16"`` the scores are f32 sums of
    bf16-rounded products, as the JAX package's (``preferred_element_type=
    f32``), and the ranks equal its own but at near-ties.  The scores the
    port rounded to bf16 before (a bf16 ``torch.matmul``) reorder
    candidates well beyond them."""
    h, w, b, gt, ids, n_real = _score_case()
    jops = jstrategy.LocalOps(cfg=JConfig(classifier_dtype="bfloat16"))
    ops = LocalOps(cfg=Config(classifier_dtype="bfloat16"))
    th, tw, tb = map(torch.from_numpy, (h, w, b))
    # the reference's scores and their own error against float64 (of the
    # same bf16-rounded operands): the near-tie band
    hr = np.asarray(jnp.asarray(h).astype(jnp.bfloat16), np.float64)
    wr = np.asarray(jnp.asarray(w).astype(jnp.bfloat16), np.float64)
    s64 = hr @ wr + b
    js = np.asarray(jnp.matmul(jnp.asarray(h).astype(jnp.bfloat16),
                               jnp.asarray(w).astype(jnp.bfloat16),
                               preferred_element_type=jnp.float32) + b)
    band = np.maximum(2 * (gates.SCORE_K + 1) * np.abs(js - s64).max(1),
                      gates.TIE_TOL)
    old = (torch.matmul(th.to(torch.bfloat16), tw.to(torch.bfloat16))
           .float() + tb).numpy()
    if mode == "full":
        want = np.asarray(jops.full_rank(jnp.asarray(h), jnp.asarray(w),
                                         jnp.asarray(b), jnp.asarray(gt),
                                         n_real))
        got = ops.full_rank(th, tw, tb, torch.from_numpy(gt), n_real).numpy()
        cand, gt_score = js[:, :n_real], js[np.arange(len(gt)), gt]
        col = np.arange(old.shape[1])
        old_s = np.where(col < n_real, old, -np.inf)
        before = (old_s > old_s[np.arange(len(gt)), gt][:, None]).sum(1) + 1
    else:
        want_s = np.asarray(jops.gather_scores(
            jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), jnp.asarray(ids)))
        got_s = ops.gather_scores(th, tw, tb, torch.from_numpy(ids)).numpy()
        assert _rel(got_s, want_s) < 1e-6
        want = (want_s[:, 1:] > want_s[:, :1]).sum(1) + 1
        got = (got_s[:, 1:] > got_s[:, :1]).sum(1) + 1
        cand = np.take_along_axis(js, ids, 1)
        gt_score = cand[:, 0]
        old_p = np.take_along_axis(old, ids, 1)
        before = (old_p[:, 1:] > old_p[:, :1]).sum(1) + 1
    assert _unexplained(got, want, cand, gt_score, band) == 0
    assert _unexplained(before, want, cand, gt_score, band) > 0


# -------------------------------------------------------------------- CE ----

def _ce_case(seed=1, B=8, R=10, d=32, V=700, n_real=650):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, R, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) / np.sqrt(d)).astype(np.float32)
    b = (rng.normal(size=V) * 0.1).astype(np.float32)
    pad = rng.normal(size=(B, R, 1)).astype(np.float32)
    tgt = rng.integers(0, n_real + 1, size=(B, R)).astype(np.int32)
    g = rng.normal(size=(B, R)).astype(np.float32)
    return h, w, b, pad, tgt, g, n_real


def _port_ce(h, w, b, pad, tgt, g, n_real, bf16, w_bf16):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (h, w, b, pad)]
    th, tw, tb, tp = leaves
    rows = fused_ce.fused_rec_ce_rows(
        th, tw.to(torch.bfloat16) if w_bf16 else tw, tb, tp,
        torch.from_numpy(tgt), n_real, bf16=bf16)
    grads = torch.autograd.grad(rows, leaves, torch.from_numpy(g))
    return rows.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("w_bf16", [True, False])
def test_plain_bf16_ce_matches_pallas(w_bf16):
    """The plain bf16 CE (forward and the gradients of h, W, b and the pad
    logit) against the Pallas CE in interpret mode, with a bf16 W (its
    gradient rounded to bf16 in both) and with an f32 W (bf16 products in
    both: ``_dot`` rounds W in the kernel).  The f32 CE falls outside."""
    h, w, b, pad, tgt, g, n_real = _ce_case()

    def jrows(hh, ww, bb, pp):
        return jfused_ce.fused_rec_ce_rows(
            hh, ww.astype(jnp.bfloat16) if w_bf16 else ww, bb, pp,
            jnp.asarray(tgt), n_real, interpret=True)

    want, vjp = jax.vjp(jrows, *map(jnp.asarray, (h, w, b, pad)))
    want_g = vjp(jnp.asarray(g))
    rows, grads = _port_ce(h, w, b, pad, tgt, g, n_real, True, w_bf16)
    assert _rel(rows, want) < CE_TOL
    for got, ref in zip(grads, want_g):
        assert _rel(got, ref) < CE_TOL
    rows32, grads32 = _port_ce(h, w, b, pad, tgt, g, n_real, False, False)
    assert max([_rel(rows32, want)]
               + [_rel(a, r) for a, r in zip(grads32, want_g)]) > CE_TOL


def test_plain_bf16_ce_backward_is_autograds():
    """``ce_bwd_plain`` (what K5's bf16 instantiation is held against on
    the card) gives the gradients autograd gives through ``ce_fwd_plain``."""
    h, w, b, pad, tgt, g, n_real = _ce_case(seed=2)
    n, d = h.shape[0] * h.shape[1], h.shape[2]
    th = torch.from_numpy(h.reshape(n, d)).requires_grad_(True)
    tw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    bm = fused_ce.mask_bias(torch.from_numpy(b), n_real)
    t = torch.from_numpy(tgt.reshape(n)).long()
    lse, tlog = fused_ce.ce_fwd_plain(th, tw, bm, torch.from_numpy(
        pad.reshape(n)), t)
    dlse = torch.from_numpy(g.reshape(n))
    dt = -dlse
    dh, dw = torch.autograd.grad((lse * dlse + tlog * dt).sum(), [th, tw])
    got = fused_ce.ce_bwd_plain(th.detach(), tw.detach(), bm, lse.detach(),
                                dlse, dt, t)
    assert got[1].dtype == torch.bfloat16
    assert torch.equal(got[0], dh) and torch.equal(got[1], dw)


def test_sharded_ce_streams_the_bf16_classifier():
    """``ShardedOps.ce_rows`` casts its vocab shard as ``LocalOps`` casts
    the classifier (``_cls``, c2dsr_tpu/parallel/strategy.py:134), the
    fused CE taking bf16 products on it: on a one-rank mesh its rows and
    the f32 master weight's gradient are the local strategy's, and both
    differ from the f32 classifier's."""
    from c2dsr_tpu_torch.parallel import comm
    from c2dsr_tpu_torch.parallel.mesh import Mesh
    from c2dsr_tpu_torch.parallel.strategy import ShardedOps
    h, w, b, pad, tgt, g, n_real = _ce_case(seed=4)
    mesh = Mesh(1, 1, 0, comm.SELF, comm.SELF)

    def rows_and_dw(ops):
        tw = torch.from_numpy(w).requires_grad_(True)
        rows = ops.ce_rows(torch.from_numpy(h), tw, torch.from_numpy(b),
                           torch.from_numpy(pad), torch.from_numpy(tgt),
                           n_real)
        (dw,) = torch.autograd.grad(rows, tw, torch.from_numpy(g))
        return rows.detach().numpy(), dw.numpy()

    cfg = Config(compute_dtype="bfloat16", classifier_dtype="bfloat16")
    local = rows_and_dw(LocalOps(cfg=cfg))
    sharded = rows_and_dw(ShardedOps(cfg=cfg, mesh=mesh))
    f32 = rows_and_dw(LocalOps(cfg=Config()))
    assert local[1].dtype == np.float32
    assert _rel(sharded[0], local[0]) < 1e-6
    assert np.array_equal(sharded[1], local[1])
    assert _rel(f32[0], local[0]) > CE_TOL and _rel(f32[1], local[1]) > CE_TOL


# ----------------------------------------------------------------- tower ----

def _tower_case(B=8, L=15, d=32, n_head=2, n_layers=2, seed=4):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 5, size=(B, L)).astype(np.int32)
    # pads after the first position only: no all-masked query row, where
    # the two JAX towers differ (ROADMAP §C)
    seq[:, 1:] = np.where(rng.random((B, L - 1)) < 0.3, PAD, seq[:, 1:])
    pos = np.tile(np.arange(L, dtype=np.int32), (B, 1))
    h = (rng.normal(size=(B, L, d)) * 0.5).astype(np.float32)
    g = rng.normal(size=(B, L, d)).astype(np.float32)
    jp = jax.tree.map(np.asarray, jparams.init_encoder_params(
        jax.random.PRNGKey(seed),
        JConfig(d_latent=d, n_attn=n_layers, n_head=n_head), L))
    return seq, pos, h, g, jp, n_head


def _port_tower(seq, pos, h, g, jp, n_head, bf16):
    p = params_mod._map(lambda t: t.requires_grad_(True),
                        params_mod.params_from_numpy(jp, device="cpu"))
    th = torch.from_numpy(h).requires_grad_(True)
    x = th + p["pos_emb"][torch.from_numpy(pos).long()]
    out = enc.encode_layers(x, torch.from_numpy(seq), p, idx_pad=PAD,
                            n_head=n_head, norm_first=False,
                            invert_padding_mask=False, bf16=bf16)
    out.backward(torch.from_numpy(g))
    grads = params_mod.params_to_numpy(params_mod._map(lambda t: t.grad, p))
    return out.detach().numpy(), [th.grad.numpy()] + jax.tree.leaves(grads)


def test_plain_bf16_tower_matches_pallas():
    """The plain bf16 tower (two layers, two heads) against the fused
    Pallas tower in interpret mode, forward, dx and every weight gradient
    (the positional embedding's included); the f32 tower falls outside."""
    seq, pos, h, g, jp, n_head = _tower_case()

    def jtower(hh, p):
        return jencp.encode_towers_fused(
            [(jnp.asarray(seq), hh, jnp.asarray(pos), p)], idx_pad=PAD,
            n_head=n_head, dropout=0.0, rng=None,
            invert_padding_mask=False)[0]

    jencp.st_interpret.set(True)
    try:
        want, vjp = jax.vjp(jtower, jnp.asarray(h), jp)
        jdh, jdp = vjp(jnp.asarray(g))
    finally:
        jencp.st_interpret.set(False)
    want_g = [jdh] + jax.tree.leaves(jdp)
    out, grads = _port_tower(seq, pos, h, g, jp, n_head, True)
    assert _fro(out, want) < TOWER_TOL
    for got, ref in zip(grads, want_g):
        assert _fro(got, ref) < TOWER_GRAD_TOL
    out32, grads32 = _port_tower(seq, pos, h, g, jp, n_head, False)
    assert _fro(out32, want) > TOWER_TOL
    assert max(_fro(a, r) for a, r in zip(grads32, want_g)) > TOWER_GRAD_TOL


# ------------------------------------------------------------------ SpMM ----

SPEC_S = DataSpec(n_item_a=40, n_item_b=60, len_max=10)


@pytest.fixture(scope="module")
def spmm_graphs():
    seqs = synthetic.generate_sequences(SPEC_S, 400, seed=5)
    return build.build_graphs(seqs, SPEC_S)


@pytest.mark.parametrize("flagged", [False, True])
def test_plain_bf16_spmm_matches_pallas(spmm_graphs, flagged):
    """The plain bf16 hop (dense, and flagged: "dest" forward, "src" over
    Aᵀ backward) against ``make_blocked_spmm[_flagged](gather_dtype=bf16)``
    in interpret mode, on both graphs, forward and over Aᵀ (the VJP); the
    f32 hop falls outside.  d 128, the width the Pallas SpMM takes."""
    for which, g in enumerate(spmm_graphs):
        rng = np.random.default_rng(which)
        n_rows = g.n + 9
        h = rng.normal(size=(n_rows, 128)).astype(np.float32)
        flag = np.zeros(n_rows, np.uint8)
        flag[rng.choice(g.n, g.n // 3, replace=False)] = 1
        cot = rng.normal(size=h.shape).astype(np.float32)
        if flagged:
            cot *= flag[:, None]
        jdev = jspmm.device_graph(g, blocked=True)
        if flagged:
            hop = spmm_pallas.make_blocked_spmm_flagged(
                jdev.bk_fwd, jdev.bk_bwd, interpret=True,
                gather_dtype=jnp.bfloat16)
            want, vjp = jax.vjp(lambda x: hop(x, jnp.asarray(flag,
                                                             jnp.float32)),
                                jnp.asarray(h))
        else:
            hop = spmm_pallas.make_blocked_spmm(jdev.bk_fwd, jdev.bk_bwd,
                                                interpret=True,
                                                gather_dtype=jnp.bfloat16)
            want, vjp = jax.vjp(hop, jnp.asarray(h))
        (want_dh,) = vjp(jnp.asarray(cot))
        dev = spmm.device_graph(g, "cpu")
        errs = {}
        for bf16 in (True, False):
            th = torch.from_numpy(h).requires_grad_(True)
            if flagged:
                out = spmm.spmm_reference_flagged(dev, th,
                                                  torch.from_numpy(flag),
                                                  "dest", bf16)
            else:
                out = spmm.spmm_reference(dev, th, bf16=bf16)
            (dh,) = torch.autograd.grad(out, th, torch.from_numpy(cot))
            errs[bf16] = max(_rel(out.detach().numpy(), want),
                             _rel(dh.numpy(), want_dh))
        assert errs[True] < SPMM_TOL, (which, errs)
        assert errs[False] > SPMM_TOL, (which, errs)


# ------------------------------------------------------------------ step ----

STEP_SPEC = dict(n_item_a=50, n_item_b=70, len_max=15)
STEP_CFG = dict(d_latent=128, batch_size=16, len_rec=5, dropout_gnn=0.0,
                dropout_attn=0.0, vocab_pad_multiple=64)


@pytest.fixture(scope="module")
def jax_bf16_step():
    """The JAX package's loss and gradients on its Pallas path (interpret
    mode), both dtypes bf16, and what the port's step needs."""
    spec, jspec = DataSpec(**STEP_SPEC), JSpec(**STEP_SPEC)
    seqs = synthetic.generate_sequences(spec, 300, seed=1)
    train = preprocess.preprocess_train(seqs, spec, seed=1)
    share, specific = build.build_graphs(seqs, spec)
    jcfg = JConfig(**STEP_CFG, kernel_backend="pallas", pallas_interpret=True,
                   compute_dtype="bfloat16", classifier_dtype="bfloat16")
    jp = jparams.init_params(jax.random.PRNGKey(0), JConfig(**STEP_CFG),
                             jspec)
    jg = jc2dsr.Graphs(jspmm.device_graph(share, blocked=True),
                       jspmm.device_graph(specific, blocked=True))
    batch = {k: v[:16] for k, v in train.items()}

    @jax.jit
    def loss_and_grads(p, b):
        return jax.value_and_grad(jstep.loss_fn, has_aux=True)(
            p, jg, b, jax.random.PRNGKey(1), jcfg, jspec)

    jencp.st_interpret.set(True)
    try:
        (loss, aux), grads = loss_and_grads(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        jencp.st_interpret.set(False)
    return dict(spec=spec, batch=batch, np_params=jax.tree.map(np.asarray, jp),
                graphs=c2dsr.Graphs(spmm.device_graph(share, "cpu"),
                                    spmm.device_graph(specific, "cpu")),
                loss=float(loss), aux={k: float(v) for k, v in aux.items()},
                grads=[np.asarray(x) for x in jax.tree.leaves(grads)])


def _port_step(s, dtype):
    cfg = Config(**STEP_CFG, compute_dtype=dtype, classifier_dtype=dtype)
    params = params_mod.params_from_numpy(s["np_params"], "cpu")
    for t in step.param_leaves(params):
        t.requires_grad_(True)
    loss, aux = step.loss_fn(params, s["graphs"],
                             ranker.to_device(s["batch"], "cpu"), None, cfg,
                             s["spec"])
    loss.backward()
    grads = params_mod.params_to_numpy(params_mod._map(lambda t: t.grad,
                                                       params))
    return ({k: float(aux[k].detach()) for k in ("loss", "loss_rec",
                                                  "loss_mi")},
            jax.tree.leaves(grads))


def test_bf16_step_matches_pallas_step(jax_bf16_step):
    """The port's CPU step at both dtypes bf16 against the JAX package's
    Pallas-path step in interpret mode: the loss and its two parts within
    STEP_LOSS_TOL relative, every gradient within STEP_GRAD_TOL of its
    leaf's largest value."""
    s = jax_bf16_step
    aux, grads = _port_step(s, "bfloat16")
    for k in ("loss", "loss_rec", "loss_mi"):
        assert abs(aux[k] - s["aux"][k]) <= STEP_LOSS_TOL * abs(s["aux"][k])
    assert len(grads) == len(s["grads"])
    for got, want in zip(grads, s["grads"]):
        assert got.dtype == np.float32
        assert _rel(got, want) < STEP_GRAD_TOL


def test_f32_step_falls_outside_the_bf16_tolerances(jax_bf16_step):
    """The same comparison with the port at float32: its loss and its
    worst gradient both fall outside."""
    s = jax_bf16_step
    aux, grads = _port_step(s, "float32")
    assert abs(aux["loss"] - s["loss"]) > STEP_LOSS_TOL * abs(s["loss"])
    assert max(_rel(a, b) for a, b in zip(grads, s["grads"])) > STEP_GRAD_TOL
