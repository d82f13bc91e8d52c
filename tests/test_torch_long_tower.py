"""The port's plain versions at the shapes K2/K3 and K4/K5 take past the
old limits (sequences longer than 64, towers and CE rows wider than 512),
held against the JAX package on the CPU.

* The plain tower (``encoder_fwd_plain`` / ``encoder_bwd_plain``, the plain
  versions of K2 and K3) at (d 64, L 65), (d 32, L 130) and (d 520, one
  head, L 8), one layer: against ``c2dsr_tpu.ops.encoder.encode_sequence``
  under ``jax.vjp`` on every row, all-pad sequences included, at 1e-5 of
  each tensor's largest value; against the fused Pallas tower
  (``encode_sequence_fused``, interpret mode, f32 matmuls) on sequences
  whose first position is real, so that every query row has an allowed key
  (the Pallas kernel averages an all-masked row over its padded length):
  forward 1e-5, gradients 1e-4.
* The plain CE at d 640 against the fused Pallas CE (interpret mode, bf16
  products with f32 sums: 2e-2) and ``losses.rec_ce_row_losses`` (f32:
  1e-5), forward and every gradient.
* One train step's loss (1e-5 relative) and every gradient against the
  JAX step at len_max 80 and at d_latent 520, on small itemsets.  A
  gradient is held by its relative Frobenius error, to the larger of 1e-4
  and three times the JAX f32 step's own distance from the float64 step
  (the port's plain path in float64, which tests/test_torch_train.py holds
  to the JAX step): at d 520 the jitted JAX step's shared-tower w_qkv
  gradient lies 8.9e-5 from float64 and 1.3e-4 from the port's f32 one,
  which lies 4.0e-5 from float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2dsr_tpu.config import Config as JConfig, DataSpec as JSpec
from c2dsr_tpu.model import c2dsr as jc2dsr
from c2dsr_tpu.model import params as jparams
from c2dsr_tpu.ops import encoder as jenc
from c2dsr_tpu.ops import encoder_pallas as jencp
from c2dsr_tpu.ops import fused_ce as jfused
from c2dsr_tpu.ops import losses as jlosses
from c2dsr_tpu.ops import spmm as jspmm
from c2dsr_tpu.train import step as jstep
from c2dsr_tpu_torch.config import Config, DataSpec
from c2dsr_tpu_torch.data import preprocess, synthetic
from c2dsr_tpu_torch.evaluate import ranker
from c2dsr_tpu_torch.graph import build
from c2dsr_tpu_torch.model import c2dsr
from c2dsr_tpu_torch.model import params as params_mod
from c2dsr_tpu_torch.ops import encoder as enc
from c2dsr_tpu_torch.ops import fused_ce, spmm
from c2dsr_tpu_torch.train import step

PAD = 99
TOWERS = [(64, 1, 65), (32, 1, 130), (520, 1, 8)]


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _tower_inputs(b, length, d, seed, first_real):
    """Sequences (left pads of every length up to all-pad, or pads after a
    real first position), their positions, the input and a gradient."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 5, size=(b, length)).astype(np.int32)
    pos = np.zeros((b, length), np.int32)
    for i in range(b):
        npad = 0 if first_real else (i * length) // max(b - 1, 1)
        if first_real:
            seq[i, 1:][rng.random(length - 1) < 0.3] = PAD
        seq[i, :npad] = PAD
        pos[i, npad:] = np.minimum(np.arange(1, length - npad + 1), length - 1)
    h = (rng.normal(size=(b, length, d)) * 0.5).astype(np.float32)
    g = rng.normal(size=(b, length, d)).astype(np.float32)
    return seq, pos, h, g


def _tower_check(jfn, d, n_head, length, first_real, tol_out, tol_grad):
    p = jax.tree.map(np.asarray, jparams.init_encoder_params(
        jax.random.PRNGKey(d + length), JConfig(d_latent=d, n_attn=1,
                                                n_head=n_head), length))
    seq, pos, h, g = _tower_inputs(3 if not first_real else 2, length, d,
                                   seed=d + length, first_real=first_real)
    tp = params_mod.params_from_numpy(p, device="cpu")
    seq_t = torch.from_numpy(seq).long()
    x = torch.from_numpy(h) + tp["pos_emb"][torch.from_numpy(pos).long()]
    kw = dict(idx_pad=PAD, n_head=n_head, invert_padding_mask=False)
    out = enc.encoder_fwd_plain(x, seq_t, tp, **kw)
    dx, grads = enc.encoder_bwd_plain(x, seq_t, torch.from_numpy(g), tp, **kw)

    @jax.jit
    def fwd_bwd(h, p, g):
        out, vjp = jax.vjp(lambda h, p: jfn(jnp.asarray(seq), h,
                                            jnp.asarray(pos), p), h, p)
        return (out,) + vjp(g)

    jout, jdh, jg = fwd_bwd(jnp.asarray(h), p, jnp.asarray(g))
    _close(out.numpy(), jout, tol_out, "out")
    _close(dx.numpy(), jdh, tol_grad, "dx")
    want = ([np.stack([np.asarray(lg[n]) for lg in jg["layers"]])
             for n in enc._NAMES]
            + [np.asarray(jg["lnf_scale"]), np.asarray(jg["lnf_bias"])])
    for name, got, w in zip(enc._NAMES + ("lnf_scale", "lnf_bias"), grads,
                            want):
        _close(got.numpy(), w, tol_grad, name)
    return seq


@pytest.mark.parametrize("d,n_head,length", TOWERS)
def test_long_plain_tower_matches_jax_xla(d, n_head, length):
    def jfn(seq, h, pos, p):
        return jenc.encode_sequence(seq, h, pos, p, idx_pad=PAD,
                                    n_head=n_head, dropout=0.0, rng=None,
                                    norm_first=False,
                                    invert_padding_mask=False)

    seq = _tower_check(jfn, d, n_head, length, False, 1e-5, 1e-5)
    assert (seq == PAD).all(axis=1).any()              # an all-pad sequence


@pytest.fixture
def _interpret():
    jencp.st_interpret.set(True)
    yield
    jencp.st_interpret.set(False)


@pytest.mark.parametrize("d,n_head,length", TOWERS)
def test_long_plain_tower_matches_fused_pallas(_interpret, d, n_head, length):
    def jfn(seq, h, pos, p):
        return jencp.encode_sequence_fused(
            seq, h, pos, p, idx_pad=PAD, n_head=n_head, dropout=0.0,
            rng=None, invert_padding_mask=False, matmul_dtype=jnp.float32,
            block_b=8)

    _tower_check(jfn, d, n_head, length, True, 1e-5, 1e-4)


CE_D = 640


def _ce_case(V, n_real, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(2, 8, CE_D)).astype(np.float32)
    w = (rng.normal(size=(CE_D, V)) * 0.05).astype(np.float32)
    w[:, n_real:] = 0.0
    b = (rng.normal(size=V) * 0.1).astype(np.float32)
    pad = rng.normal(size=(2, 8, 1)).astype(np.float32)
    tgt = rng.integers(0, n_real, size=(2, 8)).astype(np.int32)
    tgt[:, :2] = n_real                                 # ignored positions
    g = rng.normal(size=(2, 8)).astype(np.float32)
    return h, w, b, pad, tgt, g


@pytest.mark.parametrize("against", ["pallas", "losses"])
def test_plain_ce_d640_matches_jax(against):
    V, n_real = 300, 280
    h, w, b, pad, tgt, g = _ce_case(V, n_real, seed=CE_D)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (h, w, b, pad)]
    rows = fused_ce.fused_rec_ce_rows(*ts, torch.from_numpy(tgt).long(),
                                      n_real)
    rows.backward(torch.from_numpy(g))

    def f(h, w, b, pad):
        if against == "pallas":
            return jfused.fused_rec_ce_rows(h, w, b, pad, tgt, n_real,
                                            interpret=True)
        return jlosses.rec_ce_row_losses(
            jnp.einsum("brd,dv->brv", h, w) + b, pad, tgt, n_real)

    tol = 2e-2 if against == "pallas" else 1e-5
    want, vjp = jax.vjp(f, h, w, b, pad)
    _close(rows.detach().numpy(), want, tol, "rows")
    assert (rows.detach().numpy()[:, :2] == 0).all()
    for t, exp in zip(ts, vjp(jnp.asarray(g))):
        _close(t.grad.numpy(), exp, tol)


@pytest.mark.parametrize("len_max,d_latent", [(80, 32), (15, 520)])
def test_train_step_loss_and_grads_match_jax(len_max, d_latent):
    spec_kw = dict(n_item_a=50, n_item_b=70, len_max=len_max)
    cfg_kw = dict(d_latent=d_latent, batch_size=8, len_rec=5,
                  dropout_gnn=0.0, dropout_attn=0.0, vocab_pad_multiple=64)
    spec, jspec = DataSpec(**spec_kw), JSpec(**spec_kw)
    cfg, jcfg = Config(**cfg_kw), JConfig(**cfg_kw)
    seqs = synthetic.generate_sequences(spec, 60, seed=len_max)
    train = preprocess.preprocess_train(seqs, spec, seed=1)
    share, specific = build.build_graphs(seqs, spec)
    batch = {k: v[:8] for k, v in train.items()}
    jp = jparams.init_params(jax.random.PRNGKey(d_latent), jcfg, jspec)
    jgraphs = jc2dsr.Graphs(jspmm.device_graph(share, blocked=False),
                            jspmm.device_graph(specific, blocked=False))
    @jax.jit
    def jgrad(p, b):
        return jax.value_and_grad(jstep.loss_fn, has_aux=True)(
            p, jgraphs, b, jax.random.PRNGKey(1), jcfg, jspec)

    (_, jaux), jgrads = jgrad(jp, {k: jnp.asarray(v)
                                   for k, v in batch.items()})

    params = params_mod.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for t in step.param_leaves(params):
        t.requires_grad_(True)
    graphs = c2dsr.Graphs(spmm.device_graph(share, "cpu"),
                          spmm.device_graph(specific, "cpu"))
    loss, aux = step.loss_fn(params, graphs, ranker.to_device(batch, "cpu"),
                             None, cfg, spec)
    loss.backward()
    np.testing.assert_allclose(float(aux["loss"].detach()),
                               float(jaux["loss"]), rtol=1e-5)
    grads = params_mod.params_to_numpy(params_mod._map(lambda t: t.grad,
                                                       params))
    p64 = params_mod._map(lambda t: t.detach().double().requires_grad_(True),
                          params)
    loss64, _ = step.loss_fn(p64, graphs, ranker.to_device(batch, "cpu"),
                             None, cfg.with_(compute_dtype="float64"), spec)
    loss64.backward()
    grads64 = params_mod.params_to_numpy(params_mod._map(lambda t: t.grad,
                                                         p64))

    def fro(a, b):
        return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                     / max(float(np.linalg.norm(b)), 1e-30))

    for (path, want), got, ref in zip(
            jax.tree_util.tree_leaves_with_path(jgrads),
            jax.tree.leaves(grads), jax.tree.leaves(grads64)):
        tol = max(1e-4, 3 * fro(want, ref))
        assert fro(got, np.asarray(want, np.float64)) <= tol, \
            jax.tree_util.keystr(path)
