"""The pieces of the captured train and rank steps that run without a card.

A captured step reads its dropout seed from a device scalar and draws its
GNN dropout from one generator re-seeded each step (``train/step.py``
StepProgram); it stages each batch signature into static inputs
(``capture.py``).  Here, on the CPU, at small sizes:

* the dropout bits of a 0-d int32 seed tensor are the int seed's, bit for
  bit, and so are the plain tower's outputs (f32 and bf16 products);
* the GNN masks are a pure function of (seed, step), and two steps draw
  different masks;
* the batch signature tells the full batch, the ragged batch and a batch
  with a ``valid`` key apart, and staging reuses its buffers;
* the step program, run eagerly, takes the op-by-op step's (a mesh
  rank's, at one process) params, optimizer state and aux bit for bit
  over steps at dropout 0.2 with a ragged batch;
* ``capture=True`` raises on the CPU and on a mesh;
* the plain versions stand in for every registered kernel wrapper, and
  the rank program copies the propagated tables once for each new set.
"""

import numpy as np
import pytest
import torch

from c2dsr_tpu_torch import capture
from c2dsr_tpu_torch.config import Config, DataSpec
from c2dsr_tpu_torch.data import preprocess, synthetic
from c2dsr_tpu_torch.evaluate import ranker
from c2dsr_tpu_torch.graph import build
from c2dsr_tpu_torch.model import c2dsr
from c2dsr_tpu_torch.model import params as params_mod
from c2dsr_tpu_torch.ops import dropout as drop
from c2dsr_tpu_torch.ops import encoder as enc
from c2dsr_tpu_torch.ops import spmm, wrappers
from c2dsr_tpu_torch.parallel import strategy
from c2dsr_tpu_torch.train import optim, step

SPEC = DataSpec(n_item_a=50, n_item_b=70, len_max=15)
CFG = Config(d_latent=32, batch_size=16, len_rec=5, vocab_pad_multiple=64)


@pytest.fixture(scope="module")
def setup():
    seqs = synthetic.generate_sequences(SPEC, 300, seed=1)
    train = preprocess.preprocess_train(seqs, SPEC, seed=1)
    share, specific = build.build_graphs(seqs, SPEC)
    graphs = c2dsr.Graphs(spmm.device_graph(share, "cpu"),
                          spmm.device_graph(specific, "cpu"))
    init = params_mod.params_to_numpy(params_mod.init_params(
        CFG, SPEC, torch.Generator().manual_seed(0), "cpu"))
    return dict(train=train, graphs=graphs, init=init)


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
def test_tensor_seed_bits_are_the_int_seeds(seed):
    index = torch.arange(4096)
    t = drop.seed_tensor(seed, "cpu")
    assert t.dtype == torch.int32 and t.dim() == 0
    for site, tower, layer in ((0, 0, 0), (1, 2, 1), (4, 1, 3)):
        got = drop.bits(index, t, site, tower, layer)
        assert torch.equal(got, drop.bits(index, seed, site, tower, layer))
    assert [int(v) for v in drop.bits(index[:50], t, 3, 1, 2)] == [
        drop.bits_reference(seed, 3, 1, 2, i) for i in range(50)]


def test_seed_tensor_refuses_another_dtype_or_shape():
    with pytest.raises(ValueError, match="0-d int32"):
        drop.seed_tensor(torch.zeros((), dtype=torch.int64), "cpu")
    with pytest.raises(ValueError, match="0-d int32"):
        drop.seed_tensor(torch.zeros(1, dtype=torch.int32), "cpu")


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_tower_takes_a_tensor_seed(bf16):
    cfg = Config(d_latent=32, n_head=2, n_attn=2)
    p = params_mod.init_encoder_params(torch.Generator().manual_seed(3), cfg,
                                       15)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(6, 15, 32)).astype(np.float32))
    seq = torch.from_numpy(rng.integers(0, 121, size=(6, 15)))
    seq[:, :4] = 120
    kw = dict(idx_pad=120, n_head=2, norm_first=False,
              invert_padding_mask=False, dropout=0.2, tower=1, bf16=bf16)
    seed = drop.step_seed(7, 3)
    by_int = enc.encode_layers(x, seq, p, seed=seed, **kw)
    by_tensor = enc.encode_layers(x, seq, p,
                                  seed=drop.seed_tensor(seed, "cpu"), **kw)
    assert torch.equal(by_int, by_tensor)
    other = enc.encode_layers(x, seq, p, seed=seed + 1, **kw)
    assert not torch.equal(by_int, other)


def _gnn_loss(s, seed):
    """The loss of one batch with the GNN's dropout alone, its generator
    seeded with ``seed`` as the step program seeds it."""
    cfg = CFG.with_(dropout_gnn=0.5, dropout_attn=0.0)
    params = params_mod.params_from_numpy(s["init"], "cpu")
    batch = ranker.to_device({k: v[:16] for k, v in s["train"].items()},
                             "cpu")
    loss, _ = step.loss_fn(params, s["graphs"], batch,
                           drop.seed_tensor(seed, "cpu"), cfg, SPEC,
                           generator=torch.Generator().manual_seed(seed))
    return float(loss)


def test_gnn_masks_are_a_function_of_seed_and_step(setup):
    base = CFG.seed + 1
    at = {k: _gnn_loss(setup, drop.step_seed(base, k)) for k in (4, 5)}
    assert _gnn_loss(setup, drop.step_seed(base, 4)) == at[4]
    assert at[4] != at[5]


def test_signature_tells_batches_apart(setup):
    train = setup["train"]
    full = {k: v[:16] for k, v in train.items()}
    ragged = {k: v[16:27] for k, v in train.items()}
    valid = dict(full, valid=np.ones(16, np.int32))
    sigs = {capture.signature(b) for b in (full, ragged, valid)}
    assert len(sigs) == 3
    assert capture.signature({k: v[32:48] for k, v in train.items()}) == \
        capture.signature(full)
    assert capture.signature({k: full[k] for k in reversed(list(full))}) == \
        capture.signature(full)


def test_staging_reuses_its_buffers(setup):
    train = setup["train"]
    first = {k: v[:16] for k, v in train.items()}
    stage = capture.Staging(first, torch.device("cpu"))
    a = stage(first)
    ptrs = {k: t.data_ptr() for k, t in a.items()}
    second = {k: v[16:32] for k, v in train.items()}
    b = stage(second)
    assert {k: t.data_ptr() for k, t in b.items()} == ptrs
    for k, v in second.items():
        assert b[k].dtype == torch.int64
        assert np.array_equal(b[k].numpy(), v)


def test_step_program_is_the_eager_step(setup):
    """The step program's body, run eagerly on the CPU (static gradients
    zeroed in place, one re-seeded GNN generator), against
    the op-by-op step a mesh rank runs, here at one process: params,
    optimizer state and aux bitwise over three steps at dropout 0.2, the
    last ragged."""
    cfg = CFG.with_(dropout_gnn=0.2, dropout_attn=0.2)
    train = setup["train"]
    batches = [{k: v[a:b] for k, v in train.items()}
               for a, b in ((0, 16), (16, 32), (32, 43))]
    out = []
    for program in (False, True):
        params = params_mod.params_from_numpy(setup["init"], "cpu")
        opt = optim.make_optimizer(cfg, steps_per_epoch=2)
        state = step.init_state(params, opt)
        if program:
            fn = step.make_train_step(cfg, SPEC, setup["graphs"], opt, "cpu")
            assert isinstance(fn, step.StepProgram)
        else:
            fn = step._mesh_step(cfg, SPEC, setup["graphs"], opt,
                                 torch.device("cpu"), mesh=None)
        auxes = []
        for b in batches:
            state, aux = fn(state, b)
            auxes.append(torch.stack([aux[k] for k in step.AUX_KEYS]))
        moments = [state.opt_state.adamw.state[p][k]
                   for p in state.opt_state.leaves
                   for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq",
                             "step")]
        out.append((step.param_leaves(state.params), moments, auxes))
    for a, b in zip(*out):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_capture_true_raises_off_one_card(setup):
    opt = optim.make_optimizer(CFG, steps_per_epoch=2)
    with pytest.raises(ValueError, match="CPU"):
        step.make_train_step(CFG, SPEC, setup["graphs"], opt, "cpu",
                             capture=True)
    with pytest.raises(ValueError, match="CPU"):
        ranker.make_eval_fns(CFG, SPEC, setup["graphs"], "cpu", capture=True)
    with pytest.raises(ValueError, match="mesh"):
        capture.resolve(True, torch.device("cuda"), mesh=object())
    with pytest.raises(ValueError, match="debug_nans"):
        capture.resolve(True, torch.device("cuda"), debug_nans=True)
    assert capture.resolve(None, torch.device("cuda"), mesh=object())[0] is \
        False
    assert capture.resolve(None, torch.device("cuda"))[0] is True
    fn = step.make_train_step(CFG, SPEC, setup["graphs"], opt, "cpu")
    assert fn.mode.startswith("eager")


def test_plain_versions_stand_in_for_every_wrapper():
    from c2dsr_tpu_torch.bench import gates
    kernels = [getattr(mod, name) for mod, name in wrappers.WRAPPERS]
    assert wrappers.kernels_routed()
    with gates.plain_versions():
        assert not wrappers.kernels_routed()
        assert all(getattr(mod, name) is not f for (mod, name), f
                   in zip(wrappers.WRAPPERS, kernels))
    assert wrappers.kernels_routed()
    assert [getattr(mod, name) for mod, name in wrappers.WRAPPERS] == kernels


def test_rank_program_copies_each_set_of_tables_once(setup):
    """The rank program (run eagerly here) ranks against its static copy of
    the tables: a call with the tables it copied last copies nothing, one
    with new tables copies them."""
    params = params_mod.params_from_numpy(setup["init"], "cpu")
    convolve, _ = ranker.make_eval_fns(CFG, SPEC, setup["graphs"], "cpu")
    rank = ranker._rank_program(CFG, SPEC, torch.device("cpu"),
                                strategy.LocalOps(cfg=CFG), capture=False)
    ev = preprocess.preprocess_evaluate(
        synthetic.generate_sequences(SPEC, 80, seed=2), SPEC,
        n_neg_sample=20, seed=3)
    batch = {k: v[:16] for k, v in ranker.partition_by_domain(ev)["a"]
             .items()}
    hi = convolve(params)
    first = rank(params, hi, batch, "a", "full")
    # the same tables again: the static copy is what is ranked against
    with torch.inference_mode():
        for t in hi:
            t.mul_(-1.0)
    assert torch.equal(rank(params, hi, batch, "a", "full"), first)
    # new tables: copied
    fresh = c2dsr.Propagated(*(t.clone() for t in hi))
    again = ranker.make_eval_fns(CFG, SPEC, setup["graphs"], "cpu")[1](
        params, fresh, batch, "a", "full")
    assert torch.equal(rank(params, fresh, batch, "a", "full"), again)
    assert not torch.equal(again, first)
