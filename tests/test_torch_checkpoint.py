"""The port's checkpoints (``c2dsr_tpu_torch/checkpoint.py``) and resume.

The same contract as the JAX package's (``tests/test_checkpoint.py``):
  * an exact round-trip of the params, the AdamW moments (``max_exp_avg_sq``
    too), the schedule and the step, and a bitwise-identical next step
    after a restore, at dropout 0 and at the JAX test's dropout of 0.2: a
    step's dropout seed follows (``cfg.seed + 1``, ``state.step``), and the
    step count is in the checkpoint;
  * ``Experiment(resume=True)`` restores the state and the best-validation
    bookkeeping and continues at the next epoch; with ``resume`` off a
    checkpoint is ignored;
  * ``save`` returns before the disk write, and saves alternate between
    ``state0`` and ``state1``;
  * a process killed during a commit leaves the previous checkpoint and its
    meta intact;
  * a commit that raises leaves ``meta.json`` pointing at the previous,
    complete checkpoint: its meta is dropped, never written.
"""

import os
import subprocess
import sys
import threading

import pytest
import torch

from c2dsr_tpu_torch import checkpoint as ckpt_mod
from c2dsr_tpu_torch.config import Config, DataSpec
from c2dsr_tpu_torch.data import preprocess, synthetic
from c2dsr_tpu_torch.evaluate import ranker
from c2dsr_tpu_torch.graph import build
from c2dsr_tpu_torch.model import c2dsr
from c2dsr_tpu_torch.ops import dropout as drop
from c2dsr_tpu_torch.ops import spmm
from c2dsr_tpu_torch.train import step
from c2dsr_tpu_torch.train.loop import Experiment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = DataSpec(n_item_a=50, n_item_b=70, len_max=15)
CFG = Config(d_latent=32, batch_size=32, batch_size_eval=64, len_rec=5,
             n_neg_sample=20, vocab_pad_multiple=64, dropout_gnn=0.0,
             dropout_attn=0.0)
DROP_CFG = CFG.with_(dropout_gnn=0.2, dropout_attn=0.2)


@pytest.fixture(scope="module")
def setup():
    seqs = synthetic.generate_sequences(SPEC, 200, seed=1)
    train = preprocess.preprocess_train(seqs, SPEC, seed=1)
    val = preprocess.preprocess_evaluate(
        synthetic.generate_sequences(SPEC, 60, seed=2), SPEC,
        n_neg_sample=20, seed=2)
    gs, gp = build.build_graphs(seqs, SPEC)
    graphs = c2dsr.Graphs(spmm.device_graph(gs, "cpu"),
                          spmm.device_graph(gp, "cpu"))
    return train, val, graphs


def _exp(setup, cfg=CFG, path=None):
    train, val, graphs = setup
    return Experiment(cfg, SPEC, graphs, train, val, val, ckpt_path=path,
                      device="cpu")


def _state_equal(a, b):
    for x, y in zip(step.param_leaves(a.params), step.param_leaves(b.params)):
        assert torch.equal(x, y)
    sa = a.opt_state.adamw.state_dict()
    sb = b.opt_state.adamw.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys() and sa["state"]
    for k in sa["state"]:
        for name in ("step", "exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
            assert torch.equal(sa["state"][k][name], sb["state"][k][name])
    assert (a.opt_state.schedule.state_dict()
            == b.opt_state.schedule.state_dict())
    assert a.step == b.step


def test_state_roundtrip_and_identical_next_step(setup, tmp_path):
    path = str(tmp_path / "ckpt")
    exp1 = _exp(setup, path=path)
    exp1.run_train_epoch()
    ckpt_mod.save(path, exp1.state, meta={"epoch": 1, "imp_val_best": 0.25,
                                          "res_test": [0.1] * 13,
                                          "es_counter": 2})
    exp2 = _exp(setup, CFG.with_(resume=True), path)
    _state_equal(exp1.state, exp2.state)
    assert exp2.state.step == exp1.state.step > 0
    assert exp2._start_epoch == 1
    assert exp2._best == {"imp_val_best": 0.25, "res_test": [0.1] * 13,
                          "es_counter": 2}
    # the optimizer stays bound to the restored tensors
    bound = exp2.state.opt_state.adamw.param_groups[0]["params"]
    assert all(p is t for p, t in zip(bound,
                                      step.param_leaves(exp2.state.params)))

    batch = {k: v[:16] for k, v in setup[0].items()}
    s1, aux1 = exp1.train_step(exp1.state, batch)
    s2, aux2 = exp2.train_step(exp2.state, batch)
    assert float(aux1["loss"]) == float(aux2["loss"])
    _state_equal(s1, s2)


def test_resumed_step_at_dropout_equals_uninterrupted_step(setup, tmp_path):
    """tests/test_checkpoint.py:45-69 of the JAX package at its dropout of
    0.2 (GNN and towers): after a restore the next step draws the
    uninterrupted run's dropout, so loss and state agree bitwise; the seed
    of step 0, which a replayed stream would draw, gives another loss."""
    path = str(tmp_path / "ckpt")
    exp1 = _exp(setup, DROP_CFG, path)
    exp1.run_train_epoch()
    ckpt_mod.save(path, exp1.state, meta={"epoch": 1})
    exp2 = _exp(setup, DROP_CFG.with_(resume=True), path)
    _state_equal(exp1.state, exp2.state)
    assert exp2.state.step == exp1.state.step > 0

    batch = {k: v[:16] for k, v in setup[0].items()}
    b = ranker.to_device(batch, "cpu")
    with torch.no_grad():
        replayed = float(step.loss_fn(
            exp2.state.params, exp2.graphs, b,
            drop.step_seed(DROP_CFG.seed + 1, 0), DROP_CFG, SPEC)[0])
    s1, aux1 = exp1.train_step(exp1.state, batch)
    s2, aux2 = exp2.train_step(exp2.state, batch)
    assert float(aux1["loss"]) == float(aux2["loss"])
    assert float(aux2["loss"]) != replayed
    _state_equal(s1, s2)


def test_consecutive_steps_draw_different_seeds(setup, monkeypatch):
    """Each step's dropout seed is step_seed(cfg.seed + 1, state.step): two
    consecutive steps draw different seeds, below 2^31, and the same steps
    of another run draw the same ones."""
    seen = []
    real = step.loss_fn

    def spy(params, graphs, batch, seed, *args, **kw):
        seen.append(seed)
        return real(params, graphs, batch, seed, *args, **kw)

    monkeypatch.setattr(step, "loss_fn", spy)
    batch = {k: v[:16] for k, v in setup[0].items()}
    for _ in range(2):
        exp = _exp(setup, DROP_CFG)
        state = exp.state
        for _ in range(3):
            state, _ = exp.train_step(state, batch)
    want = [drop.step_seed(DROP_CFG.seed + 1, i) for i in range(3)]
    assert seen == want + want
    assert len(set(want)) == 3 and all(0 <= s < 2 ** 31 for s in want)


def test_resume_flag_off_ignores_checkpoint(setup, tmp_path):
    path = str(tmp_path / "ckpt")
    exp1 = _exp(setup, path=path)
    exp1.run_train_epoch()
    ckpt_mod.save(path, exp1.state, meta={"epoch": 3})
    exp2 = _exp(setup, path=path)
    assert exp2._start_epoch == 0
    assert exp2.state.step == 0


def test_run_saves_on_best_and_resumes_epoch_count(setup, tmp_path):
    path = str(tmp_path / "ckpt")
    exp1 = _exp(setup, CFG.with_(n_epoch=1), path)
    out1 = exp1.run()
    assert ckpt_mod.exists(path)
    meta = ckpt_mod.load_meta(path)
    assert meta["epoch"] == 1 and meta["state_dir"] == "state0"
    assert meta["imp_val_best"] == pytest.approx(out1["imp_val_best"])

    exp2 = _exp(setup, CFG.with_(n_epoch=2, resume=True), path)
    assert exp2.state.step == exp1.state.step
    out2 = exp2.run()
    assert out2["epoch"] == 2
    assert out2["imp_val_best"] >= out1["imp_val_best"]


@pytest.fixture
def held_save(monkeypatch):
    """torch.save held until the returned event is set."""
    release = threading.Event()
    real = torch.save

    def held(obj, f, *a, **kw):
        assert release.wait(timeout=60)
        return real(obj, f, *a, **kw)

    monkeypatch.setattr(torch, "save", held)
    return release


def test_save_returns_before_write_and_alternates(setup, tmp_path,
                                                  held_save):
    path = str(tmp_path / "ckpt")
    exp = _exp(setup)
    ckpt_mod.save(path, exp.state, meta={"epoch": 1})
    # returned while the write is held: nothing on disk, no meta yet
    assert not os.path.exists(os.path.join(path, "state0", "state.pt"))
    assert ckpt_mod.load_meta(path, _wait=False) == {}
    held_save.set()
    dirs = []
    for epoch in (2, 3):
        ckpt_mod.save(path, exp.state, meta={"epoch": epoch})
        dirs.append(ckpt_mod.load_meta(path, _wait=False)["state_dir"])
    ckpt_mod.wait()
    assert dirs == ["state0", "state1"]
    assert ckpt_mod.load_meta(path) == {"epoch": 3, "state_dir": "state0"}
    assert sorted(os.listdir(path)) == ["meta.json", "state0", "state1"]


_CRASH = """
import os, sys, torch
from c2dsr_tpu_torch import checkpoint as ckpt_mod
from c2dsr_tpu_torch.config import Config
from c2dsr_tpu_torch.train import optim, step
path = sys.argv[1]
params = {"w": torch.ones(4, 3), "b": torch.zeros(3)}
opt = optim.make_optimizer(Config(), steps_per_epoch=1)
state = step.init_state(params, opt)
ckpt_mod.save(path, state, meta={"epoch": 1}, block=True)
with torch.no_grad():
    params["w"].fill_(2.0)
torch.save = lambda *a, **k: os._exit(3)       # killed during the commit
ckpt_mod.save(path, state, meta={"epoch": 2})
ckpt_mod.wait()
"""


def test_killed_commit_keeps_previous_checkpoint(tmp_path):
    path = str(tmp_path / "ckpt")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-c", _CRASH, path], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 3, run.stderr
    assert ckpt_mod.load_meta(path) == {"epoch": 1, "state_dir": "state0"}
    snap = ckpt_mod.restore(path)
    assert torch.equal(snap["params"]["w"], torch.ones(4, 3))


def test_failed_commit_keeps_previous_meta(setup, tmp_path, monkeypatch):
    path = str(tmp_path / "ckpt")
    exp = _exp(setup)
    ckpt_mod.save(path, exp.state, meta={"epoch": 1}, block=True)
    first = ckpt_mod.restore(path)

    def fail(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", fail)
    exp.run_train_epoch()
    ckpt_mod.save(path, exp.state, meta={"epoch": 2})
    with pytest.raises(OSError, match="disk full"):
        ckpt_mod.wait()
    ckpt_mod.wait()                       # the failed meta is gone for good
    assert ckpt_mod.load_meta(path) == {"epoch": 1, "state_dir": "state0"}
    again = ckpt_mod.restore(path)
    for a, b in zip(step.param_leaves(first["params"]),
                    step.param_leaves(again["params"])):
        assert torch.equal(a, b)
