"""The port's optimizer (``train/optim.py``: torch AdamW(amsgrad) with
StepLR by epoch) held against the JAX package's optax chain
(``c2dsr_tpu.train.optim.make_optimizer``): the same gradients, fed as
numpy to both, for 4 steps across a StepLR boundary (2 steps an epoch,
lr_step 1), with and without the per-epoch gradient accumulation of the
reference (reset at the epoch boundary) and gradient clipping.  Parameters
agree to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from c2dsr_tpu.config import Config as JConfig
from c2dsr_tpu.train import optim as joptim
from c2dsr_tpu_torch.config import Config
from c2dsr_tpu_torch.train import optim

SHAPES = {"a": (4, 3), "b": (7,), "c": (2, 2, 2)}
STEPS, PER_EPOCH = 4, 2


def _params():
    rng = np.random.default_rng(0)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    return [{k: (rng.normal(size=s) * scale * 10 ** rng.uniform(-1, 1))
             .astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(STEPS)]


@pytest.mark.parametrize("accum", [False, True])
@pytest.mark.parametrize("clip", [False, True])
def test_optimizer_matches_optax_chain(accum, clip):
    kw = dict(lr=1e-2, l2=5e-4, lr_gamma=0.5, lr_step=1,
              bug_epoch_grad_accum=accum, apply_grad_clip=clip,
              max_grad_norm=1.0)
    grads = _grads(seed=int(accum) + 2 * int(clip), scale=3.0 if clip else 1.0)

    jopt = joptim.make_optimizer(JConfig(**kw), PER_EPOCH)
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    jstate = jopt.init(jp)

    names = sorted(SHAPES)
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in _params().items()}
    opt = optim.make_optimizer(Config(**kw), PER_EPOCH)
    state = opt.init([tp[k] for k in names])

    for i, g in enumerate(grads):
        if i % PER_EPOCH == 0 and i:
            jstate = joptim.reset_grad_accum(jstate)
            opt.reset_grad_accum(state)
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                  jstate, jp)
        jp = optax.apply_updates(jp, upd)

        opt.prepare(state)
        for k in names:                  # what backward() would leave
            gt = torch.from_numpy(g[k])
            tp[k].grad = gt if tp[k].grad is None else tp[k].grad + gt
        opt.apply(state)
        for k in names:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    # the schedule crossed its boundary: lr halved after 2 steps
    assert state.adamw.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.25)


def test_step_lr_factor_matches_jax_schedule():
    sched = joptim.step_lr_schedule(1.0, 0.5, 3, 4)
    for s in range(40):
        assert optim.step_lr_factor(s, 0.5, 3, 4) == pytest.approx(
            float(sched(jnp.int32(s))))


def test_parameter_without_gradient_still_decays():
    """optax decays every leaf; torch skips a parameter whose grad is None,
    so the port gives it a zero gradient."""
    p = torch.ones(3, requires_grad=True)
    q = torch.ones(2, requires_grad=True)
    opt = optim.make_optimizer(Config(lr=0.1, l2=0.5), 10)
    state = opt.init([p, q])
    opt.prepare(state)
    p.grad = torch.ones(3)
    opt.apply(state)
    torch.testing.assert_close(q.detach(), torch.full((2,), 1 - 0.1 * 0.5))
