"""Optimizer and LR schedule of the training step.

The counterpart of ``c2dsr_tpu/train/optim.py:43-136``, which matches the
reference's AdamW(amsgrad=True, lr=1e-3, weight_decay=5e-4)
(trainer.py:21-22) and StepLR(step_size=10, gamma=0.5) stepped once per
epoch (main.py:103,115).  Here it is ``torch.optim.AdamW(amsgrad=True)``
itself, whose update is the JAX chain's ``scale_by_amsgrad_torch`` +
``add_decayed_weights`` + the LR scale: the raw second moment is maxed, and
the decay applies to the pre-update parameter.  StepLR runs by epoch, an
epoch being ``steps_per_epoch`` optimizer steps (``step_lr_schedule``).

Decoupled weight decay applies to every parameter, as the JAX chain
applies it to every leaf; a parameter that got no gradient gets a zero one,
so torch does not skip its decay.

Optional gradient clipping (``apply_grad_clip``, off in the reference,
SURVEY.md quirk 7) is ``clip_grad_norm_``.  Quirk 11
(``bug_epoch_grad_accum``): the reference zeroes gradients once per EPOCH
(trainer.py:42) but steps every batch, so each step consumes the running sum
of the epoch's batch gradients; here the step then does not zero the
gradients, and :meth:`Optimizer.reset_grad_accum` zeroes them at an epoch
boundary.  Clipping then scales a copy, as the JAX chain clips its output
and keeps the unclipped sum.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from c2dsr_tpu_torch.config import Config


def step_lr_factor(step: int, gamma: float, step_epochs: int,
                   steps_per_epoch: int) -> float:
    """torch StepLR semantics: gamma^(epoch // step_epochs), where the epoch
    advances every ``steps_per_epoch`` optimizer steps."""
    return gamma ** ((step // steps_per_epoch) // step_epochs)


@dataclasses.dataclass
class OptState:
    """The optimizer bound to one parameter set."""
    leaves: List[torch.Tensor]
    adamw: torch.optim.AdamW
    schedule: torch.optim.lr_scheduler.LambdaLR


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The settings of the optimizer (the counterpart of the optax chain);
    :meth:`init` binds it to a parameter set."""

    cfg: Config
    steps_per_epoch: int

    def init(self, leaves: List[torch.Tensor]) -> OptState:
        cfg = self.cfg
        adamw = torch.optim.AdamW(leaves, lr=cfg.lr, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=cfg.l2, amsgrad=True)
        schedule = torch.optim.lr_scheduler.LambdaLR(
            adamw, lambda s: step_lr_factor(s, cfg.lr_gamma, cfg.lr_step,
                                            self.steps_per_epoch))
        return OptState(list(leaves), adamw, schedule)

    def prepare(self, state: OptState) -> None:
        """Before a step's backward: fresh gradients, unless they run over
        the epoch (``bug_epoch_grad_accum``)."""
        if not self.cfg.bug_epoch_grad_accum:
            self.reset_grad_accum(state)

    @staticmethod
    def reset_grad_accum(state: OptState) -> None:
        """Zero every gradient (the reference's per-epoch zero_grad)."""
        for p in state.leaves:
            p.grad = None

    def apply(self, state: OptState) -> None:
        """One update from the gradients in ``.grad``, then the schedule."""
        for p in state.leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        saved = None
        if self.cfg.apply_grad_clip and self.cfg.max_grad_norm > 0:
            if self.cfg.bug_epoch_grad_accum:
                saved = [p.grad.clone() for p in state.leaves]
            torch.nn.utils.clip_grad_norm_(state.leaves, self.cfg.max_grad_norm)
        state.adamw.step()
        state.schedule.step()
        if saved is not None:
            for p, g in zip(state.leaves, saved):
                p.grad = g


def make_optimizer(cfg: Config, steps_per_epoch: int) -> Optimizer:
    return Optimizer(cfg=cfg, steps_per_epoch=steps_per_epoch)
