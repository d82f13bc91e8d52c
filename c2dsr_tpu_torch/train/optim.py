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
SURVEY.md quirk 7) is ``clip_grad_norm_``; over model-sharded parameters
(``parallel/mesh.py``) the global norm sums each sharded parameter's
squares over the model group once and counts each replicated one once, as
the JAX chain's norm over the global arrays does.  Quirk 11
(``bug_epoch_grad_accum``): the reference zeroes gradients once per EPOCH
(trainer.py:42) but steps every batch, so each step consumes the running sum
of the epoch's batch gradients; here the step then does not zero the
gradients, and :meth:`Optimizer.reset_grad_accum` zeroes them at an epoch
boundary.  Clipping then scales a copy, as the JAX chain clips its output
and keeps the unclipped sum.

On the card the AdamW is capturable (``capturable=True``): its step
count and bias corrections live on the device, and the learning rate is a
device scalar that the schedule fills in place, so a CUDA graph of the
step (``capture.py``) replays each step's update, where a float lr and a
host step count would replay step k's forever.  The captured step keeps
static gradients (:meth:`Optimizer.bind_static_grads`): allocated once,
zeroed in place, and filled by the backward in place.  The checkpoint
holds the CPU optimizer's format either way (:func:`state_dict`,
:func:`load_state`).  On the card the update is torch's fused AdamW,
capturable: bitwise across capture, and faster inside the captured step
than the capturable foreach one (PERF.md).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from c2dsr_tpu_torch.config import Config
from c2dsr_tpu_torch.parallel import comm


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
    sharded: Optional[List[bool]] = None   # leaves sharded over `group`
    group: comm.Group = comm.SELF
    # the device lr the schedule fills (the capturable AdamW's), else None
    lr: Optional[torch.Tensor] = None
    # the gradients are static (bind_static_grads): zeroed in place
    static_grads: bool = False
    # bumped when the state's tensors are replaced (load_state): a program
    # captured over the old ones must be rebuilt
    generation: int = 0


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The settings of the optimizer (the counterpart of the optax chain);
    :meth:`init` binds it to a parameter set."""

    cfg: Config
    steps_per_epoch: int

    def init(self, leaves: List[torch.Tensor],
             sharded: Optional[List[bool]] = None,
             group: comm.Group = comm.SELF) -> OptState:
        """Bind to ``leaves``; ``sharded`` marks those whose shards lie
        across the model ``group`` (for the clipping's global norm).  On
        the card: the fused, capturable AdamW with a device lr."""
        cfg = self.cfg
        on_card = leaves[0].is_cuda
        kw = {"capturable": True, "fused": True} if on_card else {}
        adamw = torch.optim.AdamW(leaves, lr=cfg.lr, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=cfg.l2, amsgrad=True,
                                  **kw)
        # the schedule's base lr stays a float: it fills the device lr with
        # base * factor, computed on the host, with no sync
        schedule = torch.optim.lr_scheduler.LambdaLR(
            adamw, lambda s: step_lr_factor(s, cfg.lr_gamma, cfg.lr_step,
                                            self.steps_per_epoch))
        lr = None
        if on_card:
            lr = torch.tensor(adamw.param_groups[0]["lr"],
                              dtype=torch.float32, device=leaves[0].device)
            adamw.param_groups[0]["lr"] = lr
        return OptState(list(leaves), adamw, schedule, sharded, group, lr)

    def prepare(self, state: OptState) -> None:
        """Before a step's backward: fresh gradients, unless they run over
        the epoch (``bug_epoch_grad_accum``)."""
        if not self.cfg.bug_epoch_grad_accum:
            self.reset_grad_accum(state)

    @staticmethod
    def reset_grad_accum(state: OptState) -> None:
        """Zero every gradient (the reference's per-epoch zero_grad): in
        place where they are static."""
        if state.static_grads:
            torch._foreach_zero_([p.grad for p in state.leaves])
            return
        for p in state.leaves:
            p.grad = None

    @staticmethod
    def bind_static_grads(state: OptState) -> None:
        """Give every leaf a gradient of its own, allocated once, that the
        captured step zeroes and the backward fills in place (autograd adds
        into an existing ``.grad``): a graph writes the same memory on every
        replay, and the full and ragged batches' graphs share it."""
        for p in state.leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state.static_grads = True

    def apply_static(self, state: OptState) -> None:
        """One update from the static gradients, with nothing that leaves
        the card (capturable); the schedule steps after, outside the
        graph.  With clipping under ``bug_epoch_grad_accum`` the running
        sum is copied back after the update."""
        saved = None
        if self.cfg.apply_grad_clip and self.cfg.max_grad_norm > 0:
            grads = [p.grad for p in state.leaves]
            if self.cfg.bug_epoch_grad_accum:
                saved = [g.clone() for g in grads]
            torch.nn.utils.clip_grad_norm_(state.leaves,
                                           self.cfg.max_grad_norm)
        state.adamw.step()
        if saved is not None:
            torch._foreach_copy_([p.grad for p in state.leaves], saved)

    def apply(self, state: OptState) -> None:
        """One update from the gradients in ``.grad``, then the schedule."""
        for p in state.leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        saved = None
        if self.cfg.apply_grad_clip and self.cfg.max_grad_norm > 0:
            if self.cfg.bug_epoch_grad_accum:
                saved = [p.grad.clone() for p in state.leaves]
            if state.sharded is None:
                torch.nn.utils.clip_grad_norm_(state.leaves,
                                               self.cfg.max_grad_norm)
            else:
                _clip_sharded(state, self.cfg.max_grad_norm)
        state.adamw.step()
        state.schedule.step()
        if saved is not None:
            for p, g in zip(state.leaves, saved):
                p.grad = g


def _clip_sharded(state: OptState, max_norm: float) -> None:
    """``clip_grad_norm_`` over the global parameters, from shards."""
    sq = [p.grad.detach().float().square().sum() for p in state.leaves]
    own = torch.stack([s for s, sh in zip(sq, state.sharded) if sh]).sum()
    rep = torch.stack([s for s, sh in zip(sq, state.sharded) if not sh]).sum()
    total = torch.sqrt(comm.sum_(own, state.group) + rep)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p in state.leaves:
        p.grad.detach().mul_(coef.to(p.grad.dtype))


def state_dict(state: OptState) -> dict:
    """The AdamW's state dict in the CPU optimizer's format, wherever it
    runs: a float lr, ``capturable`` and ``fused`` off (tensors stay where
    they are; the checkpoint moves them to the host)."""
    sd = state.adamw.state_dict()
    groups = []
    for g in sd["param_groups"]:
        g = dict(g)
        if isinstance(g["lr"], torch.Tensor):
            g["lr"] = float(g["lr"])
        g["capturable"] = False
        g["fused"] = None
        g["foreach"] = None
        groups.append(g)
    return {"state": sd["state"], "param_groups": groups}


def load_state(state: OptState, adamw_sd: dict, schedule_sd: dict) -> None:
    """Load a saved AdamW and schedule into ``state``'s optimizer, keeping
    its own settings (on the card: capturable, the device lr, which takes
    the saved value, and each step count on the card).  The moments are new
    tensors, so ``state.generation`` moves on."""
    groups = state.adamw.param_groups
    own = [{k: g[k] for k in ("capturable", "foreach", "fused") if k in g}
           for g in groups]
    state.adamw.load_state_dict(adamw_sd)
    for g, keep in zip(state.adamw.param_groups, own):
        g.update(keep)
        if state.lr is not None:
            state.lr.fill_(float(g["lr"]))
            g["lr"] = state.lr
    if state.lr is not None:
        for p in state.leaves:
            st = state.adamw.state.get(p)
            if st and "step" in st:
                st["step"] = st["step"].to(device=p.device,
                                           dtype=torch.float32)
    state.schedule.load_state_dict(schedule_sd)
    state.generation += 1


def make_optimizer(cfg: Config, steps_per_epoch: int) -> Optimizer:
    return Optimizer(cfg=cfg, steps_per_epoch=steps_per_epoch)
