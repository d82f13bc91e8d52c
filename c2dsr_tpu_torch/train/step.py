"""Training step: the exact 6-term loss of the reference, forward,
``backward()`` and an optimizer step.

The counterpart of ``c2dsr_tpu/train/step.py:36-197``.  Loss structure
(trainer.py:91-160):
  infomax (4 BCE terms, trainer.py:96-119):
      sim_a_pos = D_a(mean_a(hx),        mean_b(h_share))
      sim_a_neg = D_a(mean_a(hx),        mean_a(share_tower(corrupt_a)))
      sim_b_pos = D_b(mean_b(hy),        mean_a(h_share))
      sim_b_neg = D_b(mean_b(hy),        mean_b(share_tower(corrupt_b)))
  recommendation (last len_rec positions, trainer.py:122-154):
      loss_share_a/b : CE(cat(cls_dom(h_share), cls_pad(h_share))),
                       count-reweighted by n_valid/(len_rec*B)
      loss_a/b       : CE(cat(cls_dom(h_share+h_dom), cls_pad(h_dom)))
  total = lambda * rec + (1-lambda) * infomax   (trainer.py:156)

The graph propagation runs inside the step, with dropout, as in
trainer.py:48.  On the card every kernel of the path runs forward and
backward: the CSR SpMM (over A and Aᵀ), the fused tower (forward and
backward, dropout in the kernels) and the fused CE (K4, K5).  With
``batch_sparse_gnn`` the last hop of each propagation is the batch-sparse
SpMM (K6), flagged by the rows the step looks up (:func:`row_flags`).  On
the CPU the same code runs their plain versions under autograd.

Dropout comes from one seed a step, a fixed hash of (``cfg.seed + 1``,
``state.step``) (``ops/dropout.step_seed``): the GNN's masks from a device
generator seeded with it, the towers' from the counter-based hash of
``ops/dropout.py``.  The step count is in the checkpoint, so a resumed run
draws what an uninterrupted one draws, as the JAX package's
``fold_in(base_rng, state.step)`` does.

On a mesh (``make_train_step(..., mesh=...)``, ``parallel/mesh.py``) each
rank runs this step on its rows of the global batch, through the strategy
of ``parallel/strategy.make_ops``.  What GSPMD gives the JAX step, the port
does by hand, and gets wrong by default:

* the loss's normalisers (the example count, each CE's valid count, the
  BCE means) are global, so each is summed over the data group before it
  divides: per-rank means averaged give another gradient whenever the
  ranks' valid counts differ.  A rank's loss is then its share of the
  global loss, and the gradients of every parameter are summed over the
  data group after the backward (the model group needs none: the
  collectives' transposes, ``parallel/comm.py``, already sum where ranks
  use a replicated value each in its own way);
* the towers' dropout masks are a hash of the element's index within one
  tower call, so every data rank would draw the same masks for its local
  row i: the row map (``LocalOps.dropout_rows``) indexes them in the global
  batch, so they are the one-process step's;
* the GNN dropout's generator is seeded per model shard and alike on the
  data replicas of a shard (``dropout_generator``), so that the replicated
  tables stay equal bit for bit.

On one card the step is one CUDA graph per batch signature (``capture.py``),
the counterpart of the JAX package's jitted step with its state donated:
:class:`StepProgram` updates the parameters and the optimizer's state in
place, in static memory.  The towers read the step's seed from a device
scalar and the GNN dropout draws from one generator registered with the
graphs, both set on the host before each replay from
``step_seed(cfg.seed + 1, step)``: the masks of a captured step are those
of the eager step.  ``make_train_step(..., capture=False)`` runs the same
program eagerly, as do the CPU and ``debug_nans`` (``capture.resolve``);
a mesh runs the step of :func:`_mesh_step`, op by op.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from c2dsr_tpu_torch import capture as capture_mod
from c2dsr_tpu_torch.config import Config, DataSpec
from c2dsr_tpu_torch.evaluate.ranker import to_device
from c2dsr_tpu_torch.model import c2dsr
from c2dsr_tpu_torch.ops import backend, losses
from c2dsr_tpu_torch.ops import dropout as drop
from c2dsr_tpu_torch.parallel import comm, strategy
from c2dsr_tpu_torch.train import optim


class TrainState(NamedTuple):
    params: Any
    opt_state: optim.OptState
    step: int


def param_leaves(params) -> List[torch.Tensor]:
    """Every tensor of a (nested dict) parameter tree, in a fixed order."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in param_leaves(params[k])]
    return [params]


def init_state(params, optimizer: optim.Optimizer, mesh=None) -> TrainState:
    """Marks every parameter as requiring grad and binds the optimizer; on a
    ``mesh``, ``params`` are this rank's shards, and the gradient clipping's
    global norm counts each sharded parameter over the model group."""
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    if mesh is None or mesh.n_model == 1:
        return TrainState(params, optimizer.init(leaves), 0)
    from c2dsr_tpu_torch.parallel import mesh as mesh_mod
    sharded = [mesh_mod.shard_dim(n) is not None
               for n in mesh_mod.leaf_names(params)]
    return TrainState(params, optimizer.init(leaves, sharded,
                                             mesh.model_group), 0)


def _pool_mask(gt_mask: torch.Tensor) -> torch.Tensor:
    """gt_mask [B, L] 0/1 -> per-row mean weights (trainer.py:85-89)."""
    m = gt_mask.float()
    return m / torch.clamp(m.sum(dim=-1, keepdim=True), min=1.0)


def row_flags(seq_share3: torch.Tensor, seq_a: torch.Tensor,
              seq_b: torch.Tensor, n_rows: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flag_share, flag_ab): uint8 [n_rows] markers of the table rows that
    ``forward_joint`` looks up from these id arrays: ``seq_share3`` (the
    positive and the two corrupted sequences) in the shared table,
    ``seq_a`` and ``seq_b`` in the A|B table.  The pad id is marked as any
    other.  Built on the ids' device with no host sync."""
    def flag(*id_arrays):
        f = torch.zeros(n_rows, dtype=torch.uint8,
                        device=id_arrays[0].device)
        for ids in id_arrays:
            f.index_fill_(0, ids.reshape(-1), 1)
        return f
    return flag(seq_share3), flag(seq_a, seq_b)


def loss_fn(params, graphs: c2dsr.Graphs, batch: Dict[str, torch.Tensor],
            seed, cfg: Config, spec: DataSpec, pops=None,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, aux) of one batch of device tensors; seed=None runs without
    dropout (eval mode), else the step's dropout comes from ``seed``: an
    int, or a 0-d int32 device tensor (``ops/dropout.seed_tensor``) with the
    GNN dropout's ``generator``, seeded by the caller with the same seed
    (else the strategy's ``dropout_generator(seed)``)."""
    pops = pops or strategy.LocalOps(cfg=cfg)
    B = batch["seq_share"].shape[0]
    device = batch["seq_share"].device
    # the normalisers' totals over the data group (None: one process)
    count = pops.data_sum if pops.data_group.size > 1 else None
    # the shared tower runs on three sequences per example (positive + two
    # corrupted, trainer.py:97,105,108) with the same weights: one stacked
    # [3B, L] tower call
    seq_share3 = torch.cat([batch["seq_share"], batch["seq_share_neg_a"],
                            batch["seq_share_neg_b"]], dim=0)
    pos3 = torch.cat([batch["pos"]] * 3, dim=0)
    gen = generator
    if gen is None and seed is not None:
        gen = pops.dropout_generator(seed, device)
    # batch-sparse propagation (cfg.batch_sparse_gnn): mark the table rows
    # this step will read.  INVARIANT: the propagated tables hi are consumed
    # ONLY by c2dsr.forward_joint's lookups, so the flags are derived from
    # the SAME arrays passed to forward_joint below (seq_share3 for the
    # shared table; seq_share_a/_b for the specific table) — any new read of
    # hi must extend this flag set or it will consume unpropagated rows.
    # Marked-row values and ALL gradients are exactly the dense
    # computation's; unmarked propagated rows are never read.
    out_flags = None
    # the sharded propagation stays dense and ignores the flags (the JAX
    # package's ShardedOps does too); its tables are this rank's rows only
    if cfg.batch_sparse_gnn and not isinstance(pops, strategy.ShardedOps):
        out_flags = row_flags(seq_share3, batch["seq_share_a"],
                              batch["seq_share_b"],
                              params["embed_share"].shape[0])
    hi = c2dsr.convolve_graph(params, graphs, cfg, spec, pops, generator=gen,
                              out_flags=out_flags)
    h_share3, hx, hy = c2dsr.forward_joint(
        params, hi, seq_share3, pos3, batch["seq_share_a"],
        batch["seq_share_b"], batch["pos_a"], batch["pos_b"], cfg, spec,
        seed=seed, pops=pops, row_map=pops.dropout_rows(B))
    h_share, h_neg_a, h_neg_b = h_share3.split(B, dim=0)

    # optional example-validity mask: padded duplicate rows contribute
    # nothing (data/pipeline.py)
    valid = batch.get("valid")
    if valid is not None:
        valid = valid.float()
    n_examples = (valid.sum() if valid is not None
                  else torch.full((), float(B), device=device))
    if count is not None:
        n_examples = count(n_examples)

    mask_a = _pool_mask(batch["gt_mask_a"])[..., None]     # [B, L, 1]
    mask_b = _pool_mask(batch["gt_mask_b"])[..., None]
    hx_mean = (hx * mask_a).sum(dim=1)
    hy_mean = (hy * mask_b).sum(dim=1)
    d_a_b = params.get("D_a_b")
    d_b_b = params.get("D_b_b")
    sim_a_pos = c2dsr.discriminate(params["D_a_w"], d_a_b, hx_mean,
                                   (h_share * mask_b).sum(dim=1))
    sim_a_neg = c2dsr.discriminate(params["D_a_w"], d_a_b, hx_mean,
                                   (h_neg_a * mask_a).sum(dim=1))
    sim_b_pos = c2dsr.discriminate(params["D_b_w"], d_b_b, hy_mean,
                                   (h_share * mask_a).sum(dim=1))
    sim_b_neg = c2dsr.discriminate(params["D_b_w"], d_b_b, hy_mean,
                                   (h_neg_b * mask_b).sum(dim=1))
    loss_mi = (losses.bce_with_logits(sim_a_pos, True, valid, count)
               + losses.bce_with_logits(sim_a_neg, False, valid, count)
               + losses.bce_with_logits(sim_b_pos, True, valid, count)
               + losses.bce_with_logits(sim_b_neg, False, valid, count))

    # --- recommendation loss over the last len_rec positions ---------------
    R = cfg.len_rec
    hs = h_share[:, -R:, :]
    ha = hx[:, -R:, :]
    hb = hy[:, -R:, :]
    gt_share_a = batch["gt_share_a"][:, -R:]
    gt_share_b = batch["gt_share_b"][:, -R:]
    gt_a = batch["gt_a"][:, -R:]
    gt_b = batch["gt_b"][:, -R:]
    na, nb = spec.n_item_a, spec.n_item_b
    if valid is not None:
        # padded rows' targets become the ignore index
        vb = valid[:, None] > 0
        gt_share_a = torch.where(vb, gt_share_a, na)
        gt_share_b = torch.where(vb, gt_share_b, nb)
        gt_a = torch.where(vb, gt_a, na)
        gt_b = torch.where(vb, gt_b, nb)

    def domain_ce(w_key, b_key, h_dom, gt_share, gt_dom, n_real):
        """Both CE terms of one domain in one pass over the classifier: rows
        [hs | hs + h_dom] (trainer.py:131-152)."""
        h_cat = torch.cat([hs, hs + h_dom], dim=1)             # [B, 2R, d]
        pad_cat = torch.cat([c2dsr.classify_pad(params, hs),
                             c2dsr.classify_pad(params, h_dom)], dim=1)
        tgt_cat = torch.cat([gt_share, gt_dom], dim=1)
        rows = pops.ce_rows(h_cat, params[w_key], params[b_key], pad_cat,
                            tgt_cat, n_real)
        l_share, n_share = losses.ce_mean_from_rows(rows[:, :R], gt_share,
                                                    n_real, count)
        l_dom, _ = losses.ce_mean_from_rows(rows[:, R:], gt_dom, n_real,
                                            count)
        return l_share, n_share, l_dom

    l_share_a, n_share_a, l_a = domain_ce("cls_a_w", "cls_a_b", ha,
                                          gt_share_a, gt_a, na)
    l_share_b, n_share_b, l_b = domain_ce("cls_b_w", "cls_b_b", hb,
                                          gt_share_b, gt_b, nb)
    denom = float(R) * n_examples
    loss_share = (l_share_a * n_share_a / denom
                  + l_share_b * n_share_b / denom)
    loss_rec = loss_share + l_a + l_b
    loss = cfg.lambda_loss * loss_rec + (1.0 - cfg.lambda_loss) * loss_mi
    aux = {"loss": loss, "loss_rec": loss_rec, "loss_mi": loss_mi,
           "n_examples": n_examples}
    return loss, aux


def sum_grads(leaves: List[torch.Tensor], group) -> None:
    """Sum every leaf's gradient over ``group`` (the data group), in one
    flat all_reduce; a leaf with no gradient gets a zero one first."""
    if group.size == 1:
        return
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = comm.sum_(torch.cat([p.grad.reshape(-1) for p in leaves]), group)
    at = 0
    for p in leaves:
        p.grad.copy_(flat[at:at + p.numel()].view_as(p))
        at += p.numel()


AUX_KEYS = ("loss", "loss_rec", "loss_mi", "n_examples")


def make_train_step(cfg: Config, spec: DataSpec, graphs: c2dsr.Graphs,
                    optimizer: optim.Optimizer, device="cuda", mesh=None,
                    capture: Optional[bool] = None):
    """The train step: ``train_step(state, batch) -> (state, aux)``.

    ``batch`` is a dict of numpy arrays (data/pipeline.BatchIterator): on a
    ``mesh``, this rank's rows of the global batch (``parallel/mesh.
    local_batch``), and ``state`` this rank's shards.  The step's dropout
    seed is ``ops/dropout.step_seed(cfg.seed + 1, state.step)``, computed on
    the host.  The parameters are updated in place; ``aux`` holds loss,
    loss_rec, loss_mi and n_examples as device tensors (of the global
    batch), read with no host sync.  Runs on the card unless
    ``device="cpu"``.

    ``capture`` (``capture.resolve``): one process runs a
    :class:`StepProgram`, on the card by default captured as one CUDA
    graph per batch signature, run eagerly with ``capture=False``, on the
    CPU and under ``cfg.debug_nans``; a mesh runs :func:`_mesh_step`.
    ``capture=True`` raises where no graph runs.  The returned function's
    ``mode`` says which, as the log states it."""
    device = backend.resolve_device(device)
    captured, mode = capture_mod.resolve(capture, device, mesh,
                                         cfg.debug_nans)
    if mesh is None:
        return StepProgram(cfg, spec, graphs, optimizer, device, captured,
                           mode)
    train_step = _mesh_step(cfg, spec, graphs, optimizer, device, mesh)
    train_step.mode = mode
    return train_step


def _mesh_step(cfg: Config, spec: DataSpec, graphs: c2dsr.Graphs,
               optimizer: optim.Optimizer, device: torch.device, mesh):
    """A mesh rank's step, run op by op: the gradients summed over the data
    group, the clipping's norm over the model group.  With ``mesh=None``
    it is the one-process step, which :class:`StepProgram` runs."""
    pops = strategy.make_ops(cfg, mesh)
    data = pops.data_group

    def train_step(state: TrainState, batch: Dict[str, Any]):
        b = to_device(batch, device)
        seed = drop.step_seed(cfg.seed + 1, state.step)
        gen = pops.dropout_generator(seed, device)
        optimizer.prepare(state.opt_state)
        leaves = state.opt_state.leaves
        # the gradients that run over the epoch (bug_epoch_grad_accum) are
        # summed over the data group already: only this step's are summed
        held = None
        if data.size > 1 and cfg.bug_epoch_grad_accum:
            held = [p.grad for p in leaves]
            for p in leaves:
                p.grad = None
        # on the card one device seed for the step's six tower calls
        loss, aux = loss_fn(state.params, graphs, b,
                            drop.seed_tensor(seed, device)
                            if device.type == "cuda" else seed, cfg, spec,
                            pops, generator=gen)
        loss.backward()
        sum_grads(leaves, data)
        if held is not None:
            for p, g in zip(leaves, held):
                if g is not None:
                    p.grad.add_(g)
        optimizer.apply(state.opt_state)
        aux = {k: v.detach() for k, v in aux.items()}
        for k in ("loss", "loss_rec", "loss_mi"):
            aux[k] = comm.sum_(aux[k], data)
        return TrainState(state.params, state.opt_state, state.step + 1), aux

    return train_step


class StepProgram:
    """The one-process train step as a program over static memory: on the
    card captured as one CUDA graph per batch signature
    (``capture.Program``), or run eagerly (``capture=False``, the CPU,
    ``debug_nans``), the same body either way.

    Bound to one optimizer state (its identity and ``generation``) and its
    parameters: the gradients become static (``Optimizer.
    bind_static_grads``), and a new binding (another state, or a restored
    one, ``optim.load_state``) drops the graphs, which its next calls
    rebuild.  A call stages the batch (``capture.Staging``), writes the
    step's seed into the device scalar the towers read (on the card; the
    CPU passes the int) and re-seeds the GNN dropout's generator, runs the
    body (zero the gradients, unless they run over the epoch; forward;
    backward; the capturable AdamW's update),
    then steps the schedule, which fills the device lr, all outside the
    graph.  ``aux`` is copied out of the graph's static output."""

    def __init__(self, cfg: Config, spec: DataSpec, graphs: c2dsr.Graphs,
                 optimizer: optim.Optimizer, device: torch.device,
                 capture: bool, mode: str = ""):
        self.cfg, self.spec, self.graphs = cfg, spec, graphs
        self.optimizer = optimizer
        self.device = device
        self.mode = mode
        self.pops = strategy.LocalOps(cfg=cfg)
        # the towers' seed on the card, which a graph reads; the CPU, which
        # runs no graph, passes the int
        self.seed = (torch.zeros((), dtype=torch.int32, device=device)
                     if device.type == "cuda" else None)
        self.generator = torch.Generator(device=device)
        self.program = capture_mod.Program(capture, [self.generator])
        self.staging: Dict[tuple, capture_mod.Staging] = {}
        self._bound = None
        self._grads: List[torch.Tensor] = []

    def _bind(self, state: TrainState) -> None:
        """Bind to ``state``, or rebuild where it is not the state the
        graphs were captured over (another optimizer state, a restored one,
        other params, or gradients a caller replaced)."""
        opt = state.opt_state
        bound = (id(opt), opt.generation, id(state.params))
        if bound != self._bound or any(
                p.grad is not g for p, g in zip(opt.leaves, self._grads)):
            self.program.reset()
            self.optimizer.bind_static_grads(opt)
            self._grads = [p.grad for p in opt.leaves]
            self._bound = bound

    def _body(self, params, opt: optim.OptState,
              batch: Dict[str, torch.Tensor], seed) -> torch.Tensor:
        if not self.cfg.bug_epoch_grad_accum:
            torch._foreach_zero_([p.grad for p in opt.leaves])
        loss, aux = loss_fn(params, self.graphs, batch, seed, self.cfg,
                            self.spec, self.pops, generator=self.generator)
        loss.backward()
        self.optimizer.apply_static(opt)
        return torch.stack([aux[k].detach() for k in AUX_KEYS])

    def __call__(self, state: TrainState, batch: Dict[str, Any]):
        self._bind(state)
        key = capture_mod.signature(batch)
        stage = self.staging.get(key)
        if stage is None:
            stage = self.staging[key] = capture_mod.Staging(batch,
                                                            self.device)
        b = stage(batch)
        seed = drop.step_seed(self.cfg.seed + 1, state.step)
        if self.seed is not None:
            self.seed.fill_(seed)
        self.generator.manual_seed(seed)
        opt = state.opt_state
        out, static = self.program.run(
            key, lambda: self._body(state.params, opt, b,
                                    seed if self.seed is None else self.seed))
        opt.schedule.step()
        if static:
            out = out.clone()
        aux = dict(zip(AUX_KEYS, out.unbind()))
        return TrainState(state.params, opt, state.step + 1), aux
