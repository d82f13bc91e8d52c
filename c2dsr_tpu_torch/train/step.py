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

Dropout comes from one seed a step, drawn from the caller's CPU
``torch.Generator``: the GNN's masks from a device generator seeded with it,
the towers' from the counter-based hash of ``ops/dropout.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from c2dsr_tpu_torch.config import Config, DataSpec
from c2dsr_tpu_torch.evaluate.ranker import to_device
from c2dsr_tpu_torch.model import c2dsr
from c2dsr_tpu_torch.ops import backend, losses
from c2dsr_tpu_torch.parallel import strategy
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


def init_state(params, optimizer: optim.Optimizer) -> TrainState:
    """Marks every parameter as requiring grad and binds the optimizer."""
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer.init(leaves), step=0)


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
            seed: Optional[int], cfg: Config, spec: DataSpec, pops=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, aux) of one batch of device tensors; seed=None runs without
    dropout (eval mode), else the step's dropout comes from ``seed``."""
    pops = pops or strategy.LocalOps(cfg=cfg)
    B = batch["seq_share"].shape[0]
    device = batch["seq_share"].device
    # the shared tower runs on three sequences per example (positive + two
    # corrupted, trainer.py:97,105,108) with the same weights: one stacked
    # [3B, L] tower call
    seq_share3 = torch.cat([batch["seq_share"], batch["seq_share_neg_a"],
                            batch["seq_share_neg_b"]], dim=0)
    pos3 = torch.cat([batch["pos"]] * 3, dim=0)
    gen = (None if seed is None
           else torch.Generator(device=device).manual_seed(seed))
    # batch-sparse propagation (cfg.batch_sparse_gnn): mark the table rows
    # this step will read.  INVARIANT: the propagated tables hi are consumed
    # ONLY by c2dsr.forward_joint's lookups, so the flags are derived from
    # the SAME arrays passed to forward_joint below (seq_share3 for the
    # shared table; seq_share_a/_b for the specific table) — any new read of
    # hi must extend this flag set or it will consume unpropagated rows.
    # Marked-row values and ALL gradients are exactly the dense
    # computation's; unmarked propagated rows are never read.
    out_flags = None
    if cfg.batch_sparse_gnn:
        out_flags = row_flags(seq_share3, batch["seq_share_a"],
                              batch["seq_share_b"],
                              params["embed_share"].shape[0])
    hi = c2dsr.convolve_graph(params, graphs, cfg, spec, pops, generator=gen,
                              out_flags=out_flags)
    h_share3, hx, hy = c2dsr.forward_joint(
        params, hi, seq_share3, pos3, batch["seq_share_a"],
        batch["seq_share_b"], batch["pos_a"], batch["pos_b"], cfg, spec,
        seed=seed, pops=pops)
    h_share, h_neg_a, h_neg_b = h_share3.split(B, dim=0)

    # optional example-validity mask: padded duplicate rows contribute
    # nothing (data/pipeline.py)
    valid = batch.get("valid")
    if valid is not None:
        valid = valid.float()
    n_examples = (valid.sum() if valid is not None
                  else torch.tensor(float(B), device=device))

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
    loss_mi = (losses.bce_with_logits(sim_a_pos, True, valid)
               + losses.bce_with_logits(sim_a_neg, False, valid)
               + losses.bce_with_logits(sim_b_pos, True, valid)
               + losses.bce_with_logits(sim_b_neg, False, valid))

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
                                                    n_real)
        l_dom, _ = losses.ce_mean_from_rows(rows[:, R:], gt_dom, n_real)
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


def make_train_step(cfg: Config, spec: DataSpec, graphs: c2dsr.Graphs,
                    optimizer: optim.Optimizer, generator: torch.Generator,
                    device="cuda"):
    """The train step: ``train_step(state, batch) -> (state, aux)``.

    ``batch`` is a dict of numpy arrays (data/pipeline.BatchIterator);
    ``generator`` is a CPU ``torch.Generator``, from which each step draws
    its dropout seed on the host.  The parameters are updated in place;
    ``aux`` holds loss, loss_rec, loss_mi and n_examples as device tensors,
    read with no host sync.  Runs on the card unless ``device="cpu"``."""
    device = backend.resolve_device(device)
    pops = strategy.LocalOps(cfg=cfg)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        b = to_device(batch, device)
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))
        optimizer.prepare(state.opt_state)
        loss, aux = loss_fn(state.params, graphs, b, seed, cfg, spec, pops)
        loss.backward()
        optimizer.apply(state.opt_state)
        return (TrainState(state.params, state.opt_state, state.step + 1),
                {k: v.detach() for k, v in aux.items()})

    return train_step
