"""Batched ranking evaluation (the serving path of the port).

As in ``c2dsr_tpu/evaluate/ranker.py``: ranking is a batched scores matmul
plus a vectorized rank count,

  rank = #(candidate scores > gt score) + 1        (trainer.py:174,179)

under two protocols:
  * "sampled": rank against the 999 preprocessed negatives (reference
    default, dataloader.py:216-226).
  * "full": rank against the entire domain itemset.

Eval examples are partitioned by ground-truth domain on the host, so each
step computes only its domain's classifier product.  On a CUDA device the
graph propagation runs the CSR SpMM kernel and each of the three towers the
fused encoder kernel; PyTorch runs eagerly, so there is nothing to jit.

On a mesh (``parallel/mesh.py``) every rank holds the whole eval split and
ranks its data index's rows of each chunk (``evaluate_split``'s
``to_global``, ``mesh.eval_slice``: a chunk the data ranks do not divide is
padded, never cut), against the sharded classifiers where the mesh shards
them; the ranks come back gathered over the data group, the same on every
rank, as the JAX package's replicated ``out_shardings`` give them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from c2dsr_tpu_torch.config import Config, DataSpec
from c2dsr_tpu_torch.model import c2dsr
from c2dsr_tpu_torch.ops import backend


def _last_hidden(params, hi, batch, cfg, spec, domain: str, pops=None):
    h_share, hx, hy = c2dsr.forward(
        params, hi, batch["seq_share"], batch["seq_share_a"],
        batch["seq_share_b"], batch["pos"], batch["pos_a"], batch["pos_b"],
        cfg, spec, pops=pops)
    L = h_share.shape[1]
    b_idx = torch.arange(h_share.shape[0], device=h_share.device)
    # the -1 sentinel (no item of the domain) wraps to the last position,
    # matching torch negative indexing in the reference (trainer.py:172)
    if domain == "a":
        h_dom_last = hx[b_idx, batch["idx_last_a"] % L]
    else:
        h_dom_last = hy[b_idx, batch["idx_last_b"] % L]
    return h_share[:, -1, :] + h_dom_last


def _rank(params, hi, batch, cfg: Config, spec: DataSpec, domain: str,
          mode: str, pops) -> torch.Tensor:
    h = _last_hidden(params, hi, batch, cfg, spec, domain, pops)
    if domain == "a":
        w, b, n_real = params["cls_a_w"], params["cls_a_b"], spec.n_item_a
    else:
        w, b, n_real = params["cls_b_w"], params["cls_b_b"], spec.n_item_b
    gt = batch["gt_last"]
    if mode == "sampled":
        ids = torch.cat([gt[:, None], batch["list_neg"]], dim=1)
        s = pops.gather_scores(h, w, b, ids)
        return (s[:, 1:] > s[:, :1]).sum(dim=1).to(torch.int32) + 1
    if mode != "full":
        raise ValueError(f"unknown eval mode {mode!r}")
    return pops.full_rank(h, w, b, gt, n_real)


def to_device(chunk: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy eval batch as int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.int64)).to(device)
            for k, v in chunk.items()}


def make_eval_fns(cfg: Config, spec: DataSpec, graphs: c2dsr.Graphs,
                  device="cuda", mesh=None):
    """Returns (convolve_eval, rank_step).

    convolve_eval(params) -> Propagated (deterministic, once per eval phase —
    the reference also convolves once before the val loop, trainer.py:65).
    rank_step(params, hi, batch, domain, mode) -> ranks [B] int32 on the
    device; ``batch`` is a dict of numpy arrays.  On a ``mesh``, ``batch``
    is this rank's slice of a chunk (``mesh.eval_slice``) and the ranks are
    the whole chunk's, gathered over the data group."""
    from c2dsr_tpu_torch.parallel import comm, strategy
    device = backend.resolve_device(device)
    pops = strategy.make_ops(cfg, mesh)
    data = pops.data_group

    @torch.inference_mode()
    def convolve_eval(params):
        return c2dsr.convolve_graph(params, graphs, cfg, spec, pops=pops)

    @torch.inference_mode()
    def rank_step(params, hi, batch, domain: str, mode: str):
        r = _rank(params, hi, to_device(batch, device), cfg, spec, domain,
                  mode, pops)
        return comm.gather_(r, data).reshape(-1)

    return convolve_eval, rank_step


def partition_by_domain(data: Dict[str, np.ndarray]
                        ) -> Dict[str, Dict[str, np.ndarray]]:
    """Split a packed eval split into per-domain example groups."""
    xory = data["xory_last"]
    out = {}
    for name, val in (("a", 0), ("b", 1)):
        sel = xory == val
        out[name] = {k: v[sel] for k, v in data.items()}
    return out


def _batches(group: Dict[str, np.ndarray], batch_size: int):
    """Fixed-size batches; the last is padded by repeating its final row."""
    n = group["seq_share"].shape[0]
    for s in range(0, n, batch_size):
        e = min(s + batch_size, n)
        chunk = {k: v[s:e] for k, v in group.items()}
        pad = batch_size - (e - s)
        if pad:
            chunk = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                     for k, v in chunk.items()}
        yield chunk, e - s


def evaluate_split(params, hi, data: Dict[str, np.ndarray], rank_step,
                   cfg: Config, mode: str | None = None, to_global=None
                   ) -> Tuple[List[int], List[int]]:
    """Rank every eval example; returns (ranks_a, ranks_b) as Python lists,
    the exact interface of the reference's evaluate loop (trainer.py:62-71).

    ``to_global`` (a mesh): maps a chunk, which every rank holds whole, to
    what this rank ranks of it (``mesh.eval_slice``); ``rank_step`` gives
    the whole chunk's ranks back, padding last, and every example keeps its
    rank (the JAX package's ``to_global`` drops a chunk's remainder,
    ``c2dsr_tpu/train/loop.py:166-175``; this one does not)."""
    mode = mode or cfg.eval_mode
    groups = partition_by_domain(data)
    ranks = {"a": [], "b": []}
    for dom in ("a", "b"):
        for chunk, n_real in _batches(groups[dom], cfg.batch_size_eval):
            if to_global is not None:
                chunk = to_global(chunk)
            r = rank_step(params, hi, chunk, dom, mode)
            ranks[dom].extend(r[:n_real].cpu().tolist())
    return ranks["a"], ranks["b"]
