"""C2DSR model forward passes (plain functions over a params dict).

Mirrors models/C2DSR.py:59-85 and ``c2dsr_tpu/model/c2dsr.py``:
  * ``convolve_graph`` — three GCN propagations over the full item tables
    (shared table over adj_share; A and B tables over adj_specific, run as
    one pass over the feature-concatenated A|B table).
  * ``forward`` — (propagated + raw) embedding lookup x sqrt(d) into three
    causal self-attention towers.
  * ``forward_share`` — shared tower only.
  * ``forward_joint`` — every tower pass of one training step: the shared
    tower on the stacked positive + two corrupted sequences, then the A and
    B towers.

Training mode is asked for explicitly: ``convolve_graph`` takes a dropout
``generator`` and ``forward_joint`` a dropout ``seed``; None is eval.

Pad-row semantics: torch's ``padding_idx`` freezes the pad row at zero
(C2DSR.py:20).  Here, as in the JAX package, the pad row is masked at the
lookup.  On CUDA tensors the towers run the fused encoder kernel and the
propagation the CSR SpMM kernel (``ops/backend.py``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from c2dsr_tpu_torch.config import Config, DataSpec
from c2dsr_tpu_torch.ops import backend, spmm
from c2dsr_tpu_torch.ops import lookup as lookup_mod


class Graphs(NamedTuple):
    share: spmm.CsrDevice
    specific: spmm.CsrDevice


class Propagated(NamedTuple):
    """GCN-propagated item tables (the reference's hi_share/hi_a/hi_b)."""
    share: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor


def embedding_tables(params: Dict[str, Any], cfg: Config, spec: DataSpec
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw tables (pad-row zeroing happens at lookup sites, see _tower_pre)."""
    share = params["embed_share"]
    if cfg.shared_item_embed:
        return share, share, share
    return share, params["embed_a"], params["embed_b"]


def _local_ops(cfg: Config):
    from c2dsr_tpu_torch.parallel.strategy import LocalOps
    return LocalOps(cfg=cfg)


def convolve_graph(params: Dict[str, Any], graphs: Graphs, cfg: Config,
                   spec: DataSpec, pops=None,
                   generator: Optional[torch.Generator] = None,
                   out_flags: Optional[Tuple[torch.Tensor, torch.Tensor]]
                   = None) -> Propagated:
    """Propagate all three tables through their GCNs (C2DSR.py:59-62).

    generator=None -> eval (no dropout); else train-mode dropout drawn from
    it (a generator on the tables' device).  Differentiable in params.
    out_flags: optional (flag_share, flag_ab) uint8 row markers of the rows
    the caller will read (batch-sparse training propagation,
    ops/spmm.gcn_propagate); None -> dense (eval, full-table consumers)."""
    pops = pops or _local_ops(cfg)
    e_share, e_a, e_b = embedding_tables(params, cfg, spec)
    f_share, f_ab = out_flags if out_flags is not None else (None, None)
    hi_share = pops.spmm_propagate(graphs.share, e_share, cfg.n_gnn,
                                   cfg.dropout_gnn, generator, f_share)
    # A and B propagate through the SAME adjacency (C2DSR.py:61-62): one pass
    # over the feature-concatenated table serves both; dropout stays iid per
    # element, as two independent passes would draw it.
    e_ab = torch.cat([e_a, e_b], dim=1)
    hi_ab = pops.spmm_propagate(graphs.specific, e_ab, cfg.n_gnn,
                                cfg.dropout_gnn, generator, f_ab)
    hi_a, hi_b = hi_ab.split(e_a.shape[1], dim=1)
    return Propagated(share=hi_share, a=hi_a, b=hi_b)


def _tower_pre(seq, hi, raw_table, cfg: Config, spec: DataSpec,
               pops=None) -> torch.Tensor:
    """(propagated + raw) lookup x sqrt(d) — the encoder's input.

    The lookup is zeroed where seq == idx_pad (padding_idx semantics)."""
    pops = pops or _local_ops(cfg)
    real = (seq != spec.idx_pad)[..., None]
    zero = torch.zeros((), dtype=raw_table.dtype, device=raw_table.device)
    if cfg.bug_inverted_padding_mask:
        # reference-parity mode: the GCN-propagated row hi[pad] is looked up
        # unguarded; only the raw lookup is masked (c2dsr_tpu c2dsr.py:103-108)
        h = pops.lookup(hi, seq) + torch.where(real, pops.lookup(raw_table, seq),
                                               zero)
    else:
        # (hi + raw)[seq] elementwise equals hi[seq] + raw[seq]: the port
        # adds the looked-up rows instead of the whole tables
        h = torch.where(real, pops.lookup_add(hi, raw_table, seq), zero)
    dtype = getattr(torch, cfg.resolved_compute_dtype())
    return (h * (cfg.d_latent ** 0.5)).to(dtype)


def _encode(h, seq, pos, attn_params, cfg: Config, spec: DataSpec,
            seed: Optional[int], tower: int, row_map=None) -> torch.Tensor:
    """Positional add, then the tower (ops/backend.encode_layers); dropout
    keyed by (seed, tower) when seed is not None, its rows placed in the
    global batch by ``row_map`` (ops/dropout.py)."""
    # the positional add stays outside the fused kernel, as in JAX; the
    # position table is replicated on every rank, so its lookup is local
    x = (h + lookup_mod.lookup(attn_params["pos_emb"], pos)).contiguous()
    return backend.encode_layers(
        x, seq, attn_params, idx_pad=spec.idx_pad, n_head=cfg.n_head,
        norm_first=cfg.norm_first,
        invert_padding_mask=cfg.bug_inverted_padding_mask,
        dropout=0.0 if seed is None else cfg.dropout_attn,
        seed=seed or 0, tower=tower, row_map=row_map).to(
            torch.promote_types(x.dtype, torch.float32))


def _tower(seq, pos, hi, raw_table, attn_params, cfg: Config, spec: DataSpec,
           pops=None) -> torch.Tensor:
    """(propagated + raw) lookup x sqrt(d) -> attention tower, in eval."""
    h = _tower_pre(seq, hi, raw_table, cfg, spec, pops)
    return _encode(h, seq, pos, attn_params, cfg, spec, None, 0)


def forward(params: Dict[str, Any], hi: Propagated, seq_share, seq_a, seq_b,
            pos_share, pos_a, pos_b, cfg: Config, spec: DataSpec, pops=None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Three towers (C2DSR.py:64-77). Returns (h_share, hx, hy), [B, L, d]."""
    e_share, e_a, e_b = embedding_tables(params, cfg, spec)
    h_share = _tower(seq_share, pos_share, hi.share, e_share,
                     params["attn_share"], cfg, spec, pops)
    hx = _tower(seq_a, pos_a, hi.a, e_a, params["attn_a"], cfg, spec, pops)
    hy = _tower(seq_b, pos_b, hi.b, e_b, params["attn_b"], cfg, spec, pops)
    return h_share, hx, hy


def forward_share(params: Dict[str, Any], hi: Propagated, seq, pos,
                  cfg: Config, spec: DataSpec, pops=None) -> torch.Tensor:
    """Shared tower only (C2DSR.py:79-85)."""
    e_share, _, _ = embedding_tables(params, cfg, spec)
    return _tower(seq, pos, hi.share, e_share, params["attn_share"],
                  cfg, spec, pops)


def forward_joint(params: Dict[str, Any], hi: Propagated, seq_share3, pos3,
                  seq_a, seq_b, pos_a, pos_b, cfg: Config, spec: DataSpec,
                  seed: Optional[int] = None, pops=None, row_map=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every tower pass of one training step (c2dsr_tpu model/c2dsr.py
    forward_joint): the shared tower on ``seq_share3`` [3B, L] (positive
    plus two corrupted sequences, stacked by the caller), then the A and B
    towers.  Three tower calls, keyed 0, 1, 2 so that their dropout masks
    are independent; seed=None is eval.  ``row_map`` places a data rank's
    rows in the global batch for the dropout hash (ops/dropout.py): the
    shared tower's three stacked segments each hold the rank's rows.
    Returns (h_share3 [3B, L, d], hx [B, L, d], hy [B, L, d])."""
    e_share, e_a, e_b = embedding_tables(params, cfg, spec)
    h_s3 = _tower_pre(seq_share3, hi.share, e_share, cfg, spec, pops)
    h_a = _tower_pre(seq_a, hi.a, e_a, cfg, spec, pops)
    h_b = _tower_pre(seq_b, hi.b, e_b, cfg, spec, pops)
    return (_encode(h_s3, seq_share3, pos3, params["attn_share"], cfg, spec,
                    seed, 0, row_map),
            _encode(h_a, seq_a, pos_a, params["attn_a"], cfg, spec, seed, 1,
                    row_map),
            _encode(h_b, seq_b, pos_b, params["attn_b"], cfg, spec, seed, 2,
                    row_map))


def classify_a(params, h):
    return h @ params["cls_a_w"] + params["cls_a_b"]


def classify_b(params, h):
    return h @ params["cls_b_w"] + params["cls_b_b"]


def classify_pad(params, h):
    return h @ params["cls_pad_w"] + params["cls_pad_b"]


def discriminate(w: torch.Tensor, b: Optional[torch.Tensor], x1: torch.Tensor,
                 x2: torch.Tensor) -> torch.Tensor:
    """Bilinear discriminator x1^T W x2 (+ b) -> [B, 1] (C2DSR.py:46-55)."""
    out = ((x1 @ w) * x2).sum(dim=-1, keepdim=True)
    if b is not None:
        out = out + b
    return out
