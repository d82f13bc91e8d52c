"""Loss primitives: masked large-vocab cross-entropy and BCE-with-logits.

The counterpart of ``c2dsr_tpu/ops/losses.py:59-96``.  The training step
takes its recommendation CE from ``ops/fused_ce.py``; ``rec_ce_row_losses``
is the materialised-logits form that the JAX package's XLA path computes.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def rec_ce_row_losses(dom_logits: torch.Tensor, pad_logit: torch.Tensor,
                      targets: torch.Tensor, n_real: int) -> torch.Tensor:
    """Per-position CE terms (lse - target logit) over [domain classes |
    pad class], already 0 at ignored positions (target == n_real).

    dom_logits [..., C_pad] with C_pad >= n_real (columns past n_real are
    vocab padding, masked to -1e9); pad_logit [..., 1]."""
    C_pad = dom_logits.shape[-1]
    if C_pad > n_real:
        col = torch.arange(C_pad, device=dom_logits.device)
        dom_logits = torch.where(col < n_real, dom_logits,
                                 torch.full((), -1e9,
                                            device=dom_logits.device))
    logits = torch.cat([dom_logits, pad_logit], dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    mask = (targets != n_real).to(lse.dtype)
    return (lse - tgt) * mask


def ce_mean_from_rows(rows: torch.Tensor, targets: torch.Tensor, n_real: int,
                      count_sum: Optional[Callable] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean over valid positions, n_valid) from masked per-position terms.
    ``count_sum`` totals the count over the batch's ranks (a data-parallel
    step divides its rows' sum by the global count); None: this batch's."""
    n_valid = (targets != n_real).to(torch.float32).sum()
    if count_sum is not None:
        n_valid = count_sum(n_valid)
    return rows.sum() / torch.clamp(n_valid, min=1.0), n_valid


def bce_with_logits(logits: torch.Tensor, label_is_one: bool,
                    weights: Optional[torch.Tensor] = None,
                    count_sum: Optional[Callable] = None) -> torch.Tensor:
    """Mean binary cross-entropy with logits against an all-ones or
    all-zeros label (trainer.py:113-117).  ``weights``: optional per-example
    0/1 validity [B]; the mean then runs over valid examples only.
    ``count_sum`` as in :func:`ce_mean_from_rows`."""
    t = F.softplus(-logits) if label_is_one else F.softplus(logits)
    if weights is None:
        if count_sum is None:
            return t.mean()
        n = count_sum(torch.full((), float(t.numel()), device=t.device))
        return t.sum() / n
    w = weights.reshape(weights.shape[0],
                        *([1] * (t.dim() - 1))).to(t.dtype)
    per_row = t.numel() // t.shape[0]
    n = w.sum() if count_sum is None else count_sum(w.sum())
    return (t * w).sum() / torch.clamp(n * per_row, min=1.0)
