"""Ranking metrics: HR/MRR/NDCG @ {5, 20} and the improvement score.

Vectorized numpy re-expression of utils/metrics.py:4-31: for each rank r,
HR@k += 1, MRR@k += 1/r, NDCG@k += 1/log2(r+1) when r <= k; metrics divide
by the total example count.  ``cal_score`` prepends the model-selection
scalar: mean relative improvement of (hr5_a, ndcg5_a, hr5_b, ndcg5_b) over
the paper's numbers (utils/metrics.py:26-31).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def cal_metrics(ranks: Sequence[int]) -> List[float]:
    """-> [hr5, hr20, mrr5, mrr20, ndcg5, ndcg20]."""
    r = np.asarray(ranks, dtype=np.float64)
    n = max(len(r), 1)
    in5 = r <= 5
    in20 = r <= 20
    inv = np.where(r > 0, 1.0 / np.maximum(r, 1), 0.0)
    ndcg = np.where(r > 0, 1.0 / np.log2(np.maximum(r, 1) + 1), 0.0)
    return [
        float(in5.sum()) / n,
        float(in20.sum()) / n,
        float((inv * in5).sum()) / n,
        float((inv * in20).sum()) / n,
        float((ndcg * in5).sum()) / n,
        float((ndcg * in20).sum()) / n,
    ]


def cal_score(ranks_a, ranks_b, benchmark) -> List[float]:
    """-> [improvement, 12 metrics] (utils/metrics.py:22-31)."""
    res = cal_metrics(ranks_a) + cal_metrics(ranks_b)
    res_select = [res[0], res[4], res[6], res[10]]   # hr5_a ndcg5_a hr5_b ndcg5_b
    imp = [x / y - 1.0 for x, y in zip(res_select, benchmark)]
    return [float(np.mean(imp))] + res
