"""Synthetic cross-domain interaction data.

The data mount of the reference is missing the FK/MB ``train_new.txt`` files
and the whole EE dataset (SURVEY.md section 2, ``.MISSING_LARGE_BLOBS``), so
training/benchmark runs need generated data.  Sequences follow the reference's
format assumptions (dataloader.py:44-58): interleaved item ids over two
domains in shared id space, 2 <= length <= len_max, timestamp-sorted.

Item popularity is Zipf-like per domain, which keeps the item-item graph
realistically skewed.  Also writes reference-format TSV so the PyTorch
baseline can run on the same data.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from c2dsr_tpu_torch.config import DataSpec


def generate_sequences(spec: DataSpec, n_users: int, seed: int = 0,
                       p_domain_a: float = 0.5, zipf_a: float = 1.1,
                       min_len: int = 4) -> List[List[int]]:
    """Per-user interleaved shared-space sequences with >=1 item per domain."""
    rng = np.random.default_rng(seed)
    na, nb = spec.n_item_a, spec.n_item_b
    L = spec.len_max

    def zipf_probs(n):
        w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), zipf_a)
        return w / w.sum()

    pa = zipf_probs(na)
    pb = zipf_probs(nb)
    # pre-draw large pools; cheaper than per-user choice with probabilities
    pool_a = rng.choice(na, size=n_users * L, p=pa)
    pool_b = rng.choice(nb, size=n_users * L, p=pb) + na
    ia = ib = 0

    out: List[List[int]] = []
    lens = rng.integers(max(2, min_len), L + 1, size=n_users)
    for u in range(n_users):
        ln = int(lens[u])
        dom = rng.random(ln) < p_domain_a
        # force at least one item in each domain so gt threading can succeed
        if dom.all():
            dom[int(rng.integers(ln))] = False
        if not dom.any():
            dom[int(rng.integers(ln))] = True
        seq = []
        for d in dom:
            if d:
                seq.append(int(pool_a[ia])); ia += 1
            else:
                seq.append(int(pool_b[ib])); ib += 1
        out.append(seq)
    return out


def write_reference_tsv(sequences: List[List[int]], path: str) -> None:
    """Write sequences in the reference's interaction-line format."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for u, seq in enumerate(sequences):
            cells = [str(u), str(u)]
            for t, item in enumerate(seq):
                ts = 1_300_000_000 + t * 86400
                cells.append(f"{item}|{ts}|2011-03-13 07:06:40|")
            f.write("\t".join(cells) + "\n")


def write_item_lists(spec: DataSpec, raw_dir: str) -> None:
    os.makedirs(raw_dir, exist_ok=True)
    for name, n in (("items_a.txt", spec.n_item_a), ("items_b.txt", spec.n_item_b)):
        with open(os.path.join(raw_dir, name), "w", encoding="utf-8") as f:
            for i in range(n):
                f.write(f"1\tITEM{i}\t{i}\n")
