"""Offline preprocessing: raw sequences -> packed, padded numpy arrays.

Reproduces the example-construction semantics of the reference
(``dataloader.py:60-228``) but emits struct-of-arrays batches (one ``.npz``
per split) instead of per-example Python lists — the layout a TPU input
pipeline wants: every field is a dense ``[N, len_max]`` (or ``[N]``/
``[N, n_neg]``) array, ready to shard and ``device_put``.

Train example fields (dataloader.py:159-160):
    seq_share, seq_share_a, seq_share_b : [N, L] shared-space item ids
    pos, pos_a, pos_b                   : [N, L] 1-based positions, 0 = pad
    gt_share_a, gt_a                    : [N, L] A-local targets, n_item_a = ignore
    gt_share_b, gt_b                    : [N, L] B-local targets, n_item_b = ignore
    gt_mask_a, gt_mask_b                : [N, L] 0/1
    seq_share_neg_a, seq_share_neg_b    : [N, L] corrupted sequences

Eval example fields (dataloader.py:218-226):
    seq_share, seq_share_a, seq_share_b, pos, pos_a, pos_b : [N, L]
    idx_last_a, idx_last_b : [N] last non-pad position per domain (-1 if none)
    xory_last              : [N] 0 = gt in domain A, 1 = domain B
    gt_last                : [N] domain-local gt id
    list_neg               : [N, n_neg] domain-local sampled negatives

Semantics notes (quirks preserved for parity, see SURVEY.md section 2):
  * Per-step ground truths are threaded backwards through each domain
    subsequence; a final-position target is kept only if the *overall* next
    item is in-domain, else that position is re-padded
    (dataloader.py:97-134).
  * The B-domain in-domain test is strict ``gt[-1] > n_item_a``
    (dataloader.py:123) — shared id exactly ``n_item_a`` (the first B item)
    fails it.  Kept as-is.
  * Users with no in-domain ground truth in either domain are dropped
    (dataloader.py:115-116, 133-134).
  * Eval negatives for domain B optionally come from the reference's
    truncated pool ``[0, n_item_b - n_item_a)`` (dataloader.py:222-224),
    gated by ``bug_truncated_b_neg_pool``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from c2dsr_tpu_torch.config import DataSpec
from c2dsr_tpu_torch.data import raw as raw_mod

TRAIN_FIELDS = (
    "seq_share", "seq_share_a", "seq_share_b", "pos", "pos_a", "pos_b",
    "gt_share_a", "gt_share_b", "gt_a", "gt_b", "gt_mask_a", "gt_mask_b",
    "seq_share_neg_a", "seq_share_neg_b",
)

EVAL_FIELDS = (
    "seq_share", "seq_share_a", "seq_share_b", "pos", "pos_a", "pos_b",
    "idx_last_a", "idx_last_b", "xory_last", "gt_last", "list_neg",
)


def _split_domains_train(seq_share, spec: DataSpec, rng: np.random.Generator):
    """Split a shared sequence into A/B subsequences with per-domain position
    counters and corrupted (negative) sequences (dataloader.py:72-91)."""
    pad = spec.idx_pad
    na = spec.n_item_a
    xc, yc = 1, 1
    sa, pa, neg_a = [], [], []
    sb, pb, neg_b = [], [], []
    # corrupted sequences: other-domain items are replaced with uniform
    # random items of their own domain (dataloader.py:80,85) — neg_a keeps A
    # items and randomizes the B slots over B ids, and vice versa for neg_b.
    for idx in seq_share:
        if idx < na:
            neg_a.append(idx)
            sa.append(idx)
            pa.append(xc)
            xc += 1
            neg_b.append(int(rng.integers(0, na)))      # random A id
            sb.append(pad)
            pb.append(0)
        else:
            neg_a.append(int(rng.integers(na, pad)))    # random B id
            sa.append(pad)
            pa.append(0)
            neg_b.append(idx)
            sb.append(idx)
            pb.append(yc)
            yc += 1
    return sa, pa, neg_a, sb, pb, neg_b


def _thread_gt_backwards(seq_dom, pos_dom, gt_last_shared, spec: DataSpec,
                         domain: str):
    """Walk a domain subsequence backwards threading next-same-domain targets
    (dataloader.py:97-134).  Mutates seq_dom/pos_dom (final-position re-pad).

    Returns (gt, gt_mask) in domain-local id space with the domain's ignore
    class (n_item_a or n_item_b) at unsupervised steps.
    """
    na, nb, pad = spec.n_item_a, spec.n_item_b, spec.idx_pad
    n = len(seq_dom)
    if domain == "a":
        ignore, off = na, 0
        def in_domain(g):
            return g < na
    else:
        ignore, off = nb, na
        def in_domain(g):
            return g > na          # strict: reference quirk, dataloader.py:123
    gt = [ignore] * n
    mask = [0] * n
    cur = -1
    for i in range(1, n + 1):
        if pos_dom[-i]:
            if cur == -1:
                cur = seq_dom[-i] - off
                if in_domain(gt_last_shared):
                    gt[-i] = gt_last_shared - off
                    mask[-i] = 1
                else:
                    seq_dom[-i] = pad
                    pos_dom[-i] = 0
            else:
                gt[-i] = cur
                mask[-i] = 1
                cur = seq_dom[-i] - off
    return gt, mask


def preprocess_train(sequences: List[List[int]], spec: DataSpec,
                     seed: int = 3407) -> Dict[str, np.ndarray]:
    """Build the packed train split from raw per-user sequences."""
    rng = np.random.default_rng(seed)
    L = spec.len_max
    pad = spec.idx_pad
    na, nb = spec.n_item_a, spec.n_item_b
    rows = {k: [] for k in TRAIN_FIELDS}

    for u in sequences:
        gt = u[1:]
        seq_share = u[:-1]
        len_seq = len(u)
        if len_seq < 2 or len_seq > L:
            # reference assumes 2 <= len(u) <= len_max (len_pad >= 1)
            continue
        pos = list(range(1, len_seq))
        sa, pa, neg_a, sb, pb, neg_b = _split_domains_train(seq_share, spec, rng)

        gt_a, gt_mask_a = _thread_gt_backwards(sa, pa, gt[-1], spec, "a")
        if sum(gt_mask_a) == 0:
            continue
        gt_b, gt_mask_b = _thread_gt_backwards(sb, pb, gt[-1], spec, "b")
        if sum(gt_mask_b) == 0:
            continue

        lp = L - len_seq + 1
        p0 = [0] * lp
        gt_pad = [pad] * lp + gt
        rows["seq_share"].append([pad] * lp + seq_share)
        rows["seq_share_a"].append([pad] * lp + sa)
        rows["seq_share_b"].append([pad] * lp + sb)
        rows["seq_share_neg_a"].append([pad] * lp + neg_a)
        rows["seq_share_neg_b"].append([pad] * lp + neg_b)
        rows["pos"].append(p0 + pos)
        rows["pos_a"].append(p0 + pa)
        rows["pos_b"].append(p0 + pb)
        rows["gt_share_a"].append([g if g < na else na for g in gt_pad])
        rows["gt_share_b"].append([g - na if g >= na else nb for g in gt_pad])
        rows["gt_a"].append([na] * lp + gt_a)
        rows["gt_b"].append([nb] * lp + gt_b)
        rows["gt_mask_a"].append(p0 + gt_mask_a)
        rows["gt_mask_b"].append(p0 + gt_mask_b)

    return {k: np.asarray(v, dtype=np.int32) for k, v in rows.items()}


def _sample_negatives(gt_local: int, pool_size: int, n_neg: int,
                      rng: np.random.Generator) -> np.ndarray:
    """n_neg distinct ids uniform over [0, pool_size) \\ {gt_local}."""
    # draw from [0, pool_size - 1) then shift ids >= gt up by one
    draw = rng.choice(pool_size - 1, size=n_neg, replace=False)
    return np.where(draw >= gt_local, draw + 1, draw).astype(np.int32)


def preprocess_evaluate(sequences: List[List[int]], spec: DataSpec,
                        n_neg_sample: int = 999, seed: int = 3407,
                        bug_truncated_b_neg_pool: bool = False,
                        neg_lists: "np.ndarray | None" = None,
                        ) -> Dict[str, np.ndarray]:
    """Build the packed eval (val/test) split (dataloader.py:163-228).

    ``neg_lists``: optional [n_examples, n_neg] int32 of DOMAIN-LOCAL
    negative ids (B-domain ids are shared_id - n_item_a, matching the
    reference's list_neg, dataloader.py:216-226) that REPLACES the sampled
    negatives, aligned with the kept examples in sequence order.  Use this
    to drop in negative lists exported from the reference's own dataset so
    sampled-eval ranks are bit-comparable (SURVEY.md section 7: "ship the
    exact negative lists as data")."""
    rng = np.random.default_rng(seed)
    L = spec.len_max
    pad = spec.idx_pad
    na, nb = spec.n_item_a, spec.n_item_b
    rows = {k: [] for k in EVAL_FIELDS}

    for u in sequences:
        gt_last = u[-1]
        seq_share = u[:-1]
        len_seq = len(u)
        if len_seq < 2 or len_seq > L:
            continue
        pos = list(range(1, len_seq))

        xc, yc = 1, 1
        sa, pa, sb, pb = [], [], [], []
        for idx in seq_share:
            if idx < na:
                sa.append(idx); pa.append(xc); xc += 1
                sb.append(pad); pb.append(0)
            else:
                sa.append(pad); pa.append(0)
                sb.append(idx); pb.append(yc); yc += 1

        lp = L - len_seq + 1
        pos = [0] * lp + pos
        pa = [0] * lp + pa
        pb = [0] * lp + pb
        sa = [pad] * lp + sa
        sb = [pad] * lp + sb
        seq_share_p = [pad] * lp + seq_share

        def last_nonpad(p):
            for i in range(1, L + 1):
                if p[-i]:
                    return L - i
            return -1

        ila, ilb = last_nonpad(pa), last_nonpad(pb)

        if gt_last < na:
            xory, gt_local = 0, gt_last
            neg = _sample_negatives(gt_local, na, n_neg_sample, rng)
        else:
            xory, gt_local = 1, gt_last - na
            pool = (nb - na) if bug_truncated_b_neg_pool else nb
            neg = _sample_negatives(gt_local, pool, n_neg_sample, rng)

        rows["seq_share"].append(seq_share_p)
        rows["seq_share_a"].append(sa)
        rows["seq_share_b"].append(sb)
        rows["pos"].append(pos)
        rows["pos_a"].append(pa)
        rows["pos_b"].append(pb)
        rows["idx_last_a"].append(ila)
        rows["idx_last_b"].append(ilb)
        rows["xory_last"].append(xory)
        rows["gt_last"].append(gt_local)
        rows["list_neg"].append(neg)

    out = {k: np.asarray(v, dtype=np.int32) for k, v in rows.items()}
    if neg_lists is not None:
        neg_lists = np.asarray(neg_lists, dtype=np.int32)
        if neg_lists.shape[0] != out["gt_last"].shape[0]:
            raise ValueError(
                f"neg_lists has {neg_lists.shape[0]} rows but the split kept "
                f"{out['gt_last'].shape[0]} examples")
        out["list_neg"] = neg_lists
    return out


def load_or_build_split(raw_dir: str, cache_dir: str, mode: str,
                        spec: DataSpec, n_neg_sample: int = 999,
                        seed: int = 3407,
                        bug_truncated_b_neg_pool: bool = False,
                        neg_file: "str | None" = None,
                        use_raw: bool = False,
                        ) -> Dict[str, np.ndarray]:
    """npz-cached preprocessing (analog of the reference's pickle caches,
    dataloader.py:24-35).  Runs the Python path (the JAX package's C++
    ``native/`` fast path is not ported yet).

    ``neg_file``: optional .npy of [n_examples, n_neg] domain-local negative
    ids replacing the sampled eval negatives (see preprocess_evaluate).
    ``use_raw``: force re-preprocessing from the raw text even when a cache
    exists (the reference's --use_raw, main.py:23); the cache is rewritten."""
    if neg_file is not None and mode != "train":
        seqs = raw_mod.parse_interactions(raw_mod.split_path(raw_dir, mode))
        return preprocess_evaluate(
            seqs, spec, n_neg_sample=n_neg_sample, seed=seed,
            bug_truncated_b_neg_pool=bug_truncated_b_neg_pool,
            neg_lists=np.load(neg_file))
    tag = "bugneg" if (mode != "train" and bug_truncated_b_neg_pool) else "std"
    cache = os.path.join(cache_dir, f"{mode}.{tag}.npz")
    if os.path.exists(cache) and not use_raw:
        with np.load(cache) as z:
            return {k: z[k] for k in z.files}
    seqs = raw_mod.parse_interactions(raw_mod.split_path(raw_dir, mode))
    if mode == "train":
        out = preprocess_train(seqs, spec, seed=seed)
    else:
        out = preprocess_evaluate(
            seqs, spec, n_neg_sample=n_neg_sample, seed=seed,
            bug_truncated_b_neg_pool=bug_truncated_b_neg_pool)
    os.makedirs(cache_dir, exist_ok=True)
    np.savez_compressed(cache, **out)
    return out
