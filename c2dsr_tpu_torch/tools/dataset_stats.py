"""Dataset statistics of a raw directory, the counterpart of the JAX
package's ``tools/dataset_stats.py`` (capability of the reference's
data/raw/read_file.py:1-94).

Reports, per split file: user and interaction counts, the item id range,
the sequence-length distribution and the domain shares: the numbers that
cross-check a dataset against the paper's Table 1.  Host-only, on the
port's own ``data/raw.py``.

    python -m c2dsr_tpu_torch.tools.dataset_stats data/raw/Food-Kitchen [--len_max 15]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from c2dsr_tpu_torch.data import raw


def split_stats(path: str, n_item_a: int) -> None:
    """Print one split file's counts, id range, lengths and domain A's
    share (ids below ``n_item_a``)."""
    seqs = raw.parse_interactions(path)
    lens = np.array([len(s) for s in seqs])
    items = np.concatenate([np.asarray(s) for s in seqs]) if seqs else \
        np.zeros(0, np.int64)
    n_a = int((items < n_item_a).sum())
    print(f"  {os.path.basename(path)}:")
    print(f"    users: {len(seqs)}   interactions: {len(items)}")
    if len(items):
        print(f"    item id range: [{items.min()}, {items.max()}]")
        print(f"    seq len: mean {lens.mean():.2f}  min {lens.min()} "
              f"max {lens.max()}  p95 {np.percentile(lens, 95):.0f}")
        print(f"    domain A share: {n_a / len(items):.3f} "
              f"({n_a} A / {len(items) - n_a} B)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("raw_dir")
    p.add_argument("--len_max", type=int, default=15)
    args = p.parse_args(argv)

    spec = raw.load_data_spec(args.raw_dir, args.len_max)
    print(f"{args.raw_dir}:")
    print(f"  items_a: {spec.n_item_a}   items_b: {spec.n_item_b}   "
          f"n_item (with pad): {spec.n_item}")
    for mode in ("train", "val", "test"):
        path = raw.split_path(args.raw_dir, mode)
        if os.path.exists(path):
            split_stats(path, spec.n_item_a)
        else:
            print(f"  {os.path.basename(path)}: MISSING")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
