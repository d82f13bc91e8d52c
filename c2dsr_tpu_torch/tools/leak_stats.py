"""Train/eval leakage of a raw directory's splits, the counterpart of the
JAX package's ``tools/leak_stats.py`` (capability of the reference's
data/raw/leak_stats.py:55-119).

A val or test line leaks when the same user has a train interaction whose
interaction id is newer (greater) than the eval line's: the model trains
on the user's future relative to the evaluated step.  The inclusive rate
also counts a train line with the same id (the evaluated step itself).
Host-only: it reads the first two fields of the interaction lines that
``data/raw.parse_interactions`` drops.

    python -m c2dsr_tpu_torch.tools.leak_stats data/raw/Food-Kitchen [--suffix _new]
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict
from typing import List, Tuple


def user_inter_ids(path: str) -> List[Tuple[int, int]]:
    """(user, interaction id) of each line of an interaction file."""
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            cells = line.strip().split("\t")
            out.append((int(cells[0]), int(cells[1])))
    return out


def _rate(train_path: str, eval_path: str, inclusive: bool
          ) -> Tuple[int, float]:
    max_train = defaultdict(lambda: -1)
    for user, inter in user_inter_ids(train_path):
        max_train[user] = max(max_train[user], inter)
    n = leaked = 0
    for user, inter in user_inter_ids(eval_path):
        n += 1
        if max_train[user] > inter or (inclusive
                                        and max_train[user] == inter):
            leaked += 1
    return n, leaked / max(n, 1)


def leak_rate(train_path: str, eval_path: str) -> Tuple[int, float]:
    """(eval lines, share whose user has a strictly newer train
    interaction): the reference script's semantics."""
    return _rate(train_path, eval_path, inclusive=False)


def leak_rate_inclusive(train_path: str, eval_path: str
                        ) -> Tuple[int, float]:
    """(eval lines, share whose user has a same-or-newer train
    interaction): also counts eval lines present verbatim in the train
    file, which the strict rate reads as clean."""
    return _rate(train_path, eval_path, inclusive=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("raw_dir")
    p.add_argument("--suffix", default="_new",
                   help="split suffix: '' for the old splits, '_new' for "
                        "the leakage-reduced ones")
    args = p.parse_args(argv)
    train = os.path.join(args.raw_dir, f"train{args.suffix}.txt")
    if not os.path.exists(train):
        print(f"missing {train}", file=sys.stderr)
        return 1
    for mode in ("val", "test"):
        path = os.path.join(args.raw_dir, f"{mode}{args.suffix}.txt")
        if not os.path.exists(path):
            print(f"{mode}: MISSING")
            continue
        n, rate = leak_rate(train, path)
        print(f"{mode}{args.suffix}: {n} lines, leak rate {rate:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
