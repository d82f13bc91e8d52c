"""Raw dataset parsing.

File formats (reference semantics, dataloader.py:39-58, 237-252):

* Interaction line: ``user \t inter_id \t item|unixts|datestr| \t ...`` — the
  first two fields are dropped, remaining fields parsed as ``(item, ts)`` pairs
  and sorted by timestamp; only the item ids are kept.
* ``items_a.txt`` / ``items_b.txt``: one item per line; only the line count is
  used (``n_item_a`` / ``n_item_b``).
"""

from __future__ import annotations

import os
from typing import List

from c2dsr_tpu_torch.config import DataSpec


def parse_interactions(path: str) -> List[List[int]]:
    """Parse an interaction file into per-user item-id sequences (time-sorted)."""
    data: List[List[int]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            fields = line.strip().split("\t")[2:]
            pairs = []
            for ui in fields:
                parts = ui.split("|")
                pairs.append((int(parts[0]), int(parts[1])))
            pairs.sort(key=lambda p: p[1])
            data.append([p[0] for p in pairs])
    return data


def count_lines(path: str) -> int:
    n = 0
    with open(path, "r", encoding="utf-8") as f:
        for _ in f:
            n += 1
    return n


def load_data_spec(raw_dir: str, len_max: int) -> DataSpec:
    """Item counts from the item list files (dataloader.py:249-252)."""
    n_a = count_lines(os.path.join(raw_dir, "items_a.txt"))
    n_b = count_lines(os.path.join(raw_dir, "items_b.txt"))
    return DataSpec(n_item_a=n_a, n_item_b=n_b, len_max=len_max)


def split_path(raw_dir: str, mode: str) -> str:
    return os.path.join(raw_dir, f"{mode}_new.txt")
