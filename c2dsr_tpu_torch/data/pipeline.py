"""Host-side input pipeline: shuffled batches of packed arrays.

The port's own copy of ``c2dsr_tpu/data/pipeline.py``, with the same
shuffle (numpy ``default_rng(seed).permutation``), so both packages see the
same batches for a seed.  It replaces the reference's torch DataLoader with
worker processes (dataloader.py:254-259): with preprocessed struct-of-arrays
splits, batching is pure array slicing.  Batches stay numpy; the train step
moves them to its device.

The final ragged batch is kept (torch DataLoader drop_last=False semantics).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class BatchIterator:
    """Reshuffling batch iterator over a packed split.

    Multi-process: pass (process_index, process_count).  Every process draws
    the SAME permutation (same seed), each yields only its contiguous slice
    of every global batch.  Global batches are padded so the slice
    boundaries divide evenly."""

    def __init__(self, data: Dict[str, np.ndarray], batch_size: int,
                 shuffle: bool, seed: int = 0, drop_last: bool = False,
                 pad_to_multiple: Optional[int] = None,
                 process_index: int = 0, process_count: int = 1):
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_to_multiple = pad_to_multiple
        if process_count > 1:
            if batch_size % process_count:
                raise ValueError(f"batch_size {batch_size} is not a multiple "
                                 f"of process_count {process_count}")
            pad = pad_to_multiple or 1
            self.pad_to_multiple = pad * process_count // _gcd(
                pad, process_count)
        self.process_index = process_index
        self.process_count = process_count
        self._rng = np.random.default_rng(seed)
        self.n = next(iter(data.values())).shape[0]

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = (self._rng.permutation(self.n) if self.shuffle
               else np.arange(self.n))
        stop = (self.n - self.n % self.batch_size if self.drop_last
                else self.n)
        for s in range(0, stop, self.batch_size):
            sel = idx[s:min(s + self.batch_size, stop)]
            batch = {k: v[sel] for k, v in self.data.items()}
            if self.pad_to_multiple:
                # padded duplicate examples carry valid=0 so the loss masks
                # them out exactly (train/step.loss_fn) — a padded multi-
                # process batch then reproduces the reference's ragged-batch
                # loss.  Always emitted when padding is enabled, so every
                # batch has the same fields.
                valid = np.ones(len(sel), np.int32)
                if len(sel) % self.pad_to_multiple:
                    pad = self.pad_to_multiple - len(sel) % self.pad_to_multiple
                    batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)])
                             for k, v in batch.items()}
                    valid = np.concatenate([valid, np.zeros(pad, np.int32)])
                batch["valid"] = valid
            if self.process_count > 1:
                b = next(iter(batch.values())).shape[0]
                m = b // self.process_count
                lo = self.process_index * m
                batch = {k: v[lo:lo + m] for k, v in batch.items()}
            yield batch


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a
