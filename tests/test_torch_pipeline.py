"""The port's BatchIterator (``data/pipeline.py``) yields the same batches
as the JAX package's for a seed: the same shuffle, the ragged last batch,
drop_last, the padded batches with their ``valid`` mask, and the
per-process slices."""

import numpy as np
import pytest

from c2dsr_tpu.data import pipeline as jpipeline
from c2dsr_tpu_torch.data import pipeline


def _data(n=103):
    rng = np.random.default_rng(0)
    return {"x": rng.integers(0, 50, size=(n, 5)).astype(np.int32),
            "y": np.arange(n, dtype=np.int32)}


@pytest.mark.parametrize("kw", [
    dict(batch_size=16, shuffle=True, seed=3),
    dict(batch_size=16, shuffle=False),
    dict(batch_size=16, shuffle=True, seed=4, drop_last=True),
    dict(batch_size=16, shuffle=True, seed=5, pad_to_multiple=8),
    dict(batch_size=16, shuffle=True, seed=6, process_index=1,
         process_count=2)])
def test_batches_match_jax(kw):
    data = _data()
    it, jit = pipeline.BatchIterator(data, **kw), jpipeline.BatchIterator(
        data, **kw)
    assert len(it) == len(jit)
    for _ in range(2):                          # two epochs: reshuffled
        got, want = list(it.epoch()), list(jit.epoch())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
