"""The port's own copies of the numpy-only data layers give exactly what the
JAX package's give (raw parsing, synthetic corpus, preprocessing)."""

import numpy as np
import pytest

from c2dsr_tpu.config import DataSpec as JSpec
from c2dsr_tpu.data import preprocess as jpre
from c2dsr_tpu.data import raw as jraw
from c2dsr_tpu.data import synthetic as jsyn
from c2dsr_tpu_torch.config import DataSpec, padded_sizes, Config
from c2dsr_tpu_torch.data import preprocess, raw, synthetic

SPEC = dict(n_item_a=30, n_item_b=45, len_max=10)


@pytest.fixture(scope="module")
def seqs():
    return synthetic.generate_sequences(DataSpec(**SPEC), 120, seed=4)


def test_synthetic_matches_jax(seqs):
    assert seqs == jsyn.generate_sequences(JSpec(**SPEC), 120, seed=4)


@pytest.mark.parametrize("bug_pool", [False, True])
def test_preprocess_evaluate_matches_jax(seqs, bug_pool):
    got = preprocess.preprocess_evaluate(seqs, DataSpec(**SPEC),
                                         n_neg_sample=10, seed=5,
                                         bug_truncated_b_neg_pool=bug_pool)
    want = jpre.preprocess_evaluate(seqs, JSpec(**SPEC), n_neg_sample=10,
                                    seed=5, bug_truncated_b_neg_pool=bug_pool)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_preprocess_train_matches_jax(seqs):
    got = preprocess.preprocess_train(seqs, DataSpec(**SPEC), seed=6)
    want = jpre.preprocess_train(seqs, JSpec(**SPEC), seed=6)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_raw_files_round_trip_and_cached_split(tmp_path, seqs):
    spec = DataSpec(**SPEC)
    raw_dir = tmp_path / "raw"
    synthetic.write_item_lists(spec, str(raw_dir))
    synthetic.write_reference_tsv(seqs, str(raw_dir / "val_new.txt"))
    assert raw.load_data_spec(str(raw_dir), 10) == spec
    assert raw.parse_interactions(str(raw_dir / "val_new.txt")) == \
        jraw.parse_interactions(str(raw_dir / "val_new.txt")) == seqs
    cache = tmp_path / "cache"
    first = preprocess.load_or_build_split(str(raw_dir), str(cache), "val",
                                           spec, n_neg_sample=10, seed=5)
    again = preprocess.load_or_build_split(str(raw_dir), str(cache), "val",
                                           spec, n_neg_sample=10, seed=5)
    # the JAX package's split from the same raw file: its native library's
    # (c2dsr_tpu/data/preprocess.py:297-319), which the port's now runs too
    want = jpre.load_or_build_split(str(raw_dir), str(tmp_path / "jax"),
                                    "val", JSpec(**SPEC), n_neg_sample=10,
                                    seed=5)
    for k in want:
        np.testing.assert_array_equal(first[k], want[k])
        np.testing.assert_array_equal(again[k], want[k])


def test_padded_sizes():
    assert padded_sizes(Config(), DataSpec(29207, 34886, 15)) == \
        (65536, 30720, 36864)
