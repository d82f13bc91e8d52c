"""The port's native data layer (``c2dsr_tpu_torch/native``) against the JAX
package's (``c2dsr_tpu/native``), on one synthetic raw directory.

* The port's library gives the JAX library's output bitwise: parsing, both
  edge lists, all 14 train fields (the corrupted sequences' mt19937_64
  streams included) and every eval field (``list_neg`` included, also with
  ``bug_truncated_b_neg_pool``).
* The port's ``load_or_build_split`` (train, val, test) and
  ``build_graphs_from_file`` give the JAX functions' output bitwise, under
  the same cache names; a ``neg_file`` replaces the negatives as there.
* Its deterministic fields equal the port's Python path, which runs only
  when asked for (``python_path=True``); the random fields keep the
  invariants of ``tests/test_native.py``.
* The library lands under ``build/``, a failed build raises with the
  compiler's output (no fallback), and two processes building at once both
  load a good library.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from c2dsr_tpu import native as jnative
from c2dsr_tpu.config import DataSpec as JSpec
from c2dsr_tpu.data import preprocess as jpre
from c2dsr_tpu.graph import build as jbuild
from c2dsr_tpu_torch import native
from c2dsr_tpu_torch.config import DataSpec
from c2dsr_tpu_torch.data import preprocess, raw, synthetic
from c2dsr_tpu_torch.graph import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(n_item_a=50, n_item_b=70, len_max=15)
N_NEG = 15               # < n_item_b - n_item_a: the truncated pool holds it
SEED = 7
DETERMINISTIC_TRAIN = preprocess.TRAIN_FIELDS[:12]
DETERMINISTIC_EVAL = preprocess.EVAL_FIELDS[:10]


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    """A raw directory as the reference lays it out: item lists and three
    interaction files of a few hundred synthetic users each."""
    d = tmp_path_factory.mktemp("raw")
    spec = DataSpec(**SPEC)
    synthetic.write_item_lists(spec, str(d))
    for seed, mode in enumerate(("train", "val", "test")):
        synthetic.write_reference_tsv(
            synthetic.generate_sequences(spec, 300, seed=10 + seed),
            raw.split_path(str(d), mode))
    return str(d)


@pytest.fixture(scope="module")
def flat(raw_dir):
    return native.load().parse_interactions(raw.split_path(raw_dir, "train"))


def _jnat():
    nat = jnative.load()
    assert nat is not None, "the JAX package's library did not build"
    return nat


def _equal(got, want):
    assert type(got) is type(want)
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("part", ["parse", "edges", "train", "eval",
                                  "eval_bug_pool"])
def test_library_gives_the_jax_librarys_output(raw_dir, flat, part):
    nat, jnat = native.load(), _jnat()
    na, nb, L = SPEC["n_item_a"], SPEC["n_item_b"], SPEC["len_max"]
    offsets, items = flat
    if part == "parse":
        path = raw.split_path(raw_dir, "train")
        _equal(nat.parse_interactions(path), jnat.parse_interactions(path))
    elif part == "edges":
        _equal(nat.build_edges(offsets, items, na),
               jnat.build_edges(offsets, items, na))
    elif part == "train":
        got = nat.preprocess_train(offsets, items, na, nb, L, SEED)
        _equal(got, jnat.preprocess_train(offsets, items, na, nb, L, SEED))
        assert got.shape[1] == 14
    else:
        bug = part == "eval_bug_pool"
        _equal(nat.preprocess_eval(offsets, items, na, nb, L, N_NEG, SEED,
                                   bug),
               jnat.preprocess_eval(offsets, items, na, nb, L, N_NEG, SEED,
                                    bug))


@pytest.mark.parametrize("mode,bug", [("train", False), ("val", False),
                                      ("test", False), ("val", True),
                                      ("test", True)])
def test_load_or_build_split_is_the_jax_split(raw_dir, tmp_path, mode, bug):
    kw = dict(n_neg_sample=N_NEG, seed=SEED, bug_truncated_b_neg_pool=bug)
    got = preprocess.load_or_build_split(raw_dir, str(tmp_path / "port"),
                                         mode, DataSpec(**SPEC), **kw)
    want = jpre.load_or_build_split(raw_dir, str(tmp_path / "jax"), mode,
                                    JSpec(**SPEC), **kw)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the same cache name, so the two packages may share a cache directory
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    again = preprocess.load_or_build_split(raw_dir, str(tmp_path / "jax"),
                                           mode, DataSpec(**SPEC), **kw)
    for k in want:
        np.testing.assert_array_equal(again[k], want[k], err_msg=k)


def test_neg_file_replaces_the_negatives_as_in_jax(raw_dir, tmp_path):
    n = jpre.load_or_build_split(raw_dir, str(tmp_path / "c"), "val",
                                 JSpec(**SPEC), N_NEG,
                                 SEED)["gt_last"].shape[0]
    neg_file = str(tmp_path / "negs.npy")
    np.save(neg_file, np.random.default_rng(0).integers(0, 40, (n, 9)))
    got = preprocess.load_or_build_split(raw_dir, str(tmp_path / "p"), "val",
                                         DataSpec(**SPEC), N_NEG, SEED,
                                         neg_file=neg_file)
    want = jpre.load_or_build_split(raw_dir, str(tmp_path / "j"), "val",
                                    JSpec(**SPEC), N_NEG, SEED,
                                    neg_file=neg_file)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_build_graphs_from_file_is_the_jax_graphs(raw_dir):
    path = raw.split_path(raw_dir, "train")
    got = build.build_graphs_from_file(path, DataSpec(**SPEC))
    want = jbuild.build_graphs_from_file(path, JSpec(**SPEC))
    python = build.build_graphs_from_file(path, DataSpec(**SPEC),
                                          python_path=True)
    for g, w, p in zip(got, want, python):
        assert g.n == w.n == p.n
        for name in ("rows", "cols", "vals"):
            a = getattr(g, name)
            for b in (getattr(w, name), getattr(p, name)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_deterministic_fields_are_the_python_paths(raw_dir, tmp_path, mode):
    spec = DataSpec(**SPEC)
    got = preprocess.load_or_build_split(raw_dir, str(tmp_path), mode, spec,
                                         N_NEG, SEED)
    py = preprocess.load_or_build_split(raw_dir, str(tmp_path / "py"), mode,
                                        spec, N_NEG, SEED, python_path=True)
    assert not os.path.exists(tmp_path / "py")    # the Python path caches not
    for k in (DETERMINISTIC_TRAIN if mode == "train" else DETERMINISTIC_EVAL):
        np.testing.assert_array_equal(got[k], py[k], err_msg=k)
    na, pad = spec.n_item_a, spec.idx_pad
    if mode == "train":
        # tests/test_native.py:72-86: same-domain slots keep the item, the
        # other domain's slots get a same-domain replacement
        seq, neg_a, neg_b = (got["seq_share"], got["seq_share_neg_a"],
                             got["seq_share_neg_b"])
        is_a, is_b = seq < na, (seq >= na) & (seq != pad)
        np.testing.assert_array_equal(neg_a[is_a], seq[is_a])
        np.testing.assert_array_equal(neg_b[is_b], seq[is_b])
        assert ((neg_a[is_b] >= na) & (neg_a[is_b] < pad)).all()
        assert ((neg_b[is_a] >= 0) & (neg_b[is_a] < na)).all()
        assert (neg_a[seq == pad] == pad).all()
        assert (neg_b[seq == pad] == pad).all()
        assert not np.array_equal(neg_a, py["seq_share_neg_a"])
    else:
        # tests/test_native.py:104-109: distinct, in the pool, gt excluded
        negs = got["list_neg"]
        pools = np.where(got["xory_last"] == 0, na, spec.n_item_b)
        for i in range(negs.shape[0]):
            assert len(set(negs[i].tolist())) == N_NEG
            assert (negs[i] >= 0).all() and (negs[i] < pools[i]).all()
            assert got["gt_last"][i] not in negs[i]
        assert not np.array_equal(negs, py["list_neg"])


def test_python_path_runs_only_when_asked(raw_dir, tmp_path, monkeypatch):
    """The library is the only path by default: a failure to build it
    raises from the entry points; python_path=True needs no library."""
    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "load", broken)
    spec = DataSpec(**SPEC)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        preprocess.load_or_build_split(raw_dir, str(tmp_path), "val", spec,
                                       N_NEG, SEED)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build.build_graphs_from_file(raw.split_path(raw_dir, "train"), spec)
    preprocess.load_or_build_split(raw_dir, str(tmp_path), "val", spec,
                                   N_NEG, SEED, python_path=True)
    build.build_graphs_from_file(raw.split_path(raw_dir, "train"), spec,
                                 python_path=True)


def test_library_lands_under_build_and_a_failed_build_raises(tmp_path):
    native.load()
    lib = native.lib_path()
    assert os.path.isfile(lib)
    assert os.path.dirname(lib) == os.path.join(REPO, "build",
                                                "c2dsr_tpu_torch")
    # the JAX package's library is not the one the port loads
    assert not os.path.samefile(lib, os.path.join(
        os.path.dirname(jnative.__file__), "libc2dsr_native.so"))
    bad = tmp_path / "bad.cpp"
    bad.write_text('extern "C" int f() { return undeclared_name; }\n')
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build(str(bad), str(tmp_path / "out"))
    assert os.listdir(tmp_path / "out") == []


_BUILD_AND_PARSE = """
import sys
from c2dsr_tpu_torch import native
nat = native.load(native.SRC, sys.argv[1])
offsets, items = nat.parse_interactions(sys.argv[2])
print(len(offsets) - 1, len(items))
"""


def test_two_processes_building_at_once_both_load_a_good_library(
        raw_dir, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    path = raw.split_path(raw_dir, "train")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_PARSE,
                               str(tmp_path), path], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    offsets, items = native.load().parse_interactions(path)
    want = f"{len(offsets) - 1} {len(items)}"
    assert [o.strip() for o, _ in outs] == [want, want]
    assert os.listdir(tmp_path) == [os.path.basename(
        native.lib_path(native.SRC, str(tmp_path)))]
