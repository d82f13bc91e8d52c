"""The port's data tools (``c2dsr_tpu_torch/tools/``) against the JAX
package's (``tools/dataset_stats.py``, ``tools/leak_stats.py``).

Inputs: a synthetic raw directory (``data/synthetic``, the reference's
interaction-line format, train, val and test splits whose users overlap)
and the leak case of ``tests/test_tools.py:26-40``.  The statistics are
compared as printed (captured output), the leak rates as returned: equal.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import dataset_stats as jax_stats  # noqa: E402
from tools import leak_stats as jax_leak  # noqa: E402

from c2dsr_tpu_torch.config import DataSpec  # noqa: E402
from c2dsr_tpu_torch.data import synthetic  # noqa: E402
from c2dsr_tpu_torch.tools import dataset_stats, leak_stats  # noqa: E402


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    """Items lists and three splits; val and test repeat some train users'
    ids (write_reference_tsv numbers each line's user and interaction id by
    its line), so that both leak rates are non-zero."""
    root = str(tmp_path_factory.mktemp("raw"))
    spec = DataSpec(n_item_a=120, n_item_b=90, len_max=15)
    synthetic.write_item_lists(spec, root)
    for mode, n, seed in (("train", 300, 0), ("val", 120, 1), ("test", 80, 2)):
        seqs = synthetic.generate_sequences(spec, n, seed=seed)
        synthetic.write_reference_tsv(seqs, os.path.join(root,
                                                         f"{mode}_new.txt"))
    return root


def _write(path, lines):
    with open(path, "w") as f:
        for user, inter, items in lines:
            cells = [str(user), str(inter)] + [
                f"{it}|{1000 + i}|d|" for i, it in enumerate(items)]
            f.write("\t".join(cells) + "\n")


def test_split_stats_print_the_jax_tools_numbers(raw_dir, capsys):
    for mode in ("train", "val", "test"):
        path = os.path.join(raw_dir, f"{mode}_new.txt")
        jax_stats.split_stats(path, 120)
        want = capsys.readouterr().out
        dataset_stats.split_stats(path, 120)
        got = capsys.readouterr().out
        assert got == want and "users:" in got


def test_dataset_stats_cli_is_the_jax_tools(raw_dir, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["dataset_stats.py", raw_dir,
                                      "--len_max", "20"])
    assert jax_stats.main() == 0
    want = capsys.readouterr().out
    assert dataset_stats.main([raw_dir, "--len_max", "20"]) == 0
    assert capsys.readouterr().out == want


def test_leak_rates_are_the_jax_tools(raw_dir):
    train = os.path.join(raw_dir, "train_new.txt")
    rates = []
    for mode in ("val", "test"):
        ev = os.path.join(raw_dir, f"{mode}_new.txt")
        assert leak_stats.user_inter_ids(ev) == jax_leak.user_inter_ids(ev)
        for mine, theirs in ((leak_stats.leak_rate, jax_leak.leak_rate),
                             (leak_stats.leak_rate_inclusive,
                              jax_leak.leak_rate_inclusive)):
            got = mine(train, ev)
            assert got == theirs(train, ev)
            rates.append(got[1])
    assert all(r > 0 for r in rates[1::2])      # every eval user is in train


def test_leak_rates_strict_vs_inclusive(tmp_path):
    """tests/test_tools.py:26-40's case: one strict leak, one verbatim."""
    train, ev = str(tmp_path / "train.txt"), str(tmp_path / "eval.txt")
    _write(train, [(1, 5, [10, 11]), (2, 7, [12]), (3, 1, [13])])
    _write(ev, [(1, 3, [10]), (2, 7, [12]), (3, 9, [14]), (4, 2, [15])])
    for mine, theirs, rate in ((leak_stats.leak_rate, jax_leak.leak_rate,
                                1 / 4),
                               (leak_stats.leak_rate_inclusive,
                                jax_leak.leak_rate_inclusive, 2 / 4)):
        assert mine(train, ev) == theirs(train, ev) == (4, rate)


def test_leak_stats_cli_is_the_jax_tools(raw_dir, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["leak_stats.py", raw_dir])
    assert jax_leak.main() == 0
    want = capsys.readouterr().out
    assert leak_stats.main([raw_dir]) == 0
    assert capsys.readouterr().out == want
    assert "leak rate" in want
