"""The port's command line (``c2dsr_tpu_torch/cli.py``) against the JAX
package's (``c2dsr_tpu/cli.py``).

* Every option of ``c2dsr_tpu.cli.build_parser()`` exists in the port's
  parser with the same default, type, choices and action; the port adds
  ``--device`` only.
* ``main([... "--synthetic", N, "--device", "cpu", "--ckpt", dir])`` at a
  small width trains two epochs, returns 0, writes a checkpoint and a log
  file that ends with the final result table.
* Each flag that asks for a mesh or several processes raises, naming the
  ROADMAP.md item; none is ignored.
"""

import glob
import os

import pytest

from c2dsr_tpu import cli as jcli
from c2dsr_tpu_torch import checkpoint as ckpt_mod
from c2dsr_tpu_torch import cli


def _options(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_has_every_jax_option_with_its_default_and_type():
    want, got = _options(jcli.build_parser()), _options(cli.build_parser())
    assert set(got) == set(want) | {"device"}
    for dest, a in want.items():
        b = got[dest]
        assert b.option_strings == a.option_strings, dest
        assert (b.default, b.type, b.choices, b.nargs, b.const) == \
            (a.default, a.type, a.choices, a.nargs, a.const), dest
        assert type(b) is type(a), dest
    assert got["device"].default == "cuda"


def test_main_runs_a_synthetic_experiment_on_the_cpu(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    rc = cli.main(["--synthetic", "240", "--n_epoch", "2", "--device", "cpu",
                   "--ckpt", ckpt, "--d_latent", "32", "--batch_size", "64",
                   "--n_neg_sample", "20", "--batch_size_eval", "64"])
    assert rc == 0
    assert ckpt_mod.exists(ckpt)
    assert ckpt_mod.load_meta(ckpt)["epoch"] in (1, 2)
    (log,) = glob.glob(os.path.join("log", "fk-*-1-1-1-0.001-0.0005.txt"))
    text = open(log).read()
    assert "experiment ends at epoch 2" in text
    tail = text[text.index("[ Test result ]"):].splitlines()
    assert tail[1].startswith("\t| Improve | hr5_a")
    assert len(tail[2].split("|")) == 15          # 13 numbers
    assert "device:cpu" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--mesh_model", "2"], ["--mesh_data", "4"], ["--distributed"],
    ["--coordinator_address", "localhost:1234"], ["--num_processes", "2"],
    ["--process_id", "0"]])
def test_unsupported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(["--synthetic", "100", "--device", "cpu"] + flags)
