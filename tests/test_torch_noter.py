"""The port's logger (``c2dsr_tpu_torch/noter.py``) prints and writes the
same lines as ``c2dsr_tpu.noter.Noter`` for the same inputs, apart from the
device text, and names its log file the same way."""

import os
import re

from c2dsr_tpu.config import Config as JConfig
from c2dsr_tpu.noter import Noter as JNoter
from c2dsr_tpu_torch.config import Config
from c2dsr_tpu_torch.noter import Noter

RES = [0.1234, 0.5, 0.25, 0.125, 0.0625, 0.3, 0.2, 0.11, 0.22, 0.33, 0.44,
       0.55, 0.66]


def _drive(noter):
    noter.log_train(1.23456, 2.5, 0.75, 12.4, examples_per_s=9876.5)
    noter.log_train(1.0, 2.0, 3.0, 4.0)
    noter.log_evaluate("valid", RES)
    noter.log_evaluate("test", [-r for r in RES])
    noter.log_msg("\t| es    | 1 / 10 |")
    noter.log_final_result(7, 0.4321, RES)


def test_noter_lines_match_jax(tmp_path, capsys):
    kw = dict(data="mb", n_gnn=2, n_attn=3, n_head=4, lr=5e-4, l2=1e-3,
              dropout_gnn=0.1)
    jn = JNoter(JConfig(**kw), log_dir=str(tmp_path / "jax"),
                device_desc="TPU_0")
    _drive(jn)
    want = capsys.readouterr().out
    pn = Noter(Config(**kw), log_dir=str(tmp_path / "port"),
               device_desc="NVIDIA H100 80GB HBM3")
    _drive(pn)
    got = capsys.readouterr().out
    assert "device:NVIDIA H100 80GB HBM3" in got
    assert got.replace("NVIDIA H100 80GB HBM3", "TPU_0") == want
    with open(jn.f_log) as f, open(pn.f_log) as g:
        assert g.read().replace("NVIDIA H100 80GB HBM3", "TPU_0") == f.read()
    stamp = r"-\d\d-\d\d-\d\d:\d\d-"
    assert (re.sub(stamp, "-", os.path.basename(pn.f_log))
            == re.sub(stamp, "-", os.path.basename(jn.f_log))
            == "mb-2-3-4-0.0005-0.001.txt")
