"""The PyTorch port's import boundary and device contract.

The port (c2dsr_tpu_torch) imports neither JAX nor the JAX package, its
entry points refuse to run on CUDA without a card unless the caller asks
for the CPU, and its kernel wrappers take CUDA tensors only.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import c2dsr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(c2dsr_tpu_torch.__path__,
                                               "c2dsr_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "jaxlib"
             or k == "c2dsr_tpu" or k.startswith("c2dsr_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for sub in ("c2dsr_tpu_torch.evaluate.ranker", "c2dsr_tpu_torch.ops.spmm_cuda",
                "c2dsr_tpu_torch.ops.encoder_cuda", "c2dsr_tpu_torch.kernels.build",
                "c2dsr_tpu_torch.train.step", "c2dsr_tpu_torch.train.optim",
                "c2dsr_tpu_torch.ops.fused_ce", "c2dsr_tpu_torch.ops.fused_ce_cuda",
                "c2dsr_tpu_torch.ops.dropout", "c2dsr_tpu_torch.ops.losses",
                "c2dsr_tpu_torch.data.pipeline", "c2dsr_tpu_torch.cli",
                "c2dsr_tpu_torch.checkpoint", "c2dsr_tpu_torch.noter",
                "c2dsr_tpu_torch.train.loop"):
        assert sub in res["modules"]


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert "import jax" not in src and "c2dsr_tpu." not in src.replace(
        "c2dsr_tpu_torch", "")


def _tiny():
    from c2dsr_tpu_torch.config import Config, DataSpec
    from c2dsr_tpu_torch.data import synthetic
    from c2dsr_tpu_torch.graph import build
    spec = DataSpec(n_item_a=20, n_item_b=30, len_max=8)
    cfg = Config(d_latent=32, vocab_pad_multiple=64)
    share, specific = build.build_graphs(
        synthetic.generate_sequences(spec, 40, seed=0), spec)
    return cfg, spec, share, specific


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import spmm
    cfg, spec, share, specific = _tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spmm.device_graph(share)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_mod.init_params(cfg, spec, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_mod.params_from_numpy({"w": np.zeros(3, np.float32)})
    graphs = c2dsr.Graphs(spmm.device_graph(share, "cpu"),
                          spmm.device_graph(specific, "cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ranker.make_eval_fns(cfg, spec, graphs)
    from c2dsr_tpu_torch.train import optim, step
    opt = optim.make_optimizer(cfg, steps_per_epoch=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        step.make_train_step(cfg, spec, graphs, opt)
    # asked for the CPU, every entry point runs
    ranker.make_eval_fns(cfg, spec, graphs, device="cpu")
    params_mod.init_params(cfg, spec, torch.Generator().manual_seed(0), "cpu")
    step.make_train_step(cfg, spec, graphs, opt, "cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel on CUDA tensors or raises; the plain
    version is chosen by ops/backend for CPU tensors only."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import backend, encoder_cuda, spmm, spmm_cuda
    _, _, share, _ = _tiny()
    g = spmm.device_graph(share, "cpu")
    h = torch.randn(g.n, 8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        spmm_cuda.spmm_csr(g, h)
    torch.testing.assert_close(backend.spmm(g, h), spmm.spmm_reference(g, h),
                               rtol=0, atol=0)
    p = params_mod.init_encoder_params(torch.Generator().manual_seed(0),
                                       Config(d_latent=64), 8)
    x = torch.randn(2, 8, 64)
    seq = torch.zeros(2, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        encoder_cuda.encoder_fwd(x, seq, p, idx_pad=5, n_head=1,
                                 invert_padding_mask=False)
    assert spmm_cuda.spmm_csr.launches == 0
    assert encoder_cuda.encoder_fwd.launches == 0


@pytest.mark.parametrize("d,n_head,length,ok", [
    (128, 1, 15, True), (128, 2, 30, True), (64, 2, 15, True),
    (32, 1, 15, True), (256, 1, 15, True), (128, 32, 15, False),
    (128, 1, 33, True), (32, 1, 30, True), (96, 2, 30, True),
    (96, 4, 15, True), (160, 2, 16, True), (256, 4, 16, True),
    (224, 28, 15, True), (256, 1, 17, True), (256, 4, 30, True),
    (160, 1, 30, True), (40, 1, 15, True), (288, 1, 15, True),
    (64, 3, 15, False), (64, 1, 0, False), (40, 1, 30, True),
    (8, 1, 15, True), (256, 4, 32, True), (256, 4, 33, True),
    (264, 1, 15, True), (44, 1, 15, False), (40, 2, 15, False),
    (512, 4, 15, True), (512, 8, 30, True), (128, 2, 64, True),
    (256, 4, 64, True), (96, 2, 48, True), (512, 1, 64, True),
    (128, 1, 65, False), (512, 4, 65, False), (520, 1, 15, False),
    (1024, 8, 15, False), (512, 128, 15, False)])
def test_encoder_kernel_shape_contract(d, n_head, length, ok):
    """encoder_cuda.supported, the one rule both tower kernels take: every
    width at which the JAX package runs its fused encoder up to d 512 (d a
    multiple of 8, head dim a multiple of 8) and L up to 64 at every width;
    d above 512 and L above 64 are refused."""
    from c2dsr_tpu_torch.ops import encoder_cuda
    assert encoder_cuda.supported(d, n_head, length) is ok


def test_config_resolves_auto_to_f32_without_jax():
    from c2dsr_tpu_torch.config import Config
    cfg = Config()
    assert cfg.resolved_compute_dtype() == "float32"
    assert cfg.resolved_classifier_dtype() == "float32"
    assert Config(compute_dtype="bfloat16").resolved_compute_dtype() == \
        "bfloat16"


def test_config_refuses_tpu_only_knobs():
    """The JAX package's TPU-only settings have no counterpart in the port:
    setting one is an error, not a silent no-op."""
    from c2dsr_tpu_torch.config import Config
    for name in ("kernel_backend", "train_prng", "pallas_interpret",
                 "mesh_data", "mesh_model", "lookup_mode"):
        with pytest.raises(TypeError):
            Config(**{name: None})


def test_training_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers of the training slice's kernels launch on CUDA tensors
    or raise, and count no launch when they raise."""
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import encoder_cuda, fused_ce_cuda, spmm, spmm_cuda
    _, _, share, _ = _tiny()
    g = spmm.device_graph(share, "cpu")
    h = torch.randn(g.n, 8, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        spmm_cuda.hop(g, h)
    p = params_mod.init_encoder_params(torch.Generator().manual_seed(0),
                                       Config(d_latent=64), 8)
    x = torch.randn(2, 8, 64)
    seq = torch.zeros(2, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        encoder_cuda.encoder_bwd(x, seq, x, p, idx_pad=5, n_head=1,
                                 invert_padding_mask=False, dropout=0.2)
    hh, w = torch.randn(4, 64), torch.randn(64, 8)
    b, v = torch.zeros(8), torch.zeros(4)
    t = torch.zeros(4, dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fused_ce_cuda.ce_fwd(hh, w, b, v, t)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fused_ce_cuda.ce_bwd(hh, w, b, v, v, v, t)
    for fn in (encoder_cuda.encoder_bwd, fused_ce_cuda.ce_fwd,
               fused_ce_cuda.ce_bwd, spmm_cuda.spmm_csr):
        assert fn.launches == 0
