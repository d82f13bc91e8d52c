"""``--ablation``: where a train step's time goes, the counterpart of the
JAX package's ``bench/step_ablation.py:57-136``.

Times the full train step at FK geometry (``bench/fk_graph.py``), batch
512, then variants with one component stubbed or switched off; the delta
against ``full`` is that component's cost, its backward included:

* ``no_ce``: ``LocalOps.ce_rows`` replaced by a row mean x 1e-3, as the
  JAX script does (no K4, no K5);
* ``no_spmm``: ``n_gnn=0``, the tables used unpropagated (no K1);
* ``plain_encoder``: the port's plain tower instead of K2/K3 (the JAX
  script's ``xla_encoder``);
* ``no_dropout``: ``dropout_gnn = dropout_attn = 0``.

The JAX script's ``f32_compute`` is left out: the port computes in f32 by
default, so it would be ``full``.  Each variant reports its wall ms a step
(the best of 3 windows of the headline's 30 steps; the JAX script's are
40) and its device-busy ms a step (the CUDA kernels' time under
``torch.profiler``, ``timing.kernel_times``): the step is host-bound, so a component's
device time need not show as wall time.  Gates: ``full`` passes the
headline's train gate (``bench/__main__.train_gate``), every variant's
loss is finite, and on the card each variant launched exactly the kernels
it should.  The stubs live here, restored in ``finally``.  Each variant's
step is the default one, captured as a CUDA graph on the card
(``capture.py``): the stubs are in place when its graph is captured.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import numpy as np
import torch

from c2dsr_tpu_torch.bench import scaled_e2e, timing

WINDOWS = 3
BUSY_STEPS = 3           # profiled steps of the busy time (after one more)
# the kernels each variant must not launch; every other step kernel must
OFF = {"full": (), "no_ce": ("ce_fwd", "ce_bwd"), "no_spmm": ("spmm_csr",),
       "plain_encoder": ("encoder_fwd", "encoder_bwd"), "no_dropout": ()}


@contextlib.contextmanager
def _no_ce():
    from c2dsr_tpu_torch.parallel import strategy
    orig = strategy.LocalOps.ce_rows
    strategy.LocalOps.ce_rows = (
        lambda self, h, w, b, pad, tgt, n_real: h.mean(dim=-1) * 1e-3)
    try:
        yield
    finally:
        strategy.LocalOps.ce_rows = orig


@contextlib.contextmanager
def _plain_encoder():
    from c2dsr_tpu_torch.ops import backend
    orig = backend.fused_encoder_runs
    backend.fused_encoder_runs = lambda n_head, d, norm_first: False
    try:
        yield
    finally:
        backend.fused_encoder_runs = orig


def step_time(cfg, sp, graphs, feed, device, warmup: int, windows: int,
              steps: int, busy_steps: int) -> Dict:
    """The step of ``cfg`` over the batches ``feed``, cycled: ``warmup``
    steps, then the best of ``windows`` windows of ``steps``."""
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.train import optim
    from c2dsr_tpu_torch.train import step as step_mod
    params = params_mod.init_params(cfg, sp, torch.Generator().manual_seed(0),
                                    device)
    opt = optim.make_optimizer(cfg, steps_per_epoch=16)
    state = step_mod.init_state(params, opt)
    fn = step_mod.make_train_step(cfg, sp, graphs, opt, device)
    for i in range(warmup):
        state, aux = fn(state, feed[i % len(feed)])
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    before = scaled_e2e.launches()
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for i in range(steps):
            state, aux = fn(state, feed[i % len(feed)])
        if on_card:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / steps)
    after = scaled_e2e.launches()
    loss = float(aux["loss"])
    busy = None
    if on_card:
        held = [state]

        def one_step():
            held[0], _ = fn(held[0], feed[0])

        busy = sum(timing.kernel_times(one_step, busy_steps)[0].values())
    wall = min(times) * 1e3
    return {"step_ms": wall, "window_step_ms": [t * 1e3 for t in times],
            "examples_per_s": cfg.batch_size / min(times), "busy_ms": busy,
            "idle_share": None if busy is None else 1.0 - busy / wall,
            "loss": loss, "launches": {k: after[k] - before[k]
                                       for k in after}}


def run(spec=None, device="cuda", windows: int = WINDOWS,
        busy_steps: int = BUSY_STEPS, log=print) -> Dict:
    """Every variant's times at ``spec`` (the bench's FK one by default;
    ``spec.steps`` steps a window), after the gates (GateFailure)."""
    from c2dsr_tpu_torch.bench import __main__ as bench_main
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import params as params_mod
    spec = spec or bench_main.FK
    steps = spec.steps
    sp, train, graphs = bench_main.setup(spec, device)
    device = torch.device(device)
    cfg = Config(batch_size=spec.batch)
    params = params_mod.init_params(cfg, sp, torch.Generator().manual_seed(0),
                                    device)
    from c2dsr_tpu_torch.train import step as step_mod
    leaves = step_mod.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    feed = bench_main._batches(train, spec.batch, spec.n_batches)
    gate = bench_main.train_gate(cfg, sp, graphs, leaves, params,
                                 ranker.to_device(feed[0], device))
    del params, leaves
    variants = (("full", cfg, contextlib.nullcontext),
                ("no_ce", cfg, _no_ce),
                ("no_spmm", cfg.with_(n_gnn=0), contextlib.nullcontext),
                ("plain_encoder", cfg, _plain_encoder),
                ("no_dropout", cfg.with_(dropout_gnn=0.0, dropout_attn=0.0),
                 contextlib.nullcontext))
    results = {}
    for tag, cfg_v, stub in variants:
        with stub():
            r = step_time(cfg_v, sp, graphs, feed, device, spec.warmup,
                          windows, steps, busy_steps)
        if not np.isfinite(r["loss"]):
            raise timing.GateFailure(f"ablation {tag}: loss {r['loss']}")
        if device.type == "cuda":
            wrong = {k: n for k, n in r["launches"].items()
                     if (n > 0) == (k in OFF[tag])}
            if wrong:
                raise timing.GateFailure(f"ablation {tag}: launches {wrong} "
                                         f"(off: {OFF[tag]})")
        results[tag] = r
        log(f"ablation {tag:14s} {r['step_ms']:8.3f} ms wall, busy "
            f"{r['busy_ms']} ms ({r['examples_per_s']:.1f} examples/s)")
        if device.type == "cuda":
            torch.cuda.empty_cache()
    base = results["full"]
    tags = [t for t in results if t != "full"]
    return {
        "method": "the FK step at batch 512, re-timed with one component "
                  "stubbed or switched off; the delta against full is that "
                  "component's cost, its backward included, in wall ms "
                  "(best of the windows) and in device-busy ms (profiled)",
        "device": bench_main.device_name(device),
        "batch": spec.batch, "windows": windows, "steps": steps,
        "busy_steps": busy_steps, "train_gate": gate,
        "f32_compute": "not run: the port computes in f32 by default, so "
                       "the JAX script's f32_compute variant is full",
        "variants": results,
        "attribution_ms": {t: base["step_ms"] - results[t]["step_ms"]
                           for t in tags},
        "attribution_busy_ms": (
            {t: base["busy_ms"] - results[t]["busy_ms"] for t in tags}
            if base["busy_ms"] is not None else None)}
