"""Timing and bounds on the card, shared by the port's bench and
``chip_smoke.py``: the CUDA-event timer with its L2 flush, the card's
published peaks, the 3xTF32 and bf16 tensor-core bounds, a per-kernel
device-time profile, and the card's name and power limit.  Nothing here runs at
import: the CPU tests import every module.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch


class GateFailure(Exception):
    """A correctness check before a timing failed: the timing is void."""


def require_cuda(device, what: str) -> None:
    """Raise unless ``device`` is a CUDA device that is present: a timing
    on the card never falls back to the CPU."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"{what} times the card: it has no CPU mode")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs an NVIDIA card; none is present")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` gives it (Hz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


FADD_CYCLES = 4      # latency of a dependent f32 add on an SM (Hopper)


def chain_bound_ms(chain: int, clock_hz: float) -> float:
    """Least time for ``chain`` dependent f32 adds in a row: the order bound
    of a sum that must be taken in one order (K7's, bitwise
    ``index_add_``)."""
    return chain * FADD_CYCLES / clock_hz * 1e3


def peaks(name: str):
    """(FP32 non-tensor FLOP/s, memory bytes/s) from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 51e12, 2.0e12
    if "NVL" in name:
        return 60e12, 3.9e12
    return 67e12, 3.35e12            # H100 SXM


def tf32_peak(name: str) -> float:
    """Dense TF32 tensor-core FLOP/s from NVIDIA's data sheets.  A 3xTF32
    product (K5's f32-accurate scheme) costs three of them."""
    if "PCIe" in name:
        return 378e12
    return 495e12                    # H100 SXM


def tc_bound_ms(flops: float, nbytes: float, name: str, peak_bw: float):
    """Least time on the tensor cores for `flops` of f32-accurate work done
    as 3xTF32, or for the bytes, whichever is larger."""
    return max(3 * flops / tf32_peak(name), nbytes / peak_bw) * 1e3


def bf16_peak(name: str) -> float:
    """Dense bf16 tensor-core FLOP/s from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 756e12
    return 989e12                    # H100 SXM


def bf16_bounds_ms(flops: float, nbytes: float, name: str, peak_bw: float):
    """Least times of `flops` of products of bf16 operands and `nbytes`:
    (at the bf16 tensor-core peak, at one TF32 pass a product, which the
    kernels' bf16 instantiations take), each against the bytes."""
    return (max(flops / bf16_peak(name), nbytes / peak_bw) * 1e3,
            max(flops / tf32_peak(name), nbytes / peak_bw) * 1e3)


def se_resolved(a, b):
    """(mean(a) - mean(b), its standard error, whether the difference lies
    beyond 3 standard errors) of two samples of one measure taken in
    turns."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    diff = a.mean() - b.mean()
    se = float(np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b)))
    return float(diff), se, bool(abs(diff) > 3 * se)


class Timer:
    """Median CUDA-event time of ``reps`` runs after warm-up; L2 is flushed
    (a 256 MB write) before each run, outside the timed window."""

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def __call__(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def kernel_times(fn, calls: int = 3, tries: int = 3):
    """({kernel name: device ms a call}, {kernel name: launches a call}) for
    a fn that launches the same kernels each call, under torch.profiler:
    the totals over ``calls`` calls over ``calls``.  The profiler may miss
    the first kernels of its window, so one profiled call is not enough,
    and a window where some kernel's launches are not a whole number a
    call (one missed) is profiled again, up to ``tries`` windows.  Names
    drop the argument list and the anonymous namespace, and keep template
    arguments."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, count = {}, {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            if ev.device_type == torch.autograd.DeviceType.CUDA and us > 0:
                name = ev.key.replace("(anonymous namespace)::", "")
                name = name.split("(")[0].removeprefix("void ")
                total[name] = total.get(name, 0.0) + us / 1e3
                count[name] = count.get(name, 0) + ev.count
        if all(n % calls == 0 for n in count.values()):
            break
    return ({name: ms / calls for name, ms in total.items()},
            {name: n / calls for name, n in count.items()})
