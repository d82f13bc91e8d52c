"""Run a function on the ranks of a mesh, each a process of its own on this
host, and collect what each returns.

    results = launch.run_ranks(fn, world=4, args=(...,), device="cpu")

``fn(rank, world, *args)`` must be a module-level function (the ranks are
started with ``spawn``), and what it returns picklable (numpy arrays, not
tensors).  Each rank joins a process group over ``tcp://localhost:<free
port>`` (``distributed.initialize``: gloo on the CPU or where ranks share a
card, NCCL where each has a card of its own) with the same ``timeout``,
which also bounds the whole run (None: the run is unbounded, each
collective waits ``distributed.DEFAULT_TIMEOUT``): a rank that fails or
hangs fails the call with its traceback instead of hanging the caller, and
every process started is stopped before it returns.
"""

from __future__ import annotations

import datetime
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch.multiprocessing as mp

from c2dsr_tpu_torch.parallel import distributed


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, fn: Callable, args, device,
           timeout: Optional[float], results) -> None:
    try:
        distributed.initialize(
            f"localhost:{port}", world, rank, device=device,
            timeout=(distributed.DEFAULT_TIMEOUT if timeout is None
                     else datetime.timedelta(seconds=timeout)))
        if str(device).startswith("cuda"):
            import torch
            torch.cuda.set_device(distributed.device_of_rank(device))
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:          # reported to the caller, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        distributed.shutdown()


def run_ranks(fn: Callable, world: int, args: Sequence[Any] = (),
              device="cpu", timeout: Optional[float] = 120.0) -> List[Any]:
    """[fn(0, world, *args), ..., fn(world - 1, world, *args)], each run in
    its own process; raises if any rank fails, or if they are not all done
    within ``timeout`` seconds (None: no bound)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry,
                         args=(r, world, port, fn, tuple(args), str(device),
                               timeout, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + (float("inf") if timeout is None
                                   else timeout)
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))}"
                                   f" not done within {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10 if len(got) == world else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]
