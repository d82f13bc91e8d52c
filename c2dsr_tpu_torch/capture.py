"""CUDA graph capture of the train step and the ranking step.

The JAX package compiles its train step into one program with its state
donated (``c2dsr_tpu/train/step.py:173-192``) and its ranking into jitted
programs (``c2dsr_tpu/evaluate/ranker.py:70-100``).  The port's
counterpart records each step as one CUDA graph and replays it: one launch
from the host where an eager step enqueues some 400.  ``jax.jit`` traces
once per shape; a :class:`Program` captures once per key, the batch
signature (:func:`signature`: keys, shapes, dtypes), so the full batch and
the ragged last batch of an epoch, or a ``valid`` key, each get their own
graph.  Every graph of one program takes its memory from one pool.

A program's first call of a key runs its body eagerly on a side stream: a
real call (the step's first run, not a rehearsal) that also makes every
lazy initialisation happen outside a capture (the kernels' libraries, K7's
shared-memory attribute, the optimizer's state).  Its second call
captures, which runs nothing, then replays; later calls replay.  So a run
takes the same sequence of states whether it is captured or not.

A graph reads and writes fixed addresses, so what changes between calls
lives in static memory that the program fills outside the graph:

* the batch: each key staged through pinned host buffers into static
  device inputs (:class:`Staging`), copied without blocking the host;
* the step's dropout seed, a device scalar that the towers' kernels read
  (``csrc/dropout.cuh``), and the GNN dropout's generator, registered
  with every graph and re-seeded before each replay (``train/step.py``);
* the learning rate, a device scalar of the capturable AdamW that the
  schedule fills (``train/optim.py``), and the gradients, allocated once.

K7 keeps its workspaces per stream in a shared cache (``ops/segsum_cuda``),
from which a later call could evict or take a workspace a graph points at:
each graph holds its own for its lifetime (:meth:`Program.run`).  The
wrappers' launch counters count a captured launch once, at capture: a
program takes that back and adds each graph's launches at each replay, so
a counter reads launches on the card, kernels times replays.

Capture applies to one process on the card.  On the CPU there is no
graph; a mesh's collectives (gloo) are not captured, and NCCL's capture
needs one card per rank; ``debug_nans`` runs autograd's anomaly mode.
Those run the eager step, by :func:`resolve`, and ``capture=True`` there
raises.  A failed capture or replay raises, and is never retried eagerly.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from c2dsr_tpu_torch.ops import segsum_cuda
from c2dsr_tpu_torch.ops.wrappers import kernels_routed, launch_counters

STAGING_SLOTS = 2     # pinned host buffers a key, used in turn


def resolve(capture: Optional[bool], device: torch.device, mesh=None,
            debug_nans: bool = False) -> Tuple[bool, str]:
    """(whether to capture, the mode as the log states it).  ``capture``
    None takes the default: captured wherever a graph can run.  True where
    none can raises."""
    reason = None
    if device.type != "cuda":
        reason = "a CPU tensor runs no CUDA graph"
    elif mesh is not None:
        reason = ("a mesh's collectives are not captured (gloo; NCCL "
                  "capture needs one card per rank)")
    elif debug_nans:
        reason = "debug_nans runs autograd's anomaly mode"
    if reason is not None:
        if capture:
            raise ValueError(f"capture=True, but {reason}")
        return False, f"eager: {reason}"
    if capture is False:
        return False, "eager: capture=False"
    return True, "captured: one CUDA graph per batch signature"


def signature(batch: Dict[str, Any]) -> tuple:
    """The key of a batch: its keys, shapes and dtypes."""
    return tuple((k, tuple(np.shape(v)), np.asarray(v).dtype.str)
                 for k, v in sorted(batch.items()))


def leaf_ptrs(tree) -> tuple:
    """The data pointers of every tensor of a nested dict (a parameter
    tree), in a fixed order: a graph is valid for the tensors at these
    addresses."""
    if isinstance(tree, dict):
        return tuple(p for k in sorted(tree) for p in leaf_ptrs(tree[k]))
    return (tree.data_ptr(),)


class Staging:
    """Static int64 device inputs of one batch signature, filled from numpy
    through pinned host buffers (``STAGING_SLOTS`` of them, in turn) by
    copies that do not block the host; an event a slot keeps the host from
    refilling it while its copy is in flight.  On the CPU the host buffers
    are plain memory and the copies synchronous."""

    def __init__(self, batch: Dict[str, np.ndarray], device: torch.device):
        self.device = device
        pin = device.type == "cuda"
        self.keys = sorted(batch)
        self.slots = []
        for _ in range(STAGING_SLOTS if pin else 1):
            host = {k: torch.empty(np.shape(batch[k]), dtype=torch.int64,
                                   pin_memory=pin) for k in self.keys}
            self.slots.append([host, {k: t.numpy() for k, t in host.items()},
                               None])
        self.inputs = {k: torch.empty(np.shape(batch[k]), dtype=torch.int64,
                                      device=device) for k in self.keys}
        self.turn = 0

    def __call__(self, batch: Dict[str, np.ndarray]
                 ) -> Dict[str, torch.Tensor]:
        """``batch`` copied into :attr:`inputs` (returned), in stream order
        on the card."""
        host, host_np, done = self.slots[self.turn]
        if done is not None:
            done.synchronize()
        for k in self.keys:
            np.copyto(host_np[k], batch[k])
        for k in self.keys:
            self.inputs[k].copy_(host[k], non_blocking=True)
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            self.slots[self.turn][2] = done
        self.turn = (self.turn + 1) % len(self.slots)
        return self.inputs


class _Entry:
    """One key of a program: its graph once captured, the static outputs
    the graph writes, the launches a replay makes, K7's workspaces."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.launches: List[int] = []
        self.workspaces: Dict[tuple, Any] = {}
        self.capture_s = 0.0
        self.replays = 0
        self.failed = False


class Program:
    """A body captured as one CUDA graph per key (``capture=True``), or run
    eagerly on every call.  ``generators``: device generators the body
    draws from, registered with every graph (their state before each
    replay is the caller's to set).  All graphs share one memory pool;
    with ``max_keys`` the least recently used key's graph is dropped past
    that many.  While the plain versions or a recorder stand in for a
    kernel (``ops/wrappers.kernels_routed``), a call runs its body
    eagerly, as the gates' comparison runs have it."""

    def __init__(self, capture: bool, generators=(),
                 max_keys: Optional[int] = None):
        self.capture = capture
        self.generators = list(generators)
        self.max_keys = max_keys
        self.entries: Dict[Any, _Entry] = {}
        self.pool = torch.cuda.graph_pool_handle() if capture else None

    def reset(self) -> None:
        """Drop every graph (the state they were bound to is gone)."""
        self.entries.clear()

    def run(self, key, body: Callable[[], Any]) -> Tuple[Any, bool]:
        """(``body()``'s outputs, whether they are a graph's static outputs,
        which its next replay overwrites)."""
        if not (self.capture and kernels_routed()):
            return body(), False
        entry = self.entries.pop(key, None)
        if entry is not None:
            self.entries[key] = entry        # the most recently used last
        else:
            # warm-up: the key's first call, eager on a side stream
            entry = self.entries[key] = _Entry()
            while self.max_keys and len(self.entries) > self.max_keys:
                self.entries.pop(next(iter(self.entries)))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), \
                    segsum_cuda.private_workspaces(entry.workspaces):
                out = body()
            torch.cuda.current_stream().wait_stream(side)
            return out, False
        if entry.failed:
            raise RuntimeError(f"the capture of {key!r} failed before; the "
                               "program does not run it eagerly instead")
        if entry.graph is None:
            self._capture(entry, body)
        entry.graph.replay()
        entry.replays += 1
        for (fn, attr), n in zip(launch_counters(), entry.launches):
            if n:
                setattr(fn, attr, getattr(fn, attr) + n)
        return entry.outputs, True

    def _capture(self, entry: _Entry, body) -> None:
        counters = launch_counters()
        before = [getattr(fn, attr) for fn, attr in counters]
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        t0 = time.perf_counter()
        entry.failed = True
        try:
            with segsum_cuda.private_workspaces(entry.workspaces), \
                    torch.cuda.graph(graph, pool=self.pool):
                outputs = body()
        finally:
            # the capture launched nothing: its counts go to each replay
            after = [getattr(fn, attr) for fn, attr in counters]
            for (fn, attr), n in zip(counters, before):
                setattr(fn, attr, n)
        entry.launches = [a - b for a, b in zip(after, before)]
        entry.graph, entry.outputs = graph, outputs
        entry.capture_s = time.perf_counter() - t0
        entry.failed = False

    def stats(self) -> Dict[str, Any]:
        """Graphs, their capture seconds and replays, and the pool's bytes
        (the card's memory the graphs hold)."""
        graphs = [e for e in self.entries.values() if e.graph is not None]
        pool = 0
        if self.pool is not None:
            for seg in torch.cuda.memory_snapshot():
                if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool):
                    pool += seg["total_size"]
        return {"graphs": len(graphs),
                "capture_s": [e.capture_s for e in graphs],
                "replays": [e.replays for e in graphs],
                "launches_per_replay": [sum(e.launches) for e in graphs],
                "pool_bytes": pool}
