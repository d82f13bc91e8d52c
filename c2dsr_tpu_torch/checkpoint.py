"""Checkpoint save/restore (params + optimizer state + step + bookkeeping).

The port's counterpart of ``c2dsr_tpu/checkpoint.py``, with its API
(``save``, ``restore``, ``load_meta``, ``exists``, ``wait``) and its
durability contract, written with ``torch.save`` instead of Orbax.  The
files are not interchangeable with the JAX package's.

Saves are asynchronous: ``save`` copies the params, the ``AdamW`` and
``LambdaLR`` state dicts and the step to host memory before it returns (the
training step updates the params and the moments in place, so the copy
cannot wait), and only the disk write runs on a background thread, so
save-on-best overlaps the next training epoch.

Durability model (crash-safe at every instant):
  * saves alternate between ``<path>/state0`` and ``<path>/state1``;
    dispatching save k deletes only the checkpoint from two saves ago, so
    the most recent complete checkpoint is never touched while the new
    commit is in flight;
  * ``meta.json`` (scalar bookkeeping, greppable) names ``state_dir`` and is
    written atomically, only after the state commit has finished, so it
    always points at a fully written checkpoint;
  * when a commit fails, its pending meta is dropped, never written, and
    ``wait`` raises the commit's error: ``meta.json`` keeps pointing at the
    previous complete checkpoint;
  * an ``atexit`` hook joins the commit in flight and writes its meta.  Only
    a hard kill during the commit loses the in-flight save, never the one
    before it.

``restore`` copies into the template's tensors in place, so the optimizer
stays bound to the same parameter tensors, and loads with
``weights_only=True``.

On a mesh (``parallel/mesh.py``), ``save`` gathers the model-sharded
parameters and their AdamW moments whole (a collective every rank joins),
and rank 0 alone writes, in the format of a one-device run; ``restore``
reads the whole state on every rank and cuts its shards.  So a checkpoint
taken on a 1x2 mesh resumes on one device, and the other way round.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import torch

_STATE_FILE = "state.pt"


def _to_host(obj):
    """A copy of a state tree with every tensor copied to host memory
    (synchronously: the copy is complete when this returns)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _snapshot(state, mesh=None) -> Dict[str, Any]:
    """What a checkpoint holds of a ``train.step.TrainState``: on a mesh,
    the whole state, gathered from the ranks' shards."""
    opt = state.opt_state
    params, adamw = state.params, opt.adamw.state_dict()
    if mesh is not None and mesh.n_model > 1:
        from c2dsr_tpu_torch.parallel import mesh as mesh_mod
        names = mesh_mod.leaf_names(params)
        params = mesh_mod.unshard_params(params, mesh)
        adamw = mesh_mod.unshard_adamw(adamw, names, mesh)
    return _to_host({"params": params, "adamw": adamw,
                     "schedule": opt.schedule.state_dict(),
                     "step": int(state.step)})


class _Committer:
    """The one background commit in flight, and the meta it will write."""

    def __init__(self):
        self.lock = threading.Lock()
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[Exception] = None
        self.pending_meta: Optional[tuple] = None

    def start(self, state_dir: str, snap: Dict[str, Any], path: str,
              meta: Dict[str, Any]) -> None:
        def commit():
            try:
                shutil.rmtree(state_dir, ignore_errors=True)
                os.makedirs(state_dir)
                tmp = os.path.join(state_dir, _STATE_FILE + ".tmp")
                torch.save(snap, tmp)
                os.replace(tmp, os.path.join(state_dir, _STATE_FILE))
            except Exception as e:      # raised again by wait()
                self.error = e

        with self.lock:
            self.error = None
            self.pending_meta = (path, meta)
            self.thread = threading.Thread(target=commit,
                                           name="checkpoint-commit")
            self.thread.start()

    def join(self) -> Optional[tuple]:
        """Join the commit in flight; its (path, meta) if it succeeded.
        Raises the commit's error after dropping its meta."""
        with self.lock:
            thread, self.thread = self.thread, None
            if thread is not None:
                thread.join()
            pending, self.pending_meta = self.pending_meta, None
            error, self.error = self.error, None
        if error is not None:
            raise error
        return pending


_COMMITTER = _Committer()


def _write_meta(path: str, meta: Dict[str, Any]) -> None:
    os.makedirs(path, exist_ok=True)   # atexit may fire after dir cleanup
    tmp = os.path.join(path, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, os.path.join(path, "meta.json"))


def wait() -> None:
    """Join the commit in flight (if any) and write its meta; raise its
    error, with its meta dropped, if it failed."""
    pending = _COMMITTER.join()
    if pending is not None:
        _write_meta(*pending)


atexit.register(wait)


def _state_dir(path: str) -> Optional[str]:
    """Directory of the newest COMPLETE checkpoint, or None."""
    name = load_meta(path, _wait=False).get("state_dir")
    if name and os.path.isfile(os.path.join(path, name, _STATE_FILE)):
        return os.path.join(path, name)
    return None


def save(path: str, state: Any, meta: Optional[Dict[str, Any]] = None,
         block: bool = False, mesh=None) -> None:
    """Checkpoint a ``train.step.TrainState`` under ``path``.

    block=False (default): returns once the state is copied to host memory;
    the disk commit runs on a background thread and meta.json is written
    when it completes (on the next ``save``/``wait``/exit).  block=True
    commits synchronously.  On a ``mesh`` every rank calls it; rank 0
    writes."""
    path = os.path.abspath(path)
    wait()                       # at most one commit in flight
    snap = _snapshot(state, mesh)
    if mesh is not None and mesh.rank != 0:
        return
    os.makedirs(path, exist_ok=True)
    prev = load_meta(path, _wait=False).get("state_dir")
    nxt = "state1" if prev == "state0" else "state0"
    # the commit deletes only <nxt>, the checkpoint from TWO saves ago; the
    # one meta.json points at (<prev>) stays intact until the new commit
    # has landed and meta is rewritten
    _COMMITTER.start(os.path.join(path, nxt), snap, path,
                     dict(meta or {}, state_dir=nxt))
    if block:
        wait()


def _copy_into(dst, src, where: str = "params") -> None:
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"checkpoint {where} keys differ: "
                             f"{sorted(set(dst) ^ set(src))}")
        for k in dst:
            _copy_into(dst[k], src[k], f"{where}.{k}")
    elif dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(f"checkpoint {where}: {src.dtype} "
                         f"{tuple(src.shape)}, the template has {dst.dtype} "
                         f"{tuple(dst.shape)}")
    else:
        with torch.no_grad():
            dst.copy_(src)


def restore(path: str, template: Optional[Any] = None, mesh=None) -> Any:
    """Restore the newest complete checkpoint under ``path``.

    With a ``template`` TrainState: copy the params into its tensors in
    place, load the optimizer and schedule state into its optimizer (which
    stays bound to those tensors) and return the TrainState with the saved
    step; on a ``mesh``, the template holds this rank's shards, cut from the
    saved whole.  Without one: the saved tree, on the host."""
    wait()                       # never read concurrently with a commit
    path = os.path.abspath(path)
    state_dir = _state_dir(path)
    if state_dir is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    snap = torch.load(os.path.join(state_dir, _STATE_FILE),
                      map_location="cpu", weights_only=True)
    if template is None:
        return snap
    params, adamw = snap["params"], snap["adamw"]
    if mesh is not None and mesh.n_model > 1:
        from c2dsr_tpu_torch.parallel import mesh as mesh_mod
        names = mesh_mod.leaf_names(params)
        params = mesh_mod.shard_params(params, mesh)
        adamw = mesh_mod.shard_adamw(adamw, names, mesh)
    _copy_into(template.params, params)
    template.opt_state.adamw.load_state_dict(adamw)
    template.opt_state.schedule.load_state_dict(snap["schedule"])
    return template._replace(step=snap["step"])


def load_meta(path: str, _wait: bool = True) -> Dict[str, Any]:
    if _wait:
        wait()
    meta_file = os.path.join(os.path.abspath(path), "meta.json")
    if not os.path.isfile(meta_file):
        return {}
    with open(meta_file) as f:
        return json.load(f)


def exists(path: str) -> bool:
    wait()
    return _state_dir(os.path.abspath(path)) is not None
