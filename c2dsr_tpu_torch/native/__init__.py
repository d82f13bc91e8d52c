"""The port's native data layer: ctypes bindings of ``preprocess.cpp``.

``preprocess.cpp`` is the port's copy of the JAX package's C++ data layer
(``c2dsr_tpu/native``): interaction parsing, graph edge extraction and the
packed train and eval splits.  Its corrupted sequences and sampled negatives
come from ``std::mt19937_64`` streams, so they differ from the port's Python
path (numpy's generator), whose deterministic fields are the same.  The
port's ``load_or_build_split`` and ``build_graphs_from_file`` run this
library, as the JAX package's do, so that both packages train and evaluate
on the same splits from the same raw files and seed.

The library is compiled with ``g++`` at first use, never at import, into
``build/c2dsr_tpu_torch/`` beside the package (git-ignored), under a name
that carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is not.  Concurrent builds (test workers, the
ranks of a mesh) each compile to a name of their own and ``os.replace`` it
into place.  A failed build raises with the compiler's output: there is no
silent fallback to the Python path, whose random fields differ.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from typing import Tuple

import numpy as np

from c2dsr_tpu_torch.kernels.build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "preprocess.cpp")
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

N_TRAIN_FIELDS = 14
EVAL_SEQ_FIELDS = 6


def lib_path(src: str = SRC, build_dir: str = BUILD_DIR) -> str:
    """The library's path, named by a hash of the source and the flags."""
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir, f"native_preprocess-{h.hexdigest()[:16]}.so")


def build(src: str = SRC, build_dir: str = BUILD_DIR) -> str:
    """Compile ``src`` unless its library exists; returns the library's path.
    Raises RuntimeError with the compiler's output when the build fails."""
    lib = lib_path(src, build_dir)
    if os.path.exists(lib):
        return lib
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        run = subprocess.run([CXX, *CXX_FLAGS, src, "-o", tmp],
                             capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"{CXX} could not run ({e}): the native data "
                           "layer cannot be built") from e
    if run.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{CXX} failed to build {src} "
                           f"(exit {run.returncode}):\n{run.stderr}")
    os.replace(tmp, lib)
    return lib


class Native:
    """The library's four entry points on numpy arrays."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        c = ctypes
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.cds_parse.restype = c.c_void_p
        lib.cds_parse.argtypes = [c.c_char_p]
        lib.cds_n_users.restype = c.c_int64
        lib.cds_n_users.argtypes = [c.c_void_p]
        lib.cds_n_interactions.restype = c.c_int64
        lib.cds_n_interactions.argtypes = [c.c_void_p]
        lib.cds_fill.argtypes = [c.c_void_p, i64p, i32p]
        lib.cds_free.argtypes = [c.c_void_p]
        lib.cds_build_edges.restype = c.c_int64
        lib.cds_build_edges.argtypes = [i64p, i32p, c.c_int64, c.c_int32,
                                        i32p, i32p, c.POINTER(c.c_int64)]
        lib.cds_preprocess_train.restype = c.c_int64
        lib.cds_preprocess_train.argtypes = [
            i64p, i32p, c.c_int64, c.c_int32, c.c_int32, c.c_int32,
            c.c_uint64, i32p]
        lib.cds_preprocess_eval.restype = c.c_int64
        lib.cds_preprocess_eval.argtypes = [
            i64p, i32p, c.c_int64, c.c_int32, c.c_int32, c.c_int32,
            c.c_int32, c.c_int32, c.c_uint64, i32p, i32p, i32p]

    def parse_interactions(self, path: str) -> Tuple[np.ndarray, np.ndarray]:
        """-> (offsets int64 [n_users + 1], items int32 [total]), each
        user's items in time order."""
        h = self._lib.cds_parse(path.encode())
        if not h:
            raise FileNotFoundError(path)
        try:
            n_users = self._lib.cds_n_users(h)
            n_inter = self._lib.cds_n_interactions(h)
            offsets = np.empty(n_users + 1, np.int64)
            items = np.empty(max(n_inter, 1), np.int32)
            self._lib.cds_fill(h, offsets, items)
            return offsets, items[:n_inter]
        finally:
            self._lib.cds_free(h)

    def build_edges(self, offsets: np.ndarray, items: np.ndarray,
                    n_item_a: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (share edges, specific edges), int32 [n, 2] (src, dst)."""
        n_users = len(offsets) - 1
        cap = max(len(items), 1)
        share = np.empty((cap, 2), np.int32)
        spec = np.empty((cap, 2), np.int32)
        n_spec = ctypes.c_int64(0)
        n_share = self._lib.cds_build_edges(
            np.ascontiguousarray(offsets), np.ascontiguousarray(items),
            n_users, n_item_a, share.reshape(-1), spec.reshape(-1),
            ctypes.byref(n_spec))
        return share[:n_share].copy(), spec[:n_spec.value].copy()

    def preprocess_train(self, offsets, items, n_item_a, n_item_b, len_max,
                         seed: int) -> np.ndarray:
        """-> int32 [kept, N_TRAIN_FIELDS, len_max] in TRAIN_FIELDS order."""
        n_users = len(offsets) - 1
        out = np.empty((max(n_users, 1), N_TRAIN_FIELDS, len_max), np.int32)
        kept = self._lib.cds_preprocess_train(
            np.ascontiguousarray(offsets), np.ascontiguousarray(items),
            n_users, n_item_a, n_item_b, len_max, seed, out.reshape(-1))
        return out[:kept].copy()

    def preprocess_eval(self, offsets, items, n_item_a, n_item_b, len_max,
                        n_neg, seed: int, bug_truncated_b=False):
        """-> (seqs int32 [kept, 6, len_max], scalars int32 [kept, 4]:
        idx_last_a, idx_last_b, xory_last, gt_last, negs int32 [kept,
        n_neg])."""
        n_users = len(offsets) - 1
        n = max(n_users, 1)
        seqs = np.empty((n, EVAL_SEQ_FIELDS, len_max), np.int32)
        scalars = np.empty((n, 4), np.int32)
        negs = np.empty((n, n_neg), np.int32)
        kept = self._lib.cds_preprocess_eval(
            np.ascontiguousarray(offsets), np.ascontiguousarray(items),
            n_users, n_item_a, n_item_b, len_max, n_neg,
            int(bug_truncated_b), seed, seqs.reshape(-1),
            scalars.reshape(-1), negs.reshape(-1))
        return seqs[:kept].copy(), scalars[:kept].copy(), negs[:kept].copy()


@functools.lru_cache(maxsize=None)
def load(src: str = SRC, build_dir: str = BUILD_DIR) -> Native:
    """The library of ``src``, built on first use; raises if it cannot be."""
    return Native(ctypes.CDLL(build(src, build_dir)))
