"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use, with ``nvcc`` for Hopper (``sm_90a``),
into a shared library with a plain C interface, which ``ctypes`` loads.
All sources are compiled at once, one ``nvcc`` process each, started
together.  Libraries land in ``build/c2dsr_tpu_torch/`` beside the package
(listed in ``.gitignore``) under a name that carries a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is not.

Nothing here touches CUDA when imported: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "c2dsr_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(src: str) -> str:
    """The library's path, named by a hash of the source, the headers of
    ``csrc`` (any source may include them) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(SRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet, all in
    parallel.  Returns {stem: library path}; raises with the compiler's
    output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = {f[:-len(".cu")]: os.path.join(SRC_DIR, f)
            for f in sorted(os.listdir(SRC_DIR)) if f.endswith(".cu")}
    libs = {stem: _lib_path(src) for stem, src in srcs.items()}
    todo = [(srcs[stem], lib) for stem, lib in libs.items()
            if not os.path.exists(lib)]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = []
    for src, lib in todo:
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", SRC_DIR, "-o", tmp, src]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, lib, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{os.path.basename(src)}:\n{out.decode()}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return libs


@functools.lru_cache(maxsize=None)
def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on demand)."""
    libs = build_all()
    if stem not in libs:
        raise KeyError(f"no csrc/{stem}.cu")
    return ctypes.CDLL(libs[stem])
