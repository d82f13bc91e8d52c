"""Where K5's cluster kernels spend their time, on a card: variants of
``c2dsr_tpu_torch/csrc/ce_cluster.cu`` built beside it, each timed against
the kernels as they stand.

Each variant is the source with one change, made by text substitution and
built into ``build/c2dsr_tpu_torch/variants/``:

* ``one_block_an_sm``: the bf16 instantiation's launch bounds at one block
  an SM (as the f32 one), where it takes two;
* ``scatter_at_2``: two blocks a cluster exchange as wider clusters do (the
  owned rows' partials, then the dlogits: two barriers a tile) instead of
  every warp reading both blocks' partials;
* ``gather_at_every_c``: the other way round: at every cluster size every
  warp reads every block's partials of its rows (one barrier a tile);
* ``local``: every read of another block's shared memory reads the block's
  own instead (the results are wrong; the exchange's traffic is gone);
* ``no_barrier``: ``local`` without the cluster barriers of the loop: the
  products and the dlogits alone.

For each width (N 10,240, V 30,720, ``chip_smoke._ce_inputs``' scales), the
profiled device ms of K5's dh and dW kernels a call, the kernels as they
stand first and last, each variant between:

    python tests/ce_cluster_variants.py [--out FILE]

PERF.md's readings of what the exchange and the barriers cost, and of why
two blocks gather and wider clusters scatter, come from this script, which
is kept as their origin.  A run raises where a substitution no longer finds
its text in the kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LOOP_SYNCS = ("    cluster.sync();\n\n    // the dlogits of the warp's",
              "      cluster.sync();\n      // 3s.")
WIDTHS = ((512, False), (1024, False), (2048, False), (512, True),
          (1024, True))


def _local(src):
    return re.sub(r"cluster\.map_shared_rank\(([a-z_]+), [^)]+\)", r"(\1)",
                  src)


def variants(src):
    """{name: source}; raises where a substitution finds nothing to
    change (the kernel's text moved)."""
    no_barrier = _local(src)
    for s in LOOP_SYNCS:
        no_barrier = no_barrier.replace(s, s.replace("cluster.sync();", ""))
    out = {
        "one_block_an_sm": src.replace(
            "__launch_bounds__(kCThreads, kBf ? 2 : 1)",
            "__launch_bounds__(kCThreads, 1)"),
        "scatter_at_2": src.replace("const bool gather = c == 2;",
                                    "const bool gather = false;"),
        "gather_at_every_c": src.replace("const bool gather = c == 2;",
                                         "const bool gather = true;"),
        "local": _local(src),
        "no_barrier": no_barrier,
    }
    for name, text in out.items():
        if text == src or (name == "no_barrier"
                           and text.count("cluster.sync();") != 1):
            raise RuntimeError(f"variant {name}: the source changed; update "
                               "its substitutions")
    return out


def build_variants():
    """{name: loaded library} of every variant, compiled in parallel (with
    the package's own build)."""
    from c2dsr_tpu_torch.kernels import build
    src = open(os.path.join(build.SRC_DIR, "ce_cluster.cu")).read()
    vdir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(vdir, exist_ok=True)
    procs = {}
    for name, text in variants(src).items():
        path = os.path.join(vdir, f"ce_cluster_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", build.SRC_DIR, "-o",
             os.path.join(vdir, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    build.build_all()
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name}:\n{out.decode()}")
        libs[name] = ctypes.CDLL(os.path.join(vdir, f"{name}.so"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON file for the times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from c2dsr_tpu_torch.bench import timing
    from c2dsr_tpu_torch.kernels import build
    from c2dsr_tpu_torch.ops import fused_ce_cuda as fc
    t0 = time.perf_counter()
    libs = {"as_it_stands": None, **build_variants()}
    print(f"built in {time.perf_counter() - t0:.1f} s; "
          f"{timing.card_line()}", flush=True)
    library = build.library

    def use(name):
        build.library = (library if libs[name] is None else
                         (lambda stem, _l=libs[name]:
                          _l if stem == "ce_cluster" else library(stem)))
        fc._fn.cache_clear()
        fc._cluster_slots.cache_clear()

    N, V, n_real = 10240, 30720, 29207
    res = {}
    try:
        for d, bf16 in WIDTHS:
            h, w, bm, pad, tgt, _, dlse, dt = cs._ce_inputs(N, d, V, n_real,
                                                            d)
            if bf16:
                w = w.to(torch.bfloat16)
            with torch.no_grad():
                lse, _ = fc.ce_fwd(h, w, bm, pad, tgt)
            tag = f"{'bf16' if bf16 else 'f32'} d={d}"
            res[tag] = {}
            for name in list(libs) + ["as_it_stands"]:
                use(name)
                with torch.no_grad():
                    fc.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
                    times = timing.kernel_times(lambda: fc.ce_bwd(
                        h, w, bm, lse, dlse, dt, tgt), calls=2)[0]
                res[tag].setdefault(name, []).append({
                    p: sum(v for k, v in times.items()
                           if cs._ce_bwd_pass(k) == p) for p in ("dh", "dw")})
            print(tag, json.dumps(res[tag]), flush=True)
            del h, w, bm, pad, tgt, dlse, dt, lse
            torch.cuda.empty_cache()
    finally:
        use("as_it_stands")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
