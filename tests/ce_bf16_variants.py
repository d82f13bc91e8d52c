"""Where K4's and K5's bf16 instantiations up to d 256 spend their time, on a
card: variants of ``c2dsr_tpu_torch/csrc`` (``ce.cu`` and the headers it
includes) built beside it, each timed against the kernels as they stand.

Each variant is the sources with one change, made by text substitution,
copied into ``build/c2dsr_tpu_torch/variants_bf16/<name>/`` and built from
there:

* ``fwd_one_block_an_sm``: K4 bf16's launch bounds at one block an SM (as
  the f32 one), where it takes two;
* ``no_kahan``: the logit partials added in f32 without Kahan's
  compensation (the results move by a few ulps);
* ``exp2_dlogits``: K5's dlogits by ``exp2_approx`` as the f32 kernels
  take them, not ``expf`` (the results are wrong: the arguments are
  scaled for the other units; the cost of the accurate exponential);
* ``no_product``: K5's second product replaced by adding each dlogit to
  one output element (the results are wrong; the logits, the dlogits and
  the per-tile adds' cost without the product's MMAs and loads);
* ``kby16``: Y tiles of 16 entities (one k16 step of K5's second product)
  at DT 128 as at 256, where DT <= 128 takes 32 (the plans' split counts
  stay the ones made for 32);
* ``kmt1``: one m-tile of 16 X rows a warp at DT 128 as at 256 (128 X
  rows a block, half the output registers), where DT <= 128 takes two
  (the plans stay the ones made for two);
* ``rolled_partials``: the bf16 logit tile's loop over its 32-column
  partials rolled at DT <= 128, as the f32 one (``logit_tile``), where it
  is unrolled;
* ``fwd_checks_a_column``: K4 bf16's resident kernel checking V and the
  target at every column (``fwd_tile`` without kRowChecks), where a row
  whose tile lies inside V and misses its target skips them;
* ``stages3``: a cp.async ring of three stages at DT 128, where it takes
  two.

For FK's domain A (N 10,240, V 30,720, ``chip_smoke._ce_inputs``' scales)
at d 128 and 256 on a bf16 W: the profiled device ms a call of K4's kernel
and of K5's dh and dW kernels, the kernels as they stand first and last,
each variant between:

    python tests/ce_bf16_variants.py [--out FILE]

PERF.md's breakdown of K4/K5 bf16's time comes from this script, which is
kept as its origin.  A run raises where a substitution no longer finds its
text.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WIDTHS = (128, 256)
NO_PRODUCT = '''    static_assert(kNy % 2 == 0 && kNo % 2 == 0, "pairs of n-tiles");
'''
NO_PRODUCT_BODY = NO_PRODUCT + '''    if constexpr (kNo >= kNy) {
#pragma unroll
      for (int m = 0; m < kMt; ++m)
#pragma unroll
        for (int j = 0; j < kNy; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[m][j][i] += s[m][j][i];
      return;
    }
'''


def variants(srcs):
    """{name: {file: source}} (only the files a variant changes); raises
    where a substitution finds nothing to change (the kernel's text
    moved)."""
    subs = {
        "fwd_one_block_an_sm": ("ce_fwd.cuh", [(
            "__launch_bounds__(BwdCfg<DT>::kThreads, kBf ? 2 : 1)",
            "__launch_bounds__(BwdCfg<DT>::kThreads, 1)")]),
        "no_kahan": ("ce_fwd.cuh", [(
            "constexpr bool kComp = std::is_same<T, uint16_t>::value;",
            "constexpr bool kComp = false;")]),
        "exp2_dlogits": ("ce_bwd.cuh", [
            ("          if (kBf)\n            p = xg[m][r] * expf(",
             "          if (false)\n            p = xg[m][r] * expf("),
            ("          if (kBf)\n            p = inf[kBy + e] * expf(",
             "          if (false)\n            p = inf[kBy + e] * expf(")]),
        "no_product": ("ce_bwd.cuh", [(NO_PRODUCT, NO_PRODUCT_BODY)]),
        "kby16": ("ce_fwd.cuh", [(
            "static constexpr int kBy = DT <= 128 ? 32 : 16;",
            "static constexpr int kBy = DT <= 64 ? 32 : 16;")]),
        "kmt1": ("ce_fwd.cuh", [(
            "static constexpr int kMt = DT <= 128 ? 2 : 1;",
            "static constexpr int kMt = DT <= 64 ? 2 : 1;")]),
        "rolled_partials": ("ce_fwd.cuh", [(
            "  if constexpr (DT <= 128 && !kComp) {\n#pragma unroll 1",
            "  if constexpr (DT <= 128) {\n#pragma unroll 1")]),
        "fwd_checks_a_column": ("ce_fwd.cuh", [(
            "fwd_tile<VARIANT, kMt, kNy, kBf>(s, bias",
            "fwd_tile<VARIANT, kMt, kNy>(s, bias")]),
        "stages3": ("ce_fwd.cuh", [(
            "static constexpr int kStages = DT <= 64 ? 3 : 2;",
            "static constexpr int kStages = DT <= 128 ? 3 : 2;")]),
    }
    out = {}
    for name, (path, pairs) in subs.items():
        text = srcs[path]
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {path} changed; update "
                                   "its substitutions")
            text = text.replace(old, new)
        out[name] = {path: text}
    return out


def build_variants():
    """{name: loaded ``ce`` library} of every variant, compiled in parallel
    (with the package's own build)."""
    from c2dsr_tpu_torch.kernels import build
    srcs = {f: open(os.path.join(build.SRC_DIR, f)).read()
            for f in os.listdir(build.SRC_DIR)
            if f.endswith((".cu", ".cuh"))}
    root = os.path.join(build.BUILD_DIR, "variants_bf16")
    procs = {}
    for name, changed in variants(srcs).items():
        vdir = os.path.join(root, name)
        shutil.rmtree(vdir, ignore_errors=True)
        os.makedirs(vdir)
        for f, text in {**srcs, **changed}.items():
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", vdir, "-o",
             os.path.join(vdir, "ce.so"), os.path.join(vdir, "ce.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    build.build_all()
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name}:\n{out.decode()}")
        libs[name] = ctypes.CDLL(os.path.join(root, name, "ce.so"))
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
                          _l if stem == "ce" else library(stem)))
        fc._fn.cache_clear()
        fc._slots.cache_clear()

    N, V, n_real = 10240, 30720, 29207
    res = {}
    try:
        for d in WIDTHS:
            h, w, bm, pad, tgt, _, dlse, dt = cs._ce_inputs(N, d, V, n_real,
                                                            d)
            wb = w.to(torch.bfloat16)
            with torch.no_grad():
                lse, _ = fc.ce_fwd(h, wb, bm, pad, tgt)
            tag = f"bf16 d={d}"
            res[tag] = {}
            for name in list(libs) + ["as_it_stands"]:
                use(name)
                with torch.no_grad():
                    fc.ce_fwd(h, wb, bm, pad, tgt)
                    fc.ce_bwd(h, wb, bm, lse, dlse, dt, tgt)
                    fwd = timing.kernel_times(lambda: fc.ce_fwd(
                        h, wb, bm, pad, tgt), calls=3)[0]
                    bwd = timing.kernel_times(lambda: fc.ce_bwd(
                        h, wb, bm, lse, dlse, dt, tgt), calls=2)[0]
                times = {"k4": sum(v for k, v in fwd.items()
                                   if "ce_fwd_kernel" in k)}
                times.update({p: sum(v for k, v in bwd.items()
                                     if cs._ce_bwd_pass(k) == p)
                              for p in ("dh", "dw")})
                res[tag].setdefault(name, []).append(times)
            print(tag, json.dumps(res[tag]), flush=True)
            del h, w, wb, bm, pad, tgt, dlse, dt, lse
            torch.cuda.empty_cache()
    finally:
        use("as_it_stands")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
