"""Where the towers' wgmma tile past d 256 spends its time, on a card:
variants of ``c2dsr_tpu_torch/csrc/wgmma.cuh`` built beside it, each
timed against the tile as it stands.

Each variant is the sources with one change, made by text substitution,
copied into ``build/c2dsr_tpu_torch/variants_wide/<name>/``, where
``encoder.cu`` and ``encoder_bwd.cu`` are built from it:

* ``wg3``: three consumer warpgroups a block (192 rows), where it takes
  two, and a ring of three stages in bf16 (four do not fit);
* ``stages2``: a ring of two stages in every mode;
* ``grid_rows_fastest``: the grid's row tiles fastest, where column tiles
  are (neighbouring blocks share a weight tile, not an A tile);
* ``no_partial_adds``: the 6-term and bf16 modes' MMAs chained straight
  into the accumulator, where each k8-step (6-term) or 32-k chunk (bf16)
  starts a zeroed partial that is added in f32; each step is still
  committed and waited for on its own;
* ``no_partial_adds_one_wait``: the same, with a stage's four k8-steps
  (6-term) or two chunks (bf16) split first and committed and waited for
  once, as the 3xTF32 mode does.

The last two change the sums' order, so their outputs are not the tile's:
they measure what the partials (and the waits they force) cost, nothing
else.

For one layer of the wide tower at d 1,024 (7,680 rows: B 512, L 15):
the profiled device ms a call of the tile's kernel (without the weight
pre-pass) for K2's QKV (6-term), its out-projection (3xTF32), the bf16
QKV and out-projection, and K3's dX of QKV (k 3,072) and of FF1; the tile
as it stands first and last, each variant between:

    python tests/wide_gemm_variants.py [--out FILE]

PERF.md's breakdown of the tile's time comes from this script, which is
kept as its origin.  A run raises where a substitution no longer finds
its text, or where a variant's output lies further than ``TOL`` from the
tile's (a variant that skipped work would read fast).
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

STEMS = ("encoder", "encoder_bwd")
# a variant's output against the tile's, max abs over max: the variants
# that sum in another order move f32 outputs by ~1e-6 and bf16 ones by a
# bf16 rounding; one that drops work moves them far more
TOL = 1e-2


# the 6-term mode's k8-step and the bf16 mode's 32-k chunk as the tile
# runs them: MMAs into a zeroed partial, waited for and added in f32
SIX_STEP = """        wgmma_fence();
        wgmma_tf32(part, pa[1], desc_sw128(b1), 0);
        wgmma_tf32(part, pa[2], desc_sw128(b0), 1);
        wgmma_tf32(part, pa[0], desc_sw128(b2), 1);
        wgmma_tf32(part, pa[1], desc_sw128(b0), 1);
        wgmma_tf32(part, pa[0], desc_sw128(b1), 1);
        wgmma_tf32(part, pa[0], desc_sw128(b0), 1);
        wgmma_commit();
        wgmma_wait();
        add_part();
"""
BF16_CHUNK = """        wgmma_fence();
        wgmma_bf16(part, a[0], desc_sw128(bs + 64 * h), 0);
        wgmma_bf16(part, a[1], desc_sw128(bs + 64 * h + 32), 1);
        wgmma_commit();
        wgmma_wait();
        add_part();
"""
# the same, straight into the accumulator
SIX_STEP_ACC = (SIX_STEP.replace("(part,", "(acc,")
                .replace("(b1), 0)", "(b1), 1)")
                .replace("add_part();", "fence_acc(acc);"))
BF16_CHUNK_ACC = (BF16_CHUNK.replace("(part,", "(acc,")
                  .replace("64 * h), 0)", "64 * h), 1)")
                  .replace("add_part();", "fence_acc(acc);"))
# the 6-term mode's stage, its k8-steps split first, one wait
SIX_STAGE = """#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t pa[3][4];   // big, mid, small
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t p[3];
          tc::split_parts<6>(
              as[swz(r + 8 * (e & 1), 8 * ks + t + 4 * (e >> 1))], p);
#pragma unroll
          for (int q = 0; q < 3; ++q) pa[q][e] = p[q];
        }
        const uint32_t b0 = bs + 32 * ks, b1 = b0 + C::kBPart,
                       b2 = b0 + 2 * C::kBPart;
""" + SIX_STEP + """      }
"""
SIX_STAGE_ONE_WAIT = """      uint32_t pas[4][3][4];   // each k8-step's big, mid, small
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t p[3];
          tc::split_parts<6>(
              as[swz(r + 8 * (e & 1), 8 * ks + t + 4 * (e >> 1))], p);
#pragma unroll
          for (int q = 0; q < 3; ++q) pas[ks][q][e] = p[q];
        }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t b0 = bs + 32 * ks, b1 = b0 + C::kBPart,
                       b2 = b0 + 2 * C::kBPart;
        const uint32_t (&pa)[3][4] = pas[ks];
        wgmma_tf32(acc, pa[1], desc_sw128(b1), 1);
        wgmma_tf32(acc, pa[2], desc_sw128(b0), 1);
        wgmma_tf32(acc, pa[0], desc_sw128(b2), 1);
        wgmma_tf32(acc, pa[1], desc_sw128(b0), 1);
        wgmma_tf32(acc, pa[0], desc_sw128(b1), 1);
        wgmma_tf32(acc, pa[0], desc_sw128(b0), 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_acc(acc);
"""
# the bf16 mode's stage, both chunks' fragments first, one wait
BF16_STAGE = """#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* ah = as + h * kRows * kKf;
        uint32_t a[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 v = *reinterpret_cast<const float2*>(
                ah + swz(r + 8 * (e & 1), 16 * ks + 2 * t + 8 * (e >> 1)));
            a[ks][e] = tc::pack_bf16(v.x, v.y);
          }
""" + BF16_CHUNK + """      }
"""
BF16_STAGE_ONE_WAIT = """      uint32_t a[2][2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 v = *reinterpret_cast<const float2*>(
                as + h * kRows * kKf +
                swz(r + 8 * (e & 1), 16 * ks + 2 * t + 8 * (e >> 1)));
            a[h][ks][e] = tc::pack_bf16(v.x, v.y);
          }
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wgmma_bf16(acc, a[h][0], desc_sw128(bs + 64 * h), 1);
        wgmma_bf16(acc, a[h][1], desc_sw128(bs + 64 * h + 32), 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_acc(acc);
"""


def variants(srcs):
    """{name: {file: source}} (only the files a variant changes); raises
    where a substitution does not find its text exactly once."""
    stages = "static constexpr int kStages = MODE == 6 ? 3 : 4;"
    subs = {
        "wg3": ("wgmma.cuh", [
            ("constexpr int kWarpgroups = 2;",
             "constexpr int kWarpgroups = 3;"),
            (stages, "static constexpr int kStages = MODE == 3 ? 4 : 3;")]),
        "stages2": ("wgmma.cuh", [
            (stages, "static constexpr int kStages = 2;")]),
        "grid_rows_fastest": (None, [(
            "  const int row0 = (blockIdx.x / tiles_m) * wg::kRows;\n"
            "  const int n0 = (blockIdx.x % tiles_m) * wg::kCols;\n",
            "  const int tiles_n = (g.n + wg::kRows - 1) / wg::kRows;\n"
            "  const int row0 = (blockIdx.x % tiles_n) * wg::kRows;\n"
            "  const int n0 = (blockIdx.x / tiles_n) * wg::kCols;\n")]),
        "no_partial_adds": ("wgmma.cuh", [(SIX_STEP, SIX_STEP_ACC),
                                          (BF16_CHUNK, BF16_CHUNK_ACC)]),
        "no_partial_adds_one_wait": ("wgmma.cuh", [
            (SIX_STAGE, SIX_STAGE_ONE_WAIT),
            (BF16_STAGE, BF16_STAGE_ONE_WAIT)]),
    }
    out = {}
    for name, (path, pairs) in subs.items():
        # None: the kernels' own files, each of which has the text once
        files = (path,) if path else ("encoder.cu", "encoder_bwd.cu")
        out[name] = {}
        for f in files:
            text = srcs[f]
            for old, new in pairs:
                if text.count(old) != 1:
                    raise RuntimeError(f"variant {name}: {f} changed; "
                                       "update its substitutions")
                text = text.replace(old, new)
            out[name][f] = text
    return out


def build_variants():
    """{name: {stem: loaded library}} of every variant, compiled in
    parallel (with the package's own build)."""
    from c2dsr_tpu_torch.kernels import build
    srcs = {f: open(os.path.join(build.SRC_DIR, f)).read()
            for f in os.listdir(build.SRC_DIR)
            if f.endswith((".cu", ".cuh"))}
    root = os.path.join(build.BUILD_DIR, "variants_wide")
    procs = {}
    for name, changed in variants(srcs).items():
        vdir = os.path.join(root, name)
        shutil.rmtree(vdir, ignore_errors=True)
        os.makedirs(vdir)
        for f, text in {**srcs, **changed}.items():
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        for stem in STEMS:
            procs[name, stem] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-I", vdir, "-o",
                 os.path.join(vdir, f"{stem}.so"),
                 os.path.join(vdir, f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    build.build_all()
    libs = {}
    for (name, stem), p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name} {stem}:\n{out.decode()}")
        libs.setdefault(name, {})[stem] = ctypes.CDLL(
            os.path.join(root, name, f"{stem}.so"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON file for the times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from c2dsr_tpu_torch.bench import timing
    from c2dsr_tpu_torch.kernels import build
    from c2dsr_tpu_torch.ops import encoder_cuda as ec
    t0 = time.perf_counter()
    libs = {"as_it_stands": None, **build_variants()}
    print(f"built in {time.perf_counter() - t0:.1f} s; "
          f"{timing.card_line()}", flush=True)
    library = build.library

    def use(name):
        build.library = (library if libs[name] is None else
                         (lambda stem, _l=libs[name]:
                          _l[stem] if stem in _l else library(stem)))
        ec._fn.cache_clear()

    d, n = 1024, 512 * 15
    gen = torch.Generator("cuda").manual_seed(0)
    a = torch.randn(n, 3 * d, device="cuda", generator=gen)
    w = torch.randn(3 * d, 3 * d, device="cuda", generator=gen) / 32
    bias = torch.zeros(3 * d, device="cuda")
    res = torch.randn(n, d, device="cuda", generator=gen)
    x = a[:, :d].contiguous()
    cases = {
        "k2_qkv_6term": lambda: ec.gemm_fwd(
            x, w[:d].contiguous(), bias, epi="bias", mode=6, wide=True),
        "k2_out_3xtf32": lambda: ec.gemm_fwd(
            x, w[:d, :d].contiguous(), bias[:d], epi="residual", mode=3,
            wide=True, res=res),
        "k2_qkv_bf16": lambda: ec.gemm_fwd(
            x, w[:d].contiguous(), bias, epi="bias", mode=1, wide=True),
        "k2_out_bf16": lambda: ec.gemm_fwd(
            x, w[:d, :d].contiguous(), bias[:d], epi="residual", mode=1,
            wide=True, res=res),
        "k3_dx_qkv_3xtf32": lambda: ec.gemm_bwd(
            a, w[:d].contiguous(), epi="res", bf16=False, wide=True,
            res=res),
        "k3_dx_ff1_3xtf32": lambda: ec.gemm_bwd(
            x, w[:d, :d].contiguous(), epi="res", bf16=False, wide=True,
            res=res),
    }
    res_t, first = {}, {}
    try:
        for name in list(libs) + ["as_it_stands"]:
            use(name)
            row, apart = {}, {}
            for case, fn in cases.items():
                out = fn()
                out = out[0] if isinstance(out, tuple) else out
                # a variant that computes something else is not timed
                ref = first.setdefault(case, out)
                apart[case] = float((out - ref).abs().max()
                                    / ref.abs().max())
                if not apart[case] <= TOL:
                    raise RuntimeError(f"variant {name} {case}: "
                                       f"{apart[case]:.3e} from the tile")
                times = timing.kernel_times(fn, calls=5)[0]
                row[case] = sum(v for k, v in times.items() if "wgmma" in k)
            res_t.setdefault(name, []).append(row)
            print(name, json.dumps(row), "max rel apart from the tile",
                  json.dumps({k: f"{v:.2e}" for k, v in apart.items()}),
                  flush=True)
    finally:
        use("as_it_stands")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res_t, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
