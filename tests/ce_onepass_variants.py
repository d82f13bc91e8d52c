"""Where K5's one pass spends its time, on a card: variants of
``c2dsr_tpu_torch/csrc/ce_onepass.cu`` built beside it, each timed against
the kernel as it stands.

Each variant is the source with one part taken out, made by text
substitution and built into ``build/c2dsr_tpu_torch/variants/`` (their
results are wrong; they are timed, not checked):

* ``no_dw_store``: the block's dW tile computed but not written to its
  partial (a store kept only for a NaN, so that the product stays);
* ``no_dw``: the block's dW tile is zeros instead of Pᵀ·h;
* ``no_dh``: no dh product (one add keeps the dlogits alive);
* ``logits_only``: neither product: the logit tiles, the dlogits, Pᵀ's
  writes, the barriers and the stores of zero tiles.

For each FK domain (N 10,240, d 128, V 30,720 and 36,864,
``chip_smoke._ce_inputs``' scales), the profiled device ms of the one
pass's kernel a call, the kernel as it stands first and last, each variant
between, and ce.cu's pair (its dh and dW kernels) beside them:

    python tests/ce_onepass_variants.py [--out FILE]

Then, at FK's rows and domain A's vocab, the one pass against the pair at
d 40, 64 (the DT 64 instantiation, the odd widths' route) and 128: each
gated against the plain version (2e-5) and a second launch, timed whole
in turns (three rounds of one pass, pair, pair, one pass) and profiled.

Then, at a 1M-item domain (N 10,240, d 128, V 501,760), the one pass at
the card's plan (a dW partial a 256-row block) against the pair: each
call's distance from float64 (dh, dW, db; the plain f32 version's beside
them), bitwise against a second call, its peak device memory above its
inputs, and each timed whole in turns (its pre-pass and merges included).

PERF.md's shares of the one pass's time come from this script, which is
kept as their origin.  A run raises where a substitution no longer finds
its text in the kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DW = "    dw_tile<DT, kNw>(q, pt, xs, e0, c0, g, t);"
NO_DW = ("    for (int n = 0; n < kNw; ++n)\n"
         "      for (int i = 0; i < 4; ++i) q[n][i] = 0.f;")
DH = "    add_py<2, kNy, kNo, ld, false>(o, s, yb, ys, 0, g, t);"
NO_DH = "    o[0][0][0] += s[0][0][0] + s[1][3][3];"
STORE = ("        if (kk < a.d && v < a.V) dw_rb[(size_t)kk * a.V + v] = "
         "q[n][i];",
         "        if (q[n][i] != q[n][i]) dw_rb[(size_t)kk * a.V + v] = "
         "q[n][i];")


def variants(src):
    """{name: source}; raises where a substitution finds nothing to
    change (the kernel's text moved)."""
    subs = {"no_dw_store": (STORE,), "no_dw": ((DW, NO_DW),),
            "no_dh": ((DH, NO_DH),),
            "logits_only": ((DW, NO_DW), (DH, NO_DH))}
    out = {}
    for name, pairs in subs.items():
        text = src
        for a, b in pairs:
            if text.count(a) != 1:
                raise RuntimeError(f"variant {name}: the source changed; "
                                   "update its substitutions")
            text = text.replace(a, b)
        out[name] = text
    return out


def build_variants():
    """{name: loaded library} of every variant, compiled in parallel (with
    the package's own build)."""
    from c2dsr_tpu_torch.kernels import build
    src = open(os.path.join(build.SRC_DIR, "ce_onepass.cu")).read()
    vdir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(vdir, exist_ok=True)
    procs = {}
    for name, text in variants(src).items():
        path = os.path.join(vdir, f"ce_onepass_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", build.SRC_DIR, "-o",
             os.path.join(vdir, f"ce_onepass_{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    build.build_all()
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name}:\n{out.decode()}")
        libs[name] = ctypes.CDLL(os.path.join(vdir, f"ce_onepass_{name}.so"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON file for the times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from c2dsr_tpu_torch.bench import scaled_e2e, timing
    from c2dsr_tpu_torch.kernels import build
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda as fc
    t0 = time.perf_counter()
    libs = {"as_it_stands": None, **build_variants()}
    print(f"built in {time.perf_counter() - t0:.1f} s; "
          f"{timing.card_line()}", flush=True)
    library = build.library

    def use(name):
        build.library = (library if libs[name] is None else
                         (lambda stem, _l=libs[name]:
                          _l if stem == "ce_onepass" else library(stem)))
        fc._fn.cache_clear()
        fc._onepass_slots.cache_clear()

    N, d = 10240, 128
    res = {}
    timer = timing.Timer()
    try:
        for V, n_real in ((30720, cs.N_ITEM_A), (36864, cs.N_ITEM_B)):
            h, w, bm, pad, tgt, _, dlse, dt = cs._ce_inputs(N, d, V, n_real,
                                                            V)
            with torch.no_grad():
                lse, _ = fc.ce_fwd(h, w, bm, pad, tgt)
            tag = f"V={V}"
            res[tag] = {}
            for name in list(libs) + ["as_it_stands"]:
                use(name)
                with torch.no_grad():
                    fc.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
                    times = timing.kernel_times(lambda: fc.ce_bwd(
                        h, w, bm, lse, dlse, dt, tgt), calls=2)[0]
                res[tag].setdefault(name, []).append(sum(
                    v for k, v in times.items() if "onepass_kernel" in k))
            with torch.no_grad():
                times = timing.kernel_times(lambda: cs._k5_entry(
                    "pair", h, w, bm, lse, dlse, dt, tgt), calls=2)[0]
            res[tag]["pair"] = {p: sum(v for k, v in times.items()
                                       if cs._ce_bwd_pass(k) == p)
                                for p in ("dh", "dw")}
            print(tag, json.dumps(res[tag]), flush=True)
            del h, w, bm, pad, tgt, dlse, dt, lse
            torch.cuda.empty_cache()
        use("as_it_stands")
        for d in (40, 64, 128):
            V = 30720
            h, w, bm, pad, tgt, _, dlse, dt = cs._ce_inputs(
                N, d, V, cs.N_ITEM_A, V)
            with torch.no_grad():
                lse, _ = fc.ce_fwd(h, w, bm, pad, tgt)
                want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt)
            plan = fc.plan_onepass(N, d, V)
            designs = {"onepass": lambda p=plan: fc.onepass_run(
                           p, h, w, bm, lse, dlse, dt, tgt),
                       "pair": lambda: cs._k5_entry(
                           "pair", h, w, bm, lse, dlse, dt, tgt)}
            tag = f"d={d}"
            res[tag] = {"plan": str(plan),
                        "pair_splits": fc.plan_bwd(N, d, V, False)}
            for name, fn in designs.items():
                with torch.no_grad():
                    rels = cs._check_ce_bwd(f"{tag} {name}", fn(), want,
                                            fn(), cs.N_ITEM_A)
                    times = timing.kernel_times(fn, calls=2)[0]
                res[tag][f"{name}_rel_err"] = rels
                res[tag][f"{name}_kernels_ms"] = times
            means, runs = cs._k5_in_turns(timer, designs, 10, rounds=3)
            res[tag].update(ms=means, runs=runs, against_pair=dict(zip(
                ("diff_ms", "se_ms", "resolved"),
                timing.se_resolved(runs["onepass"], runs["pair"]))))
            print(tag, json.dumps(res[tag]), flush=True)
            del h, w, bm, pad, tgt, dlse, dt, lse, want
            torch.cuda.empty_cache()
        N, d, V = 10240, 128, 501760
        h, w, bm, pad, tgt, _, dlse, dt = cs._ce_inputs(N, d, V, 500000, 1)
        with torch.no_grad():
            lse, _ = fc.ce_fwd(h, w, bm, pad, tgt)
            f64 = scaled_e2e._plain_ce_bwd(h, w, bm, lse, dlse, dt, tgt,
                                           torch.float64)
            plain = scaled_e2e._plain_ce_bwd(h, w, bm, lse, dlse, dt, tgt)
        tag = f"V={V}"
        plan = fc.plan_onepass(N, d, V)
        res[tag] = {"plan": str(plan), "dw_partials_gib":
                    4 * plan.row_blocks * (d + 1) * V / 2**30,
                    "plain_rel_err_f64": {
                        k: cs._rel(a.double(), b) for k, a, b in
                        zip(("dh", "dw", "db"), plain, f64)}}
        del plain
        runs = {"onepass": lambda: fc.onepass_run(plan, h, w, bm, lse, dlse,
                                                  dt, tgt),
                "pair": lambda: cs._k5_entry("pair", h, w, bm, lse, dlse,
                                             dt, tgt)}
        for name, fn in runs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with torch.no_grad():
                got, again = fn(), fn()
            torch.cuda.synchronize()
            res[tag][f"{name}_peak_gib"] = (
                (torch.cuda.max_memory_allocated() - base) / 2**30)
            res[tag][f"{name}_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(got, again))
            res[tag][f"{name}_rel_err_f64"] = {
                k: cs._rel(a.double(), b) for k, a, b in
                zip(("dh", "dw", "db"), got, f64)}
            del got, again
            torch.cuda.empty_cache()
        for name in list(runs) + list(runs)[::-1]:
            with torch.no_grad():
                res[tag].setdefault(name, []).append(timer(runs[name],
                                                           reps=3))
            torch.cuda.empty_cache()
        print(tag, json.dumps(res[tag]), flush=True)
    finally:
        use("as_it_stands")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
