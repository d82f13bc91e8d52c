"""K5's bf16 instantiation over many seeds, on a card: the reading behind
``test_torch_cuda.test_ce_bf16_kernels_match_plain``'s backward limits.

For each seed, the test's inputs at width d (``_ce_case``, and dlse, dt from
a generator seeded as the test seeds it) go through K5 bf16, the plain bf16
CE (``fused_ce.ce_bwd_plain(bf16=True)``) and the same function in float64
(the same bf16-rounded h and W, the float64 dlogits rounded to bf16 before
the products, as both versions round theirs).  Logged per seed, max abs over
max of dh, dW and db: K5 against the plain version, each of them against
float64, the f32 instantiation against the plain version, and relative
Frobenius against the plain version and against float64; a digest of K5's
outputs, compared between two processes.

    python tests/ce_bf16_seeds.py [--seeds 200] [--d 512] [--out FILE]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

NAMES = ("dh", "dw", "db")


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()) / max(
        float(b.double().abs().max()), 1e-30)


def _fro(a, b):
    return float((a.double() - b.double()).norm()) / max(
        float(b.double().norm()), 1e-30)


def readings(seeds, d):
    """One record a seed at width d (the test's N 300, V 1028)."""
    import test_torch_cuda as t
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    from c2dsr_tpu_torch.ops.bf16 import round_bf16
    cuda = torch.device("cuda")
    N, V, n_real = 300, 1028, 1000
    out = []
    for seed in seeds:
        h, w, bm, pad, tgt = t._ce_case(cuda, N, d, V, n_real, seed=seed)
        gen = t._gen(cuda, seed)
        real = (tgt != n_real).float()
        dlse = torch.randn(N, device=cuda, generator=gen) * real
        dt = torch.randn(N, device=cuda, generator=gen) * real
        lse, _ = fused_ce_cuda.ce_fwd(h, w.to(torch.bfloat16), bm, pad, tgt)
        got = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt, bf16=True)
        want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt, bf16=True)
        got32 = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
        h64, w64 = round_bf16(h).double(), round_bf16(w).double()
        dlog = dlse.double()[:, None] * torch.exp(
            h64 @ w64 + bm.double() - lse.double()[:, None])
        hit = tgt.long() < V
        rows = torch.arange(N, device=cuda)[hit]
        dlog[rows, tgt.long()[hit]] += dt.double()[hit]
        g = round_bf16(dlog)
        f64 = (g @ w64.T, h64.T @ g, dlog.sum(0))

        def each(fn, xs, ys):
            return {n: fn(a, b) for n, a, b in zip(NAMES, xs, ys)}

        out.append({
            "seed": seed, "k_vs_plain": each(_rel, got, want),
            "k_vs_f64": each(_rel, got, f64),
            "plain_vs_f64": each(_rel, want, f64),
            "f32_vs_plain": each(_rel, got32, want),
            "fro_k_vs_plain": each(_fro, got, want),
            "fro_k_vs_f64": each(_fro, got, f64),
            "fro_plain_vs_f64": each(_fro, want, f64),
            "fro_f32_vs_plain": each(_fro, got32, want),
            "digest": hashlib.sha256(b"".join(
                x.cpu().numpy().tobytes() for x in got)).hexdigest()[:16]})
    return out


def summary(runs):
    """Quantiles (min, median, p90, p99, max) of each reading's worst
    tensor, and how often K5 lies further from float64 than the plain
    version, by tensor."""
    def q(v):
        return [float(np.quantile(v, x)) for x in (0, 0.5, 0.9, 0.99, 1)]

    worst = {k: [max(r[k].values()) for r in runs]
             for k in ("k_vs_plain", "k_vs_f64", "plain_vs_f64",
                       "f32_vs_plain", "fro_k_vs_plain", "fro_f32_vs_plain")}
    out = {k: q(v) for k, v in worst.items()}
    for n in NAMES:
        k = np.array([r["k_vs_f64"][n] for r in runs])
        p = np.array([r["plain_vs_f64"][n] for r in runs])
        out[f"further_than_plain_{n}"] = int((k > p).sum())
        out[f"median_k_vs_f64_{n}"] = float(np.median(k))
        out[f"median_plain_vs_f64_{n}"] = float(np.median(p))
    out["further_than_plain_worst"] = int(sum(
        a > b for a, b in zip(worst["k_vs_f64"], worst["plain_vs_f64"])))
    # relative Frobenius from float64, K5's over the plain version's, the
    # worst tensor of each seed
    ratio = [max(r["fro_k_vs_f64"][n] / max(r["fro_plain_vs_f64"][n], 1e-30)
                 for n in NAMES) for r in runs]
    out["fro_f64_ratio"] = q(ratio)
    out["events_over_1e-4"] = [
        sum(max(r["k_vs_f64"][n] for n in ("dh", "dw")) > 1e-4
            for r in runs),
        sum(max(r["plain_vs_f64"][n] for n in ("dh", "dw")) > 1e-4
            for r in runs)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=200)
    ap.add_argument("--d", type=int, default=512)
    ap.add_argument("--out", default=None, help="JSON file for every record")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(readings(range(args.seeds), args.d)))
        return 0
    runs = [json.loads(subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", "--seeds",
         str(args.seeds), "--d", str(args.d)], capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[-1])
        for _ in range(2)]
    same = all(a["digest"] == b["digest"] for a, b in zip(*runs))
    res = {"d": args.d, "seeds": args.seeds,
           "bitwise_across_processes": same, "summary": summary(runs[0])}
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(res, runs=runs[0]), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
