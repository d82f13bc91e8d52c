"""K2's and K3's bf16 instantiations over many seeds, on a card: how often
they lie further from float64 than the plain bf16 tower does.

For each seed a tower at FK's shape (d 128, one head, L 15, B 256), one
at d 1,024 (8 heads, L 15, B 32) and one at L 200 (d 128, one head, B 64:
the tensor-core attention past L 64), one layer at dropout 0.2, goes through
K2 and K3 bf16 (K3 from K2's saved activations), the plain bf16 tower
(``ops/encoder.encoder_fwd_plain`` / ``encoder_bwd_plain(bf16=True)``, K3's
at K2's branches) and the plain bf16 tower in float64 (the same rounding
points, float64 sums): ``chip_smoke.py``'s ``_shapes_bf16`` reading.
Logged per seed, relative Frobenius (K2 on rows with an allowed key; K3
the worst of dx and the gradients): each version against float64, and the
kernels against the plain version; a digest of the kernels' outputs,
compared between two processes.  ``--root`` runs the ``c2dsr_tpu_torch``
of another checkout (say the parent, unpacked by ``git archive``) with the
same inputs.

    python tests/tower_bf16_seeds.py [--seeds 50] [--root DIR] [--out FILE]
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"fk": (128, 1, 15, 256), "d1024": (1024, 8, 15, 32),
          "l200": (128, 1, 200, 64)}
PAD = 999


def _fro(a, b, rows=None):
    d, w = a.double() - b.double(), b.double()
    if rows is not None:
        d, w = d[rows], w[rows]
    return float(d.norm()) / max(float(w.norm()), 1e-300)


def readings(seeds, shape):
    """One record a seed at SHAPES[shape]."""
    from c2dsr_tpu_torch.bench import gates
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import encoder_cuda
    d, n_head, L, B = SHAPES[shape]
    out = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        p = params_mod.init_encoder_params(
            torch.Generator().manual_seed(seed),
            Config(d_latent=d, n_head=n_head, n_attn=1), L)
        p = params_mod._map(lambda t: t.cuda(), p)
        # chip_smoke.py's _encoder_inputs scale
        x = torch.from_numpy((rng.normal(size=(B, L, d)) * 4.0)
                             .astype(np.float32)).cuda()
        # left-padded sequences of random lengths, some all pad
        lengths = rng.integers(0, L + 1, size=B)
        seq = np.full((B, L), PAD, np.int64)
        for b, n in enumerate(lengths):
            seq[b, L - n:] = rng.integers(0, PAD, size=n)
        seq = torch.from_numpy(seq).cuda()
        gout = torch.from_numpy(rng.normal(size=(B, L, d)).astype(np.float32)
                                ).cuda()
        kw = dict(idx_pad=PAD, n_head=n_head, invert_padding_mask=False,
                  dropout=0.2, seed=seed + 1, tower=1)
        live = (seq != PAD).long().cumsum(1) > 0
        acts = encoder_cuda.saved_buffer(x, n_head, 1)
        p64 = params_mod._map(lambda t: t.double(), p)
        with torch.no_grad():
            y = encoder_cuda.encoder_fwd(x, seq, p, saved=acts, bf16=True,
                                         **kw)
            ref = enc.encoder_fwd_plain(x, seq, p, bf16=True, **kw)
            ref64 = enc.encoder_fwd_plain(x.double(), seq, p64, bf16=True,
                                          **kw)
        got = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts,
                                       bf16=True, **kw)
        br = gates.k2_branches(acts, x.shape, n_head, 1, kw["tower"])
        want = enc.encoder_bwd_plain(x, seq, gout, p, bf16=True, branches=br,
                                     **kw)
        want64 = enc.encoder_bwd_plain(x.double(), seq, gout.double(), p64,
                                       bf16=True, branches=br, **kw)
        flat = [got[0]] + list(got[1])
        flat_plain = [want[0]] + list(want[1])
        flat64 = [want64[0]] + list(want64[1])
        out.append({
            "seed": seed,
            "k2_vs_f64": _fro(y, ref64, live),
            "plain_k2_vs_f64": _fro(ref, ref64, live),
            "k2_vs_plain": _fro(y, ref, live),
            "k3_vs_f64": max(_fro(a, b) for a, b in zip(flat, flat64)),
            "plain_k3_vs_f64": max(_fro(a, b)
                                   for a, b in zip(flat_plain, flat64)),
            "k3_vs_plain": max(_fro(a, b) for a, b in zip(flat, flat_plain)),
            "digest": hashlib.sha256(b"".join(
                t.detach().cpu().numpy().tobytes() for t in [y] + flat)
            ).hexdigest()[:16]})
    return out


def summary(runs):
    """How often K2 and K3 lie further from float64 than the plain bf16
    tower, and quantiles (min, median, max) of each reading."""
    def q(v):
        return [float(np.quantile(v, x)) for x in (0, 0.5, 1)]

    out = {k: q([r[k] for r in runs]) for k in runs[0]
           if k not in ("seed", "digest")}
    for k in ("k2", "k3"):
        out[f"{k}_further_than_plain"] = int(sum(
            r[f"{k}_vs_f64"] > r[f"plain_{k}_vs_f64"] for r in runs))
        out[f"{k}_over_plain_f64"] = q([
            r[f"{k}_vs_f64"] / max(r[f"plain_{k}_vs_f64"], 1e-300)
            for r in runs])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=50)
    ap.add_argument("--root", default=REPO,
                    help="the checkout whose c2dsr_tpu_torch runs")
    ap.add_argument("--out", default=None, help="JSON file for every record")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if args.child:
        sys.path.insert(0, os.path.abspath(args.root))
        print(json.dumps(readings(range(args.seeds), args.child)))
        return 0
    res = {"root": os.path.abspath(args.root), "seeds": args.seeds}
    records = {}
    for shape in SHAPES:
        runs = [json.loads(subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", shape,
             "--seeds", str(args.seeds), "--root", args.root],
            capture_output=True, text=True, check=True
        ).stdout.strip().splitlines()[-1]) for _ in range(2)]
        res[shape] = {"bitwise_across_processes": all(
            a["digest"] == b["digest"] for a, b in zip(*runs)),
            "summary": summary(runs[0])}
        records[shape] = runs[0]
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(res, records=records), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
