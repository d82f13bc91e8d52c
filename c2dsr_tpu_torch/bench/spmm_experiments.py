"""``--spmm-sweep``: K1's plan parameters swept at FK scale, the
counterpart of the JAX package's ``bench/spmm_experiments.py``.

The JAX script times its blocked SpMM across the TPU chunking (``r_block``,
``e_block``; ``spmm_pallas.prep`` and ``blocked_spmm_impl``) and the
``gather_dtype``.  The chunking has no counterpart on the card; K1's own
plan parameters do (``ops/spmm.plan``, ``csrc/spmm.cu``):

- ``heavy_deg``, the most edges a warp task sums; a row with more is cut
  into segments whose partial rows a second kernel adds (32 by default,
  ``spmm_cuda.HEAVY_DEG``);
- ``run_rows``, the most whole rows a task takes (32 by default and at
  most, ``spmm.RUN_ROWS``: the kernel reads a task's row ends one a lane);

and the gather: K1's f32 instantiation and its bf16 one
(``compute_dtype="bfloat16"``), the port's ``gather_dtype``.  The bf16
instantiation rounds as it gathers and reads the f32 table, where the JAX
kernel gathers a bf16 copy (``spmm_pallas.py:169-172``).

Each point of the grid runs the two hops of a train step: the FK share
graph at d 128 and the specific (A|B) graph at d 256, over the 65,536-row
padded table (``chip_smoke.phase_spmm``'s shapes), each over A (the hop)
and over Aᵀ (its backward), the graphs built by ``bench/fk_graph.py``.
Before a hop is timed it is held against the plain SpMM
(``spmm.spmm_reference``: f32 within SPMM_TOL of the largest output, bf16
against the plain bf16 hop within BF16_TOL) and bitwise against a second
launch; a failure raises GateFailure, never a skip.  A point reports its
plan (tasks, split rows, partial rows, the most edges in one task), the
seconds ``device_graph`` takes to build both CSRs with their plans, the
median CUDA-event ms over A and over Aᵀ with L2 flushed (bench/timing.Timer)
and their sum, the byte bound (each referenced table row read once, the
output written once, the CSR read once: ``kernel_bench.k1_bytes``) and
its share, and the error.  Then the default point and the fastest other
point of each dtype are timed in turns, ROUNDS rounds of (default, other,
other, default), each a sum of the four calls' medians; the difference
counts as resolved only beyond 3 standard errors.  The defaults are not
changed here.  Card only.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Sequence, Tuple

import torch

from c2dsr_tpu_torch.bench import fk_graph, kernel_bench, timing

HEAVY_DEGS = (8, 16, 32, 64, 128, 256)
RUN_ROWS = (8, 16, 32)
DTYPES = ("float32", "bfloat16")
GRID = tuple((hd, rr, dt) for dt in DTYPES for hd in HEAVY_DEGS
             for rr in RUN_ROWS)
HOPS = (("share", "s", 128), ("specific_ab", "p", 256))  # fk_graph keys
N_ROWS = 65536           # the padded item table (vocab_pad_multiple)
ROUNDS = 10              # rounds of (default, other, other, default)
TURN_REPS = 10           # timed launches of each call in a turn


def plan_stats(csr) -> Dict[str, int]:
    """The plan of one CSR: its warp tasks, split rows, their partial
    rows, and the most edges one task sums."""
    tasks = csr.tasks.cpu()
    return {"tasks": int(tasks.shape[0]),
            "split_rows": int(csr.heavy_rows.numel()),
            "partial_rows": int(csr.n_part),
            "max_task_edges": int((tasks[:, 3] - tasks[:, 2]).max())
            if tasks.shape[0] else 0}


def _calls(graphs, tables, bf16: bool):
    """The point's four K1 calls: each hop over A and over Aᵀ."""
    from c2dsr_tpu_torch.ops import spmm_cuda
    return [(name, tag, csr, tables[name],
             lambda csr=csr, h=tables[name]: spmm_cuda.spmm_csr(
                 csr, h, bf16=bf16))
            for name, _, _ in HOPS
            for tag, csr in (("a", graphs[name]), ("at", graphs[name].t))]


def _point(hd, rr, dtype, graphs, build_s, tables, timer, peak_bw) -> Dict:
    from c2dsr_tpu_torch.ops import spmm
    bf16 = dtype == "bfloat16"
    tol = kernel_bench.BF16_TOL if bf16 else kernel_bench.SPMM_TOL
    hops = {name: {"d": d} for name, _, d in HOPS}
    for name, tag, csr, h, call in _calls(graphs, tables, bf16):
        out = call()
        err = kernel_bench._rel(out, spmm.spmm_reference(csr, h, bf16=bf16))
        where = (f"K1 {dtype} heavy_deg {hd} run_rows {rr} {name} "
                 f"{'A' if tag == 'a' else 'A^T'}")
        if not err <= tol:
            raise timing.GateFailure(f"{where}: {err} from the plain SpMM "
                                     f"> {tol}")
        if not torch.equal(out, call()):
            raise timing.GateFailure(f"{where}: two launches differ")
        ms = timer(call)
        bound = kernel_bench.k1_bytes(csr, N_ROWS, h.shape[1]) / peak_bw * 1e3
        hops[name][tag] = {**plan_stats(csr), "ms": ms, "bound_ms": bound,
                           "pct_of_bound": 100 * bound / ms,
                           "max_rel_err": err}
    for r in hops.values():
        r["ms"] = r["a"]["ms"] + r["at"]["ms"]
        r["bound_ms"] = r["a"]["bound_ms"] + r["at"]["bound_ms"]
        r["pct_of_bound"] = 100 * r["bound_ms"] / r["ms"]
    ms = sum(r["ms"] for r in hops.values())
    bound = sum(r["bound_ms"] for r in hops.values())
    return {"heavy_deg": hd, "run_rows": rr, "dtype": dtype,
            "plan_build_s": build_s, "hops": hops, "ms": ms,
            "bound_ms": bound, "pct_of_bound": 100 * bound / ms,
            "max_rel_err": max(r[t]["max_rel_err"] for r in hops.values()
                               for t in ("a", "at"))}


def _in_turns(default: Dict, other: Dict, plans, tables, timer) -> Dict:
    """The two points' four calls timed in turns: ROUNDS rounds of
    (default, other, other, default), each a sum of TURN_REPS-launch
    medians."""
    bf16 = default["dtype"] == "bfloat16"
    calls = {id(p): [c[-1] for c in _calls(
        plans[(p["heavy_deg"], p["run_rows"])], tables, bf16)]
             for p in (default, other)}
    ms = {id(default): [], id(other): []}
    for p in (default, other, other, default) * ROUNDS:
        ms[id(p)].append(sum(timer(c, reps=TURN_REPS)
                             for c in calls[id(p)]))
    diff, se, resolved = timing.se_resolved(ms[id(other)], ms[id(default)])
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    return {"default": [default["heavy_deg"], default["run_rows"]],
            "other": [other["heavy_deg"], other["run_rows"]],
            "default_ms": mean[id(default)], "other_ms": mean[id(other)],
            "other_minus_default_ms": diff, "se_ms": se,
            "resolved": resolved, "samples": len(ms[id(default)])}


def run(device: str = "cuda",
        grid: Sequence[Tuple[int, int, str]] = GRID) -> Dict:
    """Every point of ``grid`` ((heavy_deg, run_rows, dtype) triples),
    gated then timed, each printed as a JSON line; then the default point
    against the fastest other point of each dtype, in turns."""
    timing.require_cuda(device, "--spmm-sweep")
    from c2dsr_tpu_torch.graph import build
    from c2dsr_tpu_torch.ops import spmm, spmm_cuda
    _, peak_bw = timing.peaks(torch.cuda.get_device_name(0))
    raw = fk_graph.load_or_build(fk_graph.spec())
    n = int(raw["n"])
    coo = {name: build.CooGraph(raw[f"{k}_rows"], raw[f"{k}_cols"],
                                raw[f"{k}_vals"], n) for name, k, _ in HOPS}
    gen = torch.Generator("cuda").manual_seed(1)
    tables = {}
    for name, _, d in HOPS:
        tables[name] = torch.randn((N_ROWS, d), device="cuda", generator=gen)
        tables[name][n:] = 0.0
    timer = timing.Timer()
    plans, build_s, points = {}, {}, []
    with torch.no_grad():
        for hd, rr, dtype in grid:
            if (hd, rr) not in plans:
                t0 = time.perf_counter()
                plans[(hd, rr)] = {
                    name: spmm.device_graph(coo[name], "cuda", heavy_deg=hd,
                                            run_rows=rr)
                    for name, _, _ in HOPS}
                torch.cuda.synchronize()
                build_s[(hd, rr)] = time.perf_counter() - t0
            points.append(_point(hd, rr, dtype, plans[(hd, rr)],
                                 build_s[(hd, rr)], tables, timer, peak_bw))
            print(json.dumps(points[-1]), flush=True)
        default = (spmm_cuda.HEAVY_DEG, spmm.RUN_ROWS)
        turns = {}
        for dtype in DTYPES:
            pts = [p for p in points if p["dtype"] == dtype]
            base = [p for p in pts
                    if (p["heavy_deg"], p["run_rows"]) == default]
            others = [p for p in pts
                      if (p["heavy_deg"], p["run_rows"]) != default]
            if base and others:
                turns[dtype] = _in_turns(base[0],
                                         min(others, key=lambda p: p["ms"]),
                                         plans, tables, timer)
    return {"device": timing.card_line(),
            "shapes": {name: {"d": d, "n_rows": N_ROWS,
                              "nnz": int(coo[name].rows.size)}
                       for name, _, d in HOPS},
            "default": list(default),
            "plan_build_s_total": sum(build_s.values()),
            "points": points, "default_against_fastest_other": turns}

