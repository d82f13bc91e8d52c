"""The port's bench, the counterpart of the JAX package's ``bench.py``:

    python -m c2dsr_tpu_torch.bench                 # headline
    python -m c2dsr_tpu_torch.bench --kernels       # kernel_bench.py
    python -m c2dsr_tpu_torch.bench --ce-variants   # ce_variants.py
    python -m c2dsr_tpu_torch.bench --scaled        # scaled_bench.py
    python -m c2dsr_tpu_torch.bench --spmm-sweep    # spmm_experiments.py
    python -m c2dsr_tpu_torch.bench --batches       # train rate by batch
    python -m c2dsr_tpu_torch.bench --scaled-e2e    # scaled_e2e.py
    python -m c2dsr_tpu_torch.bench --ablation      # step_ablation.py
    ... [--device cpu]

The headline (bench.py:41-66, :139-203): train examples/s of
``train/step.make_train_step`` at FK geometry (bench/fk_graph.py), default
``Config``, batch 512: 4 batches cycled, 2 warm-up steps, then 30 timed
steps; and the full-rank eval rate, examples/s and items/s, over a
1,024-row chunk a domain of 2,048 synthetic users (seed 7), 10
repetitions.  Each is gated first: one step's loss and backward at
dropout 0 through the kernels must give the plain versions' loss to 1e-5
relative and each gradient to 1e-4 of its largest element (the gate
``chip_smoke.py`` uses), and the eval split's full-rank ranks must equal
the plain versions' except at near-ties (``bench/gates.check_ranks``, the
rule ``chip_smoke.py`` uses).  Beside it, as the JAX bench times its f32
step beside its bf16 default (bench.py:138-145), the train rate with both
dtypes bf16 (``compute_dtype`` and ``classifier_dtype``: the kernels'
bf16 instantiations), gated alike with BF16_GRAD_TOL; the headline stays
the f32 step.  On the card every timed step is the default one, captured
as a CUDA graph (``capture.py``); ``details.json`` also records the same
f32 step run eagerly (``capture=False``) in the same process
(``eager_train_examples_per_s``).  A mode whose gate fails exits non-zero.
The last line of standard output is one JSON object; details go to
``build/bench_torch/details.json`` (git-ignored).  The bench writes no
tracked file.

Every mode runs on the card.  ``--device cpu`` runs the headline,
``--batches`` and ``--ablation`` with the plain versions on the CPU (the
tests do, at a tiny :class:`Spec`); the kernel modes and ``--scaled-e2e``
(1M item rows) have no CPU form and raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from c2dsr_tpu_torch.bench import fk_graph, gates, timing

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DETAILS = os.path.join(REPO_DIR, "build", "bench_torch", "details.json")
BASELINE = os.path.join(REPO_DIR, "bench_baseline.json")
LOSS_TOL = 1e-5          # the train gate: loss relative to the plain one's
GRAD_TOL = 1e-4          # and each gradient tensor, max abs error over max
                         # |plain| (chip_smoke.py's train-step gate)
BF16_GRAD_TOL = 1e-2     # the same at bf16: the kernels' and the plain
                         # versions' sums round a few values to the other
                         # bf16 neighbour, which the tower carries on
                         # (chip_smoke.py STEP_BF16_GRAD_TOL; the f32 step
                         # lies 0.22 from the bf16 one, tests/test_torch_bf16)


@dataclasses.dataclass(frozen=True)
class Spec:
    """What the headline and ``--batches`` run: FK geometry by default."""
    n_item_a: int = fk_graph.N_ITEM_A
    n_item_b: int = fk_graph.N_ITEM_B
    len_max: int = fk_graph.LEN_MAX
    n_users: int = fk_graph.N_USERS       # users of the graph and train split
    batch: int = 512
    n_batches: int = 4                    # batches cycled by the timed steps
    warmup: int = 2
    steps: int = 30
    eval_users: int = 2048
    eval_chunk: int = 1024
    eval_reps: int = 10
    batches: Tuple[int, ...] = (256, 512, 1024, 2048, 4096)
    batch_examples: int = 8192            # --batches: examples a timing,
                                          # at least 8 steps
    cache: bool = True                    # bench_cache/ for the FK corpus


FK = Spec()


def merge_details(update: Dict) -> None:
    """Merge ``update`` into build/bench_torch/details.json."""
    os.makedirs(os.path.dirname(DETAILS), exist_ok=True)
    details = {}
    if os.path.exists(DETAILS):
        with open(DETAILS) as f:
            details = json.load(f)
    details.update(update)
    tmp = f"{DETAILS}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(details, f, indent=1)
    os.replace(tmp, DETAILS)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_name(device) -> str:
    """The card's name and power limit, or "cpu"."""
    return timing.card_line() if torch.device(device).type == "cuda" else "cpu"


def setup(spec: Spec, device):
    """(DataSpec, train split, graphs on ``device``) of the spec's corpus."""
    from c2dsr_tpu_torch.ops import backend
    device = backend.resolve_device(device)
    if device.type == "cuda":
        from c2dsr_tpu_torch.kernels import build
        build.build_all()
    sp = fk_graph.spec(spec.n_item_a, spec.n_item_b, spec.len_max)
    train = fk_graph.load_train(sp, spec.n_users, spec.cache)
    graphs = fk_graph.graphs(fk_graph.load_or_build(sp, spec.n_users,
                                                    spec.cache), device)
    return sp, train, graphs


def _batches(train, batch: int, n: int):
    """The first n batches of the train split, as the step takes them."""
    return [{k: v[i * batch:(i + 1) * batch] for k, v in train.items()}
            for i in range(n)]


def train_gate(cfg, sp, graphs, leaves, params, batch) -> Dict[str, float]:
    """One step's loss and gradients at dropout 0 through the kernels and
    through the plain versions, the plain tower taken at K2's branches
    (bench/gates.recording_k2_branches), as ``chip_smoke.py``'s train phase
    holds them: the loss to LOSS_TOL relative, each gradient tensor of
    ``leaves`` to GRAD_TOL (BF16_GRAD_TOL where the config takes bf16
    products) of its largest plain element, or GateFailure.  The backward
    runs every kernel the timed steps run (K1-K5, K7)."""
    from c2dsr_tpu_torch.train import step as step_mod
    cfg0 = cfg.with_(dropout_gnn=0.0, dropout_attn=0.0)

    def run(ctx):
        with ctx:
            loss = step_mod.loss_fn(params, graphs, batch, None, cfg0, sp)[0]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return float(loss.detach()), [
            torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)]

    branches = {}
    loss_k, g_k = run(gates.recording_k2_branches(branches))
    loss_p, g_p = run(gates.plain_versions(branches or None))
    rel = abs(loss_k - loss_p) / abs(loss_p)
    g_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                if float(b.abs().max()) > 0 else float(a.abs().max())
                for a, b in zip(g_k, g_p))
    if not (np.isfinite(loss_k) and rel <= LOSS_TOL):
        raise timing.GateFailure(f"train gate: loss {loss_k} (kernels) "
                                 f"against {loss_p} (plain), relative "
                                 f"{rel} > {LOSS_TOL}")
    grad_tol = BF16_GRAD_TOL if cfg.bf16_products() else GRAD_TOL
    if not g_rel <= grad_tol:
        raise timing.GateFailure(f"train gate: a gradient {g_rel} from the "
                                 f"plain versions' > {grad_tol}")
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "rel_err": rel,
            "grad_rel_err": g_rel, "n_grads": len(leaves)}


def train_rate(cfg, sp, graphs, train, spec: Spec, device, steps: int,
               capture=None):
    """(seconds a step, final state, gate) of ``steps`` timed steps of
    ``make_train_step`` at batch ``cfg.batch_size``, after the gate and
    ``spec.warmup`` warm-up steps, cycling ``spec.n_batches`` batches; the
    step captured as a CUDA graph by default on the card (``capture``, as
    ``make_train_step`` takes it)."""
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.train import optim
    from c2dsr_tpu_torch.train import step as step_mod
    params = params_mod.init_params(cfg, sp, torch.Generator().manual_seed(0),
                                    device)
    from c2dsr_tpu_torch.evaluate import ranker
    feed = _batches(train, cfg.batch_size, spec.n_batches)
    opt = optim.make_optimizer(cfg, steps_per_epoch=16)
    state = step_mod.init_state(params, opt)
    gate = train_gate(cfg, sp, graphs, state.opt_state.leaves, params,
                      ranker.to_device(feed[0], device))
    fn = step_mod.make_train_step(cfg, sp, graphs, opt, device,
                                  capture=capture)
    for b in feed[:spec.warmup]:
        state, aux = fn(state, b)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        state, aux = fn(state, feed[i % len(feed)])
    _sync(device)
    secs = (time.perf_counter() - t0) / steps
    if not np.isfinite(float(aux["loss"])):
        raise timing.GateFailure("train rate: loss not finite")
    return secs, state, gate


def eval_rate(cfg, sp, graphs, params, spec: Spec, device):
    """Full-rank eval rate (bench.py:145-169), gated first over the whole
    eval split by bench/gates.check_ranks.  Returns (examples/s, items/s,
    gate)."""
    from c2dsr_tpu_torch.data import preprocess, synthetic
    from c2dsr_tpu_torch.evaluate import ranker
    ev = preprocess.preprocess_evaluate(
        synthetic.generate_sequences(sp, spec.eval_users, seed=7), sp,
        n_neg_sample=99, seed=7)
    convolve_eval, rank_step = ranker.make_eval_fns(cfg, sp, graphs, device)
    hi = convolve_eval(params)
    ranks = ranker.evaluate_split(params, hi, ev, rank_step, cfg, "full")
    with gates.plain_versions(), gates.deterministic():
        hi_p = convolve_eval(params)
        ranks_p = ranker.evaluate_split(params, hi_p, ev, rank_step, cfg,
                                        "full")
    gate = gates.check_ranks(params, hi, hi_p, gates.convolve_float64(
        params, graphs, cfg, sp), ev, cfg, sp, "full", ranks, ranks_p,
        device=device)
    groups = ranker.partition_by_domain(ev)
    rates = {}
    for dom, n_dom in (("a", sp.n_item_a), ("b", sp.n_item_b)):
        chunk, _ = next(iter(ranker._batches(groups[dom], spec.eval_chunk)))
        rank_step(params, hi, chunk, dom, "full")
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(spec.eval_reps):
            r = rank_step(params, hi, chunk, dom, "full")
        _sync(device)
        if int(r.min()) < 1 or int(r.max()) > n_dom:
            raise timing.GateFailure(f"eval {dom}: ranks out of range")
        rates[dom] = (spec.eval_reps * spec.eval_chunk
                      / (time.perf_counter() - t0), n_dom)
    ex = (rates["a"][0] + rates["b"][0]) / 2
    items = (rates["a"][0] * rates["a"][1] + rates["b"][0] * rates["b"][1]) / 2
    return ex, items, gate


def headline(spec: Spec = FK, device="cuda") -> Dict:
    """The headline's numbers and its JSON line (``"line"``)."""
    from c2dsr_tpu_torch.config import Config
    sp, train, graphs = setup(spec, device)
    cfg = Config(batch_size=spec.batch)
    step_s, state, t_gate = train_rate(cfg, sp, graphs, train, spec, device,
                                       spec.steps)
    rate = spec.batch / step_s
    bf16_s, _, b_gate = train_rate(
        cfg.with_(compute_dtype="bfloat16", classifier_dtype="bfloat16"), sp,
        graphs, train, spec, device, spec.steps)
    ev_ex, ev_items, e_gate = eval_rate(cfg, sp, graphs, state.params, spec,
                                        device)
    on_card = torch.device(device).type == "cuda"
    eager_s = None
    if on_card:
        # the same step run op by op, for the record beside the captured one
        eager_s, _, _ = train_rate(cfg, sp, graphs, train, spec, device,
                                   spec.steps, capture=False)
    vs = None
    if spec == FK and os.path.exists(BASELINE):
        with open(BASELINE) as f:
            vs = rate / json.load(f)["examples_per_s"]
    dev = device_name(device)
    details = {
        "train_examples_per_s": rate, "train_step_ms": step_s * 1e3,
        "bf16_train_examples_per_s": spec.batch / bf16_s,
        "bf16_train_step_ms": bf16_s * 1e3, "bf16_train_gate": b_gate,
        "train_step": "captured as a CUDA graph" if on_card else "eager",
        "eager_train_examples_per_s": (spec.batch / eager_s if eager_s
                                       else None),
        "eager_train_step_ms": eager_s * 1e3 if eager_s else None,
        "eval_full_rank_examples_per_s": ev_ex,
        "eval_full_rank_items_per_s": ev_items,
        "train_gate": t_gate, "eval_gate": e_gate, "device": dev,
        "config": {"n_item": sp.n_item, "d": cfg.d_latent,
                   "batch": spec.batch, "len_max": sp.len_max,
                   "graph_users": spec.n_users, "steps": spec.steps},
        "vs_baseline": vs,
        "baseline": "bench_baseline.json: the unmodified PyTorch reference "
                    "on a CPU (bench/baseline_torch.py), examples/s at "
                    "FK geometry, batch 512",
    }
    line = {"metric": "train_examples_per_s_" + ("chip" if on_card
                                                 else "cpu"),
            "value": rate, "unit": "examples/s", "vs_baseline": vs,
            "device": dev}
    return {"details": details, "line": line}


def batch_scaling(spec: Spec = FK, device="cuda") -> Dict:
    """Train examples/s at each batch of ``spec.batches`` (bench.py:102-121;
    the headline pins 512), each gated by :func:`train_gate`; a batch
    larger than a quarter of the train split stops the list."""
    from c2dsr_tpu_torch.config import Config
    sp, train, graphs = setup(spec, device)
    rows = []
    for b in spec.batches:
        if b > train["seq_share"].shape[0] // 4:
            break
        step_s, _, gate = train_rate(Config(batch_size=b), sp, graphs, train,
                                     spec, device,
                                     max(8, spec.batch_examples // b))
        rows.append({"batch": b, "step_ms": step_s * 1e3,
                     "examples_per_s": b / step_s,
                     "gate_rel_err": gate["rel_err"],
                     "gate_grad_rel_err": gate["grad_rel_err"]})
        print(json.dumps(rows[-1]), flush=True)
    return {"note": "FK geometry as the headline; only the batch varies",
            "device": device_name(device), "results": rows}


def main(argv=None, spec: Optional[Spec] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m c2dsr_tpu_torch.bench")
    mode = ap.add_mutually_exclusive_group()
    for flag in ("--kernels", "--ce-variants", "--scaled", "--spmm-sweep",
                 "--batches", "--scaled-e2e", "--ablation"):
        mode.add_argument(flag, action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (headline, --batches and "
                         "--ablation)")
    args = ap.parse_args(argv)
    spec = spec or FK
    try:
        if args.scaled_e2e or args.ablation:
            if args.scaled_e2e:
                timing.require_cuda(args.device, "--scaled-e2e")
                from c2dsr_tpu_torch.bench import scaled_e2e
                section, out = "scaled_e2e", scaled_e2e.run(args.device)
            else:
                from c2dsr_tpu_torch.bench import step_ablation
                section, out = "step_breakdown", step_ablation.run(
                    spec, args.device)
            merge_details({section: out})
            line = {"metric": section, "value": 1, "unit": "done",
                    "vs_baseline": None, "device": out["device"]}
        elif (args.kernels or args.ce_variants or args.scaled
              or args.spmm_sweep):
            timing.require_cuda(args.device, "this bench mode")
            from c2dsr_tpu_torch.kernels import build
            build.build_all()
            if args.kernels:
                from c2dsr_tpu_torch.bench import kernel_bench
                section, out = "kernels", kernel_bench.run(args.device)
            elif args.ce_variants:
                from c2dsr_tpu_torch.bench import ce_variants
                section, out = "ce_variants", ce_variants.run(args.device)
            elif args.spmm_sweep:
                from c2dsr_tpu_torch.bench import spmm_experiments
                section, out = "spmm_sweep", spmm_experiments.run(args.device)
            else:
                from c2dsr_tpu_torch.bench import scaled_bench
                section, out = "scaled", scaled_bench.run(args.device)
            merge_details({section: out})
            line = {"metric": f"{section}_bench", "value": 1, "unit": "done",
                    "vs_baseline": None, "device": device_name(args.device)}
        elif args.batches:
            out = batch_scaling(spec, args.device)
            merge_details({"batch_scaling": out})
            line = {"metric": "batch_scaling", "value": 1, "unit": "done",
                    "vs_baseline": None, "device": out["device"]}
        else:
            out = headline(spec, args.device)
            merge_details({"headline": out["details"]})
            line = out["line"]
    except timing.GateFailure as e:
        print(f"bench: gate failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
