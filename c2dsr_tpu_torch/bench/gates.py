"""The correctness gates the bench and ``chip_smoke.py`` share: the plain
PyTorch versions swapped in for the kernels on the card, K2's branches
(ReLU masks, attention probabilities) at which the plain tower is held
against the kernels, and the serving
ranks' near-tie rule, by which the kernels' ranks must equal the plain
versions' except where the plain versions' own error against float64
could reorder a candidate and the ground truth.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

TIE_TOL = 1e-5           # the least near-tie band (near_ties)
SCORE_K = 2.0            # the kernels' serving scores may lie up to this many
                         # times as far from a float64 scoring as the plain
                         # versions' (K2's GEMMs are 3xTF32, its attention
                         # dots compensated: more accurate than cuBLAS's f32)


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic kernels for a plain reference run: the plain
    hop's ``index_add_`` on the card then sums a row's terms in index order
    where its atomics add them in the order they land, so the reference's
    error against float64 is the same each run (at d_latent 10 the atomics'
    draws put the plain scores 8.41e-8 to 1.59e-7 from float64 over six
    runs, the kernels' 1.708e-7 in each, an H100).  Ops with no
    deterministic form only warn."""
    was, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _ignore_saved(fn):
    """A plain tower version called as its kernel wrapper is: the kernels'
    saved-activation buffer is passed and ignored."""
    return lambda *args, saved=None, **kw: fn(*args, **kw)


@contextlib.contextmanager
def plain_versions(branches=None):
    """Route CUDA tensors through the plain PyTorch versions instead of the
    kernels, for the comparison run of the main path; the plain tower taken
    at ``branches`` (``ops/encoder.encode_layers``) if given.  Every
    wrapper of ``ops/wrappers.WRAPPERS`` is swapped; one without a plain
    version here raises."""
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import fused_ce, segsum_cuda, spmm, wrappers
    plain = {"spmm_csr": spmm.spmm_reference,
             "spmm_csr_flagged": spmm.spmm_reference_flagged,
             "encoder_fwd": _ignore_saved(
                 lambda *a, **kw: enc.encoder_fwd_plain(
                     *a, branches=branches, **kw)),
             "encoder_bwd": _ignore_saved(
                 lambda *a, **kw: enc.encoder_bwd_plain(
                     *a, branches=branches, **kw)),
             "ce_fwd": fused_ce.ce_fwd_plain,
             "ce_bwd": fused_ce.ce_bwd_plain,
             "segsum": segsum_cuda.segsum_plain}
    missing = [name for _, name in wrappers.WRAPPERS if name not in plain]
    if missing or len(plain) != len(wrappers.WRAPPERS):
        raise KeyError(f"plain versions {sorted(plain)} do not match the "
                       f"kernel wrappers (missing {missing})")
    swaps = [(mod, name, plain[name]) for mod, name in wrappers.WRAPPERS]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def k2_branches(saved, shape, n_head, n_layers, tower):
    """{(tower, layer): (K2's ReLU mask, K2's attention probabilities
    [B, H, L, L])} from a saved-activation buffer."""
    from c2dsr_tpu_torch.ops import encoder_cuda
    views = encoder_cuda.saved_views(saved, shape, n_head, n_layers)
    return {(tower, li): ((lv["fr"] > 0).float(),
                          lv["p"].permute(1, 0, 2, 3).clone())
            for li, lv in enumerate(views["layers"])}


@contextlib.contextmanager
def recording_k2_branches(store, calls=None):
    """The kernels as they are, with K2's branches (k2_branches) of every
    training tower call recorded into ``store`` by (tower, layer); with a
    list ``calls``, each backward call's inputs, K2's saved activations
    and K3's result appended to it."""
    from c2dsr_tpu_torch.ops import encoder_cuda
    fwd, bwd = encoder_cuda.encoder_fwd, encoder_cuda.encoder_bwd

    def recording(x, seq, params, *, saved=None, **kw):
        out = fwd(x, seq, params, saved=saved, **kw)
        if saved is not None:
            store.update(k2_branches(saved, x.shape, kw["n_head"],
                                     params["layers"]["w_qkv"].shape[0],
                                     kw["tower"]))
        return out

    def capturing(x, seq, gout, params, *, saved=None, **kw):
        got = bwd(x, seq, gout, params, saved=saved, **kw)
        calls.append({"x": x.detach().clone(), "seq": seq, "p": params,
                      "gout": gout.detach().clone(), "kw": kw,
                      "saved": saved.clone(), "got": got})
        return got

    # the wrappers count their launches on the module's names: carry them
    counts = ("launches", "launches_bf16", "launches_wide",
              "launches_wide_bf16")
    for name in counts:
        setattr(recording, name, getattr(fwd, name))
        setattr(capturing, name, getattr(bwd, name))
    encoder_cuda.encoder_fwd = recording
    if calls is not None:
        encoder_cuda.encoder_bwd = capturing
    try:
        yield
    finally:
        for name in counts:
            setattr(fwd, name, getattr(recording, name))
            if calls is not None:
                setattr(bwd, name, getattr(capturing, name))
        encoder_cuda.encoder_fwd, encoder_cuda.encoder_bwd = fwd, bwd


def convolve_float64(params, graphs, cfg, spec):
    """The plain propagation in float64 from ``params``: the tables of the
    exact serving run (near_ties)."""
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.parallel.strategy import LocalOps
    cfg64 = cfg.with_(compute_dtype="float64")
    with torch.inference_mode(), plain_versions():
        return c2dsr.convolve_graph(
            params_mod._map(lambda t: t.double(), params), graphs, cfg64,
            spec, LocalOps(cfg=cfg64))


def near_ties(params, hi, hi_plain, hi64, data, cfg, spec, mode,
              params_k=None, device="cuda"):
    """The serving ranks' tie bands, from the plain versions alone.  Per
    example, e is the largest gap over its candidates between the plain
    run's f32 scores (from the tables ``hi_plain``) and a float64 run of
    the plain path from the same params (tables ``hi64``,
    convolve_float64).  If the kernels' scores lie within SCORE_K·e of the
    float64 ones, a candidate can change
    order against the ground truth between the kernels' and the plain run
    only if its plain score lies within 2·(SCORE_K + 1)·e (at least TIE_TOL)
    of the gt's.  Returns (per domain, each example's count of such
    candidates other than the gt; the largest band; the kernels' largest
    score error against float64, from ``params_k`` (default ``params``) and
    ``hi``; the plain versions' largest; both over examples not read at an
    all-masked row)."""
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.parallel.strategy import LocalOps
    pops = LocalOps(cfg=cfg)
    cfg64 = cfg.with_(compute_dtype="float64")
    p64 = params_mod._map(lambda t: t.double(), params)
    out, widest, err_k, err_p = {}, TIE_TOL, 0.0, 0.0
    groups = ranker.partition_by_domain(data)
    with torch.inference_mode():
        for dom in ("a", "b"):
            counts = []
            for chunk, n in ranker._batches(groups[dom], cfg.batch_size_eval):
                b = ranker.to_device(chunk, device)
                h = ranker._last_hidden(params_k or params, hi, b, cfg, spec,
                                        dom, pops)
                with plain_versions():
                    hp = ranker._last_hidden(params, hi_plain, b, cfg, spec,
                                             dom, pops)
                    h64 = ranker._last_hidden(p64, hi64, b, cfg64, spec, dom,
                                              LocalOps(cfg=cfg64))
                w, bias, n_real = ((params["cls_a_w"], params["cls_a_b"],
                                    spec.n_item_a) if dom == "a" else
                                   (params["cls_b_w"], params["cls_b_b"],
                                    spec.n_item_b))
                if mode == "sampled":      # the gt in column 0
                    idx = torch.cat([b["gt_last"][:, None], b["list_neg"]], 1)
                    gt_col = torch.zeros_like(idx[:, :1])
                else:
                    idx = torch.arange(n_real, device=h.device).expand(
                        h.shape[0], n_real)
                    gt_col = b["gt_last"][:, None]
                s = pops._scores(h, w, bias).gather(1, idx)
                sp = pops._scores(hp, w, bias).gather(1, idx)
                s64 = (h64 @ w.double() + bias.double()).gather(1, idx)
                e = (sp - s64).abs().amax(1, keepdim=True)
                band = torch.clamp(2 * (SCORE_K + 1) * e, min=TIE_TOL)
                c = ((sp - sp.gather(1, gt_col)).abs() <= band).sum(1) - 1
                widest = max(widest, float(band[:n].max()))
                # all-masked rows are exempt, as in _rank_differences
                real = b[f"idx_last_{dom}"][:, None] >= 0
                err_k = max(err_k, float(((s - s64).abs() * real)[:n].max()))
                err_p = max(err_p, float((e * real)[:n].max()))
                counts.append(c[:n].cpu().numpy())
            out[dom] = np.concatenate(counts)
    return out, widest, err_k, err_p


def rank_differences(ranks, ranks_plain, ties, groups):
    """(ranks that differ, of them at all-masked rows, not explained by a
    near-tie or an all-masked row) over both domains.  A domain tower with
    no item of its domain is read at an all-masked row: its logits are all
    -1e9 + x, rounded to steps of 64, so two summation orders may round one
    logit apart."""
    n_diff = n_masked = n_unexplained = 0
    for i, dom in enumerate(("a", "b")):
        rk, rp = np.asarray(ranks[i]), np.asarray(ranks_plain[i])
        diff = rk != rp
        masked = groups[dom][f"idx_last_{dom}"] < 0
        n_diff += int(diff.sum())
        n_masked += int((diff & masked).sum())
        n_unexplained += int(((np.abs(rk - rp) > ties[dom]) & ~masked).sum())
    return n_diff, n_masked, n_unexplained


def check_ranks(params, hi, hi_plain, hi64, data, cfg, spec, mode, ranks,
                ranks_plain, device="cuda"):
    """The serving gate of one mode: the kernels' ranks equal the plain
    versions' except at near-ties and all-masked rows, and the kernels'
    scores lie within SCORE_K times the plain versions' error of the
    float64 ones.  ``hi_plain`` and ``ranks_plain`` come from a run under
    :func:`deterministic`, so that the plain versions' error is the same
    each run.  Returns {differ, tied, masked, unexplained, band,
    err_kernels, err_plain}; raises GateFailure where the gate fails."""
    from c2dsr_tpu_torch.bench.timing import GateFailure
    from c2dsr_tpu_torch.evaluate import ranker
    groups = ranker.partition_by_domain(data)
    ties, band, err_k, err_p = near_ties(params, hi, hi_plain, hi64, data,
                                         cfg, spec, mode, device=device)
    n_diff, n_masked, n_unexplained = rank_differences(ranks, ranks_plain,
                                                       ties, groups)
    out = {"differ": n_diff,
           "tied": sum(int((ties[dom] > 0).sum()) for dom in ("a", "b")),
           "masked": n_masked, "unexplained": n_unexplained, "band": band,
           "err_kernels": err_k, "err_plain": err_p}
    if err_k > SCORE_K * err_p:
        raise GateFailure(f"{mode}: kernels' scores {err_k} from float64, "
                          f"more than {SCORE_K} x the plain versions' "
                          f"{err_p}")
    if n_unexplained:
        raise GateFailure(f"{mode}: {n_unexplained} ranks differ beyond "
                          "near-ties")
    return out
