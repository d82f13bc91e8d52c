"""``--kernels``: each kernel of the train step alone at FK shapes, the
counterpart of the JAX package's ``bench/kernel_bench.py`` (:100-322).

Every kernel is first held against its plain PyTorch version on the same
inputs (a GateFailure voids the run), then timed by CUDA events with L2
flushed (bench/timing.Timer), beside its plain version, one PyTorch
library call where one computes the same function, and its bound at the
card's published peaks (bench/timing): operations as 3xTF32 on the tensor
cores or as FFMA, or bytes, each input read once and each output written
once.  The rows:

- K4 alone, and K4 + K5 together (forward and backward of the fused CE),
  at B 512, R 20 (N 10,240 rows), d 128, V 65,536;
- K1, one hop over the FK share graph at d 128, and K6, that hop with one
  FK batch's row flags;
- K2 alone, and K2 + K3 together, at B 512, L 15, d 128, dropout 0.2;
- the lookup: ``index_select`` and its backward K7, at one FK batch's ids
  into the 64,094-row share table;
- the bf16 instantiations (``compute_dtype="bfloat16"``), after the JAX
  bench's ``_bf16w`` and ``blocked_spmm_bf16_*`` rows (:106-123,
  :209-244): K4 and K4 + K5 on a bf16 W at the CE rows' shape, K1 and K6
  with the bf16 gather at the hop's; each gated against its plain bf16
  version, bounded at the bf16 tensor-core peak (and at one TF32 pass a
  product, their design), the library call an mm of bf16 operands into f32
  where this PyTorch has one.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from c2dsr_tpu_torch.bench import fk_graph, timing

CE_TOL = 1e-5            # K4: lse and target logit, over max |float64|
SPMM_TOL = 1e-5          # K1/K6: max abs err over max |plain|
ENC_TOL = 2e-5           # K2: over max |plain|, every row has a key
GRAD_TOL = 1e-4          # K3's gradients, per tensor, over max |plain| at
                         # K2's branches (the train step's gradient gate)
CE_GRAD_TOL = 2e-5       # K4+K5's gradients, per tensor, over max |float64|
DW_TOL = 1e-5            # K5's dW of them: as close as an f32 GEMM's order
# the bf16 instantiations against their plain bf16 versions (chip_smoke.py
# phase bf16's limits): the same rounded operands summed in another order
BF16_TOL = 1e-5          # K4's rows, K1/K6: max abs over max
BF16_GRAD_TOL = 5e-5     # K4+K5's dh, dW, db: max abs over max, dW before
                         # its rounding to a bf16 W's dtype (W f32, rounded
                         # in the kernels' pre-pass: the same kernels)


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _gate(ok: bool, msg: str) -> None:
    if not ok:
        raise timing.GateFailure(msg)


def _entry(name, ms, plain_ms, library_ms, flops, nbytes, name_card,
           peak_flops, peak_bw, err, **extra) -> Dict:
    """A row: times, the bounds (tc: 3xTF32 tensor cores, ffma, bytes) and
    which of them binds."""
    bytes_ms = nbytes / peak_bw * 1e3
    tc = timing.tc_bound_ms(flops, nbytes, name_card, peak_bw)
    ffma = max(flops / peak_flops * 1e3, bytes_ms)
    return {"kernel": name, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": tc, "bound_ffma_ms": ffma,
            "bound_by": "operations" if tc > bytes_ms else "bytes",
            "tflops": flops / ms / 1e9 if flops else None,
            "gbps": nbytes / ms / 1e6, "pct_of_bound": 100 * tc / ms,
            "max_rel_err": err, **extra}


def _bf16_entry(name, ms, plain_ms, library_ms, flops, nbytes, card,
                peak_bw, err, **extra) -> Dict:
    """A bf16 row: times and the bounds at the bf16 tensor-core peak and at
    one TF32 pass a product."""
    bound, one_pass = timing.bf16_bounds_ms(flops, nbytes, card, peak_bw)
    bytes_ms = nbytes / peak_bw * 1e3
    return {"kernel": name, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound,
            "bound_tf32_one_pass_ms": one_pass,
            "bound_by": "operations" if bound > bytes_ms else "bytes",
            "tflops": flops / ms / 1e9, "gbps": nbytes / ms / 1e6,
            "pct_of_bound": 100 * bound / ms, "max_rel_err": err, **extra}


def mm_bf16_f32(a: torch.Tensor, b: torch.Tensor):
    """One PyTorch call multiplying bf16 operands into an f32 product
    (``torch.mm``'s ``out_dtype``), or None where this PyTorch has none."""
    try:
        return torch.mm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return None


def bench_ce_bf16w(timer, card, peak_bw, B=512, R=20, d=128, V=65536
                   ) -> List[Dict]:
    """K4 and K4 + K5 on a bf16 W (the bf16 classifier), the JAX bench's
    ``fused_ce_*_bf16w`` rows: gated against the plain bf16 CE (its
    backward the JAX kernels', ``ops/bf16.py``), the gradients on the f32
    W that rounds to the bf16 one (the kernels round it in their
    pre-pass), whose dW is not yet rounded to bf16: a bf16 dW rounds a
    few values to the other neighbour on each side."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    N, n_real = B * R, V - 1024
    rng = np.random.default_rng(1)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    h = put(rng.normal(size=(N, d)))
    wb = put(rng.normal(size=(d, V)) * 0.02).to(torch.bfloat16)
    bm = fused_ce.mask_bias(put(rng.normal(size=V) * 0.02), n_real)
    pad = put(rng.normal(size=N))
    tgt = torch.from_numpy(rng.integers(0, n_real, size=N)).cuda()
    leaves = [t.clone().requires_grad_(True) for t in (h, wb, bm)]
    leaves32 = [t.detach().float().requires_grad_(True) for t in leaves]

    def fwd_bwd(fn, args=leaves):
        lse, tl = fn(*args, pad, tgt, bf16=True)
        return torch.autograd.grad((lse - tl).sum(), args)

    with torch.no_grad():
        got = fused_ce_cuda.ce_fwd(h, wb, bm, pad, tgt)
        want = fused_ce.ce_fwd_plain(h, wb, bm, pad, tgt)
    e_f = max(_rel(got[0], want[0]), _rel(got[1], want[1]))
    _gate(e_f <= BF16_TOL, f"K4 bf16: {e_f} from its plain bf16 version")
    g_k = fwd_bwd(fused_ce.fused_ce, leaves32)
    g_p = fwd_bwd(fused_ce.ce_fwd_plain, leaves32)
    errs = {n: _rel(a, b) for n, a, b in zip(("dh", "dw", "db"), g_k, g_p)}
    e_b = max(errs.values())
    _gate(e_b <= BF16_GRAD_TOL and fwd_bwd(fused_ce.fused_ce)[1].dtype
          == torch.bfloat16,
          f"K4+K5 bf16: gradients from the plain bf16 versions {errs}")
    hb = h.to(torch.bfloat16)
    lib = None
    if mm_bf16_f32(hb, wb) is not None:
        def lib_fwd():
            logits = mm_bf16_f32(hb, wb) + bm
            return (torch.logsumexp(torch.cat([logits, pad[:, None]], 1), 1),
                    logits.gather(1, tgt[:, None]))
        with torch.no_grad():
            lib = timer(lib_fwd)
    with torch.no_grad():
        f_ms = timer(lambda: fused_ce_cuda.ce_fwd(h, wb, bm, pad, tgt))
        f_plain = timer(lambda: fused_ce.ce_fwd_plain(h, wb, bm, pad, tgt))
    fb_ms = timer(lambda: fwd_bwd(fused_ce.fused_ce))
    fb_plain = timer(lambda: fwd_bwd(fused_ce.ce_fwd_plain))
    io = 4.0 * (N * d + V + 3 * N) + 2.0 * d * V
    shape = {"N": N, "d": d, "V": V, "w_dtype": "bfloat16"}
    return [
        _bf16_entry("K4 ce_fwd_bf16w", f_ms, f_plain, lib, 2.0 * N * V * d,
                    io, card, peak_bw, e_f, shape=shape),
        _bf16_entry("K4+K5 ce_fwd_bwd_bf16w", fb_ms, fb_plain, None,
                    6.0 * N * V * d, 2 * io + 4.0 * (N * d + V) + 2.0 * d * V,
                    card, peak_bw, e_b, shape=shape, errors=errs,
                    note="bounds count 6·N·V·d; library: none (no one "
                         "call differentiates a bf16 product into f32)")]


def bench_ce(timer, card, peak_flops, peak_bw, B=512, R=20, d=128,
             V=65536) -> List[Dict]:
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    N, n_real = B * R, V - 1024
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    h = put(rng.normal(size=(N, d)))
    w = put(rng.normal(size=(d, V)) * 0.02)
    bm = fused_ce.mask_bias(put(rng.normal(size=V) * 0.02), n_real)
    pad = put(rng.normal(size=N))
    tgt = torch.from_numpy(rng.integers(0, n_real, size=N)).cuda()
    leaves = [t.clone().requires_grad_(True) for t in (h, w, bm)]

    def fwd_bwd(fn, args, p=pad):
        lse, tl = fn(*args, p, tgt)
        return torch.autograd.grad((lse - tl).sum(), args)

    # held against the plain versions in float64 (the plain f32 ones are
    # themselves about 1e-5 from exact at this N)
    with torch.no_grad():
        got = fused_ce_cuda.ce_fwd(h, w, bm, pad, tgt)
        want = fused_ce.ce_fwd_plain(h.double(), w.double(), bm.double(),
                                     pad.double(), tgt)
    e_f = max(_rel(got[0], want[0]), _rel(got[1], want[1]))
    _gate(e_f <= CE_TOL, f"K4: {e_f} from its plain version in float64")
    # the gradients of the summed loss, whose dlogits are p - onehot as in
    # training: each tensor within CE_GRAD_TOL of float64, dW within DW_TOL;
    # the plain f32 versions' own errors are recorded beside the kernels'.
    # The dW kernel keeps at most 1,280 of the N rows in one tensor-core
    # accumulator, whose adds truncate: over all 10,240 in one split dW lay
    # 3.67e-5 from float64 where cuBLAS's f32 is near 2.5e-6
    # (tests/test_torch_tf32.py emulates both; one-pass TF32 products land
    # above 1e-4)
    g_k = fwd_bwd(fused_ce.fused_ce, leaves)
    g_32 = fwd_bwd(fused_ce.ce_fwd_plain, leaves)
    g_64 = fwd_bwd(fused_ce.ce_fwd_plain,
                   [t.detach().double().requires_grad_(True) for t in leaves],
                   pad.double())
    errs = {n: (_rel(a, c), _rel(b, c)) for n, a, b, c in
            zip(("dh", "dw", "db"), g_k, g_32, g_64)}
    e_b = max(k for k, _ in errs.values())
    del want, g_32, g_64
    _gate(e_b <= CE_GRAD_TOL and errs["dw"][0] <= DW_TOL,
          f"K4+K5: gradients (kernels, plain f32) from float64 {errs}")

    def lib_fwd():
        logits = h @ w + bm
        return (torch.logsumexp(torch.cat([logits, pad[:, None]], 1), 1),
                logits.gather(1, tgt[:, None]))

    def lib_fwd_bwd():
        hh, ww, bb = leaves
        logits = hh @ ww + bb
        lse = torch.logsumexp(torch.cat([logits, pad[:, None]], 1), 1)
        tl = logits.gather(1, tgt[:, None])[:, 0]
        return torch.autograd.grad((lse - tl).sum(), leaves)

    with torch.no_grad():
        f_ms = timer(lambda: fused_ce_cuda.ce_fwd(h, w, bm, pad, tgt))
        f_plain = timer(lambda: fused_ce.ce_fwd_plain(h, w, bm, pad, tgt))
        f_lib = timer(lib_fwd)
    fb_ms = timer(lambda: fwd_bwd(fused_ce.fused_ce, leaves))
    fb_plain = timer(lambda: fwd_bwd(fused_ce.ce_fwd_plain, leaves))
    fb_lib = timer(lib_fwd_bwd)
    io = 4.0 * (N * d + d * V + V + 3 * N)
    shape = {"N": N, "d": d, "V": V}
    return [
        _entry("K4 ce_fwd", f_ms, f_plain, f_lib, 2.0 * N * V * d, io, card,
               peak_flops, peak_bw, e_f, shape=shape),
        _entry("K4+K5 ce_fwd_bwd", fb_ms, fb_plain, fb_lib, 6.0 * N * V * d,
               2 * io + 4.0 * (N * d + d * V + V), card, peak_flops, peak_bw,
               e_b, shape=shape, errors_vs_float64=errs,
               note="bounds count 6·N·V·d: the logits and the two products")]


def bench_spmm(timer, card, peak_flops, peak_bw, train, graphs, d=128
               ) -> List[Dict]:
    from c2dsr_tpu_torch.evaluate import ranker
    from c2dsr_tpu_torch.ops import spmm, spmm_cuda
    from c2dsr_tpu_torch.train import step as step_mod
    g = graphs.share
    n_rows = 65536
    h = torch.randn((n_rows, d), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    h[g.n:] = 0.0
    b = ranker.to_device({k: v[:512] for k, v in train.items()}, "cuda")
    seq3 = torch.cat([b["seq_share"], b["seq_share_neg_a"],
                      b["seq_share_neg_b"]], 0)
    flag, _ = step_mod.row_flags(seq3, b["seq_share_a"], b["seq_share_b"],
                                 n_rows)
    out = spmm_cuda.spmm_csr(g, h)
    ref = spmm.spmm_reference(g, h)
    out_f = spmm_cuda.spmm_csr_flagged(g, h, flag, "dest")
    ref_f = spmm.spmm_reference_flagged(g, h, flag, "dest")
    e1, e6 = _rel(out, ref), _rel(out_f, ref_f)
    _gate(e1 <= SPMM_TOL and e6 <= SPMM_TOL, f"K1 {e1}, K6 {e6} from plain")
    rowptr = torch.cat([g.rowptr, g.rowptr[-1:].expand(n_rows - g.n)])
    csr = torch.sparse_csr_tensor(rowptr.long(), g.cols.long(), g.vals,
                                  size=(n_rows, n_rows),
                                  check_invariants=False)
    nnz = int(g.cols.numel())
    used = int(torch.unique(g.cols).numel())
    k1_bytes = used * d * 4 + n_rows * d * 4 + nnz * 8 + (g.n + 1) * 4
    keep = flag[g.rows.long()].bool()
    n_kept = int(keep.sum())
    used_f = int(torch.unique(g.cols[keep]).numel())
    k6_bytes = ((g.n + 1) * 4 + n_rows + 8 * n_kept + used_f * d * 4
                + n_rows * d * 4)
    with torch.no_grad():
        rows = [
            _entry("K1 spmm_csr", timer(lambda: spmm_cuda.spmm_csr(g, h)),
                   timer(lambda: spmm.spmm_reference(g, h)),
                   timer(lambda: torch.sparse.mm(csr, h)), 2.0 * nnz * d,
                   k1_bytes, card, peak_flops, peak_bw, e1, nnz=nnz),
            _entry("K6 spmm_csr_flagged dest",
                   timer(lambda: spmm_cuda.spmm_csr_flagged(g, h, flag,
                                                            "dest")),
                   timer(lambda: spmm.spmm_reference_flagged(g, h, flag,
                                                             "dest")),
                   timer(lambda: torch.sparse.mm(csr, h)), 2.0 * n_kept * d,
                   k6_bytes, card, peak_flops, peak_bw, e6, nnz=nnz,
                   kept_edges=n_kept,
                   note="library: dense torch.sparse.mm, more work")]
    # the bf16 gather (the JAX bench's blocked_spmm_bf16_gather and
    # _batch_sparse rows): the same bytes, each product rounded to bf16
    out16 = spmm_cuda.spmm_csr(g, h, bf16=True)
    out16_f = spmm_cuda.spmm_csr_flagged(g, h, flag, "dest", bf16=True)
    e16 = _rel(out16, spmm.spmm_reference(g, h, bf16=True))
    e16_f = _rel(out16_f, spmm.spmm_reference_flagged(g, h, flag, "dest",
                                                       True))
    _gate(e16 <= BF16_TOL and e16_f <= BF16_TOL,
          f"K1 bf16 {e16}, K6 bf16 {e16_f} from the plain bf16 hop")
    with torch.no_grad():
        rows += [
            _bf16_entry("K1 spmm_csr_bf16",
                        timer(lambda: spmm_cuda.spmm_csr(g, h, bf16=True)),
                        timer(lambda: spmm.spmm_reference(g, h, bf16=True)),
                        None, 2.0 * nnz * d, k1_bytes, card, peak_bw, e16,
                        nnz=nnz, note="library: none (no sparse product of "
                                      "bf16 operands into f32)"),
            _bf16_entry("K6 spmm_csr_flagged_bf16 dest",
                        timer(lambda: spmm_cuda.spmm_csr_flagged(
                            g, h, flag, "dest", bf16=True)),
                        timer(lambda: spmm.spmm_reference_flagged(
                            g, h, flag, "dest", True)),
                        None, 2.0 * n_kept * d, k6_bytes, card, peak_bw,
                        e16_f, nnz=nnz, kept_edges=n_kept)]
    return rows


def torch_tower(p, d, n_head, n_layers, dropout=0.0):
    """nn.TransformerEncoder with the port's weights: the library yardstick
    (in train mode when dropout > 0)."""
    import torch.nn as nn
    layer = nn.TransformerEncoderLayer(
        d_model=d, nhead=n_head, dim_feedforward=d, dropout=dropout,
        activation="relu", layer_norm_eps=1e-8, batch_first=True,
        norm_first=False)
    tower = nn.TransformerEncoder(layer, n_layers, nn.LayerNorm(d, eps=1e-8),
                                  enable_nested_tensor=False)
    with torch.no_grad():
        for i, tl in enumerate(tower.layers):
            lp = {k: v[i] for k, v in p["layers"].items()}
            tl.self_attn.in_proj_weight.copy_(lp["w_qkv"].T)
            tl.self_attn.in_proj_bias.copy_(lp["b_qkv"])
            tl.self_attn.out_proj.weight.copy_(lp["w_out"].T)
            tl.self_attn.out_proj.bias.copy_(lp["b_out"])
            tl.linear1.weight.copy_(lp["w_ff1"].T)
            tl.linear1.bias.copy_(lp["b_ff1"])
            tl.linear2.weight.copy_(lp["w_ff2"].T)
            tl.linear2.bias.copy_(lp["b_ff2"])
            tl.norm1.weight.copy_(lp["ln1_scale"])
            tl.norm1.bias.copy_(lp["ln1_bias"])
            tl.norm2.weight.copy_(lp["ln2_scale"])
            tl.norm2.bias.copy_(lp["ln2_bias"])
        tower.norm.weight.copy_(p["lnf_scale"])
        tower.norm.bias.copy_(p["lnf_bias"])
    return tower.cuda().train(dropout > 0)


def bench_encoder(timer, card, peak_flops, peak_bw, B=512, L=15, d=128,
                  n_head=1) -> List[Dict]:
    from c2dsr_tpu_torch.bench import gates
    from c2dsr_tpu_torch.config import Config
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import encoder as enc
    from c2dsr_tpu_torch.ops import encoder_cuda
    p = params_mod._map(lambda t: t.cuda(), params_mod.init_encoder_params(
        torch.Generator().manual_seed(0), Config(n_head=n_head, n_attn=1),
        L))
    rng = np.random.default_rng(2)
    pad = 10 ** 6                      # every position a real item: every
    seq = torch.from_numpy(rng.integers(0, 100, size=(B, L))).cuda()
    x = torch.from_numpy(rng.normal(size=(B, L, d)).astype(np.float32)).cuda()
    gout = torch.randn(x.shape, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(3))
    kw = dict(idx_pad=pad, n_head=n_head, invert_padding_mask=False,
              dropout=0.2, seed=3, tower=0)
    acts = encoder_cuda.saved_buffer(x, n_head, 1)
    with torch.no_grad():
        out = encoder_cuda.encoder_fwd(x, seq, p, saved=acts, **kw)
        ref = enc.encoder_fwd_plain(x, seq, p, **kw)
    dx, grads = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts, **kw)
    pdx, pgrads = enc.encoder_bwd_plain(
        x, seq, gout, p, branches=gates.k2_branches(acts, x.shape, n_head, 1,
                                                    0), **kw)
    e2 = _rel(out, ref)
    e3 = max(_rel(a, b) for a, b in zip([dx] + list(grads),
                                        [pdx] + list(pgrads)))
    _gate(e2 <= ENC_TOL, f"K2: {e2} from its plain version")
    _gate(e3 <= GRAD_TOL, f"K3: {e3} from its plain version at K2's "
          "branches")

    def k2():
        return encoder_cuda.encoder_fwd(x, seq, p, saved=acts, **kw)

    def k2k3():
        k2()
        return encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts, **kw)

    def plain_fb():
        enc.encoder_fwd_plain(x, seq, p, **kw)
        return enc.encoder_bwd_plain(x, seq, gout, p, **kw)

    # the library: nn.TransformerEncoder with the same weights, in train
    # mode at the same dropout, the tower's causal and key-padding masks
    tower = torch_tower(p, d, n_head, 1, dropout=kw["dropout"])
    causal = torch.triu(torch.ones(L, L, dtype=torch.bool, device="cuda"), 1)
    kpm = seq == pad
    xg = x.clone().requires_grad_(True)
    lib_params = [xg] + list(tower.parameters())

    def lib_fb():
        return torch.autograd.grad(
            tower(xg, mask=causal, src_key_padding_mask=kpm), lib_params,
            gout)

    N = B * L
    f_flops = 12.0 * N * d * d + 4.0 * N * L * d
    w_bytes = 4.0 * 12 * d * d
    with torch.no_grad():
        f_ms = timer(k2)
        f_plain = timer(lambda: enc.encoder_fwd_plain(x, seq, p, **kw))
        f_lib = timer(lambda: tower(x, mask=causal, src_key_padding_mask=kpm))
    return [
        _entry("K2 encoder_fwd", f_ms, f_plain, f_lib, f_flops,
               8.0 * N * d + w_bytes, card, peak_flops, peak_bw, e2,
               shape={"B": B, "L": L, "d": d}, dropout=0.2,
               note="saving the activations K3 reads; bytes count x and "
                    "the output; library: nn.TransformerEncoder in train "
                    "mode"),
        _entry("K2+K3 encoder_fwd_bwd", timer(k2k3), timer(plain_fb),
               timer(lib_fb), 3 * f_flops, 16.0 * N * d + 2 * w_bytes, card,
               peak_flops, peak_bw, e3, shape={"B": B, "L": L, "d": d},
               dropout=0.2,
               note="K3 held at K2's branches (bench/gates.k2_branches); "
                    "library: nn.TransformerEncoder forward and backward in "
                    "train mode")]


def deterministic_index_add(ids: torch.Tensor, g: torch.Tensor,
                            n_rows: int) -> torch.Tensor:
    """``zeros(n_rows, d).index_add_(0, ids, g)`` under
    ``torch.use_deterministic_algorithms(True)``: PyTorch's own repeatable
    form of K7's function, a yardstick the port never calls.  The flag is
    restored afterwards."""
    from c2dsr_tpu_torch.ops import segsum_cuda
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return segsum_cuda.segsum_plain(ids, g, n_rows)
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def bench_lookup(timer, card, peak_flops, peak_bw, train, n_rows=64094,
                 d=128) -> List[Dict]:
    from c2dsr_tpu_torch.ops import lookup, segsum_cuda
    ids = torch.from_numpy(train["seq_share"][:512].astype(np.int64)).cuda()
    ids = ids.clamp(max=n_rows - 1)
    table = torch.randn((n_rows, d), device="cuda", requires_grad=True)
    g = torch.randn((ids.numel(), d), device="cuda")
    got = segsum_cuda.segsum(ids, g, n_rows).cpu()
    want = segsum_cuda.segsum_plain(ids.cpu(), g.cpu(), n_rows)
    _gate(torch.equal(got, want), "K7: not bitwise CPU index_add_")
    e7 = _rel(got, want)
    rows = lookup.lookup(table, ids)
    got_fb = torch.autograd.grad(rows, table, g.view(rows.shape))[0].cpu()
    e_fb = _rel(got_fb, want)
    _gate(e_fb == 0.0, "lookup: its backward is not bitwise CPU index_add_")

    def ours():
        rows = lookup.lookup(table, ids)
        return torch.autograd.grad(rows, table, g.view(rows.shape))

    def plain():
        rows = table.index_select(0, ids.reshape(-1))
        return torch.autograd.grad(rows, table, g)

    det = deterministic_index_add(ids, g, n_rows).cpu()
    det_bitwise = torch.equal(det.view(torch.int32), want.view(torch.int32))
    n = ids.numel()
    nbytes = 8.0 * n + 4.0 * n * d + 4.0 * n * d + 4.0 * n_rows * d
    k7_ms = timer(lambda: segsum_cuda.segsum(ids, g, n_rows))
    k7_plain = timer(lambda: segsum_cuda.segsum_plain(ids, g, n_rows))
    k7_det = timer(lambda: deterministic_index_add(ids, g, n_rows))
    fb_plain = timer(plain)
    chain = segsum_cuda.longest_chain(ids, g, n_rows)
    k7 = _entry("K7 segsum", k7_ms, k7_plain, k7_det, 0.0,
                8.0 * n + 4.0 * n * d + 4.0 * n_rows * d, card, peak_flops,
                peak_bw, e7, n_ids=n, n_rows=n_rows, longest_chain=chain,
                order_bound_ms=timing.chain_bound_ms(
                    chain, timing.sm_clock_hz()),
                index_add_atomic_ms=k7_plain,
                deterministic_index_add_bitwise_cpu=det_bitwise,
                note="the lookup's backward, K7 (no sort); plain: "
                     "index_add_ on the card (atomics); library: "
                     "index_add_ under torch.use_deterministic_algorithms"
                     "(True); K7 bitwise CPU index_add_; bound: the larger "
                     "of the bytes and the order (the longest chain of "
                     "ordered adds, a FADD latency each)")
    if k7["order_bound_ms"] > k7["bound_ms"]:
        k7.update(bound_ms=k7["order_bound_ms"], bound_by="operations",
                  pct_of_bound=100 * k7["order_bound_ms"] / k7_ms)
    return [
        k7,
        _entry("lookup index_select + K7", timer(ours), fb_plain, fb_plain,
               0.0, nbytes + 8.0 * n, card, peak_flops, peak_bw, e_fb,
               n_ids=n, n_rows=n_rows,
               note="forward and backward; plain and library: "
                    "index_select under autograd (index_add_ backward)")]


def run(device: str = "cuda") -> Dict:
    timing.require_cuda(device, "--kernels")
    card = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = timing.peaks(card)
    sp = fk_graph.spec()
    train = fk_graph.load_train(sp)
    graphs = fk_graph.graphs(fk_graph.load_or_build(sp), "cuda")
    timer = timing.Timer()
    results = (bench_ce(timer, card, peak_flops, peak_bw)
               + bench_ce_bf16w(timer, card, peak_bw)
               + bench_spmm(timer, card, peak_flops, peak_bw, train, graphs)
               + bench_encoder(timer, card, peak_flops, peak_bw)
               + bench_lookup(timer, card, peak_flops, peak_bw, train))
    return {"device": timing.card_line(),
            "peaks": {"fp32_tflops": peak_flops / 1e12,
                      "tf32_tflops": timing.tf32_peak(card) / 1e12,
                      "bf16_tflops": timing.bf16_peak(card) / 1e12,
                      "hbm_tbps": peak_bw / 1e12},
            "results": results}
