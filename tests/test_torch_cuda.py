"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These run only where there is an NVIDIA card and nvcc; elsewhere every test
skips with its reason (the ``cuda`` fixture decides, at run time).
On the card:  python -m pytest --noconftest tests/test_torch_cuda.py -q
(``tests/conftest.py`` sets up JAX, which these tests do not use.)
Shapes are small and chosen to reach the kernels' edges: odd batch sizes, a
partial last block, feature widths that are not multiples of 128, rows
heavy enough to take the SpMM's block path, tables with extra pad rows.
"""

import numpy as np
import pytest
import torch

from c2dsr_tpu_torch.config import Config, DataSpec
from c2dsr_tpu_torch.data import preprocess, synthetic
from c2dsr_tpu_torch.evaluate import ranker
from c2dsr_tpu_torch.graph import build
from c2dsr_tpu_torch.model import c2dsr
from c2dsr_tpu_torch.model import params as params_mod
from c2dsr_tpu_torch.ops import encoder as enc
from c2dsr_tpu_torch.ops import encoder_cuda, spmm, spmm_cuda

SPEC = DataSpec(n_item_a=300, n_item_b=400, len_max=15)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _graph():
    seqs = synthetic.generate_sequences(SPEC, 3000, seed=0)
    return build.build_graphs(seqs, SPEC)


@pytest.mark.parametrize("d", [4, 12, 128, 160, 256])
@pytest.mark.parametrize("heavy_deg", [8, 128])
def test_spmm_kernel_matches_plain(cuda, d, heavy_deg):
    share, _ = _graph()
    g = spmm.device_graph(share, cuda, heavy_deg=heavy_deg)
    assert g.heavy_rows.numel() > 0
    h = torch.randn(share.n + 9, d, device=cuda)
    out = spmm_cuda.spmm_csr(g, h)
    ref = spmm.spmm_reference(g, h)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= 1e-5 * scale
    assert (out[share.n:] == 0).all()
    assert torch.equal(out, spmm_cuda.spmm_csr(g, h))      # deterministic


def test_spmm_kernel_refuses_bad_width(cuda):
    share, _ = _graph()
    g = spmm.device_graph(share, cuda)
    with pytest.raises(ValueError, match="d % 4"):
        spmm_cuda.spmm_csr(g, torch.randn(share.n, 6, device=cuda))


def _inputs(B, L, d, pad, seed, device):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 50, size=(B, L))
    n_pad = rng.integers(0, L + 1, size=B)
    n_pad[::5] = L
    n_pad[1::5] = 0
    seq[np.arange(L)[None, :] < n_pad[:, None]] = pad
    x = rng.normal(size=(B, L, d)).astype(np.float32) * 2.0
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(seq).to(device))


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("d,n_head,L,n_layers,B", [
    (128, 1, 15, 1, 37), (128, 2, 30, 2, 33), (64, 2, 15, 3, 5),
    (64, 1, 32, 1, 3), (128, 1, 1, 1, 70), (128, 16, 7, 1, 19)])
def test_encoder_kernel_matches_plain(cuda, invert, d, n_head, L, n_layers,
                                      B):
    cfg = Config(d_latent=d, n_head=n_head, n_attn=n_layers)
    p = params_mod.init_encoder_params(torch.Generator().manual_seed(B), cfg,
                                       L)
    p = params_mod.params_from_numpy(params_mod.params_to_numpy(p), cuda)
    pad = 999
    x, seq = _inputs(B, L, d, pad, seed=B, device=cuda)
    kw = dict(idx_pad=pad, n_head=n_head, invert_padding_mask=invert)
    out = encoder_cuda.encoder_fwd(x, seq, p, **kw)
    ref = enc.encode_layers(x, seq, p, norm_first=False, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= 1e-4


def test_encoder_kernel_refuses_unsupported_shapes(cuda):
    p = params_mod.init_encoder_params(torch.Generator().manual_seed(0),
                                       Config(d_latent=32), 15)
    p = params_mod.params_from_numpy(params_mod.params_to_numpy(p), cuda)
    x = torch.randn(4, 15, 32, device=cuda)
    seq = torch.zeros(4, 15, dtype=torch.long, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        encoder_cuda.encoder_fwd(x, seq, p, idx_pad=1, n_head=1,
                                 invert_padding_mask=False)


def test_encoder_kernel_refuses_unstacked_weights(cuda):
    p = params_mod.init_encoder_params(torch.Generator().manual_seed(0),
                                       Config(d_latent=64, n_attn=2), 15)
    p = params_mod.params_from_numpy(params_mod.params_to_numpy(p), cuda)
    x = torch.randn(4, 15, 64, device=cuda)
    seq = torch.zeros(4, 15, dtype=torch.long, device=cuda)
    kw = dict(idx_pad=1, n_head=1, invert_padding_mask=False)
    one = dict(p, layers={k: v[0] for k, v in p["layers"].items()})
    with pytest.raises(ValueError, match="w_qkv"):
        encoder_cuda.encoder_fwd(x, seq, one, **kw)
    strided = dict(p, layers=dict(p["layers"],
                                  w_out=p["layers"]["w_out"].transpose(1, 2)))
    with pytest.raises(ValueError, match="w_out"):
        encoder_cuda.encoder_fwd(x, seq, strided, **kw)


def test_norm_first_has_no_kernel_yet(cuda):
    cfg = Config(d_latent=64, norm_first=True, vocab_pad_multiple=64)
    params = params_mod.init_params(cfg, SPEC, torch.Generator().manual_seed(0),
                                    cuda)
    share, specific = _graph()
    graphs = c2dsr.Graphs(spmm.device_graph(share, cuda),
                          spmm.device_graph(specific, cuda))
    hi = c2dsr.convolve_graph(params, graphs, cfg, SPEC)
    seq = torch.full((2, 15), SPEC.idx_pad, device=cuda)
    with pytest.raises(NotImplementedError):
        c2dsr.forward_share(params, hi, seq, torch.zeros_like(seq), cfg, SPEC)


@pytest.mark.parametrize("mode", ["sampled", "full"])
def test_ranker_on_card_matches_cpu(cuda, mode):
    """The whole serving path on the card (kernels) against the CPU (plain
    versions), from the same params: ranks equal but for near-ties."""
    cfg = Config(d_latent=64, batch_size_eval=64, n_neg_sample=50,
                 vocab_pad_multiple=64)
    share, specific = _graph()
    data = preprocess.preprocess_evaluate(
        synthetic.generate_sequences(SPEC, 300, seed=1), SPEC,
        n_neg_sample=50, seed=2)
    cpu_params = params_mod.init_params(cfg, SPEC,
                                        torch.Generator().manual_seed(0), "cpu")
    out = {}
    for dev in ("cpu", cuda):
        params = params_mod.params_from_numpy(
            params_mod.params_to_numpy(cpu_params), dev)
        graphs = c2dsr.Graphs(spmm.device_graph(share, dev),
                              spmm.device_graph(specific, dev))
        conv, rank_step = ranker.make_eval_fns(cfg, SPEC, graphs, dev)
        launches = encoder_cuda.encoder_fwd.launches
        out[str(dev)] = ranker.evaluate_split(params, conv(params), data,
                                              rank_step, cfg, mode)
        if dev != "cpu":
            assert encoder_cuda.encoder_fwd.launches > launches
    for a, b in zip(out["cpu"], out["cuda"]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        assert (a != b).mean() <= 0.02


# ---- training slice: K1 over the transpose, K2 with dropout, K3, K4, K5 ----

def _rel_err(a, b):
    """max |a - b| over max |b| (1 where b is all zero)."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("heavy_deg", [8, 128])
def test_spmm_hop_backward_is_transpose_kernel(cuda, heavy_deg):
    """The hop's backward (K1 over the Aᵀ CSR) against autograd through the
    plain version, on a table with rows past graph.n."""
    share, _ = _graph()
    g = spmm.device_graph(share, cuda, heavy_deg=heavy_deg)
    assert g.t.heavy_rows.numel() > 0
    h = torch.randn(share.n + 9, 128, device=cuda, requires_grad=True)
    gout = torch.randn(share.n + 9, 128, device=cuda)
    before = spmm_cuda.spmm_csr.launches
    (dh,) = torch.autograd.grad(spmm_cuda.hop(g, h), h, gout)
    assert spmm_cuda.spmm_csr.launches == before + 2
    (ref,) = torch.autograd.grad(spmm.spmm_reference(g, h), h, gout)
    assert _rel_err(dh, ref) <= 1e-5
    assert (dh[share.n:] == 0).all()


def test_dropout_hash_matches_reference(cuda):
    from c2dsr_tpu_torch.ops import dropout as drop
    for seed, site, tower, layer in ((0, 0, 0, 0), (12345, 1, 2, 1),
                                     (2 ** 31 - 1, 4, 1, 3)):
        got = encoder_cuda.dropout_bits(seed, site, tower, layer, 300).cpu()
        want = [drop.bits_reference(seed, site, tower, layer, i)
                for i in range(300)]
        assert got.tolist() == want


def _tower_case(cuda, d, n_head, L, n_layers, B, seed=0):
    cfg = Config(d_latent=d, n_head=n_head, n_attn=n_layers)
    p = params_mod.init_encoder_params(torch.Generator().manual_seed(B + seed),
                                       cfg, L)
    p = params_mod.params_from_numpy(params_mod.params_to_numpy(p), cuda)
    x, seq = _inputs(B, L, d, 999, seed=B + seed, device=cuda)
    return p, x, seq


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("d,n_head,L,n_layers,B", [
    (128, 1, 15, 1, 37), (128, 2, 30, 2, 5), (64, 2, 15, 2, 9),
    (128, 16, 7, 1, 11)])
def test_encoder_train_kernels_match_plain(cuda, dropout, invert, d, n_head,
                                           L, n_layers, B):
    """K2 in train mode and K3 against the plain tower and its autograd."""
    p, x, seq = _tower_case(cuda, d, n_head, L, n_layers, B)
    kw = dict(idx_pad=999, n_head=n_head, invert_padding_mask=invert,
              dropout=dropout, seed=77, tower=2)
    out = encoder_cuda.encoder_fwd(x, seq, p, **kw)
    ref = enc.encoder_fwd_plain(x, seq, p, **kw)
    assert float((out - ref).abs().max()) <= 1e-4
    gout = torch.randn_like(x)
    dx, grads = encoder_cuda.encoder_bwd(x, seq, gout, p, **kw)
    rdx, rgrads = enc.encoder_bwd_plain(x, seq, gout, p, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(dx).all()
    assert _rel_err(dx, rdx) <= 1e-4
    for name, g, r in zip(enc._NAMES + ("lnf_scale", "lnf_bias"), grads,
                          rgrads):
        assert _rel_err(g, r) <= 1e-4, name
    again = encoder_cuda.encoder_bwd(x, seq, gout, p, **kw)
    assert torch.equal(again[1][0], grads[0])            # deterministic


def test_encoder_function_routes_both_kernels(cuda):
    p, x, seq = _tower_case(cuda, 128, 1, 15, 1, 6)
    for t in enc.tower_weights(p):
        t.requires_grad_(True)
    x.requires_grad_(True)
    f0, b0 = encoder_cuda.encoder_fwd.launches, encoder_cuda.encoder_bwd.launches
    out = encoder_cuda.encode(x, seq, p, idx_pad=999, n_head=1,
                              invert_padding_mask=False, dropout=0.2, seed=3)
    out.square().sum().backward()
    assert encoder_cuda.encoder_fwd.launches == f0 + 1
    assert encoder_cuda.encoder_bwd.launches == b0 + 1
    assert torch.isfinite(x.grad).all()


def test_encoder_bwd_refuses_bad_gradient(cuda):
    p, x, seq = _tower_case(cuda, 64, 1, 15, 1, 4)
    with pytest.raises(ValueError, match="gout"):
        encoder_cuda.encoder_bwd(x, seq, torch.randn(4, 15, 32, device=cuda), p,
                                 idx_pad=999, n_head=1,
                                 invert_padding_mask=False)


def _ce_case(cuda, N, d, V, n_real, seed):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.normal(size=(d, V)) * 0.2).astype(np.float32))
    w[:, n_real:] = 0.0
    b = torch.from_numpy(rng.normal(size=V).astype(np.float32))
    tgt = rng.integers(0, n_real, size=N)
    tgt[::7] = n_real                                  # ignored rows
    pad = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(cuda)
    from c2dsr_tpu_torch.ops import fused_ce
    bm = fused_ce.mask_bias(b.to(cuda), n_real)
    return h, w.to(cuda), bm, pad, torch.from_numpy(tgt).to(cuda)


@pytest.mark.parametrize("N,d,V,n_real", [
    (640, 128, 1024, 1000), (333, 64, 196, 196), (100, 128, 4100, 4095),
    (64, 32, 52, 52)])
def test_ce_kernels_match_plain(cuda, N, d, V, n_real):
    """K4 and K5 against their plain versions: ignored rows, a padded vocab
    tail, the ignore index equal to V, ragged row and column tiles."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    h, w, bm, pad, tgt = _ce_case(cuda, N, d, V, n_real, seed=N)
    lse, tlog = fused_ce_cuda.ce_fwd(h, w, bm, pad, tgt)
    rlse, rtlog = fused_ce.ce_fwd_plain(h, w, bm, pad, tgt)
    assert float((lse - rlse).abs().max()) <= 1e-4 * float(rlse.abs().max())
    assert float((tlog - rtlog).abs().max()) <= 1e-4 * float(rtlog.abs().max())
    # as the loss gives them: no gradient at ignored rows
    real = (tgt != n_real).float()
    dlse = torch.randn(N, device=cuda) * real
    dt = torch.randn(N, device=cuda) * real
    got = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
    want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt)
    torch.cuda.synchronize()
    for name, g, r in zip(("dh", "dw", "db"), got, want):
        assert _rel_err(g, r) <= 1e-4, name
    assert (got[2][n_real:] == 0).all()


def test_ce_kernels_refuse_bad_shapes(cuda):
    from c2dsr_tpu_torch.ops import fused_ce_cuda
    h = torch.randn(8, 64, device=cuda)
    t = torch.zeros(8, dtype=torch.long, device=cuda)
    with pytest.raises(ValueError, match="V % 4"):
        fused_ce_cuda.ce_fwd(h, torch.randn(64, 6, device=cuda),
                             torch.zeros(6, device=cuda),
                             torch.zeros(8, device=cuda), t)
    with pytest.raises(ValueError, match="d % 16"):
        fused_ce_cuda.ce_fwd(torch.randn(8, 40, device=cuda),
                             torch.randn(40, 8, device=cuda),
                             torch.zeros(8, device=cuda),
                             torch.zeros(8, device=cuda), t)


def test_ce_function_routes_both_kernels(cuda):
    """``fused_ce`` on the card: K4 forward, K5 backward, and the pad-class
    gradient outside the kernels, against autograd through the plain
    version."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    h, w, bm, pad, tgt = _ce_case(cuda, 200, 64, 300, 290, seed=4)
    ins = [t.clone().requires_grad_(True) for t in (h, w, bm, pad)]
    ref_ins = [t.clone().requires_grad_(True) for t in (h, w, bm, pad)]
    glse, gt = torch.randn(200, device=cuda), torch.randn(200, device=cuda)
    f0, b0 = fused_ce_cuda.ce_fwd.launches, fused_ce_cuda.ce_bwd.launches
    lse, tlog = fused_ce.fused_ce(*ins, tgt)
    grads = torch.autograd.grad((lse * glse + tlog * gt).sum(), ins)
    assert fused_ce_cuda.ce_fwd.launches == f0 + 1
    assert fused_ce_cuda.ce_bwd.launches == b0 + 1
    rlse, rtlog = fused_ce.ce_fwd_plain(*ref_ins, tgt)
    rgrads = torch.autograd.grad((rlse * glse + rtlog * gt).sum(), ref_ins)
    for name, g, r in zip(("dh", "dw", "db", "dpad"), grads, rgrads):
        assert _rel_err(g, r) <= 1e-4, name


def test_train_steps_on_card_match_cpu(cuda):
    """Three train steps on the card (every kernel, forward and backward)
    against the CPU (plain versions), from the same params and batches;
    tower dropout on (the same hash masks on both), GNN dropout off (its
    masks come from the device's own generator)."""
    from c2dsr_tpu_torch.train import optim, step
    cfg = Config(d_latent=64, batch_size=32, len_rec=5, dropout_gnn=0.0,
                 vocab_pad_multiple=64)
    share, specific = _graph()
    train = preprocess.preprocess_train(
        synthetic.generate_sequences(SPEC, 400, seed=3), SPEC, seed=1)
    init = params_mod.params_to_numpy(params_mod.init_params(
        cfg, SPEC, torch.Generator().manual_seed(0), "cpu"))
    losses = {}
    for dev in ("cpu", cuda):
        params = params_mod.params_from_numpy(init, dev)
        graphs = c2dsr.Graphs(spmm.device_graph(share, dev),
                              spmm.device_graph(specific, dev))
        opt = optim.make_optimizer(cfg, steps_per_epoch=2)
        state = step.init_state(params, opt)
        fn = step.make_train_step(cfg, SPEC, graphs, opt,
                                  torch.Generator().manual_seed(5), dev)
        out = []
        for i in range(3):
            batch = {k: v[i * 32:(i + 1) * 32] for k, v in train.items()}
            state, aux = fn(state, batch)
            out.append(float(aux["loss"]))
        losses[str(dev)] = out
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
