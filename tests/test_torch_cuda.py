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


@pytest.mark.parametrize("d", [4, 12, 128, 160, 256, 512, 1040])
@pytest.mark.parametrize("heavy_deg", [1, 8, 64, 128])
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


# the tower widths users set beyond 64 and 128: d % 64 == 32 (a ragged half
# chunk in the GEMMs), EE's L 30 at small d, d above 128, d % 32 == 8 with
# one head (ragged k chunks), EE's L 30 at d 256; d 512 (two column tiles
# and K2's LayerNorm kernel), and L past 32 (two keys a lane in attention)
WIDE_TOWERS = [(96, 2, 30, 1, 7), (32, 1, 30, 2, 9), (256, 4, 15, 1, 5),
               (160, 2, 16, 2, 6), (40, 1, 30, 1, 7), (256, 4, 30, 1, 5),
               (512, 4, 15, 1, 5), (512, 8, 30, 2, 3), (128, 2, 64, 1, 5),
               (256, 4, 64, 1, 3), (96, 2, 48, 2, 4)]


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("d,n_head,L,n_layers,B", [
    (128, 1, 15, 1, 37), (128, 2, 30, 2, 33), (64, 2, 15, 3, 5),
    (64, 1, 32, 1, 3), (128, 1, 1, 1, 70), (128, 16, 7, 1, 19)]
    + WIDE_TOWERS)
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
    """Shapes still refused, before any launch: d above 512 and L above 64;
    the error names the shape."""
    for d, L in ((520, 15), (64, 65)):
        p = params_mod.init_encoder_params(torch.Generator().manual_seed(0),
                                           Config(d_latent=d), L)
        p = params_mod.params_from_numpy(params_mod.params_to_numpy(p), cuda)
        x = torch.randn(4, L, d, device=cuda)
        seq = torch.zeros(4, L, dtype=torch.long, device=cuda)
        with pytest.raises(ValueError, match=f"does not take d={d}, "
                                             f"n_head=1, L={L}"):
            encoder_cuda.encoder_fwd(x, seq, p, idx_pad=1, n_head=1,
                                     invert_padding_mask=False)
        with pytest.raises(ValueError, match="does not take"):
            encoder_cuda.encoder_bwd(x, seq, x, p, idx_pad=1, n_head=1,
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
    """A norm_first tower has no fused kernel, as the JAX package's Pallas
    encoder takes post-norm only: on CUDA tensors it runs the plain tower,
    launches no encoder kernel and equals the CPU run, forward and
    backward."""
    cfg = Config(d_latent=64, norm_first=True, vocab_pad_multiple=64)
    init = params_mod.params_to_numpy(params_mod.init_params(
        cfg, SPEC, torch.Generator().manual_seed(0), "cpu"))
    seq = _inputs(6, 15, 64, SPEC.idx_pad, 3, "cpu")[1]
    w = torch.randn(6, 15, 64, generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda):
        params = params_mod.params_from_numpy(init, dev)
        x = params["embed_share"][seq.to(dev) % SPEC.n_item].detach()
        x.requires_grad_(True)
        before = encoder_cuda.encoder_fwd.launches
        h = c2dsr._encode(x, seq.to(dev), torch.zeros_like(seq).to(dev),
                          params["attn_share"], cfg, SPEC, seed=11, tower=0)
        assert encoder_cuda.encoder_fwd.launches == before
        (dx,) = torch.autograd.grad((h * w.to(dev)).sum(), x)
        out[str(dev)] = (h.detach().cpu(), dx.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=1e-4)
    assert _rel_err(out["cuda"][1], out["cpu"][1]) <= 1e-4


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
    (128, 16, 7, 1, 11)] + WIDE_TOWERS)
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
    assert torch.equal(again[0], dx)                     # deterministic
    for g, g2 in zip(grads, again[1]):
        assert torch.equal(g, g2)


@pytest.mark.parametrize("d,n_head,L,n_layers", [
    (128, 1, 15, 1), (64, 2, 15, 2), (40, 1, 30, 1), (256, 4, 30, 1),
    (512, 4, 15, 2)])
def test_encoder_row_map_gives_the_whole_calls_rows(cuda, d, n_head, L,
                                                    n_layers):
    """K2 and K3 under the dropout row map (the kernels' mapped
    instantiations): data rank 1's rows of a three-segment call (3 x 4 of
    3 x 8 sequences) at dropout 0.2 give the whole call's rows, and without
    the map they differ."""
    from c2dsr_tpu_torch.ops import dropout as drop
    B, m = 8, 4
    p, x, seq = _tower_case(cuda, d, n_head, L, n_layers, 3 * B)
    gout = torch.randn_like(x)
    kw = dict(idx_pad=999, n_head=n_head, invert_padding_mask=False,
              dropout=0.2, seed=77, tower=0)
    rows = torch.cat([torch.arange(s * B + m, s * B + 2 * m)
                      for s in range(3)]).to(cuda)

    def run(take, row_map):
        xs, ss, gs = (t[take].contiguous() for t in (x, seq, gout))
        out = encoder_cuda.encoder_fwd(xs, ss, p, row_map=row_map, **kw)
        dx, _ = encoder_cuda.encoder_bwd(xs, ss, gs, p, row_map=row_map, **kw)
        return out, dx

    full_out, full_dx = run(slice(None), None)
    out, dx = run(rows, drop.row_map(m, m, B))
    bad, _ = run(rows, None)
    torch.cuda.synchronize()
    assert float((out - full_out[rows]).abs().max()) <= 1e-4
    assert _rel_err(dx, full_dx[rows]) <= 1e-4
    assert float((bad - full_out[rows]).abs().max()) > 1e-2


def _plain_activations(x, seq, p, n_head, kw):
    """The plain tower's intermediates, layer by layer, as K2 saves them."""
    from c2dsr_tpu_torch.ops import dropout as drop
    B, L, d = x.shape
    dh = d // n_head
    args = (kw["dropout"], kw["seed"])
    h = drop.apply(x, *args, drop.SITE_INPUT, kw["tower"], 0)
    out = {"xin0": h, "layers": []}
    bias = enc.attention_mask_bias(seq, kw["idx_pad"], False)
    for li in range(p["layers"]["w_qkv"].shape[0]):
        lp = {k: v[li] for k, v in p["layers"].items()}

        def dr(site, t):
            return drop.apply(t, *args, site, kw["tower"], li)

        qkv = h @ lp["w_qkv"] + lp["b_qkv"]
        q, k, v = (t.reshape(B, L, n_head, dh).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        probs = torch.softmax(q @ k.transpose(-1, -2) / dh ** 0.5 + bias, -1)
        o = (dr(drop.SITE_PROBS, probs) @ v).transpose(1, 2).reshape(B, L, d)
        y1 = enc.layer_norm(h + dr(drop.SITE_ATTN_OUT, o @ lp["w_out"]
                                   + lp["b_out"]),
                            lp["ln1_scale"], lp["ln1_bias"])
        fr = torch.relu(y1 @ lp["w_ff1"] + lp["b_ff1"])
        fd = dr(drop.SITE_FFN_RELU, fr)
        h = enc.layer_norm(y1 + dr(drop.SITE_FFN_OUT, fd @ lp["w_ff2"]
                                   + lp["b_ff2"]),
                           lp["ln2_scale"], lp["ln2_bias"])
        out["layers"].append({"qkv": qkv, "p": probs.transpose(0, 1), "o": o,
                              "y1": y1, "fr": fr, "fd": fd, "xnext": h})
    return out


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("d,n_head,L,n_layers,B", [
    (64, 2, 15, 2, 9), (40, 1, 30, 1, 7), (256, 4, 30, 1, 3),
    (512, 4, 15, 2, 3), (128, 2, 64, 1, 3)])
def test_encoder_saved_activations_match_plain_forward(cuda, dropout, d,
                                                       n_head, L, n_layers,
                                                       B):
    """K2 in training writes what K3 reads: every layer's activations, equal
    to the plain forward's intermediates (1e-5 of each tensor's largest
    value), and the LayerNorms' xhat and 1/std consistent with them."""
    p, x, seq = _tower_case(cuda, d, n_head, L, n_layers, B)
    kw = dict(idx_pad=999, n_head=n_head, invert_padding_mask=False,
              dropout=dropout, seed=41, tower=1)
    acts = encoder_cuda.saved_buffer(x, n_head, n_layers)
    out = encoder_cuda.encoder_fwd(x, seq, p, saved=acts, **kw)
    views = encoder_cuda.saved_views(acts, x.shape, n_head, n_layers)
    want = _plain_activations(x, seq, p, n_head, kw)
    torch.cuda.synchronize()
    assert _rel_err(views["xin0"], want["xin0"]) <= 1e-6
    for li, (got, ref) in enumerate(zip(views["layers"], want["layers"])):
        for name, r in ref.items():
            assert _rel_err(got[name], r) <= 1e-5, (li, name)
        lnp = {k: v[li] for k, v in p["layers"].items()}
        for ln, y in (("1", got["y1"]), ("2", got["xnext"])):
            rebuilt = (got["xhat" + ln] * lnp[f"ln{ln}_scale"]
                       + lnp[f"ln{ln}_bias"])
            assert _rel_err(rebuilt, y) <= 1e-5
    rebuilt = views["xhat_f"] * p["lnf_scale"] + p["lnf_bias"]
    assert _rel_err(rebuilt, out) <= 1e-5


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("d,n_head,L,n_layers,B", [
    (128, 1, 15, 1, 9), (96, 2, 48, 2, 5), (512, 8, 30, 2, 3)])
def test_encoder_eval_workspace_matches_saving_forward(cuda, dropout, d,
                                                       n_head, L, n_layers, B):
    """K2 without a saved buffer (the one-layer eval workspace) runs the
    same arithmetic as the training forward that saves every layer: the
    outputs are bitwise equal, and a second launch repeats them."""
    p, x, seq = _tower_case(cuda, d, n_head, L, n_layers, B)
    kw = dict(idx_pad=999, n_head=n_head, invert_padding_mask=False,
              dropout=dropout, seed=8, tower=0)
    acts = encoder_cuda.saved_buffer(x, n_head, n_layers)
    saving = encoder_cuda.encoder_fwd(x, seq, p, saved=acts, **kw)
    out = encoder_cuda.encoder_fwd(x, seq, p, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, saving)
    assert torch.equal(out, encoder_cuda.encoder_fwd(x, seq, p, **kw))


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
    (64, 32, 52, 52), (300, 256, 1028, 1000)])
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
    for d in (36, 520):
        h, w = torch.randn(8, d, device=cuda), torch.randn(d, 8, device=cuda)
        z8 = torch.zeros(8, device=cuda)
        with pytest.raises(ValueError, match="d % 8 == 0, d <= 512"):
            fused_ce_cuda.ce_fwd(h, w, z8, z8, t)
        with pytest.raises(ValueError, match=f"d={d}"):
            fused_ce_cuda.ce_bwd(h, w, z8, z8, z8, z8, t)


def _fk_ce(cuda, N, d, V, n_real, seed):
    """CE inputs at FK's scales: |h| ~ 1, |W| ~ 0.05 (zero on the padded
    vocab tail), every 5th row ignored; dlse and dt ~ 1/N on the rest."""
    from c2dsr_tpu_torch.ops import fused_ce
    rng = np.random.default_rng(seed)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    h = put(rng.normal(size=(N, d)))
    w_np = rng.normal(size=(d, V)) * 0.05
    w_np[:, n_real:] = 0.0
    bm = fused_ce.mask_bias(put(rng.normal(size=V) * 0.1), n_real)
    tgt = rng.integers(0, n_real, size=N)
    tgt[::5] = n_real                                  # ignored rows
    tgt = torch.from_numpy(tgt).to(cuda)
    real = (tgt != n_real).float()
    return (h, put(w_np), bm, put(rng.normal(size=N)), tgt,
            put(rng.normal(size=N) / N) * real,
            put(rng.normal(size=N) / N) * real)


@pytest.mark.parametrize("d", list(range(8, 257, 8)))
def test_ce_fwd_kernel_matches_plain_to_f32(cuda, d):
    """K4 on the tensor cores (3xTF32) at every width it takes, against its
    plain version to 2e-5 relative at FK's scales, with a ragged last
    vocab tile, ignored rows whose target is V; two launches bitwise
    equal."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    N, V, n_real = 301, 1028, 1028
    h, w, bm, pad, tgt, _, _ = _fk_ce(cuda, N, d, V, n_real, seed=d)
    lse, tlog = fused_ce_cuda.ce_fwd(h, w, bm, pad, tgt)
    rlse, rtlog = fused_ce.ce_fwd_plain(h, w, bm, pad, tgt)
    again = fused_ce_cuda.ce_fwd(h, w, bm, pad, tgt)
    torch.cuda.synchronize()
    assert _rel_err(lse, rlse) <= 2e-5, _rel_err(lse, rlse)
    assert _rel_err(tlog, rtlog) <= 2e-5, _rel_err(tlog, rtlog)
    assert (tlog[tgt == V] == 0).all()
    assert torch.equal(lse, again[0]) and torch.equal(tlog, again[1])


@pytest.mark.parametrize("N,d,V,n_real", [
    (333, 32, 196, 196), (640, 64, 1028, 1000), (1000, 128, 4100, 4095),
    (257, 256, 2052, 2000), (64, 16, 8, 8), (300, 40, 1028, 1000),
    (300, 200, 2052, 2000)])
def test_ce_bwd_kernel_matches_plain_to_f32(cuda, N, d, V, n_real):
    """K5 on the tensor cores (3xTF32) against its plain version to 2e-5
    relative, at FK's scales (|h| ~ 1, |W| ~ 0.05, dlse and dt ~ 1/N): ragged
    N and V, ignored rows, the ignore index equal to V (196), a padded
    vocab tail; and two launches bitwise equal."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    rng = np.random.default_rng(N + d)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    h = put(rng.normal(size=(N, d)))
    w_np = rng.normal(size=(d, V)) * 0.05
    w_np[:, n_real:] = 0.0
    w = put(w_np)
    bm = fused_ce.mask_bias(put(rng.normal(size=V) * 0.1), n_real)
    tgt = rng.integers(0, n_real, size=N)
    tgt[::5] = n_real                                  # ignored rows
    tgt = torch.from_numpy(tgt).to(cuda)
    real = (tgt != n_real).float()
    lse, _ = fused_ce_cuda.ce_fwd(h, w, bm, put(rng.normal(size=N)), tgt)
    dlse = put(rng.normal(size=N) / N) * real
    dt = put(rng.normal(size=N) / N) * real
    got = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
    want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt)
    again = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
    torch.cuda.synchronize()
    for name, g, r, g2 in zip(("dh", "dw", "db"), got, want, again):
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, r) <= 2e-5, (name, _rel_err(g, r))
        assert torch.equal(g, g2), name                # deterministic
    assert (got[1][:, n_real:] == 0).all() and (got[2][n_real:] == 0).all()


def test_ce_bwd_kernel_takes_unaligned_inputs(cuda):
    """Views whose data start off a 16-byte boundary (the kernel's copies
    need one) give the same result as aligned copies."""
    from c2dsr_tpu_torch.ops import fused_ce_cuda
    h, w, bm, pad, tgt = _ce_case(cuda, 129, 64, 300, 290, seed=9)
    lse, _ = fused_ce_cuda.ce_fwd(h, w, bm, pad, tgt)
    g = torch.randn(3 * 129 + 1, device=cuda)
    dlse, dt = g[1:130], g[130:259]
    hv = torch.cat([torch.zeros(1, device=cuda), h.reshape(-1)])[1:]
    hv = hv.view(129, 64)
    assert hv.data_ptr() % 16 != 0
    got = fused_ce_cuda.ce_bwd(hv, w, bm, lse, dlse, dt, tgt)
    want = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse.clone(), dt.clone(), tgt)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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
        fn = step.make_train_step(cfg, SPEC, graphs, opt, dev)
        out = []
        for i in range(3):
            batch = {k: v[i * 32:(i + 1) * 32] for k, v in train.items()}
            state, aux = fn(state, batch)
            out.append(float(aux["loss"]))
        losses[str(dev)] = out
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def _step_against_float64(cuda, cfg, spec, share, specific, batch):
    """One train step's loss and every gradient, dropout 0, through the
    kernels on the card and through the plain versions in float64 on the
    CPU, from the same f32 params and batch: (loss, grads) of each.  The
    float64 run computes the same function (``attention_mask_bias`` rounds
    masked logits as f32 does), so it stands for the exact step."""
    from c2dsr_tpu_torch.train import step
    init = params_mod.params_to_numpy(params_mod.init_params(
        cfg, spec, torch.Generator().manual_seed(0), "cpu"))
    out = {}
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        params = params_mod._map(lambda t: t.to(dtype),
                                 params_mod.params_from_numpy(init, dev))
        leaves = step.param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        graphs = c2dsr.Graphs(spmm.device_graph(share, dev),
                              spmm.device_graph(specific, dev))
        launches = encoder_cuda.encoder_bwd.launches
        loss, _ = step.loss_fn(
            params, graphs, ranker.to_device(batch, dev), None,
            cfg.with_(compute_dtype=str(dtype).split(".")[1]), spec)
        loss.backward()
        if dev != "cpu":
            assert encoder_cuda.encoder_bwd.launches == launches + 3
        assert all(t.grad.dtype == dtype for t in leaves)
        out[str(dev)] = (float(loss), [t.grad.cpu() for t in leaves])
    return out["cuda"], out["cpu"]


def test_wide_train_step_on_card_matches_cpu(cuda):
    """One train step's loss and every gradient at d 256 (the towers' widest
    fused-LN tiles, K4 and K5 at their widest) on the card against the
    plain versions in float64 on the CPU, from the same params and batch,
    dropout 0.  The reference is float64 because the plain f32 tower is
    itself about as far from the exact gradients as this test's limit.  One
    step, not three: at this width AdamW's first steps follow the sign of
    gradients that are zero but for rounding, so two devices' third losses
    part by about 1e-3 with or without the kernels."""
    cfg = Config(d_latent=256, batch_size=32, len_rec=5, dropout_gnn=0.0,
                 dropout_attn=0.0, vocab_pad_multiple=64)
    share, specific = _graph()
    train = preprocess.preprocess_train(
        synthetic.generate_sequences(SPEC, 400, seed=3), SPEC, seed=1)
    batch = {k: v[:32] for k, v in train.items()}
    (lg, gg), (lc, gc) = _step_against_float64(cuda, cfg, SPEC, share,
                                               specific, batch)
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(gg, gc):
        assert _rel_err(a.double(), b) <= 1e-4 if float(b.abs().max()) > 0 \
            else float(a.abs().max()) == 0


def test_ee_train_step_on_card_matches_cpu(cuda):
    """One train step at EE's geometry (len_max 30) and d 256: the towers'
    L 30 sequences at their widest, K4 and K5 at d 256, on the card against
    the plain versions in float64 on the CPU, from the same params and
    batch, dropout 0: the loss and every gradient."""
    spec = DataSpec(n_item_a=300, n_item_b=400, len_max=30)
    cfg = Config(d_latent=256, n_head=4, batch_size=16, len_rec=5,
                 dropout_gnn=0.0, dropout_attn=0.0, vocab_pad_multiple=64)
    seqs = synthetic.generate_sequences(spec, 400, seed=3)
    share, specific = build.build_graphs(seqs, spec)
    train = preprocess.preprocess_train(seqs, spec, seed=1)
    batch = {k: v[:16] for k, v in train.items()}
    (lg, gg), (lc, gc) = _step_against_float64(cuda, cfg, spec, share,
                                               specific, batch)
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(gg, gc):
        assert _rel_err(a.double(), b) <= 1e-4 if float(b.abs().max()) > 0 \
            else float(a.abs().max()) == 0


# ---- experiment slice: K6, the batch-sparse SpMM ----

def _flag(n_rows, cuda, seed, share=0.3):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.rand(n_rows, generator=g, device=cuda) < share).to(
        torch.uint8)


@pytest.mark.parametrize("d", [4, 128, 256, 512])
@pytest.mark.parametrize("heavy_deg", [1, 8, 64, 128])
def test_spmm_flagged_kernel_matches_plain(cuda, d, heavy_deg):
    """K6 in dest mode (over A) and in src mode (over Aᵀ, on a gradient
    that is zero off the flags) against their plain versions and against
    K1: flagged dest rows bitwise K1's, unflagged ones zero."""
    share, _ = _graph()
    g = spmm.device_graph(share, cuda, heavy_deg=heavy_deg)
    n_rows = share.n + 9
    flag = _flag(n_rows, cuda, d + heavy_deg)
    heavy = g.heavy_rows.long()               # heavy rows of both kinds
    flag[heavy[::2]] = 0
    flag[heavy[1::2]] = 1
    sel = flag.bool()
    h = torch.randn(n_rows, d, device=cuda)
    out = spmm_cuda.spmm_csr_flagged(g, h, flag, "dest")
    ref = spmm.spmm_reference_flagged(g, h, flag, "dest")
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= 1e-5
    assert (out[~sel] == 0).all()
    assert torch.equal(out[sel], spmm_cuda.spmm_csr(g, h)[sel])
    gin = torch.randn(n_rows, d, device=cuda) * flag[:, None]
    out = spmm_cuda.spmm_csr_flagged(g.t, gin, flag, "src")
    ref = spmm.spmm_reference_flagged(g.t, gin, flag, "src")
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= 1e-5
    assert torch.equal(out, spmm_cuda.spmm_csr(g.t, gin))
    assert torch.equal(out, spmm_cuda.spmm_csr_flagged(g.t, gin, flag,
                                                       "src"))
    assert (out[share.n:] == 0).all()


@pytest.mark.parametrize("mode", ["dest", "src"])
def test_spmm_flagged_kernel_with_every_flag_is_k1(cuda, mode):
    """With every row flagged K6 keeps every edge in CSR order: bitwise
    the dense kernel (K1), over A and over Aᵀ."""
    share, _ = _graph()
    g = spmm.device_graph(share, cuda, heavy_deg=8)
    for graph in (g, g.t):
        h = torch.randn(share.n + 5, 128, device=cuda)
        ones = torch.ones(share.n + 5, dtype=torch.uint8, device=cuda)
        assert torch.equal(spmm_cuda.spmm_csr_flagged(graph, h, ones, mode),
                           spmm_cuda.spmm_csr(graph, h))


def test_spmm_flagged_kernel_refuses_bad_flag(cuda):
    share, _ = _graph()
    g = spmm.device_graph(share, cuda)
    h = torch.randn(share.n, 8, device=cuda)
    with pytest.raises(ValueError, match="flag must be"):
        spmm_cuda.spmm_csr_flagged(g, h, torch.ones(share.n, device=cuda),
                                   "dest")
    with pytest.raises(ValueError, match="flag_on"):
        spmm_cuda.spmm_csr_flagged(
            g, h, torch.ones(share.n, dtype=torch.uint8, device=cuda), "row")


def test_flagged_hop_routes_k6_both_ways(cuda):
    """The flagged hop's autograd: K6 dest forward, K6 src backward, against
    autograd through the plain version on a loss that reads flagged rows."""
    share, _ = _graph()
    g = spmm.device_graph(share, cuda, heavy_deg=8)
    n_rows = share.n + 9
    flag = _flag(n_rows, cuda, 5)
    h = torch.randn(n_rows, 128, device=cuda, requires_grad=True)
    w = torch.randn(n_rows, 128, device=cuda) * flag[:, None]
    before = spmm_cuda.spmm_csr_flagged.launches
    (dh,) = torch.autograd.grad((spmm_cuda.flagged_hop(g, h, flag) * w).sum(),
                                h)
    assert spmm_cuda.spmm_csr_flagged.launches == before + 2
    (ref,) = torch.autograd.grad(
        (spmm.spmm_reference_flagged(g, h, flag) * w).sum(), h)
    assert _rel_err(dh, ref) <= 1e-5


def test_batch_sparse_train_steps_on_card_match_cpu(cuda):
    """Three batch-sparse train steps on the card (K6 on every hop of a
    step) against the CPU, from the same params and batches; and each
    step launches K6 four times and K1 never."""
    from c2dsr_tpu_torch.train import optim, step
    cfg = Config(d_latent=64, batch_size=32, len_rec=5, dropout_gnn=0.0,
                 vocab_pad_multiple=64, batch_sparse_gnn=True)
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
        fn = step.make_train_step(cfg, SPEC, graphs, opt, dev)
        k1, k6 = spmm_cuda.spmm_csr.launches, spmm_cuda.spmm_csr_flagged.launches
        out = []
        for i in range(3):
            batch = {k: v[i * 32:(i + 1) * 32] for k, v in train.items()}
            state, aux = fn(state, batch)
            out.append(float(aux["loss"]))
        if dev != "cpu":
            assert spmm_cuda.spmm_csr.launches == k1
            assert spmm_cuda.spmm_csr_flagged.launches == k6 + 12
        losses[str(dev)] = out
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.parametrize("d", [264, 384, 512])
def test_ce_kernels_above_d256_match_plain_float64(cuda, d):
    """K4 and K5 above d 256 (64 resident rows a block, K5's output columns
    over two blocks) against their plain versions in float64 at FK's
    scales, 2e-5 relative, with a ragged last tile and ignored rows; two
    launches of each bitwise equal."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    N, V, n_real = 701, 2052, 2000
    h, w, bm, pad, tgt, dlse, dt = _fk_ce(cuda, N, d, V, n_real, seed=d)
    lse, tlog = fused_ce_cuda.ce_fwd(h, w, bm, pad, tgt)
    again = fused_ce_cuda.ce_fwd(h, w, bm, pad, tgt)
    got = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
    got2 = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
    h64, w64, b64, p64 = (t.double() for t in (h, w, bm, pad))
    rlse, rtlog = fused_ce.ce_fwd_plain(h64, w64, b64, p64, tgt)
    want = fused_ce.ce_bwd_plain(h64, w64, b64, lse.double(), dlse.double(),
                                 dt.double(), tgt)
    torch.cuda.synchronize()
    real = tgt != n_real
    assert _rel_err(lse.double(), rlse) <= 2e-5
    assert _rel_err(tlog[real].double(), rtlog[real]) <= 2e-5
    for name, g, r in zip(("dh", "dw", "db"), got, want):
        assert _rel_err(g.double(), r) <= 2e-5, name
    assert torch.equal(lse, again[0]) and torch.equal(tlog, again[1])
    assert all(torch.equal(a, b) for a, b in zip(got, got2))
    assert (got[2][n_real:] == 0).all()


@pytest.mark.parametrize("n_rows,n,d,heavy", [
    (5000, 7680, 128, 0.3), (15, 23040, 128, 0.6), (300, 1000, 512, 0.0),
    (64094, 1, 4, 0.0), (70, 5000, 36, 0.9), (40, 200, 8, 0.5),
    (64, 9000, 40, 0.7), (65, 9000, 40, 0.7), (100, 0, 8, 0.0)])
def test_segsum_is_cpu_index_add_bitwise(cuda, n_rows, n, d, heavy):
    """K7 against CPU index_add_, bit for bit (-0.0 included), on
    Zipf-skewed ids with absent ids, all-zero and all-(-0.0) gradient rows,
    rows past the list capacity and, at heavy 0.7, a row with more live rows
    than the scan kernel holds at once; the largest small table and the
    smallest large one; no ids; two launches equal."""
    from c2dsr_tpu_torch.ops import segsum_cuda
    rng = np.random.default_rng(n)
    ids = np.minimum(rng.zipf(1.3, size=n) - 1, n_rows - 1)
    ids[rng.random(n) < heavy] = n_rows - 1
    ids_t = torch.from_numpy(ids).to(cuda)
    g = torch.randn(n, d, device=cuda)
    g[::5] = -0.0
    g[1::7] = 0.0
    got = segsum_cuda.segsum(ids_t, g, n_rows)
    again = segsum_cuda.segsum(ids_t, g, n_rows)
    want = segsum_cuda.segsum_plain(ids_t.cpu(), g.cpu(), n_rows)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(got, again)


def test_segsum_takes_int32_ids_and_refuses_what_it_cannot_read(cuda):
    """int32 ids (converted first), bitwise CPU index_add_; a gradient that
    is not 16-byte aligned, or whose d is not a multiple of 4, is refused
    (K7 reads four floats a load)."""
    from c2dsr_tpu_torch.ops import segsum_cuda
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 900, size=4000)).to(cuda)
    g = torch.randn(4000, 64, device=cuda)
    want = segsum_cuda.segsum_plain(ids.cpu(), g.cpu(), 900)
    for i in (ids, ids.int()):
        got = segsum_cuda.segsum(i, g, 900)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
    buf = torch.randn(4000 * 64 + 1, device=cuda)
    unaligned = buf[1:].view(4000, 64)            # 4 bytes past alignment
    assert unaligned.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        segsum_cuda.segsum(ids, unaligned, 900)
    with pytest.raises(ValueError, match="d % 4"):
        segsum_cuda.segsum(ids, torch.randn(4000, 6, device=cuda), 900)


def test_segsum_leaves_its_workspace_ready(cuda):
    """After a call the counts and counters are zero and the touched list
    -1 again (the next call needs no clearing launch), with the heavy count
    moved aside for the scan kernel."""
    from c2dsr_tpu_torch.ops import segsum_cuda
    ids = torch.full((500,), 7, device=cuda)
    ids[::2] = 3
    g = torch.randn(500, 16, device=cuda)
    segsum_cuda.segsum(ids, g, 1000)
    stream = torch.cuda.current_stream().cuda_stream
    keys, counts, _, _, touched, ctr = segsum_cuda.workspace(
        g.device, stream, 500, 1000)
    torch.cuda.synchronize()
    assert not counts.any() and (touched == -1).all()
    assert ctr.tolist() == [0, 2, 0, 0]           # rows 3 and 7 were heavy
    assert torch.equal(keys[:500], ids.int())


def test_lookup_routes_k7_and_matches_cpu(cuda):
    from c2dsr_tpu_torch.ops import lookup, segsum_cuda
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 50, size=(16, 15))).to(cuda)
    table = torch.randn(50, 32, device=cuda, requires_grad=True)
    n0 = segsum_cuda.segsum.launches
    rows = lookup.lookup(table, ids)
    g = torch.randn(rows.shape, device=cuda)
    (grad,) = torch.autograd.grad(rows, table, g)
    assert segsum_cuda.segsum.launches == n0 + 1
    cpu = table.detach().cpu().requires_grad_(True)
    (want,) = torch.autograd.grad(lookup.lookup(cpu, ids.cpu()), cpu,
                                  g.cpu())
    assert torch.equal(grad.cpu(), want)


def _variant_case(cuda, N, V):
    from c2dsr_tpu_torch.bench import ce_variants
    return ce_variants._inputs(N, 128, V, N, cuda)


@pytest.mark.parametrize("variant", ["base", "nomatch", "exp2", "bf16exp",
                                     "matmulonly"])
def test_ce_variant_matches_plain(cuda, variant):
    """Each of K4's experiment variants against its plain version (the
    bench's PLAIN_TOL), ragged last vocab tile."""
    from c2dsr_tpu_torch.bench import ce_variants
    h, w, b, pad, tgt = _variant_case(cuda, 700, 4100)
    hv, bv, pv = ce_variants._scaled(variant, h, b, pad)
    got = ce_variants.ce_fwd_variant(variant, hv, w, bv, pv, tgt)
    want = ce_variants.variant_plain(variant, hv, w, bv, pv, tgt)
    torch.cuda.synchronize()
    assert _rel_err(got[0], want[0]) <= ce_variants.PLAIN_TOL[variant]
    if variant in ("nomatch", "matmulonly"):
        assert not got[1].any()
    else:
        assert _rel_err(got[1], want[1]) <= ce_variants.PLAIN_TOL[variant]


def test_ce_variant_base_is_production_k4(cuda):
    """base is K4 bitwise, and every variant passes the bench's gates."""
    from c2dsr_tpu_torch.bench import ce_variants
    from c2dsr_tpu_torch.ops import fused_ce_cuda
    h, w, b, pad, tgt = _variant_case(cuda, 1000, 8196)
    base = ce_variants.ce_fwd_variant("base", h, w, b, pad, tgt)
    k4 = fused_ce_cuda.ce_fwd(h, w, b, pad, tgt)
    assert torch.equal(base[0], k4[0]) and torch.equal(base[1], k4[1])
    errs = ce_variants.check_variants(h, w, b, pad, tgt)
    assert set(errs) == set(ce_variants.VARIANTS)
