"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These run only where there is an NVIDIA card and nvcc; elsewhere every test
skips with its reason (the ``cuda`` fixture decides, at run time).
On the card:  python -m pytest --noconftest tests/test_torch_cuda.py -q
(``tests/conftest.py`` sets up JAX, which these tests do not use.)
Shapes are small and chosen to reach the kernels' edges: odd batch sizes, a
partial last block, feature widths that are not multiples of 128, rows
heavy enough to take the SpMM's block path, tables with extra pad rows.
"""

import dataclasses

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


def _gen(cuda, seed):
    """A generator on the card seeded from the case's seed: a test's draws
    do not depend on what ran before it in the process."""
    return torch.Generator(cuda).manual_seed(seed)


@pytest.mark.parametrize("d", [4, 12, 128, 160, 256, 512, 1040])
@pytest.mark.parametrize("heavy_deg", [1, 8, 64, 128])
def test_spmm_kernel_matches_plain(cuda, d, heavy_deg):
    share, _ = _graph()
    g = spmm.device_graph(share, cuda, heavy_deg=heavy_deg)
    assert g.heavy_rows.numel() > 0
    h = torch.randn(share.n + 9, d, device=cuda,
                    generator=_gen(cuda, d + heavy_deg))
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
        spmm_cuda.spmm_csr(g, torch.randn(share.n, 6, device=cuda,
                                          generator=_gen(cuda, 0)))


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
# and K2's LayerNorm kernel), L past 32 (two keys a lane in attention), L
# past 64 (the tensor-core attention's key chunks and query tiles: L 65 a
# one-row last tile, L 128 two whole ones, L 130 a two-row last tile, L
# 200) and d past 512 (the LayerNorm kernels' rows walked in chunks)
WIDE_TOWERS = [(96, 2, 30, 1, 7), (32, 1, 30, 2, 9), (256, 4, 15, 1, 5),
               (160, 2, 16, 2, 6), (40, 1, 30, 1, 7), (256, 4, 30, 1, 5),
               (512, 4, 15, 1, 5), (512, 8, 30, 2, 3), (128, 2, 64, 1, 5),
               (256, 4, 64, 1, 3), (96, 2, 48, 2, 4), (64, 1, 130, 2, 3),
               (128, 1, 200, 1, 3), (520, 1, 15, 1, 3), (640, 5, 30, 1, 3),
               (128, 1, 65, 1, 4), (64, 2, 128, 1, 3)]


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
    """d 520 and L 65, refused before, run K2 and K3 against the plain
    versions; a head dim that is not a multiple of 8 and a call of 2^31
    probabilities are still refused before any launch, the error naming
    the shape."""
    for d, L in ((520, 15), (64, 65)):
        p, x, seq = _tower_case(cuda, d, 1, L, 1, 3, seed=d)
        kw = dict(idx_pad=999, n_head=1, invert_padding_mask=False,
                  dropout=0.2, seed=3, tower=0)
        out = encoder_cuda.encoder_fwd(x, seq, p, **kw)
        assert float((out - enc.encoder_fwd_plain(x, seq, p, **kw)).abs()
                     .max()) <= 1e-4
        gout = torch.randn(x.shape, device=cuda, generator=_gen(cuda, d))
        dx, grads = encoder_cuda.encoder_bwd(x, seq, gout, p, **kw)
        rdx, rgrads = enc.encoder_bwd_plain(x, seq, gout, p, **kw)
        torch.cuda.synchronize()
        for g, r in zip([dx] + grads, [rdx] + rgrads):
            assert _rel_err(g, r) <= 1e-4
    for d, n_head, B, L in ((520, 4, 4, 15), (8, 1, 2 ** 15, 256)):
        p = params_mod.init_encoder_params(torch.Generator().manual_seed(0),
                                           Config(d_latent=d), L)
        p = params_mod.params_from_numpy(params_mod.params_to_numpy(p), cuda)
        x = torch.zeros(B, L, d, device=cuda)
        seq = torch.zeros(B, L, dtype=torch.long, device=cuda)
        match = (f"does not take d={d}, n_head={n_head}, L={L}"
                 if n_head > 1 else "2\\^31 elements")
        with pytest.raises(ValueError, match=match):
            encoder_cuda.encoder_fwd(x, seq, p, idx_pad=1, n_head=n_head,
                                     invert_padding_mask=False)
        with pytest.raises(ValueError, match=match):
            encoder_cuda.encoder_bwd(x, seq, x, p, idx_pad=1, n_head=n_head,
                                     invert_padding_mask=False)


def test_encoder_kernel_refuses_unstacked_weights(cuda):
    p = params_mod.init_encoder_params(torch.Generator().manual_seed(0),
                                       Config(d_latent=64, n_attn=2), 15)
    p = params_mod.params_from_numpy(params_mod.params_to_numpy(p), cuda)
    x = torch.randn(4, 15, 64, device=cuda, generator=_gen(cuda, 0))
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
    gen = _gen(cuda, heavy_deg)
    h = torch.randn(share.n + 9, 128, device=cuda, generator=gen,
                    requires_grad=True)
    gout = torch.randn(share.n + 9, 128, device=cuda, generator=gen)
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
    gout = torch.randn(x.shape, device=cuda, generator=_gen(cuda, B))
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


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("d,n_head,L", [(128, 1, 200), (64, 2, 130)])
def test_encoder_all_masked_rows_in_every_query_tile(cuda, dropout, invert,
                                                     d, n_head, L):
    """Past L 64 every 64-row query tile of a sequence holds all-masked
    rows (left padding past the last tile's first row: such a row averages
    over all L positions, so no tile may skip its later key chunks), beside
    sequences padded past position 64 and not at all: K2 in train mode and
    K3 against the plain tower (K3 at K2's branches), and bitwise across
    launches."""
    from c2dsr_tpu_torch.bench import gates
    p, x, _ = _tower_case(cuda, d, n_head, L, 1, 4, seed=11)
    last = (L - 1) // 64 * 64            # the last tile's first row
    n_pad = np.array([L - 2, last + 1, 70, 0])
    seq = np.where(np.arange(L)[None, :] < n_pad[:, None], 999,
                   1 + np.arange(4 * L).reshape(4, L) % 50)
    seq = torch.from_numpy(seq).to(cuda)
    kw = dict(idx_pad=999, n_head=n_head, invert_padding_mask=invert,
              dropout=dropout, seed=3, tower=1)
    acts = encoder_cuda.saved_buffer(x, n_head, 1)
    out = encoder_cuda.encoder_fwd(x, seq, p, saved=acts, **kw)
    ref = enc.encoder_fwd_plain(x, seq, p, **kw)
    assert float((out - ref).abs().max()) <= 1e-4
    gout = torch.randn(x.shape, device=cuda, generator=_gen(cuda, 5))
    dx, grads = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts, **kw)
    rdx, rgrads = enc.encoder_bwd_plain(
        x, seq, gout, p, branches=gates.k2_branches(acts, x.shape, n_head, 1,
                                                    1), **kw)
    torch.cuda.synchronize()
    assert _rel_err(dx, rdx) <= 1e-4
    for name, g, r in zip(enc._NAMES + ("lnf_scale", "lnf_bias"), grads,
                          rgrads):
        assert _rel_err(g, r) <= 1e-4, name
    again = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts, **kw)
    assert torch.equal(again[0], dx)                     # deterministic
    assert all(torch.equal(g, g2) for g, g2 in zip(grads, again[1]))


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
    gout = torch.randn(x.shape, device=cuda, generator=_gen(cuda, d))
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
        encoder_cuda.encoder_bwd(x, seq, torch.randn(4, 15, 32, device=cuda,
                                                     generator=_gen(cuda, 0)),
                                 p,
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
    gen = _gen(cuda, N)
    dlse = torch.randn(N, device=cuda, generator=gen) * real
    dt = torch.randn(N, device=cuda, generator=gen) * real
    got = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
    want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt)
    torch.cuda.synchronize()
    for name, g, r in zip(("dh", "dw", "db"), got, want):
        assert _rel_err(g, r) <= 1e-4, name
    assert (got[2][n_real:] == 0).all()


def test_ce_kernels_refuse_bad_shapes(cuda):
    from c2dsr_tpu_torch.ops import fused_ce_cuda
    gen = _gen(cuda, 0)
    h = torch.randn(8, 64, device=cuda, generator=gen)
    t = torch.zeros(8, dtype=torch.long, device=cuda)
    with pytest.raises(ValueError, match="V % 4"):
        fused_ce_cuda.ce_fwd(h, torch.randn(64, 6, device=cuda, generator=gen),
                             torch.zeros(6, device=cuda),
                             torch.zeros(8, device=cuda), t)
    z8 = torch.zeros(8, device=cuda)
    h = torch.randn(8, 36, device=cuda, generator=gen)
    w = torch.randn(36, 8, device=cuda, generator=gen)
    with pytest.raises(ValueError, match="d % 8 == 0 and V % 4 == 0"):
        fused_ce_cuda.ce_fwd(h, w, z8, z8, t)
    with pytest.raises(ValueError, match="d=36"):
        fused_ce_cuda.ce_bwd(h, w, z8, z8, z8, z8, t)
    # W of 2 GiB in f32: the JAX package's limit
    h, w = torch.zeros(8, 512, device=cuda), torch.empty(512, 2 ** 20,
                                                         device=cuda)
    zv = torch.zeros(2 ** 20, device=cuda)
    with pytest.raises(ValueError, match="reaches 2 GiB"):
        fused_ce_cuda.ce_fwd(h, w, zv, z8, t)
    with pytest.raises(ValueError, match="reaches 2 GiB"):
        fused_ce_cuda.ce_bwd(h, w, zv, z8, z8, z8, t)


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
    g = torch.randn(3 * 129 + 1, device=cuda, generator=_gen(cuda, 9))
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
    gen = _gen(cuda, 4)
    glse = torch.randn(200, device=cuda, generator=gen)
    gt = torch.randn(200, device=cuda, generator=gen)
    f0, b0 = fused_ce_cuda.ce_fwd.launches, fused_ce_cuda.ce_bwd.launches
    lse, tlog = fused_ce.fused_ce(*ins, tgt)
    grads = torch.autograd.grad((lse * glse + tlog * gt).sum(), ins)
    assert fused_ce_cuda.ce_fwd.launches == f0 + 1
    assert fused_ce_cuda.ce_bwd.launches == b0 + 1
    rlse, rtlog = fused_ce.ce_fwd_plain(*ref_ins, tgt)
    rgrads = torch.autograd.grad((rlse * glse + rtlog * gt).sum(), ref_ins)
    for name, g, r in zip(("dh", "dw", "db", "dpad"), grads, rgrads):
        assert _rel_err(g, r) <= 1e-4, name


@pytest.mark.parametrize("d", [36, 10])
def test_odd_widths_run_the_kernels_padded(cuda, d):
    """At widths the kernels do not take, the op-level callers pad d with
    zeros (ops/padding): the CE (K4/K5 at d padded to 8), the hop (K1 at d
    padded to 4) and a lookup's backward (K7), each against autograd
    through the plain version, with each kernel launched once."""
    from c2dsr_tpu_torch.ops import (backend, fused_ce, fused_ce_cuda,
                                     lookup, segsum_cuda)
    h, w, bm, pad, tgt = _ce_case(cuda, 200, d, 300, 290, seed=d)
    ins = [t.clone().requires_grad_(True) for t in (h, w, bm, pad)]
    ref_ins = [t.clone().requires_grad_(True) for t in (h, w, bm, pad)]
    gen = _gen(cuda, d)
    glse = torch.randn(200, device=cuda, generator=gen)
    gt = torch.randn(200, device=cuda, generator=gen)
    f0, b0 = fused_ce_cuda.ce_fwd.launches, fused_ce_cuda.ce_bwd.launches
    lse, tlog = fused_ce.fused_ce(*ins, tgt)
    grads = torch.autograd.grad((lse * glse + tlog * gt).sum(), ins)
    assert (fused_ce_cuda.ce_fwd.launches, fused_ce_cuda.ce_bwd.launches) \
        == (f0 + 1, b0 + 1)
    rlse, rtlog = fused_ce.ce_fwd_plain(*ref_ins, tgt)
    assert _rel_err(lse, rlse) <= 1e-5 and _rel_err(tlog, rtlog) <= 1e-5
    rgrads = torch.autograd.grad((rlse * glse + rtlog * gt).sum(), ref_ins)
    for name, g, r in zip(("dh", "dw", "db", "dpad"), grads, rgrads):
        assert g.shape == r.shape and _rel_err(g, r) <= 1e-4, name

    share, _ = _graph()
    g = spmm.device_graph(share, cuda)
    gen = _gen(cuda, d + 1)
    x = torch.randn(share.n + 9, d, device=cuda, generator=gen)
    cot = torch.randn(x.shape, device=cuda, generator=gen)
    outs = []
    for fn in (lambda t: backend.spmm(g, t),
               lambda t: spmm.spmm_reference(g, t)):
        t = x.clone().requires_grad_(True)
        out = fn(t)
        (out * cot).sum().backward()
        outs.append((out.detach(), t.grad))
    for a, b in zip(*outs):
        assert a.shape == b.shape and _rel_err(a, b) <= 1e-5

    ids = torch.randint(0, share.n, (500,), device=cuda)
    k0 = segsum_cuda.segsum.launches
    table = x.clone().requires_grad_(True)
    (lookup.lookup(table, ids) * cot[:500]).sum().backward()
    assert segsum_cuda.segsum.launches == k0 + 1
    want = torch.zeros_like(x).index_add_(0, ids, cot[:500])
    assert _rel_err(table.grad, want) <= 1e-6


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
    h = torch.randn(n_rows, d, device=cuda, generator=_gen(cuda, d + heavy_deg))
    out = spmm_cuda.spmm_csr_flagged(g, h, flag, "dest")
    ref = spmm.spmm_reference_flagged(g, h, flag, "dest")
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= 1e-5
    assert (out[~sel] == 0).all()
    assert torch.equal(out[sel], spmm_cuda.spmm_csr(g, h)[sel])
    gin = torch.randn(n_rows, d, device=cuda,
                      generator=_gen(cuda, d + heavy_deg + 1)) * flag[:, None]
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
        h = torch.randn(share.n + 5, 128, device=cuda,
                        generator=_gen(cuda, len(mode)))
        ones = torch.ones(share.n + 5, dtype=torch.uint8, device=cuda)
        assert torch.equal(spmm_cuda.spmm_csr_flagged(graph, h, ones, mode),
                           spmm_cuda.spmm_csr(graph, h))


def test_spmm_flagged_kernel_refuses_bad_flag(cuda):
    share, _ = _graph()
    g = spmm.device_graph(share, cuda)
    h = torch.randn(share.n, 8, device=cuda, generator=_gen(cuda, 0))
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
    gen = _gen(cuda, 6)
    h = torch.randn(n_rows, 128, device=cuda, generator=gen,
                    requires_grad=True)
    w = torch.randn(n_rows, 128, device=cuda, generator=gen) * flag[:, None]
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


@pytest.mark.parametrize("d", [264, 384, 512, 640, 1024])
def test_ce_kernels_above_d256_match_plain_float64(cuda, d):
    """K4 and K5 above d 256 (up to 512 64 resident rows a block, K5's
    output columns over two blocks; above, the wide kernels) against their
    plain versions in float64 at FK's scales, 2e-5 relative, with a ragged
    last tile and ignored rows; two launches of each bitwise equal."""
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
    g = torch.randn(n, d, device=cuda, generator=_gen(cuda, n + d))
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
    gen = _gen(cuda, 0)
    g = torch.randn(4000, 64, device=cuda, generator=gen)
    want = segsum_cuda.segsum_plain(ids.cpu(), g.cpu(), 900)
    for i in (ids, ids.int()):
        got = segsum_cuda.segsum(i, g, 900)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
    buf = torch.randn(4000 * 64 + 1, device=cuda, generator=gen)
    unaligned = buf[1:].view(4000, 64)            # 4 bytes past alignment
    assert unaligned.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        segsum_cuda.segsum(ids, unaligned, 900)
    with pytest.raises(ValueError, match="d % 4"):
        segsum_cuda.segsum(ids, torch.randn(4000, 6, device=cuda,
                                            generator=gen), 900)


def test_segsum_leaves_its_workspace_ready(cuda):
    """After a call the counts and counters are zero and the touched list
    -1 again (the next call needs no clearing launch), with the heavy count
    moved aside for the scan kernel."""
    from c2dsr_tpu_torch.ops import segsum_cuda
    ids = torch.full((500,), 7, device=cuda)
    ids[::2] = 3
    g = torch.randn(500, 16, device=cuda, generator=_gen(cuda, 0))
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
    gen = _gen(cuda, 0)
    table = torch.randn(50, 32, device=cuda, generator=gen,
                        requires_grad=True)
    n0 = segsum_cuda.segsum.launches
    rows = lookup.lookup(table, ids)
    g = torch.randn(rows.shape, device=cuda, generator=gen)
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


# ------------------------------------------------------------------ bf16 ----
# Each kernel's bf16 instantiation (compute_dtype="bfloat16") against its
# plain bf16 version, and the f32 instantiation in its place failing the
# same limit: chip_smoke.py's phase bf16 limits, whose readings PERF.md
# gives (the CPU readings against the JAX package: tests/test_torch_bf16.py).
BF16_SPMM_TOL, BF16_K2_TOL, BF16_K3_TOL = 1e-5, 5e-4, 1e-2
BF16_CE_TOL = 1e-5
# K5's bf16 instantiation against the plain bf16 CE, max abs over max and
# relative Frobenius, the worst of dh, dW, db.  Both versions round the
# dlogits to bf16 before the products, so an f32 difference of a few ulps
# moves a dlogit that lies near a bf16 rounding boundary by one bf16 ulp
# (2^-8 of itself), in either version.  Read by tests/ce_bf16_seeds.py
# over seeds 0-199 at d 512 and 0-59 at d 40, 128 and 1,024 (inputs as
# drawn here; an H100 80GB HBM3 at 700 W, PERF.md §6): K5 lies as
# near float64 of the same rounded operands as the plain version or
# nearer (at d 512 further on 51 of 200 seeds, its dh or dW more than
# 1e-4 from float64 on 14 seeds, the plain version's on 14) and bitwise
# across processes; it lies from the plain version at most 1.50e-3 max
# abs (d 128; d 512 7.72e-4) and 2.49e-4 Frobenius, the f32 instantiation
# at least 2.54e-3 and 2.20e-3 (d 40).  The limits sit between.  5e-5,
# drawn from one seed, failed on 42 of 200 seeds before K5's bf16
# numerics were repaired, and on 21 of 200 after.
BF16_CE_BWD_TOL, BF16_CE_BWD_FRO = 2e-3, 1e-3


def _fro_err(a, b, rows=None):
    """||a - b|| / ||b|| over ``rows`` (a mask of a's leading dims) or all."""
    d, w = a.double() - b.double(), b.double()
    if rows is not None:
        d, w = d[rows], w[rows]
    return float(d.norm()) / max(float(w.norm()), 1e-300)


@pytest.mark.parametrize("d", [40, 128, 512])
def test_spmm_bf16_kernels_match_plain(cuda, d):
    """K1 over A and Aᵀ and K6 (dest, src) in their bf16 instantiations
    against the plain bf16 hop; bitwise across launches; the f32
    instantiation falls outside."""
    share, _ = _graph()
    g = spmm.device_graph(share, cuda)
    n_rows = share.n + 9
    gen = _gen(cuda, d)
    h = torch.randn(n_rows, d, device=cuda, generator=gen)
    flag = (torch.rand(n_rows, device=cuda, generator=gen) < 0.3).to(
        torch.uint8)
    cases = [(lambda bf, graph=graph: spmm_cuda.spmm_csr(graph, h, bf16=bf),
              lambda graph=graph: spmm.spmm_reference(graph, h, bf16=True))
             for graph in (g, g.t)]
    cases += [(lambda bf, m=m, graph=graph: spmm_cuda.spmm_csr_flagged(
                  graph, h, flag, m, bf),
               lambda m=m, graph=graph: spmm.spmm_reference_flagged(
                  graph, h, flag, m, True))
              for m, graph in (("dest", g), ("src", g.t))]
    k0 = spmm_cuda.spmm_csr.launches_bf16
    for run, plain in cases:
        out, ref = run(True), plain()
        torch.cuda.synchronize()
        assert _rel_err(out, ref) <= BF16_SPMM_TOL
        assert _rel_err(run(False), ref) > BF16_SPMM_TOL
        assert torch.equal(out, run(True))
    assert spmm_cuda.spmm_csr.launches_bf16 == k0 + 4


@pytest.mark.parametrize("d,n_head,L,n_layers,B", [
    (40, 1, 15, 2, 37), (128, 2, 30, 1, 21), (512, 4, 15, 1, 9),
    (128, 1, 200, 1, 3), (1024, 8, 15, 1, 3), (256, 2, 15, 1, 9),
    (264, 1, 15, 1, 5), (64, 1, 65, 2, 3), (128, 2, 200, 1, 3),
    (520, 1, 70, 1, 2)])
def test_encoder_bf16_kernels_match_plain(cuda, d, n_head, L, n_layers, B):
    """K2 and K3 in their bf16 instantiations at dropout 0.2 against the
    plain bf16 tower (K3 at K2's branches), relative Frobenius (K2 on the
    rows with an allowed key); K3 bitwise across launches; the f32
    instantiations fall outside.  d 256 runs the GEMMs' 256-column tile,
    d 264 two column blocks of 256 and 8 and a k16 step half zero-filled
    (k % 16 == 8); past L 64 the attention's tensor-core tiles: L 65 a
    one-row last tile, L 200 at head dim 128 and 64, head dim 520 in five
    staged column chunks."""
    from c2dsr_tpu_torch.bench import gates
    p, x, seq = _tower_case(cuda, d, n_head, L, n_layers, B, seed=3)
    kw = dict(idx_pad=999, n_head=n_head, invert_padding_mask=False,
              dropout=0.2, seed=5, tower=1)
    live = (seq != 999).long().cumsum(1) > 0
    acts = encoder_cuda.saved_buffer(x, n_head, n_layers)
    out = encoder_cuda.encoder_fwd(x, seq, p, saved=acts, bf16=True, **kw)
    ref = enc.encoder_fwd_plain(x, seq, p, bf16=True, **kw)
    out32 = encoder_cuda.encoder_fwd(x, seq, p, **kw)
    assert _fro_err(out, ref, live) <= BF16_K2_TOL
    assert _fro_err(out32, ref, live) > BF16_K2_TOL
    gout = torch.randn(x.shape, device=cuda, generator=_gen(cuda, B))
    got = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts, bf16=True,
                                   **kw)
    again = encoder_cuda.encoder_bwd(x, seq, gout, p, saved=acts, bf16=True,
                                     **kw)
    want = enc.encoder_bwd_plain(x, seq, gout, p, bf16=True,
                                 branches=gates.k2_branches(
                                     acts, x.shape, n_head, n_layers, 1),
                                 **kw)
    got32 = encoder_cuda.encoder_bwd(x, seq, gout, p, **kw)
    torch.cuda.synchronize()
    flat, flat_want = [got[0]] + got[1], [want[0]] + want[1]
    assert max(_fro_err(a, b) for a, b in zip(flat, flat_want)) <= BF16_K3_TOL
    assert max(_fro_err(a, b) for a, b in
               zip([got32[0]] + got32[1], flat_want)) > BF16_K3_TOL
    assert all(torch.equal(a, b) for a, b in zip(flat, [again[0]] + again[1]))


@pytest.mark.parametrize("d,n_head,L,B", [(40, 1, 15, 13), (128, 2, 30, 7),
                                          (264, 1, 15, 5)])
def test_encoder_bf16_rounds_each_weight_once(cuda, d, n_head, L, B):
    """The bf16 instantiations multiply by the bf16 copy each call makes of
    its four weight stacks: given those weights already rounded to bf16
    (biases and LayerNorm parameters as they were), K2's output and saved
    activations and K3's dx and gradients are bitwise those of the f32
    weights, so the copy rounds as ``ops/bf16.round_bf16`` (to nearest
    even) and no product reads the f32 weights."""
    from c2dsr_tpu_torch.ops.bf16 import round_bf16
    p, x, seq = _tower_case(cuda, d, n_head, L, 2, B, seed=4)
    rounded = {k: round_bf16(v) if k in ("w_qkv", "w_out", "w_ff1", "w_ff2")
               else v for k, v in p["layers"].items()}
    p16 = dict(p, layers=rounded)
    assert any(not torch.equal(p["layers"][k], rounded[k]) for k in rounded)
    kw = dict(idx_pad=999, n_head=n_head, invert_padding_mask=False,
              dropout=0.2, seed=6, tower=2, bf16=True)
    gout = torch.randn(x.shape, device=cuda, generator=_gen(cuda, B))
    runs = []
    for params in (p, p16):
        # zeroed: the layout's alignment gaps are never written
        acts = encoder_cuda.saved_buffer(x, n_head, 2).zero_()
        out = encoder_cuda.encoder_fwd(x, seq, params, saved=acts, **kw)
        dx, grads = encoder_cuda.encoder_bwd(x, seq, gout, params,
                                             saved=acts, **kw)
        runs.append([out, acts, dx] + list(grads))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("d", [40, 128, 256, 264, 512, 1024])
def test_ce_bf16_kernels_match_plain(cuda, d):
    """K4 and K5 in their bf16 instantiations, on a bf16 W and on an f32 W
    rounded in the pre-pass (the same bits; dW in W's dtype), against the
    plain bf16 CE; bitwise across launches; the f32 instantiations fall
    outside.  d 256 is the resident kernels' widest (Y tiles of one k16
    step), d 264 K4's wide kernel at its narrowest."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    N, V, n_real = 300, 1028, 1000
    h, w, bm, pad, tgt = _ce_case(cuda, N, d, V, n_real, seed=d)
    wb = w.to(torch.bfloat16)
    lse, tlog = fused_ce_cuda.ce_fwd(h, wb, bm, pad, tgt)
    rlse, rtlog = fused_ce.ce_fwd_plain(h, wb, bm, pad, tgt)
    assert _rel_err(lse, rlse) <= BF16_CE_TOL
    assert _rel_err(tlog, rtlog) <= BF16_CE_TOL
    assert _rel_err(fused_ce_cuda.ce_fwd(h, w, bm, pad, tgt)[0],
                    rlse) > BF16_CE_TOL
    via_f32 = fused_ce_cuda.ce_fwd(h, w, bm, pad, tgt, bf16=True)
    assert torch.equal(via_f32[0], lse) and torch.equal(via_f32[1], tlog)
    real = (tgt != n_real).float()
    gen = _gen(cuda, d)
    dlse = torch.randn(N, device=cuda, generator=gen) * real
    dt = torch.randn(N, device=cuda, generator=gen) * real
    got = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt, bf16=True)
    want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt, bf16=True)
    got32 = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt)
    on_bf16 = fused_ce_cuda.ce_bwd(h, wb, bm, lse, dlse, dt, tgt)
    torch.cuda.synchronize()
    assert max(_rel_err(a, b) for a, b in zip(got, want)) <= BF16_CE_BWD_TOL
    assert max(_rel_err(a, b) for a, b in zip(got32, want)) > BF16_CE_BWD_TOL
    assert max(_fro_err(a, b) for a, b in zip(got, want)) <= BF16_CE_BWD_FRO
    assert max(_fro_err(a, b) for a, b in zip(got32, want)) > BF16_CE_BWD_FRO
    again = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt, bf16=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert on_bf16[1].dtype == torch.bfloat16
    assert torch.equal(on_bf16[1], got[1].to(torch.bfloat16))
    assert torch.equal(on_bf16[0], got[0]) and torch.equal(on_bf16[2], got[2])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d", [264, 520, 1024])
def test_ce_bwd_cluster_kernels_match_plain(cuda, d, bf16):
    """K5 past d 256 runs its cluster kernels (``csrc/ce_cluster.cu``: two,
    three and four blocks a cluster, slices of 136 + 128, 176 + 176 + 168
    and 4 x 256 columns): f32 within 2e-5 of the plain version, relative,
    and its dW within 1e-5 of float64; bf16 within BF16_CE_BWD_TOL /
    BF16_CE_BWD_FRO of the plain bf16 CE; bitwise across two launches;
    counted in ``launches_cluster`` (``launches_cluster_bf16``)."""
    from c2dsr_tpu_torch.ops import fused_ce, fused_ce_cuda
    N, V, n_real = 300, 1028, 1000
    h, w, bm, pad, tgt = _ce_case(cuda, N, d, V, n_real, seed=d + bf16)
    lse, _ = fused_ce_cuda.ce_fwd(h, w, bm, pad, tgt, bf16=bf16)
    real = (tgt != n_real).float()
    gen = _gen(cuda, d)
    dlse = torch.randn(N, device=cuda, generator=gen) * real / N
    dt = torch.randn(N, device=cuda, generator=gen) * real / N
    counter = "launches_cluster_bf16" if bf16 else "launches_cluster"
    n0 = getattr(fused_ce_cuda.ce_bwd, counter)
    got = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt, bf16=bf16)
    again = fused_ce_cuda.ce_bwd(h, w, bm, lse, dlse, dt, tgt, bf16=bf16)
    want = fused_ce.ce_bwd_plain(h, w, bm, lse, dlse, dt, tgt, bf16=bf16)
    torch.cuda.synchronize()
    assert getattr(fused_ce_cuda.ce_bwd, counter) == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.isfinite(a).all() for a in got)
    if bf16:
        assert max(_rel_err(a, b) for a, b in zip(got, want)) \
            <= BF16_CE_BWD_TOL
        assert max(_fro_err(a, b) for a, b in zip(got, want)) \
            <= BF16_CE_BWD_FRO
        return
    for name, g, r in zip(("dh", "dw", "db"), got, want):
        assert _rel_err(g, r) <= 2e-5, (name, _rel_err(g, r))
    dw64 = fused_ce.ce_bwd_plain(h.double(), w.double(), bm.double(),
                                 lse.double(), dlse.double(), dt.double(),
                                 tgt)[1]
    assert _rel_err(got[1].double(), dw64) <= 1e-5


def test_ce_bwd_cluster_refuses_a_plan_it_cannot_launch(cuda, monkeypatch):
    """The cluster entries refuse a plan they cannot launch (one block a
    cluster, or slices that do not cover d), and the wrapper raises: no
    fallback to another kernel or to the plain version."""
    from c2dsr_tpu_torch.ops import fused_ce_cuda
    N, d, V = 64, 512, 1028
    h, w, bm, pad, tgt = _ce_case(cuda, N, d, V, 1000, seed=1)
    z = torch.zeros(N, device=cuda)
    t32 = tgt.to(torch.int32)
    out = (torch.empty_like(h), torch.empty_like(w), torch.empty_like(bm))
    for bad in ((1, 512), (2, 248), (9, 64)):
        assert fused_ce_cuda._bwd_f32("ce_bwd_cluster_f32", (1, 1), h, w, bm,
                                      z, z, z, t32, *out, bad) != 0, bad
    good = fused_ce_cuda.plan_cluster(N, d, V, False)
    monkeypatch.setattr(fused_ce_cuda, "plan_cluster",
                        lambda *a: dataclasses.replace(good, c=1))
    with pytest.raises(RuntimeError, match="ce_bwd_cluster_f32"):
        fused_ce_cuda.ce_bwd(h, w, bm, z, z, z, tgt)


def test_bf16_train_step_on_card_matches_cpu(cuda):
    """One train step's loss and every gradient with both dtypes bf16,
    dropout 0, on the card against the CPU's plain bf16 versions: loss
    1e-5 relative, gradients 1e-2 relative Frobenius (bf16 rounding flips
    between two summation orders, chip_smoke.py STEP_BF16_GRAD_TOL); only
    the bf16 instantiations launch."""
    from c2dsr_tpu_torch.ops import fused_ce_cuda
    from c2dsr_tpu_torch.train import step
    cfg = Config(d_latent=128, batch_size=32, len_rec=5, dropout_gnn=0.0,
                 dropout_attn=0.0, vocab_pad_multiple=64,
                 compute_dtype="bfloat16", classifier_dtype="bfloat16")
    share, specific = _graph()
    train = preprocess.preprocess_train(
        synthetic.generate_sequences(SPEC, 400, seed=3), SPEC, seed=1)
    batch = {k: v[:32] for k, v in train.items()}
    init = params_mod.params_to_numpy(params_mod.init_params(
        cfg, SPEC, torch.Generator().manual_seed(0), "cpu"))
    wrappers = (spmm_cuda.spmm_csr, encoder_cuda.encoder_fwd,
                encoder_cuda.encoder_bwd, fused_ce_cuda.ce_fwd,
                fused_ce_cuda.ce_bwd)
    before = [(f.launches, f.launches_bf16) for f in wrappers]
    out = {}
    for dev in ("cpu", cuda):
        params = params_mod.params_from_numpy(init, dev)
        leaves = step.param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        graphs = c2dsr.Graphs(spmm.device_graph(share, dev),
                              spmm.device_graph(specific, dev))
        loss, _ = step.loss_fn(params, graphs, ranker.to_device(batch, dev),
                               None, cfg, SPEC)
        loss.backward()
        out[str(dev)] = (float(loss), [t.grad.cpu() for t in leaves])
    for f, (f32, bf) in zip(wrappers, before):
        assert f.launches == f32 and f.launches_bf16 > bf
    (loss_k, g_k), (loss_c, g_c) = out["cuda"], out["cpu"]
    assert abs(loss_k - loss_c) <= 1e-5 * abs(loss_c)
    for a, c in zip(g_k, g_c):
        assert _fro_err(a, c) <= 1e-2


# ---- the captured step and rank step (CUDA graphs) -------------------------

def test_dropout_hash_reads_a_device_seed(cuda):
    """The kernels read the seed from device memory: a 0-d int32 tensor
    gives the int seed's bits, the reference's, seeds past 2^31 too."""
    from c2dsr_tpu_torch.ops import dropout as drop
    for seed in (7, 2 ** 31 - 1, 2 ** 32 - 5):
        t = drop.seed_tensor(seed, cuda)
        got = encoder_cuda.dropout_bits(t, 1, 2, 1, 300).cpu()
        assert torch.equal(got, encoder_cuda.dropout_bits(seed, 1, 2, 1,
                                                          300).cpu())
        assert got.tolist() == [drop.bits_reference(seed, 1, 2, 1, i)
                                for i in range(300)]


def _opt_tensors(state):
    """Every tensor of an optimizer state: the moments, the max of the
    second moment and the step count of each leaf, in leaf order."""
    adamw = state.opt_state.adamw
    return [adamw.state[p][k] for p in state.opt_state.leaves
            for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq", "step")]


@pytest.mark.parametrize("sparse,bf16", [(False, False), (True, False),
                                         (False, True)])
def test_captured_step_is_the_eager_step_bitwise(cuda, sparse, bf16):
    """Four steps at dropout 0.2 (towers and GNN), the full batch and the
    ragged one in turn, so that each is run eagerly once and then captured:
    the captured program's params, optimizer state and aux are the eager
    program's bit for bit, and each replay counts its kernels' launches."""
    from c2dsr_tpu_torch.ops import fused_ce_cuda
    from c2dsr_tpu_torch.train import optim, step
    cfg = Config(d_latent=64, batch_size=32, len_rec=5, vocab_pad_multiple=64,
                 batch_sparse_gnn=sparse,
                 compute_dtype="bfloat16" if bf16 else "float32")
    share, specific = _graph()
    train = preprocess.preprocess_train(
        synthetic.generate_sequences(SPEC, 400, seed=3), SPEC, seed=1)
    sizes = (32, 20, 32, 20)
    init = params_mod.params_to_numpy(params_mod.init_params(
        cfg, SPEC, torch.Generator().manual_seed(0), "cpu"))
    graphs = c2dsr.Graphs(spmm.device_graph(share, cuda),
                          spmm.device_graph(specific, cuda))
    runs = {}
    for capture in (False, True):
        params = params_mod.params_from_numpy(init, cuda)
        opt = optim.make_optimizer(cfg, steps_per_epoch=2)
        state = step.init_state(params, opt)
        fn = step.make_train_step(cfg, SPEC, graphs, opt, cuda,
                                  capture=capture)
        auxes, at = [], 0
        before = fused_ce_cuda.ce_bwd.launches_bf16 + \
            fused_ce_cuda.ce_bwd.launches
        for n in sizes:
            batch = {k: v[at:at + n] for k, v in train.items()}
            at += n
            state, aux = fn(state, batch)
            auxes.append(torch.stack(list(aux.values())))
        after = fused_ce_cuda.ce_bwd.launches_bf16 + \
            fused_ce_cuda.ce_bwd.launches
        assert after - before == 2 * len(sizes)
        torch.cuda.synchronize()
        runs[capture] = (step.param_leaves(state.params), _opt_tensors(state),
                         auxes, fn)
    assert runs[True][3].program.stats()["graphs"] == 2
    for a, b in zip(runs[False][:3], runs[True][:3]):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["sampled", "full"])
def test_captured_rank_step_gives_the_eager_ranks(cuda, mode):
    """The captured rank_step against the eager one over both domains'
    chunks, the last padded: the same ranks."""
    cfg = Config(d_latent=64, batch_size_eval=64, n_neg_sample=50,
                 vocab_pad_multiple=64)
    share, specific = _graph()
    data = preprocess.preprocess_evaluate(
        synthetic.generate_sequences(SPEC, 300, seed=1), SPEC,
        n_neg_sample=50, seed=2)
    params = params_mod.params_from_numpy(params_mod.params_to_numpy(
        params_mod.init_params(cfg, SPEC, torch.Generator().manual_seed(0),
                               "cpu")), cuda)
    graphs = c2dsr.Graphs(spmm.device_graph(share, cuda),
                          spmm.device_graph(specific, cuda))
    out = {}
    for capture in (False, True):
        conv, rank_step = ranker.make_eval_fns(cfg, SPEC, graphs, cuda,
                                               capture=capture)
        out[capture] = ranker.evaluate_split(params, conv(params), data,
                                             rank_step, cfg, mode)
    assert out[True] == out[False]
    assert rank_step.program.stats()["graphs"] >= 1
