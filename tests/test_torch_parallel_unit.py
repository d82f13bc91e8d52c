"""The pieces of the port's ``parallel/`` that need no process group, on
the CPU.

* The towers' dropout row map (``ops/dropout.py``): a rank's rows of a
  site, indexed in the global batch, draw bitwise the global batch's masks
  for those rows, in the [B, L, d] and [B, H, L, L] layouts and in the
  shared tower's stack of three segments; the plain tower with the map
  gives bitwise the one-process tower's rows at dropout 0.2.
* ``parallel/embed.plan_spmm_a2a``, the port's own copy, builds bitwise the
  JAX package's schedule, and its per-rank CSR sums the graph's product.
* ``Config``'s mesh fields, ``mesh.local_batch`` / ``eval_slice`` and the
  sharding rule by name (``param_spec``).
* ``parallel/distributed``: NCCL only where every host has a card for each
  of its ranks (hosts and card counts published in a store), a rank's card
  its index on its host, and the same found by two ranks over an
  ``env://`` rendezvous (the one test here that starts processes).
"""

import numpy as np
import pytest
import torch

from c2dsr_tpu_torch.config import Config
from c2dsr_tpu_torch.ops import dropout as drop


def _masks(shape, rmap, seed=7):
    return drop.bits(drop.global_index(shape, rmap), seed, drop.SITE_PROBS,
                     1, 0)


@pytest.mark.parametrize("shape", [(8, 5, 16), (8, 2, 5, 5)])
@pytest.mark.parametrize("n_data", [2, 4])
def test_a_ranks_rows_draw_the_global_batchs_masks(shape, n_data):
    full = _masks(shape, None)
    m = shape[0] // n_data
    for r in range(n_data):
        rmap = drop.row_map(r * m, m, shape[0])
        got = _masks((m,) + shape[1:], rmap)
        torch.testing.assert_close(got, full[r * m:(r + 1) * m], rtol=0,
                                   atol=0)
    # without the map every rank draws rank 0's masks
    torch.testing.assert_close(_masks((m,) + shape[1:], None), full[:m],
                               rtol=0, atol=0)


def test_the_shared_towers_three_segments_keep_their_stacking():
    B, n_data = 6, 3
    full = _masks((3 * B, 4, 8), None)
    m = B // n_data
    for r in range(n_data):
        got = _masks((3 * m, 4, 8), drop.row_map(r * m, m, B))
        want = torch.cat([full[s * B + r * m:s * B + (r + 1) * m]
                          for s in range(3)])
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_row_map_is_none_for_the_whole_batch_and_checks_its_range():
    assert drop.row_map(0, 8, 8) is None
    assert drop.row_map(4, 4, 8) == (4, 4, 8)
    with pytest.raises(ValueError):
        drop.row_map(6, 4, 8)


def test_plain_tower_with_the_row_map_is_the_global_towers_rows():
    from c2dsr_tpu_torch.model import params as params_mod
    from c2dsr_tpu_torch.ops import encoder as enc
    cfg = Config(d_latent=32, n_head=2)
    p = params_mod.init_encoder_params(torch.Generator().manual_seed(0),
                                       cfg, 6)
    g = torch.Generator().manual_seed(1)
    B, L = 8, 6
    x = torch.randn(B, L, 32, generator=g)
    seq = torch.randint(0, 9, (B, L), generator=g)
    kw = dict(idx_pad=9, n_head=2, invert_padding_mask=False, dropout=0.2,
              seed=11, tower=2)
    full = enc.encoder_fwd_plain(x, seq, p, **kw)
    for r in range(2):
        rows = slice(4 * r, 4 * (r + 1))
        got = enc.encoder_fwd_plain(x[rows], seq[rows], p,
                                    row_map=drop.row_map(4 * r, 4, B), **kw)
        torch.testing.assert_close(got, full[rows], rtol=0, atol=0)
    assert not torch.equal(enc.encoder_fwd_plain(x[4:], seq[4:], p, **kw),
                           full[4:])


def _coo(n, nnz, seed):
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, n, nnz)).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    return rows, cols, rng.normal(size=nnz).astype(np.float32)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_plan_spmm_a2a_is_the_jax_plan(n_shards):
    from c2dsr_tpu.parallel import embed as jembed
    from c2dsr_tpu_torch.parallel import embed
    rows, cols, vals = _coo(64, 300, n_shards)
    got = embed.plan_spmm_a2a(rows, cols, vals, 64, n_shards)
    want = jembed.plan_spmm_a2a(rows, cols, vals, 64, n_shards)
    for name in ("send_idx", "edge_ptr", "edge_dst", "edge_val"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))
    assert got.n_edges.sum() == len(rows)


def test_each_ranks_local_csr_sums_its_rows_of_the_product():
    """Every rank's K1 CSR over the received buffer (plain version here),
    fed the rows its plan sends, gives its rows of adj @ table."""
    from c2dsr_tpu_torch.graph.build import CooGraph
    from c2dsr_tpu_torch.ops import spmm
    M, n = 4, 64
    rows, cols, vals = _coo(n, 300, 9)
    g = spmm.device_graph(CooGraph(rows, cols, vals, n), "cpu")
    table = torch.randn(n, 8, generator=torch.Generator().manual_seed(2))
    want = spmm.spmm_reference(g, table)
    S = n // M
    plans = [spmm.attach_a2a_plan(g, n, M, i).a2a for i in range(M)]
    for s in range(M):            # rank s receives from every rank t
        buf = torch.cat([table[t * S:(t + 1) * S][plans[t].send_idx[s]]
                         for t in range(M)])
        got = spmm.rect_spmm(plans[s].csr, buf)
        torch.testing.assert_close(got, want[s * S:(s + 1) * S], rtol=0,
                                   atol=1e-5)


def test_config_takes_the_mesh_and_checks_it():
    cfg = Config(mesh_data=2, mesh_model=4, lookup_mode="a2a")
    assert cfg.world_size == 8
    with pytest.raises(ValueError, match="lookup_mode"):
        Config(lookup_mode="ring")
    with pytest.raises(ValueError, match="lcm"):
        Config(mesh_model=16, vocab_pad_multiple=8)
    with pytest.raises(ValueError, match=">= 1"):
        Config(mesh_data=0)
    Config(mesh_model=3, vocab_pad_multiple=24)


def _mesh(n_data, index):
    from c2dsr_tpu_torch.parallel import comm, mesh as mesh_mod
    return mesh_mod.Mesh(n_data, 1, index, comm.Group(None, n_data, index),
                         comm.SELF)


def test_local_batch_pads_with_invalid_rows_and_eval_slice_repeats():
    from c2dsr_tpu_torch.parallel import mesh as mesh_mod
    batch = {"seq_share": np.arange(7)[:, None] * np.ones((1, 3), int)}
    parts = [mesh_mod.local_batch(batch, _mesh(2, i)) for i in range(2)]
    assert [p["seq_share"].shape[0] for p in parts] == [4, 4]
    np.testing.assert_array_equal(
        np.concatenate([p["valid"] for p in parts]), [1] * 7 + [0])
    evs = [mesh_mod.eval_slice(batch, _mesh(2, i)) for i in range(2)]
    np.testing.assert_array_equal(
        np.concatenate([e["seq_share"][:, 0] for e in evs]),
        [0, 1, 2, 3, 4, 5, 6, 6])
    assert "valid" not in evs[0]


def test_sharding_rule_is_the_jax_param_spec():
    from jax.sharding import PartitionSpec as P
    from c2dsr_tpu.parallel import mesh as jmesh
    from c2dsr_tpu_torch.parallel import mesh as mesh_mod
    for name in ("embed_share", "embed_a", "embed_b", "cls_a_w", "cls_b_w",
                 "cls_a_b", "cls_b_b", "cls_pad_w", "cls_pad_b", "attn_a",
                 "D_a_w"):
        spec = jmesh.param_spec(name)
        dim = mesh_mod.shard_dim(name)
        if spec == P():
            assert dim is None, name
        else:
            assert spec[dim] == "model", name


# --- the backend and the card of a rank (parallel/distributed.py) ---------------

def _layout(hosts, cards, rank):
    """host_layout of ``rank`` once every rank has published its host and
    card count in one store."""
    import torch.distributed as dist
    from c2dsr_tpu_torch.parallel import distributed
    store = dist.HashStore()
    for r, h in enumerate(hosts):
        store.set(f"host/{r}", f"{cards[h]} {h}")
    return distributed.host_layout(store, rank, len(hosts), hosts[rank],
                                   cards[hosts[rank]])


@pytest.mark.parametrize("hosts, cards, rank, want", [
    # one host, a card a rank: NCCL
    ("aaaa", {"a": 4}, 2, (2, 4, True)),
    # two hosts of four cards, eight ranks: NCCL, the card of the local index
    ("aaaabbbb", {"a": 4, "b": 4}, 5, (1, 4, True)),
    # four ranks sharing one card: gloo
    ("aaaa", {"a": 1}, 3, (3, 4, False)),
    # one host short of cards: gloo on every host, the other one too
    ("aaaabbbb", {"a": 4, "b": 2}, 1, (1, 4, False)),
    # ranks on the CPU: no card
    ("aa", {"a": 0}, 0, (0, 2, False)),
])
def test_the_backend_is_nccl_only_where_every_host_has_a_card_a_rank(
        hosts, cards, rank, want):
    assert _layout(hosts, cards, rank) == want


def _env_entry(rank, world, port, results):
    import datetime
    import os
    import torch.distributed as dist
    from c2dsr_tpu_torch.parallel import distributed
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world))
    try:
        # "cuda" on a host without a card: more ranks than cards, so gloo
        distributed.initialize(device="cuda",
                               timeout=datetime.timedelta(seconds=60))
        results.put((rank, dist.get_backend(), distributed._local,
                     distributed.process_count(),
                     distributed.process_index()))
    finally:
        distributed.shutdown()


def test_initialize_over_env_rendezvous_finds_the_hosts_ranks():
    """``env://`` (as torchrun sets it, the CLI's --distributed): the ranks
    learn their host's rank count from the rendezvous and take gloo where
    the host has fewer cards than ranks."""
    import torch.multiprocessing as mp
    from c2dsr_tpu_torch.parallel import launch
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = launch.free_port()
    procs = [ctx.Process(target=_env_entry, args=(r, 2, port, results),
                         daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = sorted(results.get(timeout=90) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    assert got == [(0, "gloo", (0, 2), 2, 0), (1, "gloo", (1, 2), 2, 1)]
