"""K7's order of summation (``csrc/segsum.cu``), emulated in numpy on the
CPU and held bitwise against its plain version, ``segsum_plain`` (CPU
``index_add_``, itself held against ``jax.grad`` of ``jnp.take`` in
``tests/test_torch_lookup.py``).

The emulation follows the kernels step by step: the marks (a gradient row's
id where the row holds a non-zero, sign bits aside, else -1); for a large
table the counts and the lists of ``LIST_CAP`` slots filled in whatever
order the atomics take (a random permutation here, several of them), each
list ranked back into input order by the rows kernel; the heavy rows and
the rows of a small table found in the marks by the scan kernel, tile by
tile of 1,024 marks, each tile's matches placed by an exclusive scan of
its threads' counts, in windows of ``kList`` indices; each chain a float32
sum from +0.0 in that order, zero rows left out.  Bitwise equality shows that
leaving the zero rows out (``-0.0`` entries and all-zero rows included) and
restoring the order from the atomics' slots give ``index_add_``'s bits.
"""

import numpy as np
import pytest
import torch

from c2dsr_tpu_torch.ops import segsum_cuda

SCAN_THREADS = 256      # csrc/segsum.cu kScanThreads
SCAN_LIST = 4096        # csrc/segsum.cu kList


def _marks(ids, g, n_rows):
    live = ((g.view(np.uint32) & 0x7fffffff) != 0).any(1)
    return np.where(live & (ids >= 0) & (ids < n_rows), ids, -1)


def _scan_order(keys, r):
    """The scan kernel's placement of row r's marked rows: tiles of
    SCAN_THREADS int4 keys, int4 t of a tile in thread t, each tile's
    matches placed by an exclusive scan of the threads' counts after the
    tiles before it, in windows of SCAN_LIST."""
    n4 = -(-keys.size // 4)
    padded = np.full(n4 * 4, -1, keys.dtype)
    padded[:keys.size] = keys
    total = int((padded == r).sum())
    order = []
    for base in range(0, max(total, 1), SCAN_LIST):
        window = np.full(min(total - base, SCAN_LIST), -1)
        running = 0
        for q in range(0, n4, SCAN_THREADS):
            tile = padded[4 * q:4 * (q + SCAN_THREADS)].reshape(-1, 4)
            counts = (tile == r).sum(1)
            offs = running + np.concatenate([[0], np.cumsum(counts)[:-1]])
            for t in np.flatnonzero(counts):
                o = offs[t] - base
                for j in np.flatnonzero(tile[t] == r):
                    if 0 <= o < window.size:
                        window[o] = 4 * (q + t) + j
                    o += 1
            running += int(counts.sum())
        assert (window >= 0).all()           # every slot of the window filled
        order += window.tolist()
    return order


def _chain(g, order):
    acc = np.zeros(g.shape[1], np.float32)
    for i in order:
        acc = acc + g[i]
    return acc


def emulate(ids, g, n_rows, rng):
    """K7's result, its sums taken in the kernels' order; also the rows the
    scan kernel took."""
    keys = _marks(ids, g, n_rows)
    out = np.zeros((n_rows, g.shape[1]), np.float32)
    if n_rows <= segsum_cuda.SMALL_ROWS:
        scanned = list(range(n_rows))
    else:
        cap = segsum_cuda.LIST_CAP
        counts = np.zeros(n_rows, np.int64)
        lists = np.full((n_rows, cap), -1)
        scanned = []
        for i in rng.permutation(ids.size):  # the atomics' order: any
            k = keys[i]
            if k < 0:
                continue
            s = counts[k]
            counts[k] += 1
            if s < cap:
                lists[k, s] = i
            elif s == cap:
                scanned.append(k)
        for r in np.flatnonzero((counts > 0) & (counts <= cap)):
            mine = lists[r, :counts[r]]
            ranks = (mine[None, :] < mine[:, None]).sum(1)
            order = np.empty_like(mine)
            order[ranks] = mine
            out[r] = _chain(g, order)
    for r in scanned:
        order = _scan_order(keys, r)
        assert order == np.flatnonzero(keys == r).tolist()
        out[r] = _chain(g, order)
    return out, sorted(int(r) for r in scanned)


def _case(n_rows, n, d, heavy, zero_rows, seed):
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.zipf(1.3, size=n) - 1, n_rows - 1)
    ids[rng.random(n) < heavy] = n_rows - 1
    g = rng.normal(size=(n, d)).astype(np.float32)
    g[rng.random(n) < zero_rows] = 0.0
    g[::7] = -0.0                              # all-(-0.0) rows
    g[1::5, ::3] = -0.0                        # -0.0 entries in live rows
    return ids, g


CASES = [
    # n_rows, n, d, share on the last id, share of zero rows
    (5000, 7680, 16, 0.3, 0.3),                # heavy rows and light lists
    (15, 2304, 8, 0.6, 0.4),                   # a 15-row (positions) table
    (64, 500, 4, 0.0, 0.0),                    # the largest small table
    (65, 500, 4, 0.2, 0.1),                    # the smallest large table
    (300, 1000, 12, 0.0, 0.5),                 # no heavy rows, absent ids
    (40, 200, 5, 0.5, 0.0),                    # d not a multiple of 4
]


@pytest.mark.parametrize("n_rows,n,d,heavy,zero_rows", CASES)
def test_emulated_k7_is_segsum_plain_bitwise(n_rows, n, d, heavy, zero_rows):
    ids, g = _case(n_rows, n, d, heavy, zero_rows, seed=n_rows + n)
    want = segsum_cuda.segsum_plain(torch.from_numpy(ids),
                                    torch.from_numpy(g), n_rows).numpy()
    for perm_seed in range(3):
        got, _ = emulate(ids, g, n_rows, np.random.default_rng(perm_seed))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_emulated_k7_takes_edges_of_the_paths():
    """Rows of exactly LIST_CAP and LIST_CAP + 1 non-zero rows (the last
    light list, the first heavy row), a row whose ids are all zero rows
    (written as zeros, +0.0), empty rows, and a heavy row whose zero rows
    sit between its live ones."""
    cap = segsum_cuda.LIST_CAP
    n_rows, d = 200, 8
    rng = np.random.default_rng(0)
    ids = np.concatenate([np.full(cap, 3), np.full(cap + 1, 7),
                          np.full(50, 9), np.full(3 * cap, 11)])
    ids = ids[rng.permutation(ids.size)]
    g = rng.normal(size=(ids.size, d)).astype(np.float32)
    g[ids == 9] = -0.0
    g[(ids == 11) & (rng.random(ids.size) < 0.5)] = 0.0
    got, scanned = emulate(ids, g, n_rows, rng)
    want = segsum_cuda.segsum_plain(torch.from_numpy(ids),
                                    torch.from_numpy(g), n_rows).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert scanned == [7, 11]
    assert (got[9].view(np.int32) == 0).all()          # +0.0, not -0.0


@pytest.mark.parametrize("n_rows", [15, 300])
def test_emulated_k7_of_a_row_that_holds_every_id(n_rows):
    """Every id on one row, more live rows than the scan kernel's window
    (SCAN_LIST), so its rounds are walked; -0.0 rows among them."""
    n, d = SCAN_LIST + 700, 4
    rng = np.random.default_rng(n_rows)
    ids = np.full(n, n_rows // 2)
    g = rng.normal(size=(n, d)).astype(np.float32)
    g[::9] = -0.0
    got, scanned = emulate(ids, g, n_rows, rng)
    want = segsum_cuda.segsum_plain(torch.from_numpy(ids),
                                    torch.from_numpy(g), n_rows).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert n_rows // 2 in scanned


def test_workspace_layout():
    """What the wrapper hands the kernels: the marks padded to 4 with -1,
    and for a large table zeroed counts and counters, LIST_CAP slots a row,
    room for every possible heavy row, and a touched list of -1 as long as
    the most distinct ids a call can touch."""
    cap = segsum_cuda.LIST_CAP
    cpu = torch.device("cpu")
    keys, counts, lists, heavy, touched, ctr = segsum_cuda.workspace(
        cpu, 0, 1001, 5000)
    assert keys.numel() == 1004 and (keys == -1).all()
    assert keys.dtype == counts.dtype == torch.int32
    assert counts.numel() == 5000 and not counts.any()
    assert lists.numel() == 5000 * cap
    assert heavy.numel() == 1001 // (cap + 1) + 1
    assert touched.numel() == 1001 and (touched == -1).all()
    assert ctr.tolist() == [0, 0, 0, 0]
    assert segsum_cuda.workspace(cpu, 0, 1001, 5000)[0] is keys   # kept
    small = segsum_cuda.workspace(cpu, 0, 1001, segsum_cuda.SMALL_ROWS)
    assert small[1:] == (None,) * 5


def test_longest_chain_counts_live_rows_only():
    ids = torch.tensor([2, 2, 2, 5, 5, 0])
    g = torch.ones(6, 4)
    g[0] = -0.0
    g[1] = 0.0
    assert segsum_cuda.longest_chain(ids, g, 8) == 2     # id 5
    assert segsum_cuda.longest_chain(ids, torch.zeros(6, 4), 8) == 0
