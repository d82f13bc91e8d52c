"""Food-Kitchen-scale synthetic corpus and graphs for the port's bench: the
counterpart of the JAX package's ``bench/fk_graph.py``.

Item counts match the real FK datasets (paper Table 1) and the user count
matches the real train-set size (34,117), so the graphs' density and the
SpMM's cost are those of FK.  Built through the port's own
``data.synthetic``, ``data.preprocess`` and ``graph.build`` from seed 0,
and cached under ``bench_cache/`` (beside the package, git-ignored) with a
``torch_`` prefix, so the two packages' caches never mix.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from c2dsr_tpu_torch.config import DataSpec
from c2dsr_tpu_torch.data import preprocess, synthetic
from c2dsr_tpu_torch.graph import build

N_ITEM_A, N_ITEM_B = 29207, 34886        # Food-Kitchen (paper Table 1)
N_USERS = 34117                          # real FK train-set size
LEN_MAX = 15
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "bench_cache")


def spec(n_item_a: int = N_ITEM_A, n_item_b: int = N_ITEM_B,
         len_max: int = LEN_MAX) -> DataSpec:
    return DataSpec(n_item_a=n_item_a, n_item_b=n_item_b, len_max=len_max)


def _cached(name: str, make, cache: bool) -> Dict[str, np.ndarray]:
    if not cache:
        return make()
    os.makedirs(CACHE, exist_ok=True)
    f = os.path.join(CACHE, name)
    if os.path.exists(f):
        with np.load(f) as z:
            return {k: z[k] for k in z.files}
    out = make()
    tmp = f"{f}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, f)
    return out


def load_train(sp: DataSpec = None, n_users: int = N_USERS,
               cache: bool = True) -> Dict[str, np.ndarray]:
    """The packed train split of ``n_users`` synthetic users (seed 0), as
    the JAX bench builds it."""
    sp = sp or spec()

    def make():
        seqs = synthetic.generate_sequences(sp, n_users, seed=0)
        return preprocess.preprocess_train(seqs, sp, seed=0)

    return _cached(f"torch_train_{n_users}_{sp.n_item}_{sp.len_max}.npz",
                   make, cache)


def load_or_build(sp: DataSpec = None, n_users: int = N_USERS,
                  cache: bool = True) -> Dict[str, np.ndarray]:
    """Both graphs as raw arrays {s_rows, s_cols, s_vals, p_rows, p_cols,
    p_vals, n}."""
    sp = sp or spec()

    def make():
        gs, gp = build.build_graphs(
            synthetic.generate_sequences(sp, n_users, seed=0), sp)
        return {"s_rows": gs.rows, "s_cols": gs.cols, "s_vals": gs.vals,
                "p_rows": gp.rows, "p_cols": gp.cols, "p_vals": gp.vals,
                "n": np.int64(sp.n_item)}

    return _cached(f"torch_graph_{n_users}_{sp.n_item}_{sp.len_max}.npz",
                   make, cache)


def graphs(g: Dict[str, np.ndarray], device):
    """The device graphs (``c2dsr.Graphs``) of :func:`load_or_build`'s
    arrays."""
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.ops import spmm
    n = int(g["n"])
    return c2dsr.Graphs(
        share=spmm.device_graph(build.CooGraph(g["s_rows"], g["s_cols"],
                                               g["s_vals"], n), device),
        specific=spmm.device_graph(build.CooGraph(g["p_rows"], g["p_cols"],
                                                  g["p_vals"], n), device))
