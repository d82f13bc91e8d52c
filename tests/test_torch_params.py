"""The port's parameter init and the JAX pytree converter."""

import math

import jax
import numpy as np
import pytest
import torch

from c2dsr_tpu.config import Config as JConfig, DataSpec as JSpec
from c2dsr_tpu.model import params as jparams
from c2dsr_tpu_torch.config import Config, DataSpec, padded_sizes
from c2dsr_tpu_torch.model import params as params_mod

KW = dict(d_latent=32, n_attn=2, vocab_pad_multiple=64)
SPEC = dict(n_item_a=50, n_item_b=70, len_max=15)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def jax_tree():
    p = jparams.init_params(jax.random.PRNGKey(0), JConfig(**KW),
                            JSpec(**SPEC))
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def port_params():
    return params_mod.init_params(Config(**KW), DataSpec(**SPEC),
                                  torch.Generator().manual_seed(0), "cpu")


def test_numpy_round_trip_is_exact(jax_tree):
    port = params_mod.params_from_numpy(jax_tree, device="cpu")
    back = _flat(params_mod.params_to_numpy(port))
    want = _flat(jax_tree)
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].dtype == np.float32, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    # each layer weight stacked over the tower's layers
    assert port["attn_a"]["layers"]["w_qkv"].shape == (2, 32, 96)
    np.testing.assert_array_equal(port["attn_a"]["layers"]["w_qkv"][1].numpy(),
                                  jax_tree["attn_a"]["layers"][1]["w_qkv"])


def test_init_names_and_shapes_match_jax(jax_tree, port_params):
    want = {k: v.shape for k, v in _flat(jax_tree).items()}
    got = {k: v.shape for k, v in _flat(
        params_mod.params_to_numpy(port_params)).items()}
    assert got == want
    assert all(v.dtype == torch.float32 for v in _flat(port_params).values())
    assert port_params["attn_b"]["layers"]["w_ff1"].shape == (2, 32, 32)


def test_init_padding_is_zero(port_params):
    cfg, spec = Config(**KW), DataSpec(**SPEC)
    n_p, na_p, nb_p = padded_sizes(cfg, spec)
    for name in ("embed_share", "embed_a", "embed_b"):
        t = port_params[name]
        assert t.shape == (n_p, cfg.d_latent)
        assert (t[spec.idx_pad] == 0).all()
        assert (t[spec.n_item:] == 0).all()
        assert (t[:spec.idx_pad].abs().sum(dim=1) > 0).all()
    assert (port_params["cls_a_w"][:, spec.n_item_a:] == 0).all()
    assert (port_params["cls_b_w"][:, spec.n_item_b:] == 0).all()
    assert (port_params["cls_a_b"] == 0).all()
    assert (port_params["cls_b_b"] == 0).all()


def test_init_distributions_match_jax_bounds(jax_tree, port_params):
    """Uniform leaves lie within the JAX init's bound and reach close to it;
    normal leaves have unit scale; constant leaves are equal."""
    d = KW["d_latent"]
    na, nb = SPEC["n_item_a"], SPEC["n_item_b"]
    bounds = {
        "w_qkv": math.sqrt(6.0 / (4 * d)), "w_out": math.sqrt(1.0 / d),
        "w_ff1": math.sqrt(1.0 / d), "w_ff2": math.sqrt(1.0 / d),
        "b_ff1": 1.0 / math.sqrt(d), "b_ff2": 1.0 / math.sqrt(d),
        "cls_a_w": math.sqrt(6.0 / (na + d)),
        "cls_b_w": math.sqrt(6.0 / (nb + d)),
        "cls_pad_w": math.sqrt(6.0 / (1 + d)),
        "D_a_w": math.sqrt(6.0 / (d * d + d)),
        "D_b_w": math.sqrt(6.0 / (d * d + d)),
    }
    jflat = _flat(jax_tree)
    for key, got in _flat(params_mod.params_to_numpy(port_params)).items():
        leaf = key.rsplit("/", 1)[-1]
        ref = jflat[key]
        if leaf in bounds:
            b = bounds[leaf]
            nz = got[got != 0] if leaf.startswith("cls_") else got
            assert np.abs(nz).max() <= b, key
            assert np.abs(nz).max() > 0.8 * b, key
            assert np.abs(ref[ref != 0]).max() <= b, key
        elif leaf in ("pos_emb",) or leaf.startswith("embed"):
            real = got[np.abs(got).sum(axis=-1) > 0]
            assert abs(real.std() - 1.0) < 0.15, key
            assert abs(real.mean()) < 0.15, key
        else:
            np.testing.assert_array_equal(got, ref, err_msg=key)


def test_init_is_seeded(port_params):
    again = params_mod.init_params(Config(**KW), DataSpec(**SPEC),
                                   torch.Generator().manual_seed(0), "cpu")
    other = params_mod.init_params(Config(**KW), DataSpec(**SPEC),
                                   torch.Generator().manual_seed(1), "cpu")
    torch.testing.assert_close(again["embed_a"], port_params["embed_a"],
                               rtol=0, atol=0)
    assert not torch.equal(other["embed_a"], port_params["embed_a"])
