"""Parameters of the C2DSR model: initialisation and conversion.

Same names, shapes (padding included) and distributions as
``c2dsr_tpu/model/params.py`` (reference models/C2DSR.py:20-56, torch
defaults for nn.Embedding / nn.Linear / nn.MultiheadAttention):

* item embedding tables: N(0, 1), pad row zero; rows past ``n_item`` up to
  ``config.padded_sizes`` are zero.
* positional embedding: N(0, 1).
* attention in-proj: xavier-uniform over the combined (3d, d) matrix, zero
  bias; out-proj and FFN linears: U(+-sqrt(1/fan_in)) weights, FFN biases
  U(+-1/sqrt(fan_in)), out-proj bias zero.
* classifiers: xavier-uniform weights over the real columns, zero padded
  columns, zero bias.
* bilinear discriminators: xavier-uniform with torch's 3D fan (fan_in = d*d,
  fan_out = d), optional zero bias.

Parameters are plain nested dicts of tensors in the JAX layout (``x @ w``
with w [d_in, d_out]), so ``params_from_numpy`` takes a JAX initialisation
converted to numpy and both packages run from the same numbers.  One
difference: the JAX tree keeps a tower's layers as a list of dicts, the
port keeps each layer weight stacked over layers (``layers["w_qkv"]`` is
[n_attn, d, 3d]), so the fused encoder kernel reads a tower's weights in
place.  ``params_to_numpy`` gives the JAX tree back.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from c2dsr_tpu_torch.config import Config, DataSpec, padded_sizes
from c2dsr_tpu_torch.ops import backend
from c2dsr_tpu_torch.parallel import mesh as mesh_mod


def _uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=g.device)
    return t.uniform_(-bound, bound, generator=g)


def _normal(g: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, dtype=torch.float32, device=g.device,
                       generator=g)


def _zeros(shape, g: torch.Generator) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=g.device)


def init_encoder_params(g: torch.Generator, cfg: Config, len_max: int
                        ) -> Dict[str, Any]:
    d = cfg.d_latent
    xavier_qkv = math.sqrt(6.0 / (3 * d + d))
    lin_w = math.sqrt(1.0 / d)        # kaiming-uniform a=sqrt(5), fan_in=d
    lin_b = 1.0 / math.sqrt(d)
    pos_emb = _normal(g, (len_max, d))
    layers = []
    for _ in range(cfg.n_attn):
        layers.append({
            "w_qkv": _uniform(g, (d, 3 * d), xavier_qkv),
            "b_qkv": _zeros((3 * d,), g),
            "w_out": _uniform(g, (d, d), lin_w),
            "b_out": _zeros((d,), g),
            "w_ff1": _uniform(g, (d, d), lin_w),
            "b_ff1": _uniform(g, (d,), lin_b),
            "w_ff2": _uniform(g, (d, d), lin_w),
            "b_ff2": _uniform(g, (d,), lin_b),
            "ln1_scale": torch.ones((d,), device=g.device),
            "ln1_bias": _zeros((d,), g),
            "ln2_scale": torch.ones((d,), device=g.device),
            "ln2_bias": _zeros((d,), g),
        })
    return {"pos_emb": pos_emb, "layers": _stack(layers),
            "lnf_scale": torch.ones((d,), device=g.device),
            "lnf_bias": _zeros((d,), g)}


def init_params(cfg: Config, spec: DataSpec, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """A fresh initialisation drawn from ``generator`` (on its own device),
    placed on ``device``."""
    return init_params_sharded(cfg, spec, generator, None, device)


def init_params_sharded(cfg: Config, spec: DataSpec,
                        generator: torch.Generator, mesh, device="cuda"
                        ) -> Dict[str, Any]:
    """This rank's shard of :func:`init_params` (``mesh``: a
    ``parallel/mesh.Mesh``, or None for the whole tree), bitwise
    ``shard_params(init_params(...))``, with no full table drawn: the
    counterpart of ``c2dsr_tpu/model/params.py:115-130``, where one full f32
    table of the 10M-row configuration is ~20 GB.

    Every leaf reads the generator's stream in the same order and the same
    pieces whatever the mesh; ``parallel/mesh`` says which leaves are
    sharded, along which dim and over which block, and the rest is drawn
    whole.  A table's N(0, 1) rows are drawn in chunks of a whole number of
    16-element blocks (torch's CPU ``randn`` fills blocks of 16 and redraws
    a ragged tail, so such chunks give one whole draw's values), the rows
    outside the rank's block discarded chunk by chunk; a classifier's
    [d, n_real] uniform draw one d-row at a time.  The host holds one chunk
    beside the shard, the card the shard alone."""
    device = backend.resolve_device(device)
    return _map(lambda t: t.to(device), _draw(cfg, spec, generator, mesh))


CHUNK_ELEMS = 1 << 20    # a table's rows drawn at a time, in elements at most


def _normal_rows(g: torch.Generator, n: int, d: int, lo: int, hi: int,
                 out: torch.Tensor) -> None:
    """Rows [lo, hi) of an (n, d) N(0, 1) draw from ``g`` into ``out[:k]``
    (k of them fall below n), reading the whole draw from the stream in
    chunks of whole 16-element blocks."""
    step = 16 // math.gcd(d, 16)               # rows of a whole block
    rows = step * max(1, CHUNK_ELEMS // (step * d))
    ends = list(range(rows, n - rows + 1, rows)) + [n] if n > rows else [n]
    start = 0
    for end in ends:
        chunk = _normal(g, (end - start, d))
        a, b = max(start, lo), min(end, hi)
        if a < b:
            out[a - lo:b - lo] = chunk[a - start:b - start]
        start = end


def _draw(cfg: Config, spec: DataSpec, g: torch.Generator, mesh
          ) -> Dict[str, Any]:
    """The parameter tree, or model rank ``mesh.model_index``'s shard of
    it, on the generator's device."""
    d = cfg.d_latent
    na, nb = spec.n_item_a, spec.n_item_b
    n_p, na_p, nb_p = padded_sizes(cfg, spec)
    drawn_local = set()

    def span(name, dim, n):
        """This rank's [lo, hi) of dim ``dim`` (size n) of leaf ``name``."""
        if mesh_mod.shard_dim(name) != dim:
            return 0, n
        drawn_local.add(name)
        return mesh_mod.shard_range(n, mesh)

    def embed_table(name):
        lo, hi = span(name, 0, n_p)
        t = _zeros((hi - lo, d), g)
        _normal_rows(g, spec.n_item, d, lo, hi, t)
        if lo <= spec.idx_pad < hi:
            t[spec.idx_pad - lo] = 0.0
        return t

    def cls(name, n_real, n_pad):
        lo, hi = span(name, 1, n_pad)
        w = _zeros((d, hi - lo), g)
        bound = math.sqrt(6.0 / (n_real + d))
        keep = max(0, min(hi, n_real) - lo)
        for k in range(d):
            row = _uniform(g, (n_real,), bound)
            w[k, :keep] = row[lo:lo + keep]
        return w

    def bias(name, n_pad):
        lo, hi = span(name, 0, n_pad)
        return _zeros((hi - lo,), g)

    params: Dict[str, Any] = {
        "embed_share": embed_table("embed_share"),
        "attn_share": init_encoder_params(g, cfg, spec.len_max),
        "attn_a": init_encoder_params(g, cfg, spec.len_max),
        "attn_b": init_encoder_params(g, cfg, spec.len_max),
        "cls_a_w": cls("cls_a_w", na, na_p),
        "cls_a_b": bias("cls_a_b", na_p),
        "cls_b_w": cls("cls_b_w", nb, nb_p),
        "cls_b_b": bias("cls_b_b", nb_p),
        "cls_pad_w": _uniform(g, (d, 1), math.sqrt(6.0 / (1 + d))),
        "cls_pad_b": _zeros((1,), g),
        # torch Bilinear(1, d, d): fan_in = d*d, fan_out = 1*d
        "D_a_w": _uniform(g, (d, d), math.sqrt(6.0 / (d * d + d))),
        "D_b_w": _uniform(g, (d, d), math.sqrt(6.0 / (d * d + d))),
    }
    if not cfg.shared_item_embed:
        params["embed_a"] = embed_table("embed_a")
        params["embed_b"] = embed_table("embed_b")
    if cfg.d_bias:
        params["D_a_b"] = _zeros((1,), g)
        params["D_b_b"] = _zeros((1,), g)
    if mesh is not None:
        # a leaf that the mesh shards and that was drawn whole is cut here
        for name, t in params.items():
            dim = mesh_mod.shard_dim(name)
            if dim is not None and name not in drawn_local:
                params[name] = mesh_mod.shard_tensor(t, dim, mesh)
    return params


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _stack(layers):
    """A tower's layers, a list of dicts, as one dict of [n_layers, ...]
    tensors."""
    return {k: torch.stack([layer[k] for layer in layers]) for k in layers[0]}


def _restack(tree, fn):
    """``tree`` with ``fn`` applied to the value of every "layers" key."""
    if isinstance(tree, dict):
        return {k: fn(v) if k == "layers" else _restack(v, fn)
                for k, v in tree.items()}
    return tree


def params_from_numpy(tree, device="cuda") -> Dict[str, Any]:
    """A parameter tree of numpy arrays (nested dicts and lists, as
    ``jax.tree.map(np.asarray, params)`` gives for the JAX package's params)
    -> the port's tensors on ``device``, values unchanged, each tower's
    layers stacked."""
    device = backend.resolve_device(device)
    tensors = _map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)
    return _map(lambda t: t.to(device), _restack(tensors, _stack))


def params_to_numpy(params) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: the JAX package's tree."""
    def unstack(layers):
        n = next(iter(layers.values())).shape[0]
        return [{k: v[i] for k, v in layers.items()} for i in range(n)]
    return _map(lambda t: t.detach().cpu().numpy(), _restack(params, unstack))

