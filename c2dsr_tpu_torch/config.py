"""Typed experiment configuration (the PyTorch port's own copy).

Preserves every hyperparameter of the reference CLI with identical defaults
(reference: main.py:15-66), expressed as a frozen dataclass instead of an
argparse namespace with derived fields stuffed onto it (main.py:69-89).
The fields are the reference's hyperparameters and those build knobs of
``c2dsr_tpu/config.py`` that the port reads, under the same names, so one
set of keyword arguments configures both packages: the mesh among them
(``mesh_data``, ``mesh_model``, ``lookup_mode``, ``c2dsr_tpu/config.py:
109-130``).  The JAX package's TPU-only knobs (kernel backend, PRNG, Pallas
interpreter) have no counterpart: the port picks a kernel by the device of
the tensor it is given (``ops/backend.py``).

Derived fields (item counts, pad index) live in :class:`DataSpec`, produced by
the data layer, so the model/config split is explicit instead of implicit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

MAPPING_DATASET = {
    "fk": "Food-Kitchen",
    "mb": "Movie-Book",
    "ee": "Entertainment-Education",
}

# Paper's C2DSR results (hr5_a, ndcg5_a, hr5_b, ndcg5_b), the denominator of the
# "improvement" model-selection scalar.  Reference: utils/constant.py:13-17.
BENCHMARKS = {
    "fk": [0.1124, 0.0865, 0.0574, 0.0416],
    "mb": [0.0647, 0.0476, 0.0284, 0.0217],
    "ee": [0.6945, 0.5620, 0.7104, 0.5905],
}


@dataclasses.dataclass(frozen=True)
class Config:
    """All experiment hyperparameters (reference defaults, main.py:15-66)."""

    # Experiment
    data: str = "fk"                # fk | mb | ee
    len_rec: int = 10               # loss window over last positions (main.py:21)

    # Data
    use_raw: bool = False
    n_neg_sample: int = 999         # eval negatives (main.py:25)

    # Model
    d_latent: int = 128
    shared_item_embed: bool = False
    d_bias: bool = False            # bias on bilinear discriminators

    # GNN
    n_gnn: int = 1
    dropout_gnn: float = 0.2

    # Transformer
    n_attn: int = 1
    n_head: int = 1
    dropout_attn: float = 0.2
    norm_first: bool = False

    # Optimizer (AdamW amsgrad + StepLR; reference trainer.py:21-23)
    lr: float = 1e-3
    l2: float = 5e-4
    lr_gamma: float = 0.5
    lr_step: int = 10
    max_grad_norm: float = 5.0      # declared but unused in the reference (main.py:54)
    apply_grad_clip: bool = False   # parity default: reference never applies clipping

    # Sequences
    len_max: int = 15               # 30 for ee (main.py:71)
    lambda_loss: float = 0.7

    # Training
    seed: int = 3407
    n_epoch: int = 200
    batch_size: int = 512
    batch_size_eval: int = 2048
    es_patience: int = 10

    # --- Build-only knobs (no reference counterpart) -----------------------
    # Numerics of the products; params stay f32.  "auto" resolves to
    # float32 in the port (use resolved_compute_dtype()): every kernel
    # computes f32-accurate products (3xTF32 on the card).  "bfloat16" is
    # the JAX package's Pallas numerics, its default on the TPU: the tower
    # input is rounded to bf16, and the SpMM, the towers and the CE round
    # both operands of every product to bf16 and accumulate in f32 (on the
    # card K1/K6, K2/K3 and K4/K5 in their bf16 instantiations, on the CPU
    # their plain bf16 versions; ops/bf16.py).  LayerNorm, softmax,
    # dropout and every sum stay f32.  "float64" runs the plain path in
    # float64 (float64 params; a reference for the card's tests).
    compute_dtype: str = "auto"
    # Streaming dtype of the classifier weight at its use sites (CE loss and
    # ranking), as in the JAX package.  "auto" -> float32 in the port.
    # "bfloat16" casts [d, V] to bf16 at each use (the master weight stays
    # f32): the CE kernels read two bytes an element and compute bf16
    # products whatever compute_dtype says, dW comes back rounded to bf16,
    # and ranking scores are f32 sums of bf16-rounded products.
    classifier_dtype: str = "auto"
    # Eval protocol: "sampled" = 999 negatives (reference default),
    # "full" = full-itemset ranking (the headline mode of this framework).
    eval_mode: str = "sampled"
    # Mesh shape, data-parallel x model-parallel, one process (rank) per
    # device: rank r sits at data index r // mesh_model and model index
    # r % mesh_model (parallel/mesh.py).  (1, 1) = one device.
    mesh_data: int = 1
    mesh_model: int = 1
    # Sharded-table tower-lookup strategy (mesh_model > 1 only): "psum" =
    # owner-masked gather + psum; "a2a" = bucket-by-owner all-to-all of the
    # ids split over the model ranks, then an all_gather back.  Both exact
    # (parallel/embed.py).
    lookup_mode: str = "psum"
    # Embedding-table rows and classifier output dims are padded up to this
    # multiple (the JAX package's default, so one set of keyword arguments
    # gives both packages the same shapes).  Padded rows are never indexed;
    # padded logit columns are masked to -inf in ranking.  Must be a
    # multiple of lcm(8, mesh_model), so that the tables and classifiers
    # split evenly over the model ranks.
    vocab_pad_multiple: int = 2048
    # Batch-sparse graph propagation in the TRAIN step: the last hop of each
    # propagation is computed only for the table rows the step reads (the
    # batch's lookup ids), by the flagged SpMM kernel (K6) on the card.  The
    # step reads only those rows and their gradient is zero elsewhere, so
    # every consumed value and every gradient is the dense computation's
    # (c2dsr_tpu/ops/spmm_pallas.make_blocked_spmm_flagged).  Eval always
    # runs dense.  Default off, as in the JAX package.
    batch_sparse_gnn: bool = False
    # Resume from the --ckpt directory if a checkpoint exists there
    # (params + optimizer state + step + best-validation bookkeeping).
    resume: bool = False
    # Write a torch.profiler trace of the first training epoch here.
    profile_dir: Optional[str] = None
    # Debug mode: autograd anomaly detection, and fail fast on a non-finite
    # epoch loss.
    debug_nans: bool = False

    # --- Reference bug-parity switches (SURVEY.md section 2 quirks) --------
    # Quirk 1: reference inverts the key-padding mask (encoders.py:33): real
    # tokens are masked out and pads attended.  Default here: correct masking.
    bug_inverted_padding_mask: bool = False
    # Quirk 2: reference draws domain-B eval negatives from the truncated pool
    # [0, n_item_b - n_item_a) (dataloader.py:222-224).  Default: full pool.
    bug_truncated_b_neg_pool: bool = False
    # Quirk 11: the reference calls optimizer.zero_grad() once per EPOCH
    # (trainer.py:42) while train_batch does backward+step per batch with no
    # per-batch zero (trainer.py:157-158) — so the gradient each step is the
    # RUNNING SUM of every batch gradient so far this epoch.  The published
    # numbers come from those dynamics.  Default: standard fresh grads.
    bug_epoch_grad_accum: bool = False

    def __post_init__(self):
        if self.mesh_data < 1 or self.mesh_model < 1:
            raise ValueError(f"mesh {self.mesh_data}x{self.mesh_model}: "
                             "each axis must be >= 1")
        if self.lookup_mode not in ("psum", "a2a"):
            raise ValueError(f"lookup_mode must be 'psum' or 'a2a', got "
                             f"{self.lookup_mode!r}")
        need = math.lcm(8, self.mesh_model)
        if self.vocab_pad_multiple % need:
            raise ValueError(f"vocab_pad_multiple {self.vocab_pad_multiple} "
                             f"is not a multiple of lcm(8, mesh_model) = "
                             f"{need}")

    @property
    def world_size(self) -> int:
        """The ranks of the mesh: mesh_data * mesh_model."""
        return self.mesh_data * self.mesh_model

    @property
    def dataset(self) -> str:
        return MAPPING_DATASET[self.data]

    @property
    def benchmark(self) -> list:
        return BENCHMARKS[self.data]

    def resolved_len_max(self) -> int:
        return 30 if self.data == "ee" else 15

    def resolved_compute_dtype(self) -> str:
        """'auto' -> float32: the port computes in f32 everywhere (TF32 is
        switched off at its entry points, ops/backend.resolve_device)."""
        if self.compute_dtype != "auto":
            return self.compute_dtype
        return "float32"

    def resolved_classifier_dtype(self) -> str:
        """'auto' -> float32 (see resolved_compute_dtype)."""
        if self.classifier_dtype != "auto":
            return self.classifier_dtype
        return "float32"

    def bf16_products(self) -> bool:
        """Whether the kernels and their plain versions take the JAX
        package's bf16 products (compute_dtype="bfloat16")."""
        return self.resolved_compute_dtype() == "bfloat16"

    def with_(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Derived dataset geometry (reference: dataloader.py:249-252).

    Shared id space: domain A occupies [0, n_item_a), domain B occupies
    [n_item_a, n_item_a + n_item_b); pad id = n_item - 1.
    """

    n_item_a: int
    n_item_b: int
    len_max: int

    @property
    def n_item(self) -> int:
        return self.n_item_a + self.n_item_b + 1  # + pad row

    @property
    def idx_pad(self) -> int:
        return self.n_item - 1


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_sizes(cfg: "Config", spec: DataSpec):
    """(n_item_p, n_item_a_p, n_item_b_p): table rows / classifier output
    dims rounded up to cfg.vocab_pad_multiple.  Padding rows/columns sit at
    the END of each array, beyond every real id, so the shared id space
    (A = [0, na), B = [na, na+nb), pad = n_item-1) is untouched."""
    m = cfg.vocab_pad_multiple
    return (round_up(spec.n_item, m), round_up(spec.n_item_a, m),
            round_up(spec.n_item_b, m))
