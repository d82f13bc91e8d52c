"""Wrappers of the fused CE kernels (``csrc/ce.cu``, ``csrc/ce_onepass.cu``,
``csrc/ce_cluster.cu``): K4 :func:`ce_fwd` and K5 :func:`ce_bwd` (in f32 up
to d 128 one pass over the logit tiles, elsewhere a dh kernel and a dW/db
kernel).

Replace the fused linear + softmax CE Pallas kernels of the JAX package
(``c2dsr_tpu/ops/fused_ce.py``: ``_fwd_kernel`` for the forward;
``_bwd_merged_kernel``, ``_bwd_dh_kernel`` and ``_bwd_dw_kernel`` for the
backward, whose split the TPU needed only when dh outgrew VMEM).

What bounds them on an H100: operations, which both run on the tensor
cores with products at f32 accuracy (3xTF32: each operand split into a
TF32 part and its remainder, three products a step, 165 TFLOP/s at most).
The tensor cores' accumulator truncates its adds, so no long sum stays in
it: each k-step of a logit is added in f32, and the backward's products sum
at most 2,560 vocab columns (dh) or 1,280 rows (dW) a split there, the
splits added in f32 (tests/test_torch_tf32.py emulates the error of each
scheme).  The forward does 2·N·V·d FLOPs: h stays resident, tiles of Wᵀ
(split once by a pre-pass) stream through a ``cp.async`` ring, and each
warp keeps a running (max, sum-exp) per row over one of a few vocab
splits; a small kernel merges the splits in order.  Above d 256 K4 runs its
wide kernel, which streams h and Wᵀ in chunks of 32 columns.

The backward's design follows d and the dtype (:func:`bwd_route`).  In f32
up to d 128 (FK's width) it is one pass (``ce_onepass.cu``, 6·N·V·d FLOPs):
each logit tile computed once for dh, dW and db, dh kept in registers over
a vocab split, dW written as a partial a block of 256 rows
(:func:`onepass_plan`; past ONEPASS_PARTIAL_BYTES of them the pair runs).
Elsewhere it takes two kernels of 4·N·V·d FLOPs each (the logits, then one
product) over (resident, streamed) operands, h and Wᵀ for dh, Wᵀ and h for
dW; the vocab or row splits of every grid are summed in order by a small
kernel: up to d 256 (bf16 from d 8) the narrow kernels of ``ce.cu`` (the
whole row of h resident); up to 2,048 the cluster kernels of
``ce_cluster.cu``, a thread-block cluster of c = ceil(d / 256) blocks,
each with a slice of d, whose partial logits meet in distributed shared
memory, added in rank order, so each logit is computed once (where
``ce.cu``'s wide kernels recomputed them for each 256 output columns),
bound by operations: the tensor cores' 3xTF32 rate (165 TFLOP/s) in f32,
their bf16 rate (989 TFLOP/s, m16n8k16 MMAs) in bf16.  Past 2,048
``ce.cu``'s wide kernels.  Every plan is made here, the kernels' split
counts (:func:`plan_fwd`, :func:`plan_bwd`) and the cluster's slices
(:func:`cluster_plan`), by one cost model (:func:`best_splits`) from the
blocks or clusters the card holds at once, which the C side reports; a
plan the card cannot launch raises.
No logit reaches device memory, and each output element is written once,
with no atomics, for any N: the results are bitwise repeatable.  Shapes:
d % 8 == 0, V % 4 == 0, W under 2 GiB (d·V·4 < 2^31, or d·V·2 in the bf16
instantiations: the JAX package's limit).

``bf16=True`` (``compute_dtype="bfloat16"``, and always for a bf16 W)
selects the bf16 instantiations, the JAX kernels' numerics: every product
of bf16-rounded operands (h, W and the dlogits) summed in f32, on the bf16
tensor cores (``mma.sync.m16n8k16`` bf16, operands read by ``ldmatrix``)
in every design.  A pre-pass writes h and Wᵀ in bf16 (W read once, at two
bytes an element where it is bf16), and the kernels stage the bf16 rows.
Their launches count apart (``launches_bf16``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from c2dsr_tpu_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _fn(name: str, n_ptr: int, n_int: int = 4, lib: str = "ce"):
    f = getattr(build.library(lib), name)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes (the
    kernels' 16-byte asynchronous copies need that)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


D_MULTIPLE = 8       # the widths the kernels take (ops/fused_ce pads to it)
RESIDENT = 256       # the widest d of K4's and K5's resident-X kernels
                     # (ce.cu kResident): ce_fwd_f32 / ce_bwd_f32 run the
                     # wide kernels above it
CLUSTER_MAX = 2048   # the widest d K5 runs on the cluster kernels
                     # (csrc/ce_cluster.cu); the wide kernels above
CLUSTER_RANKS = 8    # blocks a cluster at most (the portable cluster size)
CLUSTER_SLICE = 256  # columns of d a block at most
CLUSTER_WIDTHS = (160, 192, 224, 256)   # the compile-time slice widths
CLUSTER_ROWS = 64    # X rows a cluster (ce_cluster.cu kCBx)
CLUSTER_TILE = 32    # Y entities a tile (kCBy)
EXCHANGE_LD = CLUSTER_TILE + 8           # an exchange row, floats (kXld)
WIDE_ROWS = 64       # X rows a block of ce.cu's wide kernels (kWBx)
WIDE_FWD_TILE = 64   # K4's Y entities a tile there (kWFwdBy)
WIDE_BWD_TILE = 32   # K5's (kWBwdBy)
WIDE_COLS = 256      # K5's output columns a part there (kWCols)
SMEM_LIMIT = 232448  # shared memory a block may take on an H100

# The longest vocab chain of K5's dh pass a split, in columns.  Each split
# sums its columns in one tensor-core accumulator, whose adds truncate:
# once the target's column has put dt·w_target into it, every later MMA
# drops part of an ulp of that, so the error grows with the chain.  FK's
# plans stay under it at d 128 (13 and 33 splits of 2,368 and 1,120
# columns); at V 501,760 a plan of 33 splits of 15,232 columns left dh
# 1.76e-4 of its largest element from float64 where the plain f32 version
# lies 1.9e-5 (an H100, the composed step at 1M item rows).
MAX_CHAIN = 2560
# The longest row chain of K5's dW/db pass a split, in rows.  At the port's
# --kernels shape (N 10,240, V 65,536) one split left dW 3.67e-5 of its
# largest element from float64 (an H100); emulated on those inputs, chains
# of 2,560 rows end 1.1e-5 from float64 and chains of 1,280 4.1e-6
# (tests/test_torch_tf32.py).
MAX_ROW_CHAIN = 1280


# The one pass (csrc/ce_onepass.cu): K5 in f32 up to d 128 with each logit
# tile computed once for dh, dW and db.
ONEPASS_MAX = 128    # the widest d it takes (DT 64 and 128)
ONEPASS_ROWS = 256   # h rows a block, a dW partial each (kORows)
ONEPASS_TILE = 32    # vocab entities a tile (kOBy)
# The bytes of dW partials (one a block of ONEPASS_ROWS rows) a call may
# write; past them K5 runs the pair.  A 1M-item domain (N 10,240, d 128, V
# 501,760) takes 9.65 GiB and ran 67 ms a call there against the pair's 72
# (tests/ce_onepass_variants.py, an H100, PERF.md §6); the cap keeps the
# largest vocabularies the kernels take (d·V·4 < 2^31) on an 80 GB card.
ONEPASS_PARTIAL_BYTES = 12 << 30


def bwd_route(d: int, bf16: bool = False) -> str:
    """K5's design at width d and dtype: "onepass" (csrc/ce_onepass.cu, f32
    up to ONEPASS_MAX), "narrow" (ce.cu's resident kernels, the dh pass
    and the dW pass, up to RESIDENT), "cluster" (csrc/ce_cluster.cu, up to
    CLUSTER_MAX) or "wide" (ce.cu's wide kernels).  The route depends on d
    and the dtype alone.  The one pass does 6·N·V·d FLOPs where the pair
    recomputes each logit (8·N·V·d), and at FK it beats the pair in turns
    (``chip_smoke.py`` phase_ce, PERF.md §6).  The bf16 instantiations keep
    the pair: the one pass has none.  Where the one pass's dW partials
    would pass ONEPASS_PARTIAL_BYTES, :func:`ce_bwd` runs the pair
    (:func:`onepass_plan`)."""
    if d <= ONEPASS_MAX and not bf16:
        return "onepass"
    return ("narrow" if d <= RESIDENT else "cluster" if d <= CLUSTER_MAX
            else "wide")


def cluster_slices(d: int) -> Tuple[int, int]:
    """(c, w): the cluster's c = ceil(d / 256) blocks and the columns of d
    each takes, w the smallest multiple of 8 with c·w >= d (the last block
    takes the rest: d 264 is 136 + 128)."""
    c = -(-d // CLUSTER_SLICE)
    return c, -(-d // (c * D_MULTIPLE)) * D_MULTIPLE


def slice_width(w: int) -> int:
    """The compile-time slice width (CLUSTER_WIDTHS) that computes w
    columns (ce_cluster.cu slice_width)."""
    return next(ws for ws in CLUSTER_WIDTHS if w <= ws)


def cluster_smem(w: int, bf16: bool) -> int:
    """A cluster block's shared memory in bytes at slice width w
    (ce_cluster.cu ``Cluster<WS, kBf>::kSmem``): the resident X slice, two
    ring stages of the Y slice (f32: big and small parts) and 4 floats an
    entity, two exchange tiles (the partial logits, and the owned rows'
    dlogits or the next tile's partials)."""
    ws = slice_width(w)
    elt, ld, parts = (2, ws + 8, 1) if bf16 else (4, ws + 4, 2)
    stage = elt * parts * CLUSTER_TILE * ld + 16 * CLUSTER_TILE
    return (elt * CLUSTER_ROWS * ld + 2 * stage
            + 2 * 4 * CLUSTER_ROWS * EXCHANGE_LD)


def resident_tile(d: int) -> Tuple[int, int, int]:
    """(DT, X rows a block, Y entities a tile) of ce.cu's resident kernels
    at width d <= RESIDENT (ce_fwd.cuh ``BwdCfg``): the narrowest compile
    width DT >= d, 8 warps of 32 rows up to DT 128, of 16 at 256."""
    dt = next(x for x in (64, 128, 256) if d <= x)
    return (dt, 256, 32) if dt <= 128 else (dt, 128, 16)


def best_splits(x_tiles: int, y_tiles: int, slots: int, tile_us: float,
                out_bytes: float, min_splits: int = 1) -> int:
    """The split count of one pass over X tiles x Y tiles that takes the
    least estimated time: whole waves of ``slots`` resident blocks (or
    clusters), each Y tile costing tile_us, plus the merge's read of every
    split's partial (out_bytes each, at about 3 TB/s); at least min_splits
    where there are as many Y tiles.  Every plan of K4 and K5 takes it."""
    lo = min(min_splits, y_tiles)
    best, best_us = lo, float("inf")
    for s in range(lo, min(y_tiles, max(min_splits, 128)) + 1):
        per = -(-y_tiles // s)
        if -(-y_tiles // per) != s:         # an empty split: same as fewer
            continue
        waves = -(-(x_tiles * s) // slots)
        us = waves * per * tile_us + (s * out_bytes / 3e6 if s > 1 else 0.0)
        if us < best_us:
            best, best_us = s, us
    return best


def _k5_splits(N: int, d: int, V: int, slots: int, tile_us: float, bx: int,
               by: int, parts: int = 1) -> Tuple[int, int]:
    """K5's (dh vocab splits, dW row splits) of its two passes (ce.cu's
    narrow and wide kernels, ce_cluster.cu's) over X tiles of bx entities
    (``parts`` blocks each) and Y tiles of by: at most MAX_CHAIN vocab
    columns and MAX_ROW_CHAIN rows a split, the splits' partials merged in
    f32 in order.  The one pass keeps the same caps in one grid
    (:func:`onepass_plan`)."""
    v_tiles, n_tiles = -(-V // by), -(-N // by)
    split_h = best_splits(parts * -(-N // bx), v_tiles, slots, tile_us,
                          4.0 * N * d, -(-V // MAX_CHAIN))
    split_w = best_splits(parts * -(-V // bx), n_tiles, slots, tile_us,
                          4.0 * (d + 1) * V,
                          -(-n_tiles // (MAX_ROW_CHAIN // by)))
    return split_h, split_w


# A tile's MMA work in the plans' cost model, in TF32 FLOPs a multiply-add:
# 6 in f32 (three TF32 terms), 1 in the bf16 instantiations of ce.cu's
# kernels (one bf16 MMA, at twice the TF32 rate); at an assumed 2 TFLOP/s
# an SM in the resident and cluster kernels and 1 in the wide ones, which
# the L2's reads hold to about half that rate.
def _flops(bf16: bool) -> float:
    return 1.0 if bf16 else 6.0


# The cluster kernels' bf16 tile in the same units: their exchange and
# barriers, not the MMAs, take 61% of its time at d 1,024 (PERF.md §6), so
# a tile costs about a third of the f32 one (13.49 against 31.63 ms at d
# 512, an H100), 2 TF32 FLOPs a multiply-add.
CLUSTER_BF16_FLOPS = 2.0


def fwd_splits(N: int, d: int, V: int, bf16: bool, slots: int) -> int:
    """K4's vocab splits at N rows, width d and V columns, given the blocks
    the card holds at once (``slots``): the resident kernel's up to
    RESIDENT, the wide one's above."""
    if d <= RESIDENT:
        dt, bx, by = resident_tile(d)
        return best_splits(-(-N // bx), -(-V // by), slots,
                           _flops(bf16) * dt * bx * by / 2e6, 12.0 * N)
    return best_splits(-(-N // WIDE_ROWS), -(-V // WIDE_FWD_TILE), slots,
                       _flops(bf16) * d * WIDE_ROWS * WIDE_FWD_TILE / 1e6,
                       12.0 * N)


def bwd_splits(N: int, d: int, V: int, bf16: bool, slots: int,
               wide: bool = False) -> Tuple[int, int]:
    """K5's (dh vocab splits, dW row splits) on ce.cu's kernels: the
    resident ones up to RESIDENT (unless ``wide``), the wide ones above,
    whose c = ceil(d / 256) output parts each recompute the logits."""
    if d <= RESIDENT and not wide:
        dt, bx, by = resident_tile(d)
        return _k5_splits(N, d, V, slots,
                          _flops(bf16) * 2 * dt * bx * by / 2e6, bx, by)
    parts = -(-d // WIDE_COLS)
    return _k5_splits(N, d, V, slots,
                      _flops(bf16) * (d + WIDE_COLS) * WIDE_ROWS
                      * WIDE_BWD_TILE / 1e6, WIDE_ROWS, WIDE_BWD_TILE,
                      parts)


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """A launch of K5's cluster kernels: c blocks of w columns (compile
    width ws, smem bytes a block), split_h vocab splits of the dh pass and
    split_w row splits of the dW pass."""
    c: int
    w: int
    ws: int
    split_h: int
    split_w: int
    smem: int


def cluster_plan(N: int, d: int, V: int, bf16: bool, slots: int
                 ) -> ClusterPlan:
    """The cluster kernels' plan at N rows, width d and V columns, given
    the clusters the card holds at once (``slots``).  Each split keeps
    ce.cu's chains: at most MAX_CHAIN vocab columns for dh and
    MAX_ROW_CHAIN rows for dW, their partials merged in f32."""
    if not RESIDENT < d <= CLUSTER_MAX or d % D_MULTIPLE:
        raise ValueError(f"the cluster kernels take 256 < d <= "
                         f"{CLUSTER_MAX}, d % 8 == 0; got d={d}")
    if slots < 1:
        raise RuntimeError(f"no cluster of K5's kernels fits on the card "
                           f"at d={d} (cudaOccupancyMaxActiveClusters 0)")
    c, w = cluster_slices(d)
    ws = slice_width(w)
    # a block's work on a Y tile: the slice's logits and its share of the
    # product
    flops = CLUSTER_BF16_FLOPS if bf16 else _flops(False)
    split_h, split_w = _k5_splits(
        N, d, V, slots, flops * 2 * ws * CLUSTER_ROWS * CLUSTER_TILE / 2e6,
        CLUSTER_ROWS, CLUSTER_TILE)
    return ClusterPlan(c, w, ws, split_h, split_w, cluster_smem(w, bf16))


@functools.lru_cache(maxsize=64)
def _slots(design: int, d: int, bf16: bool) -> int:
    """Blocks of ce.cu's kernels the card holds at once (``ce_slots``):
    design 0 K5's resident kernels at width d, 1 K4's wide kernel, 2 K5's
    wide kernels, 3 K4's resident kernel at width d (two blocks an SM in
    bf16, one in f32)."""
    f = build.library("ce").ce_slots
    f.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = f(design, d, int(bf16), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"ce_slots({design}, d={d}) failed: CUDA error "
                           f"{err}")
    return out.value


def plan_fwd(N: int, d: int, V: int, bf16: bool) -> int:
    """:func:`fwd_splits` with the card's own slots."""
    return fwd_splits(N, d, V, bf16,
                      _slots(3 if d <= RESIDENT else 1, d, bf16))


def plan_bwd(N: int, d: int, V: int, bf16: bool, wide: bool = False
             ) -> Tuple[int, int]:
    """:func:`bwd_splits` with the card's own slots."""
    narrow = d <= RESIDENT and not wide
    return bwd_splits(N, d, V, bf16, _slots(0 if narrow else 2, d, bf16),
                      wide)


@dataclasses.dataclass(frozen=True)
class OnePassPlan:
    """A launch of the one pass: a block of ONEPASS_ROWS rows (and a dW
    partial) for each of ``row_blocks``, over split_h vocab splits."""
    split_h: int
    row_blocks: int


def onepass_plan(N: int, d: int, V: int, slots: int
                 ) -> Optional[OnePassPlan]:
    """The one pass's plan at N rows, width d and V columns, given the
    blocks the card holds at once (``slots``): the vocab splits of least
    estimated time; None where its dW partials would pass
    ONEPASS_PARTIAL_BYTES (:func:`ce_bwd` then runs the pair).  A vocab
    split takes at most MAX_CHAIN columns (dh's chain in the accumulator);
    dW's chain there is a block's ONEPASS_ROWS rows (within
    MAX_ROW_CHAIN), the blocks' partials added in f32.  A tile costs its
    three products (logits, dh, dW) at the resident kernels' assumed
    rate, in whole waves, plus the merge's read of dh's partials."""
    if not 0 < d <= ONEPASS_MAX or d % D_MULTIPLE:
        raise ValueError(f"the one pass takes d <= {ONEPASS_MAX}, d % 8 == 0;"
                         f" got d={d}")
    if slots < 1:
        raise RuntimeError(f"no block of K5's one pass fits on the card at "
                           f"d={d} (occupancy 0)")
    blocks = -(-N // ONEPASS_ROWS)
    if blocks > 1 and 4 * blocks * (d + 1) * V > ONEPASS_PARTIAL_BYTES:
        return None
    dt = 64 if d <= 64 else 128
    tile_us = _flops(False) * 3 * dt * ONEPASS_ROWS * ONEPASS_TILE / 2e6
    split_h = best_splits(blocks, -(-V // ONEPASS_TILE), slots, tile_us,
                          4.0 * N * d, -(-V // MAX_CHAIN))
    return OnePassPlan(split_h, blocks)


def onepass_workspace(N: int, d: int, V: int, plan: OnePassPlan) -> int:
    """Floats of the one pass's workspace (``ce_bwd_onepass_f32``): Wᵀ's
    TF32 parts, then dh's partials where there is more than one vocab
    split, then dW's and db's where there is more than one row block."""
    return (2 * V * d + (plan.split_h * N * d if plan.split_h > 1 else 0)
            + (plan.row_blocks * (d + 1) * V if plan.row_blocks > 1 else 0))


@functools.lru_cache(maxsize=64)
def _onepass_slots(d: int) -> int:
    """Blocks of the one pass at width d the card holds at once
    (``ce_bwd_onepass_slots``)."""
    f = build.library("ce_onepass").ce_bwd_onepass_slots
    f.argtypes = [ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = f(d, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"ce_bwd_onepass_slots(d={d}) failed: CUDA error "
                           f"{err}")
    return out.value


def plan_onepass(N: int, d: int, V: int) -> Optional[OnePassPlan]:
    """:func:`onepass_plan` with the card's own slots."""
    return onepass_plan(N, d, V, _onepass_slots(d))


@functools.lru_cache(maxsize=64)
def _cluster_slots(c: int, w: int, bf16: bool) -> int:
    """Clusters of c blocks at slice width w the card holds at once
    (``ce_bwd_cluster_slots``: cudaOccupancyMaxActiveClusters)."""
    f = build.library("ce_cluster").ce_bwd_cluster_slots
    f.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = f(c, w, int(bf16), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"ce_bwd_cluster_slots(c={c}, w={w}) failed: "
                           f"CUDA error {err}")
    return out.value


def cluster_smem_card(w: int, bf16: bool) -> int:
    """The cluster kernels' own count of a block's shared memory at slice
    width w (``ce_bwd_cluster_smem``), against which the card checks
    :func:`cluster_smem`."""
    f = build.library("ce_cluster").ce_bwd_cluster_smem
    f.argtypes = [ctypes.c_int] * 2
    f.restype = ctypes.c_int
    return f(w, int(bf16))


def plan_cluster(N: int, d: int, V: int, bf16: bool) -> ClusterPlan:
    """:func:`cluster_plan` with the card's own slots; raises where no
    cluster fits."""
    c, w = cluster_slices(d)
    return cluster_plan(N, d, V, bf16, _cluster_slots(c, w, bf16))


def check_shape(name: str, N: int, d: int, V: int, w_bytes: int = 4
                ) -> None:
    """Raise unless the kernels take N rows, width d and V columns: d % 8
    == 0, V % 4 == 0, and W [d, V] of ``w_bytes`` an element under 2 GiB
    (d·V·w_bytes < 2^31), the JAX package's limit
    (``c2dsr_tpu/ops/fused_ce.py`` ``_pick_blocks``)."""
    if d % D_MULTIPLE or d == 0 or V % 4 or V == 0 or N == 0:
        raise ValueError(f"{name} needs d % 8 == 0 and V % 4 == 0; got N={N} "
                         f"d={d} V={V}")
    if d * V * w_bytes >= 2 ** 31:
        raise ValueError(f"{name}: classifier operand d*V = {d}x{V} at "
                         f"{w_bytes} B/elt reaches 2 GiB, the 32-bit "
                         "per-operand addressing limit; use a bfloat16 "
                         "classifier or shard the vocab "
                         "(parallel/sharded_loss.py)")


def _check(name: str, h, w, rows, targets, bf16: bool = False
           ) -> Tuple[int, int, int]:
    if not h.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors only")
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(f"{name} takes h [N, d] and w [d, V], got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
    N, d = h.shape
    V = w.shape[1]
    # the bf16 instantiations multiply a bf16 Wᵀ (rounded by the pre-pass)
    check_shape(name, N, d, V, 2 if bf16 else w.element_size())
    if not (w.dtype == torch.float32
            or (bf16 and w.dtype == torch.bfloat16)):
        raise ValueError(f"{name}: w must be f32 (or bf16 with bf16=True), "
                         f"got {w.dtype}")
    if w.device != h.device or not w.is_contiguous():
        raise ValueError(f"{name}: w must be contiguous on h's device")
    for t, shape in rows:
        if (t.dtype != torch.float32 or t.device != h.device
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"{name}: every float input must be contiguous "
                             f"f32 of shape {shape} on h's device")
    if tuple(targets.shape) != (N,) or targets.device != h.device:
        raise ValueError(f"{name}: targets must be [N] on h's device")
    return N, d, V


def ce_fwd(h: torch.Tensor, w: torch.Tensor, b_masked: torch.Tensor,
           pad: torch.Tensor, targets: torch.Tensor, bf16: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, target logit) per row of softmax over [h·w + b_masked | pad],
    by K4.  h [N, d], b_masked [V], pad [N] f32; w [d, V] f32, or bf16 (the
    bf16 instantiation then, whatever ``bf16`` says); targets [N] int (a
    target >= V gives a target logit of 0).  Above RESIDENT the wide
    kernel runs."""
    bf16 = bf16 or w.dtype == torch.bfloat16
    N, d, V = _check("ce_fwd", h, w, [(h, tuple(h.shape)),
                                      (b_masked, (w.shape[1],)),
                                      (pad, (h.shape[0],))], targets, bf16)
    h = _aligned(h)
    tgt = targets.to(torch.int32).contiguous()
    lse = torch.empty(N, dtype=torch.float32, device=h.device)
    tlog = torch.empty_like(lse)
    if bf16:
        splits = plan_fwd(N, d, V, True)
        # h and Wᵀ in bf16, then the splits' partials
        ws = torch.empty((N + V) * d // 2 + 3 * splits * N,
                         dtype=torch.float32, device=h.device)
        err = _fn("ce_fwd_bf16", 8, 5)(
            h.data_ptr(), w.data_ptr(), b_masked.data_ptr(), pad.data_ptr(),
            tgt.data_ptr(), lse.data_ptr(), tlog.data_ptr(), ws.data_ptr(),
            int(w.dtype == torch.bfloat16), splits, N, d, V,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"ce_fwd (bf16) launch failed: CUDA error "
                               f"{err}")
        ce_fwd.launches_bf16 += 1
        return lse, tlog
    splits = plan_fwd(N, d, V, False)
    # Wᵀ's TF32 split, then the splits' (max, sum, target) partials
    ws = torch.empty(2 * V * d + 3 * splits * N, dtype=torch.float32,
                     device=h.device)
    err = _fn("ce_fwd_f32", 8, 4)(
        h.data_ptr(), w.data_ptr(), b_masked.data_ptr(), pad.data_ptr(),
        tgt.data_ptr(), lse.data_ptr(), tlog.data_ptr(), ws.data_ptr(),
        splits, N, d, V, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ce_fwd launch failed: CUDA error {err}")
    ce_fwd.launches += 1
    return lse, tlog


ce_fwd.launches = 0
ce_fwd.launches_bf16 = 0


def ce_bwd(h: torch.Tensor, w: torch.Tensor, b_masked: torch.Tensor,
           lse: torch.Tensor, dlse: torch.Tensor, dt: torch.Tensor,
           targets: torch.Tensor, bf16: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dh, dw, db) of :func:`ce_fwd` given the gradients dlse, dt of its
    two outputs, by K5; with ``bf16`` (or a bf16 w) by its bf16
    instantiation, dw in w's dtype.  The design follows d and the dtype
    (:func:`bwd_route`): in f32 the one pass up to ONEPASS_MAX (its
    launches counted also in ``launches_onepass``), the narrow kernels (a
    dh kernel, then a dW/db kernel) up to RESIDENT, the cluster kernels up
    to CLUSTER_MAX (their launches counted also in ``launches_cluster`` /
    ``launches_cluster_bf16``), the wide kernels above.  A plan or launch
    the card refuses raises."""
    bf16 = bf16 or w.dtype == torch.bfloat16
    n = (h.shape[0],)
    N, d, V = _check("ce_bwd", h, w, [(h, tuple(h.shape)),
                                      (b_masked, (w.shape[1],)), (lse, n),
                                      (dlse, n), (dt, n)], targets, bf16)
    route = bwd_route(d, bf16)
    plan = plan_onepass(N, d, V) if route == "onepass" else None
    if plan is not None:
        out = onepass_run(plan, h, w, b_masked, lse, dlse, dt, targets)
        ce_bwd.launches += 1
        ce_bwd.launches_onepass += 1
        return out
    h = _aligned(h)
    tgt = targets.to(torch.int32).contiguous()
    dh = torch.empty_like(h)
    dw = torch.empty(w.shape, dtype=torch.float32, device=h.device)
    db = torch.empty_like(b_masked)
    cluster = route == "cluster"
    if cluster:
        plan = plan_cluster(N, d, V, bf16)
        splits, extra = (plan.split_h, plan.split_w), (plan.c, plan.w)
        entry = "ce_bwd_cluster_bf16" if bf16 else "ce_bwd_cluster_f32"
    else:
        splits = plan_bwd(N, d, V, bf16)
        extra, entry = (), "ce_bwd_bf16" if bf16 else "ce_bwd_f32"
    run = _bwd_bf16 if bf16 else _bwd_f32
    err = run(entry, splits, h, w, b_masked, lse, dlse, dt, tgt, dh, dw, db,
              extra)
    if err != 0:
        raise RuntimeError(f"ce_bwd{' (bf16)' if bf16 else ''} launch "
                           f"failed ({entry}): CUDA error {err}")
    if bf16:
        ce_bwd.launches_bf16 += 1
        ce_bwd.launches_cluster_bf16 += cluster
        return dh, dw.to(w.dtype), db
    ce_bwd.launches += 1
    ce_bwd.launches_cluster += cluster
    return dh, dw, db


ce_bwd.launches = 0
ce_bwd.launches_bf16 = 0
ce_bwd.launches_cluster = 0
ce_bwd.launches_cluster_bf16 = 0
ce_bwd.launches_onepass = 0


def onepass_run(plan: OnePassPlan, h, w, b_masked, lse, dlse, dt, targets
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dh, dw, db) by K5's one pass (``ce_bwd_onepass_f32``) at ``plan``,
    on inputs :func:`ce_bwd` has checked.  Not counted as a launch."""
    (N, d), V = h.shape, w.shape[1]
    h = _aligned(h)
    tgt = targets.to(torch.int32).contiguous()
    dh = torch.empty_like(h)
    dw = torch.empty(w.shape, dtype=torch.float32, device=h.device)
    db = torch.empty_like(b_masked)
    ws = torch.empty(onepass_workspace(N, d, V, plan), dtype=torch.float32,
                     device=h.device)
    err = _fn("ce_bwd_onepass_f32", 11, 4, "ce_onepass")(
        h.data_ptr(), w.data_ptr(), b_masked.data_ptr(), lse.data_ptr(),
        dlse.data_ptr(), dt.data_ptr(), tgt.data_ptr(), dh.data_ptr(),
        dw.data_ptr(), db.data_ptr(), ws.data_ptr(), plan.split_h, N, d, V,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ce_bwd_onepass launch failed ({plan}): CUDA "
                           f"error {err}")
    return dh, dw, db


def _library(entry: str) -> str:
    return "ce_cluster" if entry.startswith("ce_bwd_cluster") else "ce"


def _bwd_f32(entry: str, splits, h, w, b_masked, lse, dlse, dt, tgt, dh, dw,
             db, cluster=()) -> int:
    """Runs the f32 backward's C ``entry`` with ``splits`` from its plan:
    ``ce_bwd_f32`` (ce.cu's kernels by d: the resident ones up to
    RESIDENT, the wide ones above; the port runs it outside the cluster's
    widths), ``ce_bwd_wide_f32`` (the wide kernels at any width, which
    ``chip_smoke.py`` times beside the cluster kernels) or
    ``ce_bwd_cluster_f32`` with ``cluster`` = (c, w).  Returns its CUDA
    error code."""
    (split_h, split_w), (N, d), V = splits, h.shape, w.shape[1]
    # Wᵀ and its TF32 split, h's split, then each pass's partials
    floats = (3 * V * d + 2 * N * d + (split_h * N * d if split_h > 1 else 0)
              + (split_w * (d + 1) * V if split_w > 1 else 0))
    ws = torch.empty(floats, dtype=torch.float32, device=h.device)
    return _fn(entry, 11, 5 + len(cluster), _library(entry))(
        h.data_ptr(), w.data_ptr(), b_masked.data_ptr(), lse.data_ptr(),
        dlse.data_ptr(), dt.data_ptr(), tgt.data_ptr(), dh.data_ptr(),
        dw.data_ptr(), db.data_ptr(), ws.data_ptr(), *cluster, split_h,
        split_w, N, d, V, torch.cuda.current_stream().cuda_stream)


def _bwd_bf16(entry: str, splits, h, w, b_masked, lse, dlse, dt, tgt, dh,
              dw, db, cluster=()) -> int:
    """The bf16 instantiation's C ``entry`` (``ce_bwd_bf16``, ce.cu's
    kernels by d, or ``ce_bwd_cluster_bf16`` with ``cluster`` = (c, w)), as
    :func:`_bwd_f32`; dw comes back f32."""
    (split_h, split_w), (N, d), V = splits, h.shape, w.shape[1]
    # h and Wᵀ in bf16, then each pass's partials
    floats = ((N + V) * d // 2
              + (split_h * N * d if split_h > 1 else 0)
              + (split_w * (d + 1) * V if split_w > 1 else 0))
    ws = torch.empty(floats, dtype=torch.float32, device=h.device)
    return _fn(entry, 11, 6 + len(cluster), _library(entry))(
        h.data_ptr(), w.data_ptr(), b_masked.data_ptr(), lse.data_ptr(),
        dlse.data_ptr(), dt.data_ptr(), tgt.data_ptr(), dh.data_ptr(),
        dw.data_ptr(), db.data_ptr(), ws.data_ptr(),
        int(w.dtype == torch.bfloat16), *cluster, split_h, split_w, N, d, V,
        torch.cuda.current_stream().cuda_stream)
