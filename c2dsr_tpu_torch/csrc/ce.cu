// Fused linear + softmax cross-entropy over [h·W + b_masked | pad], f32:
// the forward (K4) and the backward (K5).
//
// Replaces the fused CE Pallas kernels (c2dsr_tpu/ops/fused_ce.py):
// _fwd_kernel (forward, K4), _bwd_merged_kernel, _bwd_dh_kernel and
// _bwd_dw_kernel (backward, K5).  None of them writes a logit to device
// memory: each recomputes its tile of h·W + b on chip.
//
// Both are bound on an H100 by operations, and both run them on the tensor
// cores with products at f32 accuracy (3xTF32, tc.cuh): the ceiling is
// 495 / 3 = 165 TFLOP/s of f32-accurate products against 67 for FFMA.  The
// tensor cores' accumulator adds with truncation, so no long sum stays in
// it: a logit's k-steps are added in f32 (ce_fwd.cuh, logit_tile), and the
// backward's products keep a chain of at most 2,560 vocab columns (dh) or
// 1,280 rows (dW) in it a split, the splits' partials added in f32 by a
// merge; the plans (ops/fused_ce_cuda.py, MAX_CHAIN, MAX_ROW_CHAIN) set
// those caps.  Over
// one 10,240-row chain dW ended 3.67e-5 of its largest element from
// float64, where cuBLAS's f32 ends 2.5e-6 (tests/test_torch_tf32.py
// emulates both schemes).
//
// K4 and the tile machinery both kernels share live in ce_fwd.cuh, K5's
// shared machinery (its pass arguments, dlogits, second product, writes,
// pre-passes and merges) in ce_bwd.cuh.  The port routes K5 by d and
// dtype (ops/fused_ce_cuda.bwd_route): in f32 up to d 128 to the one pass
// of ce_onepass.cu (each logit computed once, 6·N·V·d FLOPs); in bf16 up
// to d 256, and in f32 from 136 to 256, to the narrow kernels here;
// from 264 to 2,048 to the cluster kernels of ce_cluster.cu, one
// thread-block cluster over d that computes each logit once (4·N·V·d FLOPs
// a kernel); past 2,048 to the wide kernels here.  This file's C entries
// ce_bwd_f32 / ce_bwd_bf16 run the narrow kernels up to kResident and the
// wide ones above, and ce_bwd_wide_f32 the wide ones at any width:
// chip_smoke.py times the wide kernels beside the cluster kernels.  The
// split counts come from the plans in ops/fused_ce_cuda.py, given the
// resident blocks that ce_slots reports.
//
// K4, the forward: 2·N·V·d FLOPs for the logits (the bytes, h and W once
// and a few floats a row, are small beside them).  It is K5's dh kernel
// without the second product: X = h stays resident in shared memory, Y = Wᵀ
// (split into its TF32 part and remainder once, by the pre-pass) streams
// through the cp.async ring, and a warp computes its logit tile S =
// X_w·Y_tileᵀ + b in the C layout.  Per fragment row a thread keeps a
// running (max, sum-exp), in log2 units, over the columns it holds; the four
// threads of a quad hold a row's columns and merge their pairs with two
// shuffles at the end.  The target logit is picked where the column
// matches; a target >= V (an ignored row whose ignore index n_real equals V)
// matches none and gives 0, which the caller masks.  The vocab is split over
// blocks in whole waves (fused_ce_cuda.plan_fwd), and ce_fwd_merge_kernel
// merges the splits in split order and folds in the pad-class logit, as
// _fwd_kernel does at its last vocab block: no atomics, and two launches on the same
// inputs give bitwise-equal results.  The TPU's vocab padding and
// _pick_blocks stripes do not carry over: V is taken as stored (V % 4 == 0)
// and the ragged last tile is masked.  K4 runs its own pre-pass (Wᵀ's split,
// 2·V·d floats) instead of handing it to K5 through the autograd Function:
// the two calls stay independent at the cost of one more transpose of W (a
// few hundredths of a millisecond at FK shapes).
//
// K5, the backward: dlogits = dlse·softmax + dt·onehot(target), then
// dh = dlogits·Wᵀ, dW = hᵀ·dlogits, db = colsum(dlogits).  4·N·V·d FLOPs
// for the two products, plus 2·N·V·d for the logits, which each of its two
// kernels recomputes (8·N·V·d in all).
// * The MMA is mma.sync.m16n8k8 TF32 (warp-level), not wgmma: a warp's
//   logit accumulator (C layout) becomes the A operand of the next product
//   in registers, by permuting k within each group of 8 (C holds columns
//   2t, 2t+1 where A wants t, t+4; the B operand is read with the same
//   permutation), so dlogits never touch shared memory.  Why not wgmma: it
//   takes a TF32 B operand only K-major from shared memory, so the second
//   product needs a transposed, k-permuted copy of every Y tile beside the
//   first, and 3xTF32 doubles both (big and small parts).  A wgmma version
//   (two warpgroups of 64 rows, A from registers, 32-entity tiles: all the
//   shared memory allows) was right but took 13.2 ms at FK shapes where
//   this kernel takes 10.0, on an H100 at 700 W.
// * Operand layouts: both kernels are one template.  X is the resident
//   operand and Y the streamed one, both [entities x d] row-major: the dh
//   kernel has X = h, Y = Wᵀ; the dW kernel X = Wᵀ, Y = h.  Up to d 128 a
//   block holds 256 X rows, 32 a warp (two 16-row m-tiles, so that every B
//   fragment a warp reads from shared memory feeds six MMAs: shared-memory
//   reads, not the tensor cores, set the pace at one m-tile), and streams
//   Y in tiles of 32; up to d 256, 128 X rows, 16 a warp, and Y tiles of
//   16 (ce_fwd.cuh, BwdCfg).  A warp computes
//   S = X_w·Y_tileᵀ, turns it into dlogits in registers, and adds P·Y_tile
//   into its [rows x d] output in registers.
//   A pre-pass writes Wᵀ [V, d] and the TF32 split of Wᵀ and of h (about
//   0.05 ms at FK shapes): each Y element is split once, not once per warp
//   and product (the splits were the largest share of the instructions),
//   and X and dlogits are split as they are read, in two integer
//   operations and a subtraction.  The width is a compile-time DT (64,
//   128 or 256; columns past d are zero, so any d % 4 == 0 up to DT
//   works), so the unrolled loops carry no branch, and shared rows are
//   padded to DT + 4 floats, so every fragment load is free of bank
//   conflicts.
// * Copy ring: Y tiles, big and small parts (and, per tile, the bias or
//   the per-row lse, dlse, dt, target) arrive by cp.async in a ring of 2
//   stages (3 at d <= 64), so the next tile loads while this one is
//   multiplied; one barrier a tile.
// * Two kernels, no atomics.  The grid is X tiles x splits of Y, the split
//   count chosen (fused_ce_cuda.plan_bwd) to fill the SMs in whole waves;
//   each split writes its partial of dh (or dW, db) once, and a small
//   kernel sums the partials in split order.  Every output element is
//   written once, in a fixed order: two launches on the same inputs give
//   bitwise-equal results.
// * Shared memory sets the pace: mma.sync reads every operand fragment
//   from it into registers, 0.31 bytes a multiply-add at these warp tiles
//   (32 x 32 for the logits, 32 x d for the product, whose A comes from
//   registers).  ce_onepass.cu is the dh kernel with the dW product added
//   from a transposed copy of the dlogits: it reads about 0.85 of this
//   pair's bytes for 0.75 of its multiply-adds, and takes K5's f32 route up
//   to d 128 (PERF.md §6).  Its bf16 instantiation and DT 256 are not
//   built: there the pair stays.
//
// The bf16 instantiations (ce_fwd_bf16, ce_bwd_bf16; compute_dtype=
// "bfloat16" or a bf16 classifier) compute the Pallas kernels' numerics:
// every product of bf16-rounded h, W and dlogits, summed in f32 (_dot and
// the backward's products in fused_ce.py), at the rate those products
// have on the TPU's MXU: the bf16 tensor cores.  A pre-pass writes h and
// Wᵀ in bf16 (W read once, f32 rounded or bf16 as it is), the kernels
// stage the bf16 rows (ce_fwd.cuh, Tile), read them by ldmatrix and take
// one mma.sync.m16n8k16 bf16 a k16 step (tc.cuh), where 3xTF32 takes
// three m16n8k8 TF32 MMAs a k8 step: the bf16 bound is a sixth of the
// 3xTF32 one.  K5's second product takes the dlogits rounded to bf16 and
// packed in pairs, which are its A fragment as they lie (ce_bwd.cuh,
// add_py), and Y transposed by ldmatrix.  The same plans, chains and
// merges, so they too are bitwise repeatable.  As each dlogit is rounded
// to bf16, K5's bf16 instantiation sums the logits' 32-column partials
// with compensation (ce_fwd.cuh, logit_tile), computes each softmax value
// as the plain version does (expf(logit - lse)) and adds each Y tile's
// products to its output in f32 (dlogits, add_py): K5 bf16 lies as near
// float64 as the plain bf16 CE or nearer (PERF.md §6,
// tests/ce_bf16_seeds.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ce_bwd.cuh"

namespace {

// One backward pass (the dh kernel for kRowsX, else the dW/db kernel) over
// X tile blockIdx.x and the Y tiles of split blockIdx.y; kBf: the bf16
// instantiation (ce_fwd.cuh, Tile).
template <int DT, bool kRowsX, bool kBf = false>
__global__ void __launch_bounds__(BwdCfg<DT>::kThreads, 1)
ce_bwd_kernel(const BwdArgs a) {
  using L = Tile<DT, kBf>;
  using T = typename L::T;
  constexpr int kThreads = BwdCfg<DT>::kThreads;
  constexpr int kMt = BwdCfg<DT>::kMt;
  constexpr int kBx = BwdCfg<DT>::kBx;
  constexpr int kBy = BwdCfg<DT>::kBy;
  constexpr int kStages = BwdCfg<DT>::kStages;
  constexpr int kNy = kBy / 8;         // n-tiles of S, k-steps of the output
  constexpr int kNo = DT / 8;          // n-tiles of the output
  constexpr int ld = L::ld;
  extern __shared__ float4 smem4[];
  const int d = a.d;
  T* xs = reinterpret_cast<T*>(smem4);
  // stage: Y's big [kBy][ld] and small part (bf16: the one part), info
  char* ring = reinterpret_cast<char*>(xs + kBx * ld);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;             // fragment row group
  const int t = lane & 3;              // thread in group
  const int x0 = blockIdx.x * kBx;
  const int y_tiles = (a.n_y + kBy - 1) / kBy;
  const int per = (y_tiles + gridDim.y - 1) / gridDim.y;
  const int t_begin = min(y_tiles, (int)blockIdx.y * per);
  const int n_tiles = min(y_tiles, t_begin + per) - t_begin;

  const int xa = x0 + warp * 16 * kMt + g;
  float xl[kMt][2], xg[kMt][2], xt[kMt][2], xb[kMt][2];
  int xtg[kMt][2];
  bool xok[kMt][2];
  x_values<kMt, kRowsX, kBf>(a, xa, xl, xg, xt, xb, xtg, xok);

  auto stage = [&](int slot, int tile) {
    T* st = reinterpret_cast<T*>(ring + slot * L::kStageBytes);
    const int y0 = tile * kBy;
    if constexpr (kBf) {
      stage_rows<DT, kBy>(st, a.yh, y0, a.n_y, d);
    } else {
      stage_rows<DT, kBy>(st, a.y_big, y0, a.n_y, d);
      stage_rows<DT, kBy>(st + kBy * ld, a.y_small, y0, a.n_y, d);
    }
    stage_info<kBy, kRowsX, kThreads>(
        reinterpret_cast<float*>(st + L::kYParts * kBy * ld), a, y0);
  };
  if constexpr (kBf)
    stage_rows<DT, kBx>(xs, a.xh, x0, a.n_x, d);
  else
    stage_rows<DT, kBx>(xs, a.x, x0, a.n_x, d);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) stage(s, t_begin + s);
    cp_async_commit();
  }

  float o[kMt][kNo][4];
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int n = 0; n < kNo; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[m][n][i] = 0.f;
  float dbs[kMt][2] = {};
  const T* xw = xs + (warp * 16 * kMt + g) * ld + t;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < n_tiles)
      stage((it + kStages - 1) % kStages, t_begin + it + kStages - 1);
    cp_async_commit();
    const T* yb =
        reinterpret_cast<const T*>(ring + (it % kStages) * L::kStageBytes);
    const T* ys = yb + kBy * ld;
    const float* inf =
        reinterpret_cast<const float*>(yb + L::kYParts * kBy * ld);
    const int y0 = (t_begin + it) * kBy;

    float s[kMt][kNy][4];
    logit_tile<DT, kMt, kNy>(s, xw, yb, ys, g, t);
    dlogits<kMt, kNy, kBy, kRowsX, kBf>(s, inf, y0, a.n_y, xa, xl, xg, xt,
                                        xb, xtg, xok, dbs, t);
    add_py<kMt, kNy, kNo, ld, kBf>(o, s, yb, ys, 0, g, t);
  }
  cp_async_wait<0>();
  bwd_write<kMt, kNo, kRowsX>(o, dbs, a, xa, 0, a.d, true, t);
}

// ------------------------------------------ K4 past d 256, K5 past 2,048 ----
//
// The resident-X tiles above stop at DT 256 (kResident): 128 X rows of
// d + 4 floats are 133 KB there and would be 264 KB at 512, and K5 holds
// its output in registers, a warp's 16 rows x 256 columns at most.  K4
// runs its wide kernel above d 256; K5 its wide kernels past the cluster
// kernels' d 2,048 (ce_cluster.cu).  The wide kernels take
// any d % 8 == 0: nothing is resident, and a block walks steps of kWKc = 32
// k-columns (kLogitSteps k-steps, one logit partial: the same partials,
// added in f32, as logit_tile) with X's and Y's chunks of that step staged
// through the cp.async ring beside each other, a GEMM tile's loop.  K5
// splits its output columns over ceil(d / 256) parts (grid.z), each part a
// block that recomputes the logits and holds a warp's 16 rows x 256
// columns; a part stages its tile's own 256 columns of Y (big and small)
// once a tile, into a buffer beside the ring, for the second product.
// With c = ceil(d / 256) parts K5 does (2c + 2)·N·V·d FLOPs where one pass
// needs 4·N·V·d (2.5x at d 1,024, 4.5x at 2,048), and each step reads
// kBx + kBy rows of 32 columns from L2: per logit, (4·kBx + 8·kBy)·d /
// (kBx·kBy) bytes, 8 FLOPs a byte for K5's 64 x 32 tile and 10.7 for K4's
// 64 x 64, so the L2's bandwidth, not the tensor cores, bounds both.  The
// cluster kernels (ce_cluster.cu) compute each logit once across a cluster
// of blocks over d and exchange the partial logits through distributed
// shared memory: at d 1,024 they take a third of these kernels' time, at
// 2,048 a sixth (PERF.md §6).  The
// chains are the narrow kernels': K5's plans cap a split at MAX_CHAIN vocab
// columns and MAX_ROW_CHAIN rows, merged in f32, no atomics, bitwise across
// launches.  bf16 (kBf): X and Y bf16 rows and bf16 MMAs as in the narrow
// kernels (a 32-column step is two k16 steps).
constexpr int kWThreads = 128;       // 4 warps, 16 X rows each
constexpr int kWBx = 64;             // X rows a block
constexpr int kWKc = 32;             // k-columns a step
constexpr int kWCols = 256;          // K5's output columns a part
constexpr int kWFwdBy = 64;          // K4's Y entities a tile
constexpr int kWBwdBy = 32;          // K5's
constexpr int kWFwdStages = 3;
constexpr int kWBwdStages = 2;

template <bool kBf, int kBy>
struct Wide {
  using T = typename std::conditional<kBf, uint16_t, float>::type;
  static constexpr int ld = Tile<kWKc, kBf>::ld;       // a chunk's row
  static constexpr int kYParts = kBf ? 1 : 2;          // big, small
  // a stage: X's chunk [kWBx][ld] (split as it is read), Y's chunk parts
  // [kBy][ld], then 4·kBy floats of per-entity values
  static constexpr int kStageBytes =
      static_cast<int>(sizeof(T)) * (kWBx + kYParts * kBy) * ld + 16 * kBy;
  static constexpr int ldo = kBf ? kWCols + 8 : kWCols + 4;  // own columns
  static constexpr int kOwnBytes =
      static_cast<int>(sizeof(T)) * kYParts * kBy * ldo;
};

constexpr int wide_fwd_smem(bool bf) {
  return kWFwdStages * (bf ? Wide<true, kWFwdBy>::kStageBytes
                           : Wide<false, kWFwdBy>::kStageBytes);
}
constexpr int wide_bwd_smem(bool bf) {
  return bf ? kWBwdStages * Wide<true, kWBwdBy>::kStageBytes +
                  Wide<true, kWBwdBy>::kOwnBytes
            : kWBwdStages * Wide<false, kWBwdBy>::kStageBytes +
                  Wide<false, kWBwdBy>::kOwnBytes;
}

// Rows [e0, e0 + kN) x columns [k0, k0 + cols) of src [n_src, d] into dst
// (row stride ld), zero past n_src and past d, by 16-byte cp.async over
// the block (d % 8 == 0: a 16-byte piece is in or out whole).
template <int kN, int cols, int ld, typename T>
__device__ __forceinline__ void wide_stage(T* dst, const T* src, int e0,
                                           int n_src, int k0, int d) {
  constexpr int kE = 16 / static_cast<int>(sizeof(T));   // elements a piece
  constexpr int kP = cols / kE;                          // pieces a row
  for (int v = threadIdx.x; v < kN * kP; v += kWThreads) {
    const int e = v / kP, c = (v % kP) * kE;
    const bool ok = e0 + e < n_src && k0 + c < d;
    cp_async16(reinterpret_cast<float*>(dst + e * ld + c),
               reinterpret_cast<const float*>(
                   ok ? src + (size_t)(e0 + e) * d + k0 + c : src),
               ok);
  }
}

// K4 past d 256: ce_fwd_kernel's function over steps of kWKc columns.
template <bool kBf>
__global__ void __launch_bounds__(kWThreads, 2)
ce_fwd_wide_kernel(const FwdArgs a) {
  using W = Wide<kBf, kWFwdBy>;
  using T = typename W::T;
  constexpr int kBy = kWFwdBy;
  constexpr int kNy = kBy / 8;
  constexpr int ld = W::ld;
  constexpr int kStages = kWFwdStages;
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int x0 = blockIdx.x * kWBx;
  const int y_tiles = (a.V + kBy - 1) / kBy;
  const int per = (y_tiles + gridDim.y - 1) / gridDim.y;
  const int t_begin = min(y_tiles, (int)blockIdx.y * per);
  const int n_tiles = min(y_tiles, t_begin + per) - t_begin;
  const int nkc = (a.d + kWKc - 1) / kWKc;
  const int n_steps = n_tiles * nkc;

  const int xa = x0 + warp * 16 + g;
  int xtg[1][2];
  float rm[1][2], rs[1][2], tl[1][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int x = xa + 8 * r;
    xtg[0][r] = x < a.n_x ? a.tgt[x] : -1;
    rm[0][r] = -1e30f;
    rs[0][r] = tl[0][r] = 0.f;
  }
  const T* xsrc;
  const T* ybig;
  if constexpr (kBf) {
    xsrc = a.xh;
    ybig = a.yh;
  } else {
    xsrc = a.x;
    ybig = a.y_big;
  }
  // step: X's and Y's chunk c of tile t_begin + step / nkc, and at its last
  // chunk the tile's biases
  auto stage = [&](int slot, int step) {
    T* st = reinterpret_cast<T*>(ring + slot * W::kStageBytes);
    const int y0 = (t_begin + step / nkc) * kBy;
    const int c = step % nkc;
    wide_stage<kWBx, kWKc, ld>(st, xsrc, x0, a.n_x, c * kWKc, a.d);
    wide_stage<kBy, kWKc, ld>(st + kWBx * ld, ybig, y0, a.V, c * kWKc, a.d);
    if constexpr (!kBf)
      wide_stage<kBy, kWKc, ld>(st + (kWBx + kBy) * ld, a.y_small, y0, a.V,
                                c * kWKc, a.d);
    if (c == nkc - 1) {
      float* bias =
          reinterpret_cast<float*>(st + (kWBx + W::kYParts * kBy) * ld);
      for (int e = threadIdx.x; e < kBy; e += kWThreads) {
        const bool ok = y0 + e < a.V;
        cp_async4(bias + e, ok ? a.b + y0 + e : a.b, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) stage(s, s);
    cp_async_commit();
  }
  float s[1][kNy][4];
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (step + kStages - 1 < n_steps)
      stage((step + kStages - 1) % kStages, step + kStages - 1);
    cp_async_commit();
    const T* st =
        reinterpret_cast<const T*>(ring + (step % kStages) * W::kStageBytes);
    const T* xw = st + (warp * 16 + g) * ld + t;
    const T* yb = st + kWBx * ld;
    const T* ys = yb + kBy * ld;
    const int c = step % nkc;
    if (c == 0) {
      logit_steps<kWKc, 1, kNy>(s, 0, xw, yb, ys, g, t);
    } else {
      float p[1][kNy][4];
      logit_steps<kWKc, 1, kNy>(p, 0, xw, yb, ys, g, t);
#pragma unroll
      for (int j = 0; j < kNy; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[0][j][i] += p[0][j][i];
    }
    if (c == nkc - 1)
      fwd_tile<kBase, 1, kNy, kBf>(
          s, reinterpret_cast<const float*>(st + (kWBx + W::kYParts * kBy) * ld),
          (t_begin + step / nkc) * kBy, a.V, xtg, rm, rs, tl, t);
  }
  cp_async_wait<0>();
  fwd_partials<kBase, 1>(rm, rs, tl, a.part, a.n_x, xa, t);
}

// K5 past d 2,048: ce_bwd_kernel's function over steps of kWKc columns, the
// output columns of part blockIdx.z (kWCols of them) a block.
template <bool kRowsX, bool kBf>
__global__ void __launch_bounds__(kWThreads, 2)
ce_bwd_wide_kernel(const BwdArgs a) {
  using W = Wide<kBf, kWBwdBy>;
  using T = typename W::T;
  constexpr int kBy = kWBwdBy;
  constexpr int kNy = kBy / 8;
  constexpr int kNo = kWCols / 8;
  constexpr int ld = W::ld;
  constexpr int ldo = W::ldo;
  constexpr int kStages = kWBwdStages;
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  T* own = reinterpret_cast<T*>(ring + kStages * W::kStageBytes);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int x0 = blockIdx.x * kWBx;
  const int y_tiles = (a.n_y + kBy - 1) / kBy;
  const int per = (y_tiles + gridDim.y - 1) / gridDim.y;
  const int t_begin = min(y_tiles, (int)blockIdx.y * per);
  const int n_tiles = min(y_tiles, t_begin + per) - t_begin;
  const int nkc = (a.d + kWKc - 1) / kWKc;
  const int n_steps = n_tiles * nkc;
  const int col0 = blockIdx.z * kWCols;

  const int xa = x0 + warp * 16 + g;
  float xl[1][2], xg[1][2], xt[1][2], xb[1][2];
  int xtg[1][2];
  bool xok[1][2];
  x_values<1, kRowsX, kBf>(a, xa, xl, xg, xt, xb, xtg, xok);
  const T* xsrc;
  const T* ybig;
  if constexpr (kBf) {
    xsrc = a.xh;
    ybig = a.yh;
  } else {
    xsrc = a.x;
    ybig = a.y_big;
  }
  auto stage = [&](int slot, int step) {
    T* st = reinterpret_cast<T*>(ring + slot * W::kStageBytes);
    const int y0 = (t_begin + step / nkc) * kBy;
    const int c = step % nkc;
    wide_stage<kWBx, kWKc, ld>(st, xsrc, x0, a.n_x, c * kWKc, a.d);
    wide_stage<kBy, kWKc, ld>(st + kWBx * ld, ybig, y0, a.n_y, c * kWKc,
                              a.d);
    if constexpr (!kBf)
      wide_stage<kBy, kWKc, ld>(st + (kWBx + kBy) * ld, a.y_small, y0,
                                a.n_y, c * kWKc, a.d);
    if (c == nkc - 1)
      stage_info<kBy, kRowsX, kWThreads>(
          reinterpret_cast<float*>(st + (kWBx + W::kYParts * kBy) * ld), a,
          y0);
  };
  // the tile's own columns [col0, col0 + kWCols) of Y, for the second
  // product; issued with a tile's first step, after every warp has left
  // the previous tile's product (nkc >= kStages: complete by its last step)
  auto stage_own = [&](int tile) {
    const int y0 = tile * kBy;
    wide_stage<kBy, kWCols, ldo>(own, ybig, y0, a.n_y, col0, a.d);
    if constexpr (!kBf)
      wide_stage<kBy, kWCols, ldo>(own + kBy * ldo, a.y_small, y0, a.n_y,
                                   col0, a.d);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) {
      if (s == 0) stage_own(t_begin);
      stage(s, s);
    }
    cp_async_commit();
  }
  float o[1][kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[0][n][i] = 0.f;
  float dbs[1][2] = {};
  float s[1][kNy][4];
  for (int step = 0; step < n_steps; ++step) {
    const int c = step % nkc;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (c == 0 && step > 0) stage_own(t_begin + step / nkc);
    if (step + kStages - 1 < n_steps)
      stage((step + kStages - 1) % kStages, step + kStages - 1);
    cp_async_commit();
    const T* st =
        reinterpret_cast<const T*>(ring + (step % kStages) * W::kStageBytes);
    const T* xw = st + (warp * 16 + g) * ld + t;
    const T* yb = st + kWBx * ld;
    const T* ys = yb + kBy * ld;
    if (c == 0) {
      logit_steps<kWKc, 1, kNy>(s, 0, xw, yb, ys, g, t);
    } else {
      float p[1][kNy][4];
      logit_steps<kWKc, 1, kNy>(p, 0, xw, yb, ys, g, t);
#pragma unroll
      for (int j = 0; j < kNy; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[0][j][i] += p[0][j][i];
    }
    if (c == nkc - 1) {
      const float* inf = reinterpret_cast<const float*>(
          st + (kWBx + W::kYParts * kBy) * ld);
      dlogits<1, kNy, kBy, kRowsX, kBf>(
          s, inf, (t_begin + step / nkc) * kBy, a.n_y, xa, xl, xg, xt, xb,
          xtg, xok, dbs, t);
      add_py<1, kNy, kNo, ldo, kBf>(o, s, own, own + kBy * ldo, 0, g, t);
    }
  }
  cp_async_wait<0>();
  bwd_write<1, kNo, kRowsX>(o, dbs, a, xa, col0, a.d, blockIdx.z == 0,
                            t);
}

// The widest d that K4's and K5's resident-X kernels take; wider rows run
// the wide kernels (K5 between 256 and 2,048 the cluster kernels of
// ce_cluster.cu, by the port's route).
constexpr int kResident = 256;

template <int DT, bool kBf = false>
cudaError_t prepare() {
  constexpr int kSmem = Tile<DT, kBf>::kSmem;
  const cudaFuncAttribute at = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(ce_fwd_kernel<DT, kBase, kBf>, at,
                                         kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ce_bwd_kernel<DT, true, kBf>, at, kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ce_bwd_kernel<DT, false, kBf>, at, kSmem);
  return err;
}

// The resident kernels' blocks an SM at width DT: K5's dh kernel's (its
// plans), or K4's (fwd: K4's plans).
template <int DT, bool kBf>
cudaError_t resident_per_sm(int* per_sm, bool fwd) {
  const cudaError_t err = prepare<DT, kBf>();
  if (err != cudaSuccess) return err;
  return fwd ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   per_sm, ce_fwd_kernel<DT, kBase, kBf>,
                   BwdCfg<DT>::kThreads, Tile<DT, kBf>::kSmem)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   per_sm, ce_bwd_kernel<DT, true, kBf>,
                   BwdCfg<DT>::kThreads, Tile<DT, kBf>::kSmem);
}

template <bool kBf>
cudaError_t prepare_d(int d) {
  return d <= 64    ? prepare<64, kBf>()
         : d <= 128 ? prepare<128, kBf>()
                    : prepare<256, kBf>();
}

template <int DT, bool kBf>
cudaError_t launch_fwd(const FwdArgs& a, int splits, cudaStream_t s) {
  const dim3 grid((a.n_x + BwdCfg<DT>::kBx - 1) / BwdCfg<DT>::kBx, splits);
  ce_fwd_kernel<DT, kBase, kBf>
      <<<grid, BwdCfg<DT>::kThreads, Tile<DT, kBf>::kSmem, s>>>(a);
  return cudaGetLastError();
}

// K4 at the narrowest width DT >= d that is instantiated (d <= kResident).
template <bool kBf>
cudaError_t launch_fwd_d(const FwdArgs& a, int splits, cudaStream_t s) {
  return a.d <= 64    ? launch_fwd<64, kBf>(a, splits, s)
         : a.d <= 128 ? launch_fwd<128, kBf>(a, splits, s)
                      : launch_fwd<256, kBf>(a, splits, s);
}

template <int DT, bool kBf>
cudaError_t launch_bwd(const BwdArgs& a, int splits, cudaStream_t s,
                       bool rows_x) {
  const dim3 grid((a.n_x + BwdCfg<DT>::kBx - 1) / BwdCfg<DT>::kBx, splits);
  constexpr int kThreads = BwdCfg<DT>::kThreads;
  constexpr int kSmem = Tile<DT, kBf>::kSmem;
  if (rows_x)
    ce_bwd_kernel<DT, true, kBf><<<grid, kThreads, kSmem, s>>>(a);
  else
    ce_bwd_kernel<DT, false, kBf><<<grid, kThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}

// K5's pass at the narrowest width DT >= d that is instantiated (d <=
// kResident).
template <bool kBf>
cudaError_t launch_bwd_d(const BwdArgs& a, int splits, cudaStream_t s,
                         bool rows_x) {
  return a.d <= 64    ? launch_bwd<64, kBf>(a, splits, s, rows_x)
         : a.d <= 128 ? launch_bwd<128, kBf>(a, splits, s, rows_x)
                      : launch_bwd<256, kBf>(a, splits, s, rows_x);
}

// The wide kernels' shared memory; once per device.
template <bool kBf>
cudaError_t prepare_wide() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  const cudaFuncAttribute at = cudaFuncAttributeMaxDynamicSharedMemorySize;
  err = cudaFuncSetAttribute(ce_fwd_wide_kernel<kBf>, at, wide_fwd_smem(kBf));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ce_bwd_wide_kernel<true, kBf>, at,
                               wide_bwd_smem(kBf));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ce_bwd_wide_kernel<false, kBf>, at,
                               wide_bwd_smem(kBf));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <bool kBf>
cudaError_t slots(int design, int d, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (design == 0 || design == 3) {
    if (d > kResident) return cudaErrorInvalidValue;
    const bool fwd = design == 3;
    err = d <= 64    ? resident_per_sm<64, kBf>(&per_sm, fwd)
          : d <= 128 ? resident_per_sm<128, kBf>(&per_sm, fwd)
                     : resident_per_sm<256, kBf>(&per_sm, fwd);
  } else {
    err = prepare_wide<kBf>();
    if (err == cudaSuccess)
      err = design == 1
                ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, ce_fwd_wide_kernel<kBf>, kWThreads,
                      wide_fwd_smem(kBf))
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, ce_bwd_wide_kernel<true, kBf>, kWThreads,
                      wide_bwd_smem(kBf));
  }
  *out = sms * (per_sm < 1 ? 1 : per_sm);
  return err;
}

template <bool kBf>
cudaError_t launch_fwd_any(const FwdArgs& a, int splits, cudaStream_t s) {
  cudaError_t err;
  if (a.d <= kResident) {
    err = prepare_d<kBf>(a.d);
    return err == cudaSuccess ? launch_fwd_d<kBf>(a, splits, s) : err;
  }
  err = prepare_wide<kBf>();
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_x + kWBx - 1) / kWBx, splits);
  ce_fwd_wide_kernel<kBf><<<grid, kWThreads, wide_fwd_smem(kBf), s>>>(a);
  return cudaGetLastError();
}

// A backward pass by the resident kernels (d <= kResident) or (wide, or
// any wider d) the wide ones, whose parts need a tile's own columns staged
// a step ahead: d > kWKc.
template <bool kBf>
cudaError_t launch_bwd_any(const BwdArgs& a, int splits, bool wide,
                           cudaStream_t s, bool rows_x) {
  cudaError_t err;
  if (!wide && a.d <= kResident) {
    err = prepare_d<kBf>(a.d);
    return err == cudaSuccess ? launch_bwd_d<kBf>(a, splits, s, rows_x) : err;
  }
  if (a.d <= kWKc) return cudaErrorInvalidValue;
  err = prepare_wide<kBf>();
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_x + kWBx - 1) / kWBx, splits,
                  (a.d + kWCols - 1) / kWCols);
  if (rows_x)
    ce_bwd_wide_kernel<true, kBf>
        <<<grid, kWThreads, wide_bwd_smem(kBf), s>>>(a);
  else
    ce_bwd_wide_kernel<false, kBf>
        <<<grid, kWThreads, wide_bwd_smem(kBf), s>>>(a);
  return cudaGetLastError();
}

// K5 by the resident kernels up to kResident and the wide ones above, or
// (wide) the wide ones at any width.
template <bool kBf>
int bwd(const float* h, const void* w, int w_bf16, const float* b,
        const float* lse, const float* dlse, const float* dt, const int* tgt,
        float* dh, float* dw, float* db, float* workspace, bool wide,
        int split_h, int split_w, int N, int d, int V, cudaStream_t s) {
  return static_cast<int>(bwd_passes<kBf>(
      h, w, w_bf16, b, lse, dlse, dt, tgt, dh, dw, db, workspace, split_h,
      split_w, N, d, V, s, [&](const BwdArgs& a, int splits, bool rows_x) {
        return launch_bwd_any<kBf>(a, splits, wide, s, rows_x);
      }));
}

}  // namespace

// The blocks resident at once on the device (SMs times blocks an SM) of
// the kernels a plan fills in whole waves (ops/fused_ce_cuda.py): design 0
// K5's resident kernels at width d (d <= 256), 1 K4's wide kernel, 2 K5's
// wide kernels, 3 K4's resident kernel at width d; bf16 the bf16
// instantiations'.  Into *out; returns a CUDA error code (0 = answered).
extern "C" int ce_slots(int design, int d, int bf16, int* out) {
  return static_cast<int>(bf16 ? slots<true>(design, d, out)
                               : slots<false>(design, d, out));
}

// h [N, d], w [d, V] row-major, b [V] (-1e9 on padded columns), pad [N],
// tgt [N] -> lse [N], tlog [N], by the resident kernels up to d 256 and the
// wide one above, the vocab split over `splits` blocks.  workspace: Wᵀ's
// TF32 split (2·V·d floats), then the splits' partials (3 · splits · N).
// All pointers 16-byte aligned; d % 8 == 0, V % 4 == 0.  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int ce_fwd_f32(const float* h, const float* w, const float* b,
                          const float* pad, const int* tgt, float* lse,
                          float* tlog, float* workspace, int splits, int N,
                          int d, int V, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t vd = (size_t)V * d;
  float* wt_big = workspace;
  float* wt_small = wt_big + vd;
  float* part = wt_small + vd;
  cudaError_t err = transpose_split(w, nullptr, wt_big, wt_small, d, V, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FwdArgs a{h, wt_big, wt_small, b, tgt, part, N, d, V};
  err = launch_fwd_any<false>(a, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_fwd_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(part, pad, splits, N,
                                                      lse, tlog);
  return static_cast<int>(cudaGetLastError());
}

// K4's bf16 instantiation: ce_fwd_f32's function with every logit a sum of
// exact products of bf16-rounded h and W (fused_ce.py's _dot), in f32.  w
// [d, V] is f32 (w_bf16 0) or bf16 (w_bf16 1: two bytes an element, read
// once by the pre-pass).  workspace: h and Wᵀ in bf16 ((N + V)·d / 2
// floats), then the splits' partials (3 · splits · N).  Pointers 16-byte
// aligned; d % 8 == 0, V % 4 == 0.  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int ce_fwd_bf16(const float* h, const void* w, const float* b,
                           const float* pad, const int* tgt, float* lse,
                           float* tlog, float* workspace, int w_bf16,
                           int splits, int N, int d, int V, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint16_t* hb = reinterpret_cast<uint16_t*>(workspace);
  uint16_t* wtb = hb + (size_t)N * d;
  float* part = reinterpret_cast<float*>(wtb + (size_t)V * d);
  cudaError_t err = bf16_operands(h, w, w_bf16, hb, wtb, N, d, V, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  FwdArgs a{};
  a.b = b; a.tgt = tgt; a.part = part; a.n_x = N; a.d = d; a.V = V;
  a.xh = hb; a.yh = wtb;
  err = launch_fwd_any<true>(a, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_fwd_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(part, pad, splits, N,
                                                      lse, tlog);
  return static_cast<int>(cudaGetLastError());
}

// The backward from the forward's inputs, its lse and the gradients dlse,
// dt of (lse, tlog): dh [N, d], dw [d, V], db [V], by the resident kernels
// up to d 256 and the wide ones above, split_h vocab splits of the dh pass
// and split_w row splits of the dW pass.  workspace as ce_bwd.cuh's
// bwd_passes: Wᵀ and its TF32 split (3·V·d floats), h's split (2·N·d),
// then, where a pass has more than one split, its partials: split_h·N·d
// floats for dh, split_w·(d + 1)·V for dW and db.  All pointers 16-byte
// aligned; d % 8 == 0, V % 4 == 0.  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int ce_bwd_f32(const float* h, const float* w, const float* b,
                          const float* lse, const float* dlse,
                          const float* dt, const int* tgt, float* dh,
                          float* dw, float* db, float* workspace, int split_h,
                          int split_w, int N, int d, int V, void* stream) {
  return bwd<false>(h, w, 0, b, lse, dlse, dt, tgt, dh, dw, db, workspace,
                    false, split_h, split_w, N, d, V,
                    static_cast<cudaStream_t>(stream));
}

// ce_bwd_f32 by the wide kernels at any d > 32: the wide design timed
// beside the others (chip_smoke.py phase_ce_wide).
extern "C" int ce_bwd_wide_f32(const float* h, const float* w,
                               const float* b, const float* lse,
                               const float* dlse, const float* dt,
                               const int* tgt, float* dh, float* dw,
                               float* db, float* workspace, int split_h,
                               int split_w, int N, int d, int V,
                               void* stream) {
  return bwd<false>(h, w, 0, b, lse, dlse, dt, tgt, dh, dw, db, workspace,
                    true, split_h, split_w, N, d, V,
                    static_cast<cudaStream_t>(stream));
}

// K5's bf16 instantiation: ce_bwd_f32's function from bf16-rounded h and
// W (w [d, V] f32, or bf16 where w_bf16), the dlogits rounded to bf16
// before both products and db their f32 sum (fused_ce.py's backward
// kernels); dw comes out f32 (the caller casts it to W's dtype).
// workspace: h and Wᵀ in bf16 ((N + V)·d / 2 floats), then the partials
// as ce_bwd_f32's.  Pointers 16-byte aligned; d % 8 == 0, V % 4 == 0.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int ce_bwd_bf16(const float* h, const void* w, const float* b,
                           const float* lse, const float* dlse,
                           const float* dt, const int* tgt, float* dh,
                           float* dw, float* db, float* workspace, int w_bf16,
                           int split_h, int split_w, int N, int d, int V,
                           void* stream) {
  return bwd<true>(h, w, w_bf16, b, lse, dlse, dt, tgt, dh, dw, db,
                   workspace, false, split_h, split_w, N, d, V,
                   static_cast<cudaStream_t>(stream));
}
