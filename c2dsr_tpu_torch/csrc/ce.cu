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
// backward's products keep a chain of at most kMaxChain vocab columns (dh)
// or kMaxRowChain rows (dW) in it a split, the splits' partials added in
// f32 by a merge.  Over one 10,240-row chain dW ended 3.67e-5 of its
// largest element from float64, where cuBLAS's f32 ends 2.5e-6
// (tests/test_torch_tf32.py emulates both schemes).
//
// K4 and the tile machinery both kernels share live in ce_fwd.cuh.
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
// blocks in whole waves (ce_fwd_plan), and ce_fwd_merge_kernel merges the
// splits in split order and folds in the pad-class logit, as _fwd_kernel
// does at its last vocab block: no atomics, and two launches on the same
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
//   16; up to d 512, 4 warps, 64 X rows and Y tiles of 8, with the output
//   columns split over two blocks (ce_fwd.cuh, BwdCfg).  A warp computes
//   S = X_w·Y_tileᵀ, turns it into dlogits in registers, and adds P·Y_tile
//   into its [rows x d] output in registers.
//   A pre-pass writes Wᵀ [V, d] and the TF32 split of Wᵀ and of h (about
//   0.05 ms at FK shapes): each Y element is split once, not once per warp
//   and product (the splits were the largest share of the instructions),
//   and X and dlogits are split as they are read, in two integer
//   operations and a subtraction.  The width is a compile-time DT (64,
//   128, 256 or 512; columns past d are zero, so any d % 4 == 0 up to DT
//   works), so the unrolled loops carry no branch, and shared rows are
//   padded to DT + 4 floats, so every fragment load is free of bank
//   conflicts.
// * Copy ring: Y tiles, big and small parts (and, per tile, the bias or
//   the per-row lse, dlse, dt, target) arrive by cp.async in a ring of 2
//   stages (3 at d <= 64), so the next tile loads while this one is
//   multiplied; one barrier a tile.
// * Two kernels, no atomics.  The grid is X tiles x splits of Y, the split
//   count chosen (ce_bwd_plan) to fill the SMs in whole waves; each split
//   writes its partial of dh (or dW, db) once, and a small kernel sums the
//   partials in split order.  One fused pass would need dh (N·d) on chip
//   or atomics; here every output element is written once, in a fixed
//   order: two launches on the same inputs give bitwise-equal results.
//
// The bf16 instantiations (ce_fwd_bf16, ce_bwd_bf16; compute_dtype=
// "bfloat16" or a bf16 classifier) compute the Pallas kernels' numerics:
// every product of bf16-rounded h, W and dlogits, summed in f32 (_dot and
// the backward's products in fused_ce.py).  A pre-pass writes h and Wᵀ in
// bf16 (W read once, f32 rounded or bf16 as it is), the kernels stage the
// bf16 rows (ce_fwd.cuh, Tile) and take one TF32 MMA of the widened values
// a k-step, exact for bf16 operands, where 3xTF32 takes three; the same
// plans, chains and merges, so they too are bitwise repeatable.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ce_fwd.cuh"

namespace {

// ---------------------------------------------------------------- K5 ----

// What a backward pass reads and where it writes.  Rows are the N rows of
// h, columns the V vocab entries; X is the resident operand, Y the
// streamed one, split once into its TF32 part and remainder by a pre-pass
// (kRowsX: X = h, Y = Wᵀ; else X = Wᵀ, Y = h).
struct BwdArgs {
  const float* x;
  const float* y_big;
  const float* y_small;
  const float* b;       // [V] masked bias
  const float* lse;     // [N]
  const float* dlse;    // [N]
  const float* dt;      // [N]
  const int* tgt;       // [N]
  float* out;           // partial (x, k) at out + split·out_split + x·sx + k·sk
  float* db;            // dW pass: db partial at db + split·V + x
  size_t out_split;
  int sx, sk;
  int n_x, n_y, d, V;
  const uint16_t* xh;   // the bf16 instantiations' X and Y, bf16 rows (x,
  const uint16_t* yh;   // y_big, y_small unused)
};

// The per-entity values of Y tile y0 (info [4][kBy]): the bias of its
// vocab entries (dh pass), or lse, dlse, dt and the target of its rows.
template <int kBy, bool kRowsX, int kThreads>
__device__ __forceinline__ void stage_info(float* info, const BwdArgs& a,
                                           int y0) {
  if (kRowsX) {
    for (int e = threadIdx.x; e < kBy; e += kThreads) {
      const bool ok = y0 + e < a.V;
      cp_async4(info + e, ok ? a.b + y0 + e : a.b, ok);
    }
  } else {
    for (int c = threadIdx.x; c < 4 * kBy; c += kThreads) {
      const int which = c / kBy;
      const int e = c % kBy;
      const float* src = which == 0 ? a.lse : which == 1 ? a.dlse
                         : which == 2 ? a.dt
                                      : reinterpret_cast<const float*>(a.tgt);
      const bool ok = y0 + e < a.n_y;
      cp_async4(info + c, ok ? src + y0 + e : src, ok);
    }
  }
}

// One backward pass (the dh kernel for kRowsX, else the dW/db kernel) over
// X tile blockIdx.x, the Y tiles of split blockIdx.y and, at DT 512, the
// output columns of part blockIdx.z; kBf: the bf16 instantiation
// (ce_fwd.cuh, Tile).
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
  constexpr int kNo = BwdCfg<DT>::kCols / 8;  // n-tiles of the output
  constexpr int kNb = 4;               // output n-tiles a batch of B loads
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
  // the first output column of this block's part
  const int col0 = BwdCfg<DT>::kParts > 1 ? blockIdx.z * BwdCfg<DT>::kCols
                                          : 0;

  // the X entities of this thread's fragment rows, xa + 16·m + 8·r: lse
  // times log2(e), dlse, dt and the target of a row (kRowsX), or the bias
  // of a vocab entry
  const int xa = x0 + warp * 16 * kMt + g;
  float xl[kMt][2], xg[kMt][2], xt[kMt][2], xb[kMt][2];
  int xtg[kMt][2];
  bool xok[kMt][2];
#pragma unroll
  for (int m = 0; m < kMt; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int x = xa + 16 * m + 8 * r;
      xok[m][r] = x < a.n_x;
      xl[m][r] = xg[m][r] = xt[m][r] = xb[m][r] = 0.f;
      xtg[m][r] = -1;
      if (xok[m][r]) {
        if (kRowsX) {
          xl[m][r] = a.lse[x] * kLog2e;
          xg[m][r] = a.dlse[x];
          xt[m][r] = a.dt[x];
          xtg[m][r] = a.tgt[x];
        } else {
          xb[m][r] = a.b[x];
        }
      }
    }
  }

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

    // dlogits in place: element i of n-tile j of m-tile m is X entity
    // xa + 16·m + 8·(i >> 1), Y entity y0 + 8·j + 2·t + (i & 1)
#pragma unroll
    for (int m = 0; m < kMt; ++m) {
#pragma unroll
      for (int j = 0; j < kNy; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int e = j * 8 + 2 * t + (i & 1);
          const int y = y0 + e;
          float p;
          if (kRowsX) {
            p = xg[m][r] *
                exp2_approx(fmaf(s[m][j][i] + inf[e], kLog2e, -xl[m][r]));
            if (y == xtg[m][r]) p += xt[m][r];
          } else {
            p = inf[kBy + e] *
                exp2_approx((s[m][j][i] + xb[m][r] - inf[e]) * kLog2e);
            if (xa + 16 * m + 8 * r ==
                reinterpret_cast<const int*>(inf)[3 * kBy + e])
              p += inf[2 * kBy + e];
          }
          p = (xok[m][r] && y < a.n_y) ? p : 0.f;
          if (!kRowsX) dbs[m][r] += p;
          s[m][j][i] = p;
        }
      }
    }

    // out_w += P · Y_tile[:, col0 .. col0 + kCols): [16·kMt x kCols], k
    // over the tile's kBy entities;
    // the C fragment of S is the A fragment with k permuted (t <-> 2t,
    // t+4 <-> 2t+1), and B is read with the same permutation; kNb n-tiles
    // of B at a time.  bf16: P rounded to bf16, one MMA a tile.
    if constexpr (kBf) {
#pragma unroll
      for (int j = 0; j < kNy; ++j) {
        uint32_t ab[kMt][4];
#pragma unroll
        for (int m = 0; m < kMt; ++m) {
          ab[m][0] = round_bf16(s[m][j][0]);
          ab[m][1] = round_bf16(s[m][j][2]);
          ab[m][2] = round_bf16(s[m][j][1]);
          ab[m][3] = round_bf16(s[m][j][3]);
        }
        const int row = (j * 8 + 2 * t) * ld + col0 + g;
#pragma unroll
        for (int n0 = 0; n0 < kNo; n0 += kNb) {
          uint32_t bb[kNb][2];
#pragma unroll
          for (int n = 0; n < kNb; ++n) {
            const int at = row + (n0 + n) * 8;
            bb[n][0] = widen_bf16(yb[at]);
            bb[n][1] = widen_bf16(yb[at + ld]);
          }
#pragma unroll
          for (int m = 0; m < kMt; ++m)
#pragma unroll
            for (int n = 0; n < kNb; ++n) mma_tf32(o[m][n0 + n], ab[m], bb[n]);
        }
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < kNy; ++j) {
      uint32_t ab[kMt][4], as[kMt][4];
#pragma unroll
      for (int m = 0; m < kMt; ++m) {
        split_tf32(s[m][j][0], ab[m][0], as[m][0]);
        split_tf32(s[m][j][2], ab[m][1], as[m][1]);
        split_tf32(s[m][j][1], ab[m][2], as[m][2]);
        split_tf32(s[m][j][3], ab[m][3], as[m][3]);
      }
      const int row = (j * 8 + 2 * t) * ld + col0 + g;
#pragma unroll
      for (int n0 = 0; n0 < kNo; n0 += kNb) {
        uint32_t bb[kNb][2], bs[kNb][2];
#pragma unroll
        for (int n = 0; n < kNb; ++n) {
          const int at = row + (n0 + n) * 8;
          bb[n][0] = __float_as_uint(yb[at]);
          bb[n][1] = __float_as_uint(yb[at + ld]);
          bs[n][0] = __float_as_uint(ys[at]);
          bs[n][1] = __float_as_uint(ys[at + ld]);
        }
#pragma unroll
        for (int m = 0; m < kMt; ++m)
#pragma unroll
          for (int n = 0; n < kNb; ++n) mma_tf32(o[m][n0 + n], as[m], bb[n]);
#pragma unroll
        for (int m = 0; m < kMt; ++m)
#pragma unroll
          for (int n = 0; n < kNb; ++n) mma_tf32(o[m][n0 + n], ab[m], bs[n]);
#pragma unroll
        for (int m = 0; m < kMt; ++m)
#pragma unroll
          for (int n = 0; n < kNb; ++n) mma_tf32(o[m][n0 + n], ab[m], bb[n]);
      }
    }
  }
  cp_async_wait<0>();

  // each output element once: C fragment (X entity xa + 16·m + 8·(i >> 1),
  // column col0 + 8·n + 2·t + (i & 1))
  float* out = a.out + (size_t)blockIdx.y * a.out_split;
#pragma unroll
  for (int m = 0; m < kMt; ++m) {
#pragma unroll
    for (int n = 0; n < kNo; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = xa + 16 * m + 8 * (i >> 1);
        const int k = col0 + n * 8 + 2 * t + (i & 1);
        if (x < a.n_x && k < d)
          out[(size_t)x * a.sx + (size_t)k * a.sk] = o[m][n][i];
      }
    }
  }
  if (!kRowsX && blockIdx.z == 0) {     // every part has the same db
#pragma unroll
    for (int m = 0; m < kMt; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = dbs[m][r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int x = xa + 16 * m + 8 * r;
        if (t == 0 && x < a.n_x) a.db[(size_t)blockIdx.y * a.V + x] = v;
      }
    }
  }
}

// big[i], small[i]: the TF32 split of x[i], i < n (n % 4 == 0).
__global__ void split_kernel(const float* __restrict__ x, size_t n,
                             float* __restrict__ big,
                             float* __restrict__ small) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n / 4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    uint32_t b[4], s[4];
    split_tf32(v.x, b[0], s[0]);
    split_tf32(v.y, b[1], s[1]);
    split_tf32(v.z, b[2], s[2]);
    split_tf32(v.w, b[3], s[3]);
    reinterpret_cast<float4*>(big)[i] =
        make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                    __uint_as_float(b[2]), __uint_as_float(b[3]));
    reinterpret_cast<float4*>(small)[i] =
        make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                    __uint_as_float(s[2]), __uint_as_float(s[3]));
  }
}

// dst[i] = sum over splits s, in order, of part[s][i]; n % 4 == 0.
__global__ void ce_merge_kernel(const float* __restrict__ part, int splits,
                                size_t n, float* __restrict__ dst) {
  const size_t n4 = n / 4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float4 v = reinterpret_cast<const float4*>(part + (size_t)s * n)[i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    reinterpret_cast<float4*>(dst)[i] = acc;
  }
}

// The split count of one pass over X tiles x Y tiles that takes the least
// estimated time: whole waves of `slots` resident blocks, each Y tile
// costing tile_us, plus the merge's read of every split's partial (out_bytes
// each, at about 3 TB/s); at least min_splits where there are as many Y
// tiles.
int best_splits(int x_tiles, int y_tiles, int slots, double tile_us,
                double out_bytes, int min_splits = 1) {
  const int lo = min_splits < y_tiles ? min_splits : y_tiles;
  const int hi = min_splits > 128 ? min_splits : 128;
  int best = lo;
  double best_us = 1e30;
  for (int s = lo; s <= y_tiles && s <= hi; ++s) {
    const int per = (y_tiles + s - 1) / s;
    const int used = (y_tiles + per - 1) / per;
    if (used != s) continue;                  // an empty split: same as used
    const int waves = (x_tiles * s + slots - 1) / slots;
    const double us = waves * per * tile_us +
                      (s > 1 ? s * out_bytes / 3e6 : 0.0);
    if (us < best_us) {
      best_us = us;
      best = s;
    }
  }
  return best;
}

template <int DT, bool kBf = false>
cudaError_t prepare() {
  constexpr int kSmem = Tile<DT, kBf>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      ce_fwd_kernel<DT, kBase, kBf>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ce_bwd_kernel<DT, true, kBf>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ce_bwd_kernel<DT, false, kBf>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmem);
}

// The longest vocab chain of K5's dh kernel a split, in columns.  FK's
// plans stay under it at d 128 (13 and 33 splits of 2,368 and 1,120
// columns); at V 501,760 the plan took 33 splits of 15,232 columns, and dh
// lay 1.76e-4 of its largest element from float64 where the plain f32
// version lies 1.9e-5 (an H100, the composed step at 1M item rows).
constexpr int kMaxChain = 2560;

// The longest row chain of K5's dW/db kernel a split, in rows.  Its output
// sums a split's rows in one tensor-core accumulator; at the port's
// --kernels shape (N 10,240, V 65,536) the plan took one split, and dW lay
// 3.67e-5 of its largest element from float64 (an H100).  Emulated on those
// inputs, chains of 2,560 rows end 1.1e-5 from float64 and chains of 1,280
// 4.1e-6 (tests/test_torch_tf32.py).
constexpr int kMaxRowChain = 1280;

// The vocab splits of K4 (splits[0]), or of K5's dh kernel (splits[0]) and
// the row splits of its dW/db kernel (splits[1]); kBf: of the bf16
// instantiations.
template <int DT, bool kBf = false>
int plan(int N, int d, int V, bool forward, int* splits) {
  cudaError_t err = prepare<DT, kBf>();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ce_bwd_kernel<DT, true, kBf>, BwdCfg<DT>::kThreads,
      Tile<DT, kBf>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = sms * (per_sm < 1 ? 1 : per_sm);
  constexpr int kBx = BwdCfg<DT>::kBx;
  constexpr int kBy = BwdCfg<DT>::kBy;
  constexpr int kParts = BwdCfg<DT>::kParts;
  // a tile's MMA work at an assumed 2 TFLOP/s of TF32 per SM: one product
  // (three TF32 terms, or one of bf16 operands) in K4; in K5 the logits and
  // a part's share of the second product
  constexpr double kFlops = kBf ? 2.0 : 6.0;
  const double tile_us =
      (forward ? kFlops * DT : kFlops * (DT + BwdCfg<DT>::kCols)) * kBx *
      kBy / 2e6;
  if (forward) {
    splits[0] = best_splits((N + kBx - 1) / kBx, (V + kBy - 1) / kBy, slots,
                            tile_us, 12.0 * N);
    return 0;
  }
  // dh sums a split's vocab columns in one tensor-core accumulator, whose
  // adds truncate: once the target's column has put dt·w_target into it,
  // every later MMA drops part of an ulp of that, so the error grows with
  // the chain.  A split takes at most kMaxChain columns; ce_merge_kernel adds
  // the splits' partials in f32
  splits[0] = best_splits(kParts * ((N + kBx - 1) / kBx), (V + kBy - 1) / kBy,
                          slots, tile_us, 4.0 * N * d,
                          (V + kMaxChain - 1) / kMaxChain);
  // dW the same over its rows: at most kMaxRowChain rows a split
  constexpr int kRowTiles = kMaxRowChain / kBy;
  const int n_tiles = (N + kBy - 1) / kBy;
  splits[1] = best_splits(kParts * ((V + kBx - 1) / kBx), n_tiles, slots,
                          tile_us, 4.0 * (d + 1) * V,
                          (n_tiles + kRowTiles - 1) / kRowTiles);
  return 0;
}

template <bool kBf>
int plan_d(int N, int d, int V, bool forward, int* splits) {
  return d <= 64    ? plan<64, kBf>(N, d, V, forward, splits)
         : d <= 128 ? plan<128, kBf>(N, d, V, forward, splits)
         : d <= 256 ? plan<256, kBf>(N, d, V, forward, splits)
                    : plan<512, kBf>(N, d, V, forward, splits);
}

template <bool kBf>
cudaError_t prepare_d(int d) {
  return d <= 64    ? prepare<64, kBf>()
         : d <= 128 ? prepare<128, kBf>()
         : d <= 256 ? prepare<256, kBf>()
                    : prepare<512, kBf>();
}

template <int DT, bool kBf>
cudaError_t launch_fwd(const FwdArgs& a, int splits, cudaStream_t s) {
  const dim3 grid((a.n_x + BwdCfg<DT>::kBx - 1) / BwdCfg<DT>::kBx, splits);
  ce_fwd_kernel<DT, kBase, kBf>
      <<<grid, BwdCfg<DT>::kThreads, Tile<DT, kBf>::kSmem, s>>>(a);
  return cudaGetLastError();
}

// K4 at the narrowest width DT >= d that is instantiated.
template <bool kBf>
cudaError_t launch_fwd_d(const FwdArgs& a, int splits, cudaStream_t s) {
  return a.d <= 64    ? launch_fwd<64, kBf>(a, splits, s)
         : a.d <= 128 ? launch_fwd<128, kBf>(a, splits, s)
         : a.d <= 256 ? launch_fwd<256, kBf>(a, splits, s)
                      : launch_fwd<512, kBf>(a, splits, s);
}

template <int DT, bool kBf>
cudaError_t launch_bwd(const BwdArgs& a, int splits, cudaStream_t s,
                       bool rows_x) {
  const dim3 grid((a.n_x + BwdCfg<DT>::kBx - 1) / BwdCfg<DT>::kBx, splits,
                  BwdCfg<DT>::kParts);
  constexpr int kThreads = BwdCfg<DT>::kThreads;
  constexpr int kSmem = Tile<DT, kBf>::kSmem;
  if (rows_x)
    ce_bwd_kernel<DT, true, kBf><<<grid, kThreads, kSmem, s>>>(a);
  else
    ce_bwd_kernel<DT, false, kBf><<<grid, kThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}

// The pass at the narrowest width DT >= d that is instantiated.
template <bool kBf>
cudaError_t launch_bwd_d(const BwdArgs& a, int splits, cudaStream_t s,
                         bool rows_x) {
  return a.d <= 64    ? launch_bwd<64, kBf>(a, splits, s, rows_x)
         : a.d <= 128 ? launch_bwd<128, kBf>(a, splits, s, rows_x)
         : a.d <= 256 ? launch_bwd<256, kBf>(a, splits, s, rows_x)
                      : launch_bwd<512, kBf>(a, splits, s, rows_x);
}

// Blocks of 256 threads for a grid-stride loop over n4 items.
int stride_blocks(size_t n4) {
  const size_t want = (n4 + 255) / 256;
  return static_cast<int>(want < 4096 ? want : 4096);
}

cudaError_t merge(const float* part, int splits, size_t n, float* dst,
                  cudaStream_t s) {
  ce_merge_kernel<<<stride_blocks(n / 4), 256, 0, s>>>(part, splits, n, dst);
  return cudaGetLastError();
}

cudaError_t transpose_split(const float* w, float* wt, float* wt_big,
                            float* wt_small, int d, int V, cudaStream_t s) {
  transpose_split_kernel<<<dim3((V + 31) / 32, (d + 31) / 32), dim3(32, 8), 0,
                           s>>>(w, wt, wt_big, wt_small, d, V);
  return cudaGetLastError();
}

// The bf16 instantiations' pre-pass: h [N, d] rounded into hb, W [d, V]
// (f32, or bf16 where w_bf16) into bf16 Wᵀ [V, d].
cudaError_t bf16_operands(const float* h, const void* w, int w_bf16,
                          uint16_t* hb, uint16_t* wtb, int N, int d, int V,
                          cudaStream_t s) {
  const size_t nd = (size_t)N * d;
  round_bf16_kernel<<<stride_blocks(nd / 4), 256, 0, s>>>(h, nd, hb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((V + 31) / 32, (d + 31) / 32);
  if (w_bf16)
    transpose_bf16_kernel<<<grid, dim3(32, 8), 0, s>>>(
        static_cast<const uint16_t*>(w), wtb, d, V);
  else
    transpose_bf16_kernel<<<grid, dim3(32, 8), 0, s>>>(
        static_cast<const float*>(w), wtb, d, V);
  return cudaGetLastError();
}

}  // namespace

// The forward's vocab splits for N rows, width d and V columns (splits[0]).
// Returns a CUDA error code (0 = planned).
extern "C" int ce_fwd_plan(int N, int d, int V, int* splits) {
  return plan_d<false>(N, d, V, true, splits);
}

// The bf16 instantiation's (ce_fwd_bf16) vocab splits.
extern "C" int ce_fwd_plan_bf16(int N, int d, int V, int* splits) {
  return plan_d<true>(N, d, V, true, splits);
}

// h [N, d], w [d, V] row-major, b [V] (-1e9 on padded columns), pad [N],
// tgt [N] -> lse [N], tlog [N].  workspace: Wᵀ's TF32 split (2·V·d floats),
// then the splits' partials (3 · splits · N).  All pointers 16-byte aligned;
// d % 4 == 0, d <= 512, V % 4 == 0.  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int ce_fwd_f32(const float* h, const float* w, const float* b,
                          const float* pad, const int* tgt, float* lse,
                          float* tlog, float* workspace, int splits, int N,
                          int d, int V, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = prepare_d<false>(d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t vd = (size_t)V * d;
  float* wt_big = workspace;
  float* wt_small = wt_big + vd;
  float* part = wt_small + vd;
  err = transpose_split(w, nullptr, wt_big, wt_small, d, V, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FwdArgs a{h, wt_big, wt_small, b, tgt, part, N, d, V};
  err = launch_fwd_d<false>(a, splits, s);
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
// aligned; d % 8 == 0, d <= 512, V % 4 == 0.  Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int ce_fwd_bf16(const float* h, const void* w, const float* b,
                           const float* pad, const int* tgt, float* lse,
                           float* tlog, float* workspace, int w_bf16,
                           int splits, int N, int d, int V, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = prepare_d<true>(d);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint16_t* hb = reinterpret_cast<uint16_t*>(workspace);
  uint16_t* wtb = hb + (size_t)N * d;
  float* part = reinterpret_cast<float*>(wtb + (size_t)V * d);
  err = bf16_operands(h, w, w_bf16, hb, wtb, N, d, V, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  FwdArgs a{};
  a.b = b; a.tgt = tgt; a.part = part; a.n_x = N; a.d = d; a.V = V;
  a.xh = hb; a.yh = wtb;
  err = launch_fwd_d<true>(a, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_fwd_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(part, pad, splits, N,
                                                      lse, tlog);
  return static_cast<int>(cudaGetLastError());
}

// The backward's split counts for N rows, width d and V columns: splits[0]
// of V for the dh kernel, splits[1] of N for the dW/db kernel.  Returns a
// CUDA error code (0 = planned).
extern "C" int ce_bwd_plan(int N, int d, int V, int* splits) {
  return plan_d<false>(N, d, V, false, splits);
}

// The bf16 instantiation's (ce_bwd_bf16) split counts.
extern "C" int ce_bwd_plan_bf16(int N, int d, int V, int* splits) {
  return plan_d<true>(N, d, V, false, splits);
}

// The backward from the forward's inputs, its lse and the gradients dlse,
// dt of (lse, tlog): dh [N, d], dw [d, V], db [V].  workspace: Wᵀ and its
// TF32 split (3·V·d floats), h's split (2·N·d), then, where a pass has more
// than one split, its partials: splits[0]·N·d floats for dh,
// splits[1]·(d + 1)·V for dW and db.  All pointers 16-byte aligned;
// d % 4 == 0, d <= 512, V % 4 == 0.  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int ce_bwd_f32(const float* h, const float* w, const float* b,
                          const float* lse, const float* dlse,
                          const float* dt, const int* tgt, float* dh,
                          float* dw, float* db, float* workspace, int split_h,
                          int split_w, int N, int d, int V, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = prepare_d<false>(d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t vd = (size_t)V * d, nd = (size_t)N * d;
  float* wt = workspace;
  float* wt_big = wt + vd;
  float* wt_small = wt_big + vd;
  float* h_big = wt_small + vd;
  float* h_small = h_big + nd;
  float* part_h = h_small + nd;
  float* part_w = part_h + (split_h > 1 ? (size_t)split_h * nd : 0);
  float* part_b = part_w + (size_t)split_w * vd;

  err = transpose_split(w, wt, wt_big, wt_small, d, V, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  split_kernel<<<stride_blocks(nd / 4), 256, 0, s>>>(h, nd, h_big, h_small);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // dh: X = h rows, Y = Wᵀ rows; partial [split][N][d]
  BwdArgs a{h, wt_big, wt_small, b, lse, dlse, dt, tgt,
            split_h > 1 ? part_h : dh, nullptr, nd, d, 1, N, V, d, V};
  err = launch_bwd_d<false>(a, split_h, s, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split_h > 1) {
    err = merge(part_h, split_h, (size_t)N * d, dh, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  // dW, db: X = Wᵀ rows, Y = h rows; partials [split][d][V] and [split][V]
  BwdArgs c{wt, h_big, h_small, b, lse, dlse, dt, tgt,
            split_w > 1 ? part_w : dw, split_w > 1 ? part_b : db, vd, 1, V, V,
            N, d, V};
  err = launch_bwd_d<false>(c, split_w, s, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split_w > 1) {
    err = merge(part_w, split_w, (size_t)d * V, dw, s);
    if (err == cudaSuccess) err = merge(part_b, split_w, (size_t)V, db, s);
  }
  return static_cast<int>(err);
}

// K5's bf16 instantiation: ce_bwd_f32's function from bf16-rounded h and
// W (w [d, V] f32, or bf16 where w_bf16), the dlogits rounded to bf16
// before both products and db their f32 sum (fused_ce.py's backward
// kernels); dw comes out f32 (the caller casts it to W's dtype).
// workspace: h and Wᵀ in bf16 ((N + V)·d / 2 floats), then, where a pass
// has more than one split, its partials: splits[0]·N·d floats for dh,
// splits[1]·(d + 1)·V for dW and db.  Pointers 16-byte aligned; d % 8 ==
// 0, d <= 512, V % 4 == 0.  Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int ce_bwd_bf16(const float* h, const void* w, const float* b,
                           const float* lse, const float* dlse,
                           const float* dt, const int* tgt, float* dh,
                           float* dw, float* db, float* workspace, int w_bf16,
                           int split_h, int split_w, int N, int d, int V,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = prepare_d<true>(d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t vd = (size_t)V * d, nd = (size_t)N * d;
  uint16_t* hb = reinterpret_cast<uint16_t*>(workspace);
  uint16_t* wtb = hb + nd;
  float* part_h = reinterpret_cast<float*>(wtb + vd);
  float* part_w = part_h + (split_h > 1 ? (size_t)split_h * nd : 0);
  float* part_b = part_w + (size_t)split_w * vd;
  err = bf16_operands(h, w, w_bf16, hb, wtb, N, d, V, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // dh: X = h rows, Y = Wᵀ rows; partial [split][N][d]
  BwdArgs a{nullptr, nullptr, nullptr, b, lse, dlse, dt, tgt,
            split_h > 1 ? part_h : dh, nullptr, nd, d, 1, N, V, d, V,
            hb, wtb};
  err = launch_bwd_d<true>(a, split_h, s, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split_h > 1) {
    err = merge(part_h, split_h, nd, dh, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  // dW, db: X = Wᵀ rows, Y = h rows; partials [split][d][V] and [split][V]
  BwdArgs c{nullptr, nullptr, nullptr, b, lse, dlse, dt, tgt,
            split_w > 1 ? part_w : dw, split_w > 1 ? part_b : db, vd, 1, V,
            V, N, d, V, wtb, hb};
  err = launch_bwd_d<true>(c, split_w, s, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split_w > 1) {
    err = merge(part_w, split_w, vd, dw, s);
    if (err == cudaSuccess) err = merge(part_b, split_w, (size_t)V, db, s);
  }
  return static_cast<int>(err);
}
