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
// plans, chains and merges, so they too are bitwise repeatable.  As each
// dlogit is rounded to bf16, K5's bf16 instantiation sums the logits with
// compensation (ce_fwd.cuh, logit_tile), computes each softmax value as the
// plain version does (expf(logit - lse)) and adds each Y tile's products to
// its output in f32 (dlogits, add_py): at d 40-1,024 it lies as near
// float64 as the plain bf16 CE or nearer (PERF.md §6).

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

// The dlogits of logit tile s in place, for this thread's fragment rows
// (X entities xa + 16·m + 8·r) and Y entities y0 + e: kRowsX (the dh pass)
// dlse·softmax + dt·onehot(target) from each row's lse (xl: log2 units, or
// natural in the bf16 instantiations), dlse (xg), dt (xt) and target (xtg)
// and the tile's biases (inf[e]); else (the dW pass) from the tile's rows'
// lse, dlse, dt and targets (inf [4][kBy]) and each vocab entry's bias xb,
// adding them into the db sums dbs.  Zero outside the X and Y ranges.
// Element i of n-tile j of m-tile m is X entity xa + 16·m + 8·(i >> 1), Y
// entity y0 + 8·j + 2·t + (i & 1).
//
// kBf: the bf16 instantiations round each dlogit to bf16, so an error of a
// few f32 ulps in it moves a dlogit that lies near a rounding boundary by
// a bf16 ulp (2^-8 of itself).  There the softmax is expf(logit - lse),
// the plain version's order of operations: exp2_approx of the log2-scaled
// argument adds the rounding of lse·log2(e) and ex2.approx's own error,
// about 2-3x the plain version's error in each softmax value (K5 lay
// further from float64 than the plain bf16 CE on 132 of 200 seeds, an
// H100, PERF.md §6).
template <int kMt, int kNy, int kBy, bool kRowsX, bool kBf>
__device__ __forceinline__ void dlogits(
    float (&s)[kMt][kNy][4], const float* inf, int y0, int n_y, int xa,
    const float (&xl)[kMt][2], const float (&xg)[kMt][2],
    const float (&xt)[kMt][2], const float (&xb)[kMt][2],
    const int (&xtg)[kMt][2], const bool (&xok)[kMt][2],
    float (&dbs)[kMt][2], int t) {
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
          if (kBf)
            p = xg[m][r] * expf((s[m][j][i] + inf[e]) - xl[m][r]);
          else
            p = xg[m][r] *
                exp2_approx(fmaf(s[m][j][i] + inf[e], kLog2e, -xl[m][r]));
          if (y == xtg[m][r]) p += xt[m][r];
        } else {
          if (kBf)
            p = inf[kBy + e] * expf((s[m][j][i] + xb[m][r]) - inf[e]);
          else
            p = inf[kBy + e] *
                exp2_approx((s[m][j][i] + xb[m][r] - inf[e]) * kLog2e);
          if (xa + 16 * m + 8 * r ==
              reinterpret_cast<const int*>(inf)[3 * kBy + e])
            p += inf[2 * kBy + e];
        }
        p = (xok[m][r] && y < n_y) ? p : 0.f;
        if (!kRowsX) dbs[m][r] += p;
        s[m][j][i] = p;
      }
    }
  }
}

// o += P · Y[:, col .. col + 8·kNo): [16·kMt x 8·kNo], k over the tile's
// 8·kNy entities, P the dlogits in s (C layout) and Y's rows of stride ld
// in yb (ys: their TF32 remainders).  The C fragment of S is the A
// fragment with k permuted (t <-> 2t, t+4 <-> 2t+1), and B is read with
// the same permutation; kNb n-tiles of B at a time.  kBf: P rounded to
// bf16, one MMA a k-step, each tile's sum added to o in f32.
template <int kMt, int kNy, int kNo, int ld, bool kBf, typename T>
__device__ __forceinline__ void add_py(float (&o)[kMt][kNo][4],
                                       const float (&s)[kMt][kNy][4],
                                       const T* yb, const T* ys, int col,
                                       int g, int t) {
  constexpr int kNb = 4;               // output n-tiles a batch of B loads
  if constexpr (kBf) {
    // the tile's products summed in a zeroed accumulator, then added to o
    // in f32: the accumulator's adds truncate, and o summed a split's
    // whole chain in it (kMaxChain columns or kMaxRowChain rows), which
    // left K5's bf16 dh 4.0e-6 (median over 200 seeds) of its largest
    // element from float64 where the plain bf16 CE lies 1.2e-6 (an H100,
    // PERF.md §6)
    uint32_t ab[kMt][kNy][4];
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int j = 0; j < kNy; ++j) {
        ab[m][j][0] = round_bf16(s[m][j][0]);
        ab[m][j][1] = round_bf16(s[m][j][2]);
        ab[m][j][2] = round_bf16(s[m][j][1]);
        ab[m][j][3] = round_bf16(s[m][j][3]);
      }
#pragma unroll
    for (int n0 = 0; n0 < kNo; n0 += kNb) {
      float p[kMt][kNb][4];
#pragma unroll
      for (int j = 0; j < kNy; ++j) {
        const int row = (j * 8 + 2 * t) * ld + col + g;
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
          for (int n = 0; n < kNb; ++n) {
            if (j == 0)
              mma_tf32_zero(p[m][n], ab[m][j], bb[n]);
            else
              mma_tf32(p[m][n], ab[m][j], bb[n]);
          }
      }
#pragma unroll
      for (int m = 0; m < kMt; ++m)
#pragma unroll
        for (int n = 0; n < kNb; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[m][n0 + n][i] += p[m][n][i];
    }
  } else {
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
      const int row = (j * 8 + 2 * t) * ld + col + g;
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
}

// Each output element of this thread's fragments once (X entity xa + 16·m
// + 8·(i >> 1), column col0 + 8·n + 2·t + (i & 1), below d), into the
// split's partial; the dW pass's part 0 also writes its db sums.
template <int kMt, int kNo, bool kRowsX>
__device__ __forceinline__ void bwd_write(const float (&o)[kMt][kNo][4],
                                          float (&dbs)[kMt][2],
                                          const BwdArgs& a, int xa, int col0,
                                          int t) {
  float* out = a.out + (size_t)blockIdx.y * a.out_split;
#pragma unroll
  for (int m = 0; m < kMt; ++m) {
#pragma unroll
    for (int n = 0; n < kNo; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = xa + 16 * m + 8 * (i >> 1);
        const int k = col0 + n * 8 + 2 * t + (i & 1);
        if (x < a.n_x && k < a.d)
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

// The X entities' values of this thread's fragment rows xa + 16·m + 8·r:
// lse times log2(e) (kBf: lse), dlse, dt and the target of a row (kRowsX),
// or the bias of a vocab entry; xok where in range.
template <int kMt, bool kRowsX, bool kBf>
__device__ __forceinline__ void x_values(const BwdArgs& a, int xa,
                                         float (&xl)[kMt][2],
                                         float (&xg)[kMt][2],
                                         float (&xt)[kMt][2],
                                         float (&xb)[kMt][2],
                                         int (&xtg)[kMt][2],
                                         bool (&xok)[kMt][2]) {
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
          xl[m][r] = kBf ? a.lse[x] : a.lse[x] * kLog2e;
          xg[m][r] = a.dlse[x];
          xt[m][r] = a.dt[x];
          xtg[m][r] = a.tgt[x];
        } else {
          xb[m][r] = a.b[x];
        }
      }
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
    add_py<kMt, kNy, kNo, ld, kBf>(o, s, yb, ys, col0, g, t);
  }
  cp_async_wait<0>();
  bwd_write<kMt, kNo, kRowsX>(o, dbs, a, xa, col0, t);
}

// ----------------------------------------------------- K4/K5 past d 512 ----
//
// The resident-X tiles above stop at DT 512: 64 X rows of d + 4 floats
// are 132 KB there and 263 KB at d 1,024, and K5 holds its output in
// registers, a warp's 16 rows x 256 columns at most.  K5 runs its wide
// kernels above d 512 (kBwdResident), K4 above d 256 (kFwdResident), where
// its resident tile would compute at DT 512 whatever d.  The wide kernels take
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
// fewer-rows alternative (P through shared memory, more warps over the
// columns) halves the recompute and is left to a later redesign.  The
// chains are the narrow kernels': K5's plans cap a split at kMaxChain vocab
// columns and kMaxRowChain rows, merged in f32, no atomics, bitwise across
// launches.  bf16 (kBf): X and Y bf16 rows as in the narrow kernels.
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

// K4 past d 512: ce_fwd_kernel's function over steps of kWKc columns.
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
      fwd_tile<kBase, 1, kNy>(
          s, reinterpret_cast<const float*>(st + (kWBx + W::kYParts * kBy) * ld),
          (t_begin + step / nkc) * kBy, a.V, xtg, rm, rs, tl, t);
  }
  cp_async_wait<0>();
  fwd_partials<kBase, 1>(rm, rs, tl, a.part, a.n_x, xa, t);
}

// K5 past d 512: ce_bwd_kernel's function over steps of kWKc columns, the
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
  bwd_write<1, kNo, kRowsX>(o, dbs, a, xa, col0, t);
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

// The widest d that K4's and K5's resident-X kernels take; wider rows run
// the wide kernels.  K4's wide kernel is the faster one above d 256 (its
// DT 512 resident tile computes every width up to 512 at the cost of 512);
// K5's resident kernels stay faster up to d 512 (PERF.md §6).
constexpr int kFwdResident = 256;
constexpr int kBwdResident = 512;

template <int DT, bool kBf = false>
cudaError_t prepare() {
  constexpr int kSmem = Tile<DT, kBf>::kSmem;
  const cudaFuncAttribute at = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaSuccess;
  if constexpr (DT <= kFwdResident)
    err = cudaFuncSetAttribute(ce_fwd_kernel<DT, kBase, kBf>, at, kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ce_bwd_kernel<DT, true, kBf>, at, kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ce_bwd_kernel<DT, false, kBf>, at, kSmem);
  return err;
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

// K4 at the narrowest width DT >= d that is instantiated (d <=
// kFwdResident).
template <bool kBf>
cudaError_t launch_fwd_d(const FwdArgs& a, int splits, cudaStream_t s) {
  return a.d <= 64    ? launch_fwd<64, kBf>(a, splits, s)
         : a.d <= 128 ? launch_fwd<128, kBf>(a, splits, s)
                      : launch_fwd<256, kBf>(a, splits, s);
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

// The wide kernels' plans, as plan's: K4's vocab splits, or K5's dh vocab
// splits and dW row splits, under the same chain limits.
template <bool kBf>
int plan_wide(int N, int d, int V, bool forward, int* splits) {
  cudaError_t err = prepare_wide<kBf>();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (forward)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ce_fwd_wide_kernel<kBf>, kWThreads, wide_fwd_smem(kBf));
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ce_bwd_wide_kernel<true, kBf>, kWThreads,
        wide_bwd_smem(kBf));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = sms * (per_sm < 1 ? 1 : per_sm);
  // a tile's MMA work at an assumed 1 TFLOP/s of TF32 per SM (the L2 reads
  // bound these kernels at about half the resident ones' rate)
  constexpr double kFlops = kBf ? 2.0 : 6.0;
  const int x_tiles = (N + kWBx - 1) / kWBx;
  if (forward) {
    splits[0] = best_splits(x_tiles, (V + kWFwdBy - 1) / kWFwdBy, slots,
                            kFlops * d * kWBx * kWFwdBy / 1e6, 12.0 * N);
    return 0;
  }
  const int parts = (d + kWCols - 1) / kWCols;
  const double tile_us = kFlops * (d + kWCols) * kWBx * kWBwdBy / 1e6;
  splits[0] = best_splits(parts * x_tiles, (V + kWBwdBy - 1) / kWBwdBy,
                          slots, tile_us, 4.0 * N * d,
                          (V + kMaxChain - 1) / kMaxChain);
  constexpr int kRowTiles = kMaxRowChain / kWBwdBy;
  const int n_tiles = (N + kWBwdBy - 1) / kWBwdBy;
  splits[1] = best_splits(parts * ((V + kWBx - 1) / kWBx), n_tiles, slots,
                          tile_us, 4.0 * (d + 1) * V,
                          (n_tiles + kRowTiles - 1) / kRowTiles);
  return 0;
}

// K4's plan: the resident kernels' up to kFwdResident, else the wide one's.
template <bool kBf>
int plan_fwd(int N, int d, int V, int* splits) {
  return d <= kFwdResident ? plan_d<kBf>(N, d, V, true, splits)
                           : plan_wide<kBf>(N, d, V, true, splits);
}

// K5's plan, of the resident kernels (d <= kBwdResident) or the wide ones.
template <bool kBf>
int plan_bwd(int N, int d, int V, bool wide, int* splits) {
  if (wide) return plan_wide<kBf>(N, d, V, false, splits);
  if (d > kBwdResident) return static_cast<int>(cudaErrorInvalidValue);
  return plan_d<kBf>(N, d, V, false, splits);
}

template <bool kBf>
cudaError_t launch_fwd_any(const FwdArgs& a, int splits, cudaStream_t s) {
  cudaError_t err;
  if (a.d <= kFwdResident) {
    err = prepare_d<kBf>(a.d);
    return err == cudaSuccess ? launch_fwd_d<kBf>(a, splits, s) : err;
  }
  err = prepare_wide<kBf>();
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_x + kWBx - 1) / kWBx, splits);
  ce_fwd_wide_kernel<kBf><<<grid, kWThreads, wide_fwd_smem(kBf), s>>>(a);
  return cudaGetLastError();
}

// A backward pass by the resident or the wide kernel (the wide one's parts
// need a tile's own columns staged a step ahead: d > kWKc).
template <bool kBf>
cudaError_t launch_bwd_any(const BwdArgs& a, int splits, bool wide,
                           cudaStream_t s, bool rows_x) {
  cudaError_t err;
  if (!wide) {
    if (a.d > kBwdResident) return cudaErrorInvalidValue;
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

// The f32 backward (ce_bwd_f32) by the resident kernels or (wide) the wide
// ones.
int bwd_f32(const float* h, const float* w, const float* b, const float* lse,
            const float* dlse, const float* dt, const int* tgt, float* dh,
            float* dw, float* db, float* workspace, bool wide, int split_h,
            int split_w, int N, int d, int V, cudaStream_t s) {
  const size_t vd = (size_t)V * d, nd = (size_t)N * d;
  float* wt = workspace;
  float* wt_big = wt + vd;
  float* wt_small = wt_big + vd;
  float* h_big = wt_small + vd;
  float* h_small = h_big + nd;
  float* part_h = h_small + nd;
  float* part_w = part_h + (split_h > 1 ? (size_t)split_h * nd : 0);
  float* part_b = part_w + (size_t)split_w * vd;

  cudaError_t err = transpose_split(w, wt, wt_big, wt_small, d, V, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  split_kernel<<<stride_blocks(nd / 4), 256, 0, s>>>(h, nd, h_big, h_small);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // dh: X = h rows, Y = Wᵀ rows; partial [split][N][d]
  BwdArgs a{h, wt_big, wt_small, b, lse, dlse, dt, tgt,
            split_h > 1 ? part_h : dh, nullptr, nd, d, 1, N, V, d, V};
  err = launch_bwd_any<false>(a, split_h, wide, s, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split_h > 1) {
    err = merge(part_h, split_h, (size_t)N * d, dh, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  // dW, db: X = Wᵀ rows, Y = h rows; partials [split][d][V] and [split][V]
  BwdArgs c{wt, h_big, h_small, b, lse, dlse, dt, tgt,
            split_w > 1 ? part_w : dw, split_w > 1 ? part_b : db, vd, 1, V, V,
            N, d, V};
  err = launch_bwd_any<false>(c, split_w, wide, s, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split_w > 1) {
    err = merge(part_w, split_w, (size_t)d * V, dw, s);
    if (err == cudaSuccess) err = merge(part_b, split_w, (size_t)V, db, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// The forward's vocab splits for N rows, width d and V columns (splits[0]):
// of the resident kernels up to d 256, of the wide one above.  Returns a
// CUDA error code (0 = planned).
extern "C" int ce_fwd_plan(int N, int d, int V, int* splits) {
  return plan_fwd<false>(N, d, V, splits);
}

// The bf16 instantiation's (ce_fwd_bf16) vocab splits.
extern "C" int ce_fwd_plan_bf16(int N, int d, int V, int* splits) {
  return plan_fwd<true>(N, d, V, splits);
}

// h [N, d], w [d, V] row-major, b [V] (-1e9 on padded columns), pad [N],
// tgt [N] -> lse [N], tlog [N].  workspace: Wᵀ's TF32 split (2·V·d floats),
// then the splits' partials (3 · splits · N).  All pointers 16-byte aligned;
// d % 8 == 0, V % 4 == 0.  Returns cudaGetLastError() after the launches (0
// = launched).
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

// The backward's split counts for N rows, width d and V columns: splits[0]
// of V for the dh kernel, splits[1] of N for the dW/db kernel, of the
// resident kernels up to d 512, of the wide ones above.  Returns a CUDA
// error code (0 = planned).
extern "C" int ce_bwd_plan(int N, int d, int V, int* splits) {
  return plan_bwd<false>(N, d, V, d > kBwdResident, splits);
}

// The bf16 instantiation's (ce_bwd_bf16) split counts.
extern "C" int ce_bwd_plan_bf16(int N, int d, int V, int* splits) {
  return plan_bwd<true>(N, d, V, d > kBwdResident, splits);
}

// The backward from the forward's inputs, its lse and the gradients dlse,
// dt of (lse, tlog): dh [N, d], dw [d, V], db [V].  workspace: Wᵀ and its
// TF32 split (3·V·d floats), h's split (2·N·d), then, where a pass has more
// than one split, its partials: splits[0]·N·d floats for dh,
// splits[1]·(d + 1)·V for dW and db.  All pointers 16-byte aligned;
// d % 8 == 0, V % 4 == 0.  Returns cudaGetLastError() after the launches (0
// = launched).
extern "C" int ce_bwd_f32(const float* h, const float* w, const float* b,
                          const float* lse, const float* dlse,
                          const float* dt, const int* tgt, float* dh,
                          float* dw, float* db, float* workspace, int split_h,
                          int split_w, int N, int d, int V, void* stream) {
  return bwd_f32(h, w, b, lse, dlse, dt, tgt, dh, dw, db, workspace,
                 d > kBwdResident, split_h, split_w, N, d, V,
                 static_cast<cudaStream_t>(stream));
}

// ce_bwd_plan and ce_bwd_f32 by the wide kernels at any d > 32, d <= 512
// included: the two designs timed side by side (chip_smoke.py
// phase_ce_wide).  The port's backward takes ce_bwd_f32.
extern "C" int ce_bwd_plan_wide(int N, int d, int V, int* splits) {
  return plan_bwd<false>(N, d, V, true, splits);
}

extern "C" int ce_bwd_wide_f32(const float* h, const float* w,
                               const float* b, const float* lse,
                               const float* dlse, const float* dt,
                               const int* tgt, float* dh, float* dw,
                               float* db, float* workspace, int split_h,
                               int split_w, int N, int d, int V,
                               void* stream) {
  return bwd_f32(h, w, b, lse, dlse, dt, tgt, dh, dw, db, workspace, true,
                 split_h, split_w, N, d, V,
                 static_cast<cudaStream_t>(stream));
}

// K5's bf16 instantiation: ce_bwd_f32's function from bf16-rounded h and
// W (w [d, V] f32, or bf16 where w_bf16), the dlogits rounded to bf16
// before both products and db their f32 sum (fused_ce.py's backward
// kernels); dw comes out f32 (the caller casts it to W's dtype).
// workspace: h and Wᵀ in bf16 ((N + V)·d / 2 floats), then, where a pass
// has more than one split, its partials: splits[0]·N·d floats for dh,
// splits[1]·(d + 1)·V for dW and db.  Pointers 16-byte aligned; d % 8 ==
// 0, V % 4 == 0.  Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int ce_bwd_bf16(const float* h, const void* w, const float* b,
                           const float* lse, const float* dlse,
                           const float* dt, const int* tgt, float* dh,
                           float* dw, float* db, float* workspace, int w_bf16,
                           int split_h, int split_w, int N, int d, int V,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = d > kBwdResident;
  const size_t vd = (size_t)V * d, nd = (size_t)N * d;
  uint16_t* hb = reinterpret_cast<uint16_t*>(workspace);
  uint16_t* wtb = hb + nd;
  float* part_h = reinterpret_cast<float*>(wtb + vd);
  float* part_w = part_h + (split_h > 1 ? (size_t)split_h * nd : 0);
  float* part_b = part_w + (size_t)split_w * vd;
  cudaError_t err = bf16_operands(h, w, w_bf16, hb, wtb, N, d, V, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // dh: X = h rows, Y = Wᵀ rows; partial [split][N][d]
  BwdArgs a{nullptr, nullptr, nullptr, b, lse, dlse, dt, tgt,
            split_h > 1 ? part_h : dh, nullptr, nd, d, 1, N, V, d, V,
            hb, wtb};
  err = launch_bwd_any<true>(a, split_h, wide, s, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split_h > 1) {
    err = merge(part_h, split_h, nd, dh, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  // dW, db: X = Wᵀ rows, Y = h rows; partials [split][d][V] and [split][V]
  BwdArgs c{nullptr, nullptr, nullptr, b, lse, dlse, dt, tgt,
            split_w > 1 ? part_w : dw, split_w > 1 ? part_b : db, vd, 1, V,
            V, N, d, V, wtb, hb};
  err = launch_bwd_any<true>(c, split_w, wide, s, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split_w > 1) {
    err = merge(part_w, split_w, vd, dw, s);
    if (err == cudaSuccess) err = merge(part_b, split_w, (size_t)V, db, s);
  }
  return static_cast<int>(err);
}
