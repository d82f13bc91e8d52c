// K5's machinery shared by its designs: the narrow and wide kernels in
// ce.cu and the cluster kernel in ce_cluster.cu (what a pass reads, the
// dlogits, the second product, the writes), and the pre-passes and split
// merges of both translation units.  ce.cu's head comment describes K5;
// ce_cluster.cu's the cluster design past d 256.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "ce_fwd.cuh"

namespace {

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
// in yb (ys: their TF32 remainders).  f32: the C fragment of S is the A
// fragment with k permuted (t <-> 2t, t+4 <-> 2t+1), and B is read with
// the same permutation; kNb n-tiles of B at a time.  kBf: P rounded to
// bf16 and packed in pairs, two adjacent n-tiles of S's C layout being the
// A fragment of one m16n8k16 step as they lie (no permutation), Y read
// transposed by ldmatrix (lane l gives entity 8·(l / 8 % 2) + l % 8 at
// column 8·(l / 16): matrices 0-3 are B's two k8 halves of two output
// n-tiles), one bf16 MMA a k16 step and pair of n-tiles, each tile's sum
// added to o in f32.
template <int kMt, int kNy, int kNo, int ld, bool kBf, typename T>
__device__ __forceinline__ void add_py(float (&o)[kMt][kNo][4],
                                       const float (&s)[kMt][kNy][4],
                                       const T* yb, const T* ys, int col,
                                       int g, int t) {
  // output n-tiles a batch of B loads (the cluster kernel's slices of
  // 160 and 224 columns give a warp 10 and 14)
  constexpr int kNb = kNo % 4 == 0 ? 4 : kNo % 2 == 0 ? 2 : 1;
  if constexpr (kBf) {
    // the tile's products summed in a zeroed accumulator, then added to o
    // in f32: the accumulator's adds truncate, and o summed a split's
    // whole chain in it (MAX_CHAIN columns or MAX_ROW_CHAIN rows), which
    // left K5's bf16 dh 4.0e-6 (median over 200 seeds) of its largest
    // element from float64 where the plain bf16 CE lies 1.2e-6 (an H100,
    // PERF.md §6)
    static_assert(kNy % 2 == 0 && kNo % 2 == 0, "pairs of n-tiles");
    static_assert((ld * 2) % 32 == 16, "ldmatrix phases free of bank "
                  "conflicts (ce_fwd.cuh logit_steps)");
    uint32_t ap[kMt][kNy / 2][4];
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int J = 0; J < kNy / 2; ++J) {
        ap[m][J][0] = pack_bf16(s[m][2 * J][0], s[m][2 * J][1]);
        ap[m][J][1] = pack_bf16(s[m][2 * J][2], s[m][2 * J][3]);
        ap[m][J][2] = pack_bf16(s[m][2 * J + 1][0], s[m][2 * J + 1][1]);
        ap[m][J][3] = pack_bf16(s[m][2 * J + 1][2], s[m][2 * J + 1][3]);
      }
    const int lane = 4 * g + t;
    const T* yl = yb + (8 * ((lane >> 3) & 1) + (lane & 7)) * ld + col +
                  8 * (lane >> 4);
#pragma unroll
    for (int n0 = 0; n0 < kNo; n0 += 2) {
      float p[kMt][2][4];
#pragma unroll
      for (int J = 0; J < kNy / 2; ++J) {
        uint32_t b[4];
        ldsm_x4<true>(b, yl + 16 * J * ld + 8 * n0);
#pragma unroll
        for (int m = 0; m < kMt; ++m) {
          if (J == 0) {
            mma_bf16_zero(p[m][0], ap[m][J], b[0], b[1]);
            mma_bf16_zero(p[m][1], ap[m][J], b[2], b[3]);
          } else {
            mma_bf16(p[m][0], ap[m][J], b[0], b[1]);
            mma_bf16(p[m][1], ap[m][J], b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kMt; ++m)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[m][n0 + q][i] += p[m][q][i];
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
// + 8·(i >> 1), column col0 + 8·n + 2·t + (i & 1), below col_end), into
// the split's partial; in the dW pass, where write_db (one warp of the
// block's rows, warp-uniform), also its db sums.
template <int kMt, int kNo, bool kRowsX>
__device__ __forceinline__ void bwd_write(const float (&o)[kMt][kNo][4],
                                          float (&dbs)[kMt][2],
                                          const BwdArgs& a, int xa, int col0,
                                          int col_end, bool write_db,
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
        if (x < a.n_x && k < col_end)
          out[(size_t)x * a.sx + (size_t)k * a.sk] = o[m][n][i];
      }
    }
  }
  if (!kRowsX && write_db) {
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

// K5 from the forward's inputs, its lse and the gradients dlse, dt of (lse,
// tlog) into dh [N, d], dw [d, V] (f32) and db [V], by any of its designs:
// the pre-pass, the dh pass (X = h rows, Y = Wᵀ rows), the dW/db pass (X =
// Wᵀ rows, Y = h rows), and where a pass has more than one split, the
// ordered merge of its partials.  pass(args, splits, rows_x) launches one
// pass of the design and returns its error.  workspace: f32 (kBf false,
// w f32) Wᵀ and its TF32 split (3·V·d floats) and h's split (2·N·d); bf16
// (w f32, or bf16 where w_bf16) h and Wᵀ in bf16 ((N + V)·d / 2 floats);
// then split_h·N·d floats of dh partials where split_h > 1 and split_w·(d
// + 1)·V of dW and db partials where split_w > 1.
template <bool kBf, typename Pass>
cudaError_t bwd_passes(const float* h, const void* w, int w_bf16,
                       const float* b, const float* lse, const float* dlse,
                       const float* dt, const int* tgt, float* dh, float* dw,
                       float* db, float* workspace, int split_h, int split_w,
                       int N, int d, int V, cudaStream_t s, Pass pass) {
  const size_t vd = (size_t)V * d, nd = (size_t)N * d;
  BwdArgs ah{}, aw{};
  float* part_h;
  cudaError_t err;
  if constexpr (kBf) {
    uint16_t* hb = reinterpret_cast<uint16_t*>(workspace);
    uint16_t* wtb = hb + nd;
    part_h = reinterpret_cast<float*>(wtb + vd);
    err = bf16_operands(h, w, w_bf16, hb, wtb, N, d, V, s);
    ah.xh = hb;
    ah.yh = wtb;
    aw.xh = wtb;
    aw.yh = hb;
  } else {
    float* wt = workspace;
    float* wt_big = wt + vd;
    float* wt_small = wt_big + vd;
    float* h_big = wt_small + vd;
    float* h_small = h_big + nd;
    part_h = h_small + nd;
    err = transpose_split(static_cast<const float*>(w), wt, wt_big, wt_small,
                          d, V, s);
    if (err == cudaSuccess) {
      split_kernel<<<stride_blocks(nd / 4), 256, 0, s>>>(h, nd, h_big,
                                                         h_small);
      err = cudaGetLastError();
    }
    ah.x = h;
    ah.y_big = wt_big;
    ah.y_small = wt_small;
    aw.x = wt;
    aw.y_big = h_big;
    aw.y_small = h_small;
  }
  if (err != cudaSuccess) return err;
  float* part_w = part_h + (split_h > 1 ? (size_t)split_h * nd : 0);
  float* part_b = part_w + (size_t)split_w * vd;
  for (BwdArgs* a : {&ah, &aw}) {
    a->b = b;
    a->lse = lse;
    a->dlse = dlse;
    a->dt = dt;
    a->tgt = tgt;
    a->d = d;
    a->V = V;
  }

  // dh: partial [split][N][d]
  ah.out = split_h > 1 ? part_h : dh;
  ah.out_split = nd;
  ah.sx = d;
  ah.sk = 1;
  ah.n_x = N;
  ah.n_y = V;
  err = pass(ah, split_h, true);
  if (err != cudaSuccess) return err;
  if (split_h > 1) {
    err = merge(part_h, split_h, nd, dh, s);
    if (err != cudaSuccess) return err;
  }

  // dW, db: partials [split][d][V] and [split][V]
  aw.out = split_w > 1 ? part_w : dw;
  aw.db = split_w > 1 ? part_b : db;
  aw.out_split = vd;
  aw.sx = 1;
  aw.sk = V;
  aw.n_x = V;
  aw.n_y = N;
  err = pass(aw, split_w, false);
  if (err != cudaSuccess) return err;
  if (split_w > 1) {
    err = merge(part_w, split_w, vd, dw, s);
    if (err == cudaSuccess) err = merge(part_b, split_w, (size_t)V, db, s);
  }
  return err;
}

}  // namespace
