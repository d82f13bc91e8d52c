// The fused CE's forward (K4) and the tile machinery it shares with the
// backward (K5): included by ce.cu, which builds the production kernels,
// and by ce_variants.cu, which builds K4's experiment variants at DT 128
// only.  Both translation units compile the same template, so variant 0
// there is the production kernel, bitwise.
//
// K4 replaces the fused CE forward Pallas kernel
// (c2dsr_tpu/ops/fused_ce.py:_fwd_kernel); its variants replace the
// experiment kernels of bench/ce_experiments.py (_mk_kernel, variant_fn).
// ce.cu's head comment describes the design.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "tc.cuh"

namespace {

using namespace tc;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tile shapes by the width DT an instantiation computes at: d <= DT, the
// columns past d zero in shared memory, so that every loop over the width
// has a compile-time trip count and no branch.  A warp holds kMt m-tiles
// of 16 X rows, so that each B fragment it reads feeds 3·kMt MMAs; a stage
// holds the big and the small part of a Y tile and 4·kBy floats of
// per-entity values.  K4 and K5 share it up to DT 256; wider rows run
// their wide kernels (ce.cu) or K5's cluster kernels (ce_cluster.cu): at
// DT 512, 128 resident X rows would take 264 KB of shared memory (a block
// has 227 KB), and K5's dh kernel would keep a warp's 16 x 512 output in
// registers (256 floats a thread, beyond the 255 a thread may have).
template <int DT>
struct BwdCfg {
  static_assert(DT <= 256, "the resident tiles stop at DT 256");
  static constexpr int kThreads = 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kMt = DT <= 128 ? 2 : 1;      // m-tiles a warp
  static constexpr int kBx = 16 * kMt * kWarps;      // resident entities
  static constexpr int kBy = DT <= 128 ? 32 : 16;    // streamed entities
  static constexpr int kStages = DT <= 64 ? 3 : 2;   // cp.async ring depth
  static constexpr int kStage = 2 * kBy * (DT + 4) + 4 * kBy;  // floats
};

template <int DT>
constexpr int tile_smem() {
  return static_cast<int>(sizeof(float)) *
         (BwdCfg<DT>::kBx * (DT + 4) +
          BwdCfg<DT>::kStages * BwdCfg<DT>::kStage);
}

// The bf16 instantiations (compute_dtype="bfloat16", or a bf16
// classifier): X and Y are bf16 rows in device memory, written by the
// pre-pass (h rounded, Wᵀ rounded or copied from a bf16 W), staged as
// they are (two bytes an element, one part where 3xTF32 stages two), read
// by ldmatrix and multiplied by mma.sync.m16n8k16 bf16 with f32
// accumulators (tc.cuh): the Pallas kernels' bf16 product.  The dlogits
// are rounded to bf16 and packed in pairs as they become the A fragment
// of K5's second product; their sums (db) stay f32.  A row is DT + 8 bf16
// (16 bytes past DT, so that rows start on 16 bytes and each ldmatrix
// phase of 8 rows falls on 32 distinct banks).
template <int DT, bool kBf>
struct Tile {
  using T = typename std::conditional<kBf, uint16_t, float>::type;
  static constexpr int ld = kBf ? DT + 8 : DT + 4;     // elements a row
  static constexpr int kYParts = kBf ? 1 : 2;          // big, small
  static constexpr int kStageBytes =
      static_cast<int>(sizeof(T)) * kYParts * BwdCfg<DT>::kBy * ld +
      16 * BwdCfg<DT>::kBy;                            // + per-entity info
  static constexpr int kSmem =
      static_cast<int>(sizeof(T)) * BwdCfg<DT>::kBx * ld +
      BwdCfg<DT>::kStages * kStageBytes;
};
static_assert(Tile<128, false>::kSmem == tile_smem<128>(), "one layout");

// rows [e0, e0 + kN) of bf16 src [n_src, d] into dst (row stride DT + 8),
// zero past n_src and past d (d % 8 == 0), as stage_rows does f32 rows.
template <int DT, int kN>
__device__ __forceinline__ void stage_rows(uint16_t* dst, const uint16_t* src,
                                           int e0, int n_src, int d) {
  constexpr int kD8 = DT / 8;
  constexpr int kStep = BwdCfg<DT>::kThreads / kD8;   // rows a pass
  constexpr int ld = Tile<DT, true>::ld;
  static_assert(kN % kStep == 0, "whole passes");
  const int e = threadIdx.x / kD8;
  const int k8 = threadIdx.x % kD8;
  const bool col_ok = k8 * 8 < d;
  const uint16_t* from = src + (size_t)(e0 + e) * d + k8 * 8;
  uint16_t* to = dst + e * ld + k8 * 8;
#pragma unroll
  for (int i = 0; i < kN / kStep; ++i) {
    const bool ok = col_ok && e0 + e + i * kStep < n_src;
    cp_async16(reinterpret_cast<float*>(to + i * kStep * ld),
               reinterpret_cast<const float*>(
                   ok ? from + (size_t)i * kStep * d : src),
               ok);
  }
}

// rows [e0, e0 + kN) of src [n_src, d] into dst (row stride DT + 4, DT
// columns), zero past n_src and past d, by 16-byte cp.async; a thread
// copies the same 16 bytes of every (kThreads / (DT / 4))-th row.
template <int DT, int kN>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int e0, int n_src, int d) {
  constexpr int kD4 = DT / 4;
  constexpr int kStep = BwdCfg<DT>::kThreads / kD4;   // rows a pass
  static_assert(kN % kStep == 0, "whole passes");
  const int e = threadIdx.x / kD4;
  const int k4 = threadIdx.x % kD4;
  const bool col_ok = k4 * 4 < d;
  const float* from = src + (size_t)(e0 + e) * d + k4 * 4;
  float* to = dst + e * (DT + 4) + k4 * 4;
#pragma unroll
  for (int i = 0; i < kN / kStep; ++i) {
    const bool ok = col_ok && e0 + e + i * kStep < n_src;
    cp_async16(to + i * kStep * (DT + 4),
               ok ? from + (size_t)i * kStep * d : src, ok);
  }
}

// The k-steps of a logit tile summed in one partial (logit_tile).
constexpr int kLogitSteps = 4;

// acc = the 3xTF32 products of k-steps [k0, k0 + kLogitSteps) of X_w ·
// Y_tileᵀ, from a zero accumulator.  xw is this thread's first A element
// of the warp's X rows in shared memory (split as it is read), yb and ys
// the big and small parts of the Y tile (row stride DT + 4).  MMAs are
// issued term-major (all small·big of a k-step, then big·small, then
// big·big), so that two products into one accumulator are at least
// kMt·kNy MMAs apart.  Element i of n-tile j of m-tile m is X row
// 16·m + 8·(i >> 1) + g, Y row 8·j + 2·t + (i & 1).
template <int DT, int kMt, int kNy>
__device__ __forceinline__ void logit_steps(float (&acc)[kMt][kNy][4], int k0,
                                            const float* xw, const float* yb,
                                            const float* ys, int g, int t) {
  constexpr int ld = DT + 4;
#pragma unroll
  for (int kk = 0; kk < kLogitSteps; ++kk) {
    const int ks = k0 + kk;
    uint32_t ab[kMt][4], as[kMt][4], bb[kNy][2], bs[kNy][2];
#pragma unroll
    for (int m = 0; m < kMt; ++m) {
      const float* xk = xw + 16 * m * ld + ks * 8;
      split_tf32(xk[0], ab[m][0], as[m][0]);
      split_tf32(xk[8 * ld], ab[m][1], as[m][1]);
      split_tf32(xk[4], ab[m][2], as[m][2]);
      split_tf32(xk[8 * ld + 4], ab[m][3], as[m][3]);
    }
#pragma unroll
    for (int j = 0; j < kNy; ++j) {
      const int at = (j * 8 + g) * ld + ks * 8 + t;
      bb[j][0] = __float_as_uint(yb[at]);
      bb[j][1] = __float_as_uint(yb[at + 4]);
      bs[j][0] = __float_as_uint(ys[at]);
      bs[j][1] = __float_as_uint(ys[at + 4]);
    }
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int j = 0; j < kNy; ++j) {
        if (kk == 0)
          mma_tf32_zero(acc[m][j], as[m], bb[j]);
        else
          mma_tf32(acc[m][j], as[m], bb[j]);
      }
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int j = 0; j < kNy; ++j) mma_tf32(acc[m][j], ab[m], bs[j]);
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int j = 0; j < kNy; ++j) mma_tf32(acc[m][j], ab[m], bb[j]);
  }
}

// logit_steps of the bf16 instantiations: X and Y bf16 rows (row stride
// ld = DT + 8, Tile), read by ldmatrix, and kLogitSteps / 2 k16 steps of
// mma.sync.m16n8k16 bf16 a pair of n-tiles (ys unused): the exact products
// of bf16 operands, summed in f32 by the tensor cores, the Pallas kernels'
// bf16 product.  xw is this thread's element of the warp's X rows, as the
// f32 overload takes it (row g, column t); the ldmatrix row addresses are
// taken from it: lane l gives A's row l % 16 at column 8·(l / 16), and Y's
// entity 8·(l / 16) + l % 8 at column 8·(l / 8 % 2), so that matrices 0-3
// are A's fragment (rows 0-7 and 8-15, columns 0-7 and 8-15 of the k16
// step) and B's of two n-tiles (entities 0-7 at columns 0-7 and 8-15, then
// entities 8-15).  A row is an odd number of 16-byte units (ld · 2
// bytes: 9, 17 and 33 at DT 64, 128 and 256, 5 in the wide kernels' 32
// columns), so the 8 rows of an ldmatrix phase fall on 32 distinct banks.
template <int DT, int kMt, int kNy>
__device__ __forceinline__ void logit_steps(float (&acc)[kMt][kNy][4], int k0,
                                            const uint16_t* xw,
                                            const uint16_t* yb,
                                            const uint16_t* ys, int g,
                                            int t) {
  constexpr int ld = Tile<DT, true>::ld;
  static_assert(kNy % 2 == 0 && kLogitSteps % 2 == 0,
                "pairs of n-tiles and of k8 steps");
  static_assert((ld * 2) % 32 == 16,
                "rows on 16 bytes, ldmatrix phases free of bank conflicts");
  const int lane = 4 * g + t;
  const uint16_t* xl =
      xw - (g * ld + t) + (lane & 15) * ld + 8 * (lane >> 4);
  const uint16_t* yl =
      yb + (8 * (lane >> 4) + (lane & 7)) * ld + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < kLogitSteps / 2; ++kk) {
    const int k = (k0 + 2 * kk) * 8;
    uint32_t a[kMt][4], b[kNy / 2][4];
#pragma unroll
    for (int m = 0; m < kMt; ++m) ldsm_x4<false>(a[m], xl + 16 * m * ld + k);
#pragma unroll
    for (int j = 0; j < kNy / 2; ++j)
      ldsm_x4<false>(b[j], yl + 16 * j * ld + k);
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int j = 0; j < kNy / 2; ++j) {
        if (kk == 0) {
          mma_bf16_zero(acc[m][2 * j], a[m], b[j][0], b[j][1]);
          mma_bf16_zero(acc[m][2 * j + 1], a[m], b[j][2], b[j][3]);
        } else {
          mma_bf16(acc[m][2 * j], a[m], b[j][0], b[j][1]);
          mma_bf16(acc[m][2 * j + 1], a[m], b[j][2], b[j][3]);
        }
      }
  }
}

// S = X_w · Y_tileᵀ, [16·kMt x 8·kNy], k over the width, in 3xTF32
// (logit_steps).  The tensor cores add into their accumulator with
// truncation, so a logit summed over all of d's k-steps there drifts toward
// zero by ulps of itself: K4's lse on a trained state at V 500,000 lay
// 8.77e-6 from float64 where plain f32 lies 2.6e-7 (an H100).  So S sums
// partials of kLogitSteps k-steps each in f32, as K2's QKV sums its k-steps
// (tc.cuh, TERMS 6); the first partial is S itself.  The bf16
// instantiations add the partials with Kahan's compensation (kComp): K5
// rounds each dlogit to bf16, where a few f32 ulps of a logit move a
// dlogit near a rounding boundary by a bf16 ulp; with plain adds K5 bf16
// at d 512 lay further from float64 than the plain bf16 CE (its dh or dW
// more than 1e-4 of the largest element from float64 on 25 of 200 seeds,
// the plain version's on 14), compensated on 14 (an H100, PERF.md §6 PR
// 14), at 12-14% of K4's and K5's bf16 time at FK.  Partials of 1, 2 or
// 4 k-steps are all within plain f32's error of float64
// (tests/test_torch_tf32.py), and 4 takes the fewest adds.  Up to DT 128
// the loop over partials stays rolled: unrolled, the loads hoisted across
// partials spilled registers, and K4 + K5 at FK took 13.64 ms a step
// against 13.28 rolled.  Above it the loop is unrolled: there a partial is
// one or two MMA chains, and unrolled, the partials' independent chains
// overlap, where the tile before them was one dependent chain: at d 512
// K4 took 10.53 ms and K5 51.71 against 16.19 and 72.86 before, and rolled
// 20.54 and 85.34 (N 10,240, V 30,720; an H100 at 700 W).  The bf16
// instantiations (T = uint16_t) take the same 32-column partials, each
// two chained m16n8k16 bf16 MMAs, unrolled at every width: their
// fragments take fewer registers, and unrolled K4 and K5 bf16 at d 128
// took 4-9% less time (tests/ce_bf16_variants.py, an H100).
template <int DT, int kMt, int kNy, typename T>
__device__ __forceinline__ void logit_tile(float (&s)[kMt][kNy][4],
                                           const T* xw, const T* yb,
                                           const T* ys, int g, int t) {
  constexpr int kNd = DT / 8;
  static_assert(kNd % kLogitSteps == 0, "whole partials");
  constexpr bool kComp = std::is_same<T, uint16_t>::value;
  float c[kMt][kNy][4];                 // kComp: the sum's lost low part
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int j = 0; j < kNy; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[m][j][i] = 0.f;
  auto add_partial = [&](int k0) {
    float p[kMt][kNy][4];
    logit_steps<DT, kMt, kNy>(p, k0, xw, yb, ys, g, t);
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int j = 0; j < kNy; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kComp) {
            const float y = p[m][j][i] - c[m][j][i];
            const float u = s[m][j][i] + y;
            c[m][j][i] = (u - s[m][j][i]) - y;
            s[m][j][i] = u;
          } else {
            s[m][j][i] += p[m][j][i];
          }
        }
  };
  logit_steps<DT, kMt, kNy>(s, 0, xw, yb, ys, g, t);
  if constexpr (DT <= 128 && !kComp) {
#pragma unroll 1
    for (int k0 = kLogitSteps; k0 < kNd; k0 += kLogitSteps) add_partial(k0);
  } else {
#pragma unroll
    for (int k0 = kLogitSteps; k0 < kNd; k0 += kLogitSteps) add_partial(k0);
  }
}

// ---------------------------------------------------------------- K4 ----

// K4's compile-time variants, after bench/ce_experiments.py's: what each
// per-logit operation of the forward costs.  kBase is the production
// kernel.  kNoMatch drops the target compare/select (target logit 0).
// kExp2 drops the per-logit scale into log2 units: the caller pre-scales
// h, b and pad by log2 e, and the lse comes out in log2 units.  kBf16Exp
// takes the exponentials of pairs of (logit - max), packed as bf16x2, by
// ex2.approx.ftz.bf16x2.  kMatmulOnly keeps the 3xTF32 logit tile and a
// plain row sum of the logits (no max, no exp, no target): K4's
// tensor-core floor.
enum Variant : int {
  kBase = 0,
  kNoMatch = 1,
  kExp2 = 2,
  kBf16Exp = 3,
  kMatmulOnly = 4
};

// 2^a and 2^b from one packed bf16x2 exponential: a and b rounded to
// bf16, the results read back as f32.
__device__ __forceinline__ void exp2_bf16x2(float a, float b, float& ea,
                                            float& eb) {
  uint32_t in, out;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(in) : "f"(b), "f"(a));
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(out) : "r"(in));
  ea = __uint_as_float(out << 16);
  eb = __uint_as_float(out & 0xffff0000u);
}

// What the forward reads and where it writes.
struct FwdArgs {
  const float* x;        // h [N, d]
  const float* y_big;    // Wᵀ [V, d], TF32 part
  const float* y_small;  // and remainder
  const float* b;        // [V] masked bias
  const int* tgt;        // [N]
  float* part;           // [3][splits][N]: max (log2 units), sum, target
  int n_x, d, V;
  const uint16_t* xh;    // the bf16 instantiation's h [N, d] and Wᵀ [V, d]
  const uint16_t* yh;    // in bf16 (x, y_big, y_small unused)
};

// The forward's per-tile step for the rows of this thread's fragments:
// logit tile s (bias added here, from bias[e] for tile column e; columns
// past V masked) folded into the running max rm and sum rs (log2 units) and
// the target logit tl (kMatmulOnly: the plain sum of the logits in rs).
// kRowChecks (the bf16 instantiations, kBase): a row whose tile lies
// wholly inside V and holds none of its target takes no check a column,
// the same arithmetic: the bf16 tile's MMAs leave the f32 work a column
// the larger share of its time, and K4 bf16 at d 128 took 10% less time
// (tests/ce_bf16_variants.py, an H100).
template <int VARIANT, int kMt, int kNy, bool kRowChecks = false>
__device__ __forceinline__ void fwd_tile(float (&s)[kMt][kNy][4],
                                         const float* bias, int y0, int V,
                                         const int (&xtg)[kMt][2],
                                         float (&rm)[kMt][2],
                                         float (&rs)[kMt][2],
                                         float (&tl)[kMt][2], int t) {
#pragma unroll
  for (int m = 0; m < kMt; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (VARIANT == kMatmulOnly) {
        float acc = rs[m][r];
#pragma unroll
        for (int j = 0; j < kNy; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (y0 + j * 8 + 2 * t + c < V)
              acc += s[m][j][2 * r + c] + bias[j * 8 + 2 * t + c];
        rs[m][r] = acc;
        continue;
      }
      float lm = -CUDART_INF_F;
      bool checked = true;
      if constexpr (kRowChecks) {
        static_assert(VARIANT == kBase, "the production kernel's checks");
        if (y0 + 8 * kNy <= V &&
            static_cast<unsigned>(xtg[m][r] - y0) >= 8u * kNy) {
#pragma unroll
          for (int j = 0; j < kNy; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float v2 =
                  (s[m][j][2 * r + c] + bias[j * 8 + 2 * t + c]) * kLog2e;
              s[m][j][2 * r + c] = v2;
              lm = fmaxf(lm, v2);
            }
          checked = false;
        }
      }
      if (checked) {
#pragma unroll
        for (int j = 0; j < kNy; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = j * 8 + 2 * t + c;
            const int y = y0 + e;
            const float v = s[m][j][2 * r + c] + bias[e];
            if (VARIANT != kNoMatch && y < V && y == xtg[m][r])
              tl[m][r] = v;
            const float v2 = y < V ? (VARIANT == kExp2 ? v : v * kLog2e)
                                   : -CUDART_INF_F;
            s[m][j][2 * r + c] = v2;
            lm = fmaxf(lm, v2);
          }
        }
      }
      // the tile's exponentials summed apart, then added to the
      // rescaled running sum once: a long chain of small terms added to
      // one large sum rounds each of them
      const float mn = fmaxf(rm[m][r], lm);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kNy; ++j) {
        if constexpr (VARIANT == kBf16Exp) {
          float e0, e1;
          exp2_bf16x2(s[m][j][2 * r] - mn, s[m][j][2 * r + 1] - mn, e0, e1);
          acc += e0;
          acc += e1;
        } else {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            acc += exp2_approx(s[m][j][2 * r + c] - mn);
        }
      }
      rs[m][r] = fmaf(rs[m][r], exp2_approx(rm[m][r] - mn), acc);
      rm[m][r] = mn;
    }
  }
}

// A row's four threads merge their (max, sum) pairs and target logits and
// write the split's partials (part + blockIdx.y·n_x, planes of
// gridDim.y·n_x); partners compute the same sums in the other order, so
// they agree.  xa: the row of this thread's first fragment row.
template <int VARIANT, int kMt>
__device__ __forceinline__ void fwd_partials(const float (&rm)[kMt][2],
                                             const float (&rs)[kMt][2],
                                             const float (&tl)[kMt][2],
                                             float* part_all, int n_x, int xa,
                                             int t) {
  const size_t plane = (size_t)gridDim.y * n_x;
  float* part = part_all + (size_t)blockIdx.y * n_x;
#pragma unroll
  for (int m = 0; m < kMt; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = rm[m][r], sm = rs[m][r], tv = tl[m][r];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, mx, o);
        const float os = __shfl_xor_sync(0xffffffffu, sm, o);
        tv += __shfl_xor_sync(0xffffffffu, tv, o);
        if constexpr (VARIANT == kMatmulOnly) {
          sm += os;
        } else {
          const float mn = fmaxf(mx, om);
          sm = sm * exp2_approx(mx - mn) + os * exp2_approx(om - mn);
          mx = mn;
        }
      }
      const int x = xa + 16 * m + 8 * r;
      if (t == 0 && x < n_x) {
        part[x] = mx;
        part[plane + x] = sm;
        part[2 * plane + x] = tv;
      }
    }
  }
}

// Per row and split of the vocab: the running max and sum of exp over the
// split's columns, in log2 units, and the target logit (kMatmulOnly: the
// plain sum of the split's logits in the sum's place).  The bf16
// instantiation takes two blocks an SM (at most 128 registers a thread;
// its bf16 tiles take half the shared memory of the f32 ones), so that
// one block's f32 work (the Kahan adds, the exponentials) overlaps the
// other's MMAs; its plans read its own residency (ce.cu, ce_slots design
// 3).
template <int DT, int VARIANT = kBase, bool kBf = false>
__global__ void __launch_bounds__(BwdCfg<DT>::kThreads, kBf ? 2 : 1)
ce_fwd_kernel(const FwdArgs a) {
  using L = Tile<DT, kBf>;
  using T = typename L::T;
  constexpr int kThreads = BwdCfg<DT>::kThreads;
  constexpr int kMt = BwdCfg<DT>::kMt;
  constexpr int kBx = BwdCfg<DT>::kBx;
  constexpr int kBy = BwdCfg<DT>::kBy;
  constexpr int kStages = BwdCfg<DT>::kStages;
  constexpr int kNy = kBy / 8;
  constexpr int ld = L::ld;
  extern __shared__ float4 smem4[];
  T* xs = reinterpret_cast<T*>(smem4);
  // stage: Y's big [kBy][ld] and small part (bf16: the one part), bias
  char* ring = reinterpret_cast<char*>(xs + kBx * ld);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int x0 = blockIdx.x * kBx;
  const int y_tiles = (a.V + kBy - 1) / kBy;
  const int per = (y_tiles + gridDim.y - 1) / gridDim.y;
  const int t_begin = min(y_tiles, (int)blockIdx.y * per);
  const int n_tiles = min(y_tiles, t_begin + per) - t_begin;

  // this thread's fragment rows xa + 16·m + 8·r: target, running max (a
  // finite floor, so that a row with no column yet rescales by 2^0 · 0),
  // running sum, target logit
  const int xa = x0 + warp * 16 * kMt + g;
  int xtg[kMt][2];
  float rm[kMt][2], rs[kMt][2], tl[kMt][2];
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int x = xa + 16 * m + 8 * r;
      xtg[m][r] = x < a.n_x ? a.tgt[x] : -1;
      rm[m][r] = -1e30f;
      rs[m][r] = tl[m][r] = 0.f;
    }

  auto stage = [&](int slot, int tile) {
    T* st = reinterpret_cast<T*>(ring + slot * L::kStageBytes);
    const int y0 = tile * kBy;
    if constexpr (kBf) {
      stage_rows<DT, kBy>(st, a.yh, y0, a.V, a.d);
    } else {
      stage_rows<DT, kBy>(st, a.y_big, y0, a.V, a.d);
      stage_rows<DT, kBy>(st + kBy * ld, a.y_small, y0, a.V, a.d);
    }
    float* bias = reinterpret_cast<float*>(st + L::kYParts * kBy * ld);
    for (int e = threadIdx.x; e < kBy; e += kThreads) {
      const bool ok = y0 + e < a.V;
      cp_async4(bias + e, ok ? a.b + y0 + e : a.b, ok);
    }
  };
  if constexpr (kBf)
    stage_rows<DT, kBx>(xs, a.xh, x0, a.n_x, a.d);
  else
    stage_rows<DT, kBx>(xs, a.x, x0, a.n_x, a.d);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) stage(s, t_begin + s);
    cp_async_commit();
  }
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
    const float* bias =
        reinterpret_cast<const float*>(yb + L::kYParts * kBy * ld);
    const int y0 = (t_begin + it) * kBy;

    float s[kMt][kNy][4];
    logit_tile<DT, kMt, kNy>(s, xw, yb, ys, g, t);
    fwd_tile<VARIANT, kMt, kNy, kBf>(s, bias, y0, a.V, xtg, rm, rs, tl, t);
  }
  cp_async_wait<0>();

  fwd_partials<VARIANT, kMt>(rm, rs, tl, a.part, a.n_x, xa, t);
}

// wt[v, k] = w[k, v]: W [d, V] into Wᵀ [V, d], through 32x32 shared tiles,
// and Wᵀ's TF32 split into wt_big and wt_small (wt null: the split only).
__global__ void transpose_split_kernel(const float* __restrict__ w,
                                       float* __restrict__ wt,
                                       float* __restrict__ wt_big,
                                       float* __restrict__ wt_small, int d,
                                       int V) {
  __shared__ float tile[32][33];
  const int v0 = blockIdx.x * 32;
  const int k0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int k = k0 + r, v = v0 + threadIdx.x;
    if (k < d && v < V) tile[r][threadIdx.x] = w[(size_t)k * V + v];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int v = v0 + r, k = k0 + threadIdx.x;
    if (k < d && v < V) {
      const float x = tile[threadIdx.x][r];
      uint32_t big, small;
      split_tf32(x, big, small);
      const size_t i = (size_t)v * d + k;
      if (wt) wt[i] = x;
      wt_big[i] = __uint_as_float(big);
      wt_small[i] = __uint_as_float(small);
    }
  }
}

// The bf16 instantiations' pre-pass: wt[v, k] = bf16(w[k, v]), W [d, V]
// rounded (f32) or copied (bf16, In = uint16_t) into bf16 Wᵀ [V, d],
// through 32x32 shared tiles.
template <typename In>
__global__ void transpose_bf16_kernel(const In* __restrict__ w,
                                      uint16_t* __restrict__ wt, int d,
                                      int V) {
  __shared__ uint32_t tile[32][33];
  const int v0 = blockIdx.x * 32;
  const int k0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int k = k0 + r, v = v0 + threadIdx.x;
    if (k < d && v < V) {
      if constexpr (std::is_same<In, float>::value)
        tile[r][threadIdx.x] = round_bf16(w[(size_t)k * V + v]) >> 16;
      else
        tile[r][threadIdx.x] = w[(size_t)k * V + v];
    }
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int v = v0 + r, k = k0 + threadIdx.x;
    if (k < d && v < V)
      wt[(size_t)v * d + k] = static_cast<uint16_t>(tile[threadIdx.x][r]);
  }
}

// dst[i] = bf16(x[i]), i < n (n % 4 == 0): h's rows for the bf16
// instantiations.
__global__ void round_bf16_kernel(const float* __restrict__ x, size_t n,
                                  uint16_t* __restrict__ dst) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n / 4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    reinterpret_cast<uint2*>(dst)[i] =
        make_uint2((round_bf16(v.x) >> 16) | round_bf16(v.y),
                   (round_bf16(v.z) >> 16) | round_bf16(v.w));
  }
}

// Merges the splits' partials in split order, folds in the pad-class logit
// (as _fwd_kernel does at its last vocab block) and writes lse and tlog.
__global__ void ce_fwd_merge_kernel(const float* __restrict__ part,
                                    const float* __restrict__ pad,
                                    int splits, int N,
                                    float* __restrict__ lse,
                                    float* __restrict__ tlog) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t plane = (size_t)splits * N;
  float m = -CUDART_INF_F;
  for (int k = 0; k < splits; ++k) m = fmaxf(m, part[(size_t)k * N + row]);
  float s = 0.f, t = 0.f;
  for (int k = 0; k < splits; ++k) {
    s += part[plane + (size_t)k * N + row] *
         exp2f(part[(size_t)k * N + row] - m);
    t += part[2 * plane + (size_t)k * N + row];
  }
  const float p = pad[row] * kLog2e;
  const float m_fin = fmaxf(m, p);
  const float s_fin = s * exp2f(m - m_fin) + exp2f(p - m_fin);
  lse[row] = (m_fin + log2f(s_fin)) * kLn2;
  tlog[row] = t;
}

}  // namespace
