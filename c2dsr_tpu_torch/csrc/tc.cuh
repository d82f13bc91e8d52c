// Tensor-core building blocks shared by the CE kernels (ce.cu) and the
// tower forward and backward (encoder.cu, encoder_bwd.cu): f32-accurate
// products on the TF32 units (3xTF32), the warp-level MMA, 16-byte
// asynchronous copies into shared memory, and the towers' 64-row GEMM
// tile.
//
// 3xTF32 (CUTLASS's "fast accurate f32"): each f32 operand x is split into
// big = tf32_rna(x) and small = x - big, and a product is small·big +
// big·small + big·big, accumulated in f32 by the tensor cores.  small·small
// (2^-22 relative) is dropped, and the hardware reads small to 10 mantissa
// bits (2^-21 relative of x), so a term is within a few f32 roundings of the
// exact one (tests/test_torch_tf32.py emulates it against float64).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// x = big + small: big rounded to TF32 to nearest, ties away from zero (the
// rounding of cvt.rna.tf32.f32 for finite x, in two integer operations: the
// magnitude's bits plus half a unit of the 13 dropped bits, then cleared),
// small the f32 remainder, whose low bits the tensor core ignores.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// 2^x, flushing results below f32's normal range to zero; 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// c += a·b on the tensor cores, m16n8k8, TF32 in, f32 accumulate.  With
// g = lane / 4 and t = lane % 4: a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; c = C[g][2t], C[g][2t+1],
// C[g+8][2t], C[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global src to shared dst, or 16 zero bytes when !ok (src
// must still be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------ the towers' GEMM ----
// A block of kGemmThreads threads (4 warps, 16 rows each) computes a
// 64 x NT tile of A·B over all of k: A [n, k] row-major; B is W [m, k]
// row-major (A·Wᵀ, the tower backward's products) or, with KM, W [k, m]
// row-major (A·W in JAX's layout, the tower forward's).  Tiles of kKc
// k-steps of A and W arrive through a kGemmStages-deep cp.async ring; rows
// past n or m and k-steps past k are zero-filled.  k % 4 == 0, m % 8 == 0,
// pointers 16-byte aligned.
//
// TERMS = 3 is 3xTF32 (split_tf32): each term within about 2^-22 of the
// exact one, against 2^-24 for an f32 FMA, accumulated by the tensor cores.
// TERMS = 6 splits each operand into three TF32 parts, x = big + mid +
// small, takes the six products down to mid·mid (about 2^-30 of a term)
// and adds each k-step's products to the sum in f32, rounded to nearest:
// as close to the exact sum as an f32 GEMM (chip_smoke.py's d 256 step
// logs it against float64); twice the MMAs and an add a k-step.
constexpr int kGemmThreads = 128;
constexpr int kGemmRows = 64;
constexpr int kKc = 32;
constexpr int kGemmStages = 2;   // K is short (the towers' d or 3·d): two
                                 // stages leave room for 3 blocks an SM
constexpr int kLds = kKc + 4;   // k-major tile row stride: fragment loads
                                // free of bank conflicts

template <int NT, bool KM>
struct GemmCfg {
  // W [k, m] tiles are [kKc][NT + 8]: 8·t + g spreads a fragment's loads
  // over the 32 banks
  static constexpr int kLdw = KM ? NT + 8 : kLds;
  static constexpr int kStage = kGemmRows * kLds + (KM ? kKc * kLdw
                                                       : NT * kLds);
  static constexpr int kSmem = 4 * kGemmStages * kStage;
};

// The TERMS-way split of an operand into p[0] (big), p[1], p[2]: 3xTF32's
// big and small, or big, mid and small.
template <int TERMS>
__device__ __forceinline__ void split_parts(float x, uint32_t (&p)[3]) {
  split_tf32(x, p[0], p[1]);
  if constexpr (TERMS == 6) split_tf32(__uint_as_float(p[1]), p[1], p[2]);
}

// acc = A[row0 .. row0 + 63, :]·B[:, n0 .. n0 + NT - 1] in the m16n8k8 C
// layout: warp w holds rows row0 + 16·w + g (and + 8) of n-tile j in
// acc[j] (tc.cuh's mma_tf32 note).  smem holds GemmCfg<NT, KM>::kSmem
// bytes.
template <int NT, bool KM, int TERMS = 3>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ a,
                                          const float* __restrict__ w,
                                          int n, int k, int m, int row0,
                                          int n0, float* smem,
                                          float (&acc)[NT / 8][4]) {
  static_assert(TERMS == 3 || TERMS == 6, "3xTF32 or its 6-term form");
  using Cfg = GemmCfg<NT, KM>;
  constexpr int kNj = NT / 8;             // n-tiles a warp
  constexpr int kNb = NT == 256 || TERMS == 6 ? 4 : 8;  // n-tiles a batch
                                                        // of B loads
  constexpr int kP = TERMS == 6 ? 3 : 2;  // parts an operand
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int n_chunks = (k + kKc - 1) / kKc;

  auto stage = [&](int slot, int chunk) {
    float* as = smem + slot * Cfg::kStage;
    float* ws = as + kGemmRows * kLds;
    const int k0 = chunk * kKc;
    for (int v = threadIdx.x; v < kGemmRows * (kKc / 4); v += kGemmThreads) {
      const int r = v >> 3, c4 = v & 7;
      const bool ok = row0 + r < n && k0 + c4 * 4 < k;
      cp_async16(as + r * kLds + c4 * 4,
                 ok ? a + (size_t)(row0 + r) * k + k0 + c4 * 4 : a, ok);
    }
    if constexpr (KM) {
      for (int v = threadIdx.x; v < kKc * (NT / 4); v += kGemmThreads) {
        const int r = v / (NT / 4), c4 = v % (NT / 4);
        const bool ok = k0 + r < k && n0 + c4 * 4 < m;
        cp_async16(ws + r * Cfg::kLdw + c4 * 4,
                   ok ? w + (size_t)(k0 + r) * m + n0 + c4 * 4 : w, ok);
      }
    } else {
      for (int v = threadIdx.x; v < NT * (kKc / 4); v += kGemmThreads) {
        const int r = v >> 3, c4 = v & 7;
        const bool ok = n0 + r < m && k0 + c4 * 4 < k;
        cp_async16(ws + r * kLds + c4 * 4,
                   ok ? w + (size_t)(n0 + r) * k + k0 + c4 * 4 : w, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < n_chunks) stage(s, s);
    cp_async_commit();
  }

#pragma unroll
  for (int j = 0; j < kNj; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int it = 0; it < n_chunks; ++it) {
    cp_async_wait<kGemmStages - 2>();
    __syncthreads();
    if (it + kGemmStages - 1 < n_chunks)
      stage((it + kGemmStages - 1) % kGemmStages, it + kGemmStages - 1);
    cp_async_commit();
    const float* as = smem + (it % kGemmStages) * Cfg::kStage;
    const float* ws = as + kGemmRows * kLds;
#pragma unroll
    for (int ks = 0; ks < kKc / 8; ++ks) {
      uint32_t ap[kP][4];                 // A's parts, fragment-ordered
      {
        const float* src = as + (warp * 16 + gq) * kLds + ks * 8 + tq;
        const float x[4] = {src[0], src[8 * kLds], src[4], src[8 * kLds + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t p[3];
          split_parts<TERMS>(x[e], p);
#pragma unroll
          for (int q = 0; q < kP; ++q) ap[q][e] = p[q];
        }
      }
#pragma unroll
      for (int j0 = 0; j0 < kNj; j0 += kNb) {
        uint32_t bp[kP][kNb][2];          // B's parts
#pragma unroll
        for (int j = 0; j < kNb; ++j) {
          float x[2];
          if constexpr (KM) {   // B[t][g] = W[k0 + t][n0 + 8·j + g]
            const float* src = ws + (ks * 8 + tq) * Cfg::kLdw + (j0 + j) * 8
                               + gq;
            x[0] = src[0];
            x[1] = src[4 * Cfg::kLdw];
          } else {              // B[t][g] = W[n0 + 8·j + g][k0 + t]
            const float* src = ws + ((j0 + j) * 8 + gq) * kLds + ks * 8 + tq;
            x[0] = src[0];
            x[1] = src[4];
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            uint32_t p[3];
            split_parts<TERMS>(x[e], p);
#pragma unroll
            for (int q = 0; q < kP; ++q) bp[q][j][e] = p[q];
          }
        }
        // term-major, smallest first: two products into one accumulator
        // kNb MMAs apart.  3 terms: small·big, big·small, big·big, into
        // acc.  6 terms: mid·mid, small·big, big·small, mid·big, big·mid,
        // big·big into a zeroed partial, which an f32 add then rounds into
        // acc to nearest: the tensor cores add into their accumulator with
        // truncation, each MMA about an ulp of the running sum.
        if constexpr (TERMS == 6) {
          float part[kNb][4];
#pragma unroll
          for (int j = 0; j < kNb; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
#pragma unroll
          for (int j = 0; j < kNb; ++j) mma_tf32(part[j], ap[1], bp[1][j]);
#pragma unroll
          for (int j = 0; j < kNb; ++j) mma_tf32(part[j], ap[2], bp[0][j]);
#pragma unroll
          for (int j = 0; j < kNb; ++j) mma_tf32(part[j], ap[0], bp[2][j]);
#pragma unroll
          for (int j = 0; j < kNb; ++j) mma_tf32(part[j], ap[1], bp[0][j]);
#pragma unroll
          for (int j = 0; j < kNb; ++j) mma_tf32(part[j], ap[0], bp[1][j]);
#pragma unroll
          for (int j = 0; j < kNb; ++j) mma_tf32(part[j], ap[0], bp[0][j]);
#pragma unroll
          for (int j = 0; j < kNb; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j0 + j][i] += part[j][i];
        } else {
#pragma unroll
          for (int j = 0; j < kNb; ++j) mma_tf32(acc[j0 + j], ap[1], bp[0][j]);
#pragma unroll
          for (int j = 0; j < kNb; ++j) mma_tf32(acc[j0 + j], ap[0], bp[1][j]);
#pragma unroll
          for (int j = 0; j < kNb; ++j) mma_tf32(acc[j0 + j], ap[0], bp[0][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace tc
