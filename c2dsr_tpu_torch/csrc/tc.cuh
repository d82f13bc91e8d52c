// Tensor-core building blocks shared by the CE kernels (ce.cu) and the
// tower forward and backward (encoder.cu, encoder_bwd.cu): f32-accurate
// products on the TF32 units (3xTF32), the warp-level MMAs (TF32 and bf16),
// 16-byte asynchronous copies into shared memory, and the towers' 64-row
// GEMM tiles (f32 and bf16).
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

// x rounded to bf16 (to nearest, ties to even: the JAX package's astype),
// as the bits of an f32 whose low 16 bits are zero (the towers'
// whole-sequence attention kernels round their FFMA operands so).  The
// other products run bf16 MMAs on bf16 rows (below).  Finite x.
__device__ __forceinline__ uint32_t round_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
}

// x rounded to bf16, as an f32.
__device__ __forceinline__ float bf16f(float x) {
  return __uint_as_float(round_bf16(x));
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

// d = a·b on the tensor cores from a zero accumulator, m16n8k8 as
// mma_tf32.
__device__ __forceinline__ void mma_tf32_zero(float d[4], const uint32_t a[4],
                                              const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// The bf16 tensor cores (the bf16 instantiations of the CE kernels,
// ce_fwd.cuh, ce_bwd.cuh, ce_cluster.cu, and of the towers' products,
// gemm_tile_bf16 below, encoder_bwd.cu's weight gradients and
// encoder_common.cuh's attention past L 64): operands
// read from shared memory by ldmatrix, one mma.sync.m16n8k16 bf16 with
// f32 accumulators a k16 step (twice the TF32 rate, and a quarter of the
// fragment loads of mma_tf32 on bf16 values widened one 16-bit load at a
// time).  The C layout is mma_tf32's, so two adjacent n8-tiles of a
// product's C fragments, rounded and packed in pairs (pack_bf16), are the
// A fragment of the next product's k16 step as they lie.

// lo and hi rounded to bf16 (to nearest, ties to even: round_bf16's
// rounding) and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Four 8x8 bf16 matrices from shared memory, lanes 8·q .. 8·q + 7 giving
// the row addresses of matrix q (16 bytes each); thread (g, t) receives
// row g, columns 2t, 2t + 1 of each (kTrans: row 2t and 2t + 1, column g).
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
}

// c += a·b, m16n8k16, bf16 in, f32 accumulate.  a = A[g][2t..2t+1],
// A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]; b = B[2t..2t+1][g],
// B[2t+8..2t+9][g]; c as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a·b from a zero accumulator, as mma_bf16.
__device__ __forceinline__ void mma_bf16_zero(float d[4], const uint32_t a[4],
                                              const uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// 16 bytes from global src to shared dst, or 16 zero bytes when !ok (src
// must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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
// Up to d 256 (encoder_common.cuh kWideD): past it the towers' products
// run wgmma.cuh's wg::tile, whose wgmma reads a TF32 B operand only
// K-major and already split, so each call splits its weights once into a
// K-major copy there; here each warp splits the W fragments it loads.
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
// logs it against float64); twice the MMAs and an add a k-step.  The
// bf16 instantiations take gemm_tile_bf16 (below).
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
    // B[t][g] of k-step ks and n-tile j: x[0] and x[1] (rows t and t + 4)
    auto b_values = [&](int ks, int j, float (&x)[2]) {
      if constexpr (KM) {   // B[t][g] = W[k0 + t][n0 + 8·j + g]
        const float* src = ws + (ks * 8 + tq) * Cfg::kLdw + j * 8 + gq;
        x[0] = src[0];
        x[1] = src[4 * Cfg::kLdw];
      } else {              // B[t][g] = W[n0 + 8·j + g][k0 + t]
        const float* src = ws + (j * 8 + gq) * kLds + ks * 8 + tq;
        x[0] = src[0];
        x[1] = src[4];
      }
    };
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
          b_values(ks, j0 + j, x);
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

// ------------------------------------------- the towers' bf16 GEMM ----
// gemm_tile's bf16 sibling, the towers' bf16 instantiations
// (compute_dtype="bfloat16", the Pallas tower's matmul_dtype=bf16): the
// same 64 x NT tile of A·B in the same C layout, with A f32 and W the
// call's bf16 copy of its weights (encoder_common.cuh round_weights_bf16),
// [m, k] or, with KM, [k, m].  Each operand is the bf16 value round_bf16
// gives, the products exact and summed in f32:
// * A chunk of kKc k-steps of A is loaded as float4s into registers while
//   the block multiplies the chunk before, then rounded (cvt.rn.bf16x2:
//   round_bf16's rounding) and stored; W's chunks arrive by cp.async.  Two
//   slots of each.  Both lie in shared memory as bf16 rows of an odd count
//   of 16-byte units, so each 8-row phase of an ldmatrix meets every bank
//   once.
// * Fragments come by ldmatrix (W [k, m] transposed), one
//   mma.sync.m16n8k16 bf16 a k16 step (the bf16 rate, twice the TF32).
// * A chunk's two k16 steps sum in a zeroed accumulator (whose adds
//   truncate) and that partial is added to acc in f32, to nearest: no
//   chain longer than 32 k-steps stays in the tensor cores' accumulator
//   (tests/test_torch_tower_bf16_mma.py emulates the order).  Zero-filled
//   rows, columns and k-steps past n, m and k add nothing.
// k % 8 == 0, m % 8 == 0, pointers 16-byte aligned.
template <int NT, bool KM>
struct GemmBf16Cfg {
  static constexpr int kLda = kKc + 8;              // A [64][kLda]
  static constexpr int kLdw = KM ? NT + 8 : kKc + 8;  // W [kKc][kLdw] or
                                                      // [NT][kLdw]
  static constexpr int kA = kGemmRows * kLda;       // elements a slot
  static constexpr int kStage = kA + (KM ? kKc : NT) * kLdw;
  static constexpr int kSmem = 2 * kGemmStages * kStage;   // bytes
  static_assert((2 * kLda) % 32 == 16 && (2 * kLdw) % 32 == 16,
                "rows of an odd count of 16-byte units");
};

// Dynamic shared memory of a tower GEMM block: gemm_tile's, or at TERMS 1
// (the bf16 instantiation) gemm_tile_bf16's.
template <int NT, bool KM, int TERMS>
constexpr int gemm_smem() {
  return TERMS == 1 ? GemmBf16Cfg<NT, KM>::kSmem : GemmCfg<NT, KM>::kSmem;
}

template <int NT, bool KM>
__device__ __forceinline__ void gemm_tile_bf16(
    const float* __restrict__ a, const uint16_t* __restrict__ w, int n, int k,
    int m, int row0, int n0, uint16_t* smem, float (&acc)[NT / 8][4]) {
  using Cfg = GemmBf16Cfg<NT, KM>;
  static_assert(kGemmStages == 2 && kKc == 32, "two slots of two k16 steps");
  constexpr int kNj = NT / 8;                  // n-tiles a warp
  constexpr int kNb = NT == 256 ? 4 : 8;       // n-tiles a partial
  constexpr int kAv = kGemmRows * kKc / 4 / kGemmThreads;  // float4s a
                                                           // thread
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_chunks = (k + kKc - 1) / kKc;

  // A chunk's float4 i of this thread: row v / 8, columns 4·(v % 8) + 0..3
  // of the chunk, v = threadIdx.x + i·kGemmThreads
  float4 av[kAv];
  auto load_a = [&](int chunk) {
    const int k0 = chunk * kKc;
#pragma unroll
    for (int i = 0; i < kAv; ++i) {
      const int v = threadIdx.x + i * kGemmThreads;
      const int r = v >> 3, c = k0 + (v & 7) * 4;
      av[i] = row0 + r < n && c < k
                  ? *reinterpret_cast<const float4*>(
                        a + (size_t)(row0 + r) * k + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_a = [&](int slot) {
    uint16_t* as = smem + slot * Cfg::kStage;
#pragma unroll
    for (int i = 0; i < kAv; ++i) {
      const int v = threadIdx.x + i * kGemmThreads;
      *reinterpret_cast<uint2*>(as + (v >> 3) * Cfg::kLda + (v & 7) * 4) =
          make_uint2(pack_bf16(av[i].x, av[i].y),
                     pack_bf16(av[i].z, av[i].w));
    }
  };
  auto stage_w = [&](int slot, int chunk) {
    uint16_t* ws = smem + slot * Cfg::kStage + Cfg::kA;
    const int k0 = chunk * kKc;
    if constexpr (KM) {   // kKc rows of W [k, m], NT columns, 8 a copy
      for (int v = threadIdx.x; v < kKc * (NT / 8); v += kGemmThreads) {
        const int r = v / (NT / 8), c = n0 + (v % (NT / 8)) * 8;
        const bool ok = k0 + r < k && c < m;
        cp_async16(ws + r * Cfg::kLdw + (c - n0),
                   ok ? w + (size_t)(k0 + r) * m + c : w, ok);
      }
    } else {              // NT rows of W [m, k], kKc columns
      for (int v = threadIdx.x; v < NT * (kKc / 8); v += kGemmThreads) {
        const int r = v >> 2, c = k0 + (v & 3) * 8;
        const bool ok = n0 + r < m && c < k;
        cp_async16(ws + r * Cfg::kLdw + (c - k0),
                   ok ? w + (size_t)(n0 + r) * k + c : w, ok);
      }
    }
  };

  load_a(0);
  stage_w(0, 0);
  cp_async_commit();
  store_a(0);
#pragma unroll
  for (int j = 0; j < kNj; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  // this lane's ldmatrix row: lanes 8·q .. 8·q + 7 address matrix q.  A's
  // four: rows 0-7 and 8-15 of the warp's 16 at k 0-7, then at k 8-15 (the
  // m16n8k16 A fragment); B's four: k 0-7 and 8-15 of n-tile j, then of
  // n-tile j + 1 (the b0, b1 of both)
  const int q = lane >> 3, r8 = lane & 7;
  const int a_off = (warp * 16 + (q & 1) * 8 + r8) * Cfg::kLda + (q >> 1) * 8;
  const int b_off = KM ? ((q & 1) * 8 + r8) * Cfg::kLdw + (q >> 1) * 8
                       : ((q >> 1) * 8 + r8) * Cfg::kLdw + (q & 1) * 8;
  for (int it = 0; it < n_chunks; ++it) {
    cp_async_wait<0>();
    __syncthreads();     // chunk it in its slot; the other slot read
    const bool more = it + 1 < n_chunks;
    if (more) {
      stage_w((it + 1) & 1, it + 1);
      load_a(it + 1);
    }
    cp_async_commit();
    const uint16_t* as = smem + (it & 1) * Cfg::kStage;
    const uint16_t* ws = as + Cfg::kA;
    uint32_t af[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldsm_x4<false>(af[ks], as + a_off + 16 * ks);
#pragma unroll
    for (int j0 = 0; j0 < kNj; j0 += kNb) {
      float part[kNb][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int jp = 0; jp < kNb / 2; ++jp) {
          const int j = j0 + 2 * jp;
          uint32_t b[4];
          ldsm_x4<KM>(b, ws + b_off + (KM ? 16 * ks * Cfg::kLdw + 8 * j
                                          : 8 * j * Cfg::kLdw + 16 * ks));
          if (ks == 0) {
            mma_bf16_zero(part[2 * jp], af[0], b[0], b[1]);
            mma_bf16_zero(part[2 * jp + 1], af[0], b[2], b[3]);
          } else {
            mma_bf16(part[2 * jp], af[1], b[0], b[1]);
            mma_bf16(part[2 * jp + 1], af[1], b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kNb; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j0 + j][i] += part[j][i];
    }
    if (more) store_a((it + 1) & 1);
  }
}

}  // namespace tc
