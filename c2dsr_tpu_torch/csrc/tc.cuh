// Tensor-core building blocks shared by the CE kernels (ce.cu) and the
// tower backward (encoder_bwd.cu): f32-accurate products on the TF32 units
// (3xTF32), the warp-level MMA, and 16-byte asynchronous copies into
// shared memory.
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

}  // namespace tc
