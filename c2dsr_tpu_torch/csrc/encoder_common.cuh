// Building blocks of the fused tower kernels (encoder.cu forward,
// encoder_bwd.cu backward): a block of kThreads threads holds a tile of
// rows in shared memory and streams weights from L2 in 32x64 tiles.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dropout.cuh"

namespace tower {

constexpr int kThreads = 256;
constexpr int kTileK = 32;
constexpr int kTileM = 64;
constexpr float kNeg = -1e9f;
constexpr float kLnEps = 1e-8f;

struct Layer {
  const float *w_qkv, *b_qkv, *w_out, *b_out, *w_ff1, *b_ff1, *w_ff2, *b_ff2;
  const float *ln1_s, *ln1_b, *ln2_s, *ln2_b;
};

// Issues an L2 prefetch for each 128-byte line of p[0, n), spread over all
// threads of the grid.
__device__ __forceinline__ void prefetch_l2(const float* p, size_t n) {
  const size_t lines = (n + 31) / 32;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < lines;
       i += (size_t)gridDim.x * kThreads)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + i * 32));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// C[r, m] = act(sum_k A[r, k] W[k, m] + b[m]) for the 16·RPT rows of a block.
// A, C in shared memory (row strides lda, ldc); W [K, M] row-major in global
// memory.  K % 32 == 0, M % 32 == 0.  Thread (ty, tx) owns rows
// ty*RPT..+RPT-1 and columns m0 + tx*4..+3 of each 64-column chunk; when
// M % 64 == 32 the last chunk's right half is zero in the tile and not
// written.  The sum over k runs in order, one FMA a step.
template <int RPT>
__device__ void gemm(const float* A, int lda, const float* __restrict__ W,
                     const float* __restrict__ bias, int K, int M, float* C,
                     int ldc, bool relu, float* wt) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int m0 = 0; m0 < M; m0 += kTileM) {
    float acc[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kTileK) {
      __syncthreads();  // the previous tile is no longer read
      for (int v = tid; v < kTileK * kTileM / 4; v += kThreads) {
        const int r = v / (kTileM / 4);
        const int c4 = v % (kTileM / 4);
        float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m0 + c4 * 4 < M)
          w4 = __ldg(reinterpret_cast<const float4*>(
                         W + (size_t)(k0 + r) * M + m0) + c4);
        reinterpret_cast<float4*>(wt)[v] = w4;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kTileK; ++kk) {
        const float4 w = reinterpret_cast<const float4*>(wt + kk * kTileM)[tx];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float a = A[(ty * RPT + i) * lda + k0 + kk];
          acc[i][0] = fmaf(a, w.x, acc[i][0]);
          acc[i][1] = fmaf(a, w.y, acc[i][1]);
          acc[i][2] = fmaf(a, w.z, acc[i][2]);
          acc[i][3] = fmaf(a, w.w, acc[i][3]);
        }
      }
    }
    if (m0 + tx * 4 < M) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + tx * 4 + j;
        const float b = bias[m];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          float v = acc[i][j] + b;
          if (relu) v = fmaxf(v, 0.f);
          C[(ty * RPT + i) * ldc + m] = v;
        }
      }
    }
  }
  __syncthreads();
}

// C[r, k] (+)= sum_m A[r, m] W[k, m]: the product with W's transpose, for the
// backward.  W [K, M] row-major in global memory, K % 32 == 0, M % 32 == 0;
// a 64x32 tile of W is staged transposed in shared memory (its rows past K
// zero when K % 64 == 32, and their columns of C not written).
template <int RPT>
__device__ void gemm_nt(const float* A, int lda, const float* __restrict__ W,
                        int K, int M, float* C, int ldc, bool accumulate,
                        float* wt) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int k0 = 0; k0 < K; k0 += kTileM) {
    float acc[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int m0 = 0; m0 < M; m0 += kTileK) {
      __syncthreads();
      for (int v = tid; v < kTileM * kTileK / 4; v += kThreads) {
        const int kk = v / (kTileK / 4);
        const int m4 = v % (kTileK / 4);
        float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + kk < K)
          w = __ldg(reinterpret_cast<const float4*>(
                        W + (size_t)(k0 + kk) * M + m0) + m4);
        wt[(m4 * 4 + 0) * kTileM + kk] = w.x;
        wt[(m4 * 4 + 1) * kTileM + kk] = w.y;
        wt[(m4 * 4 + 2) * kTileM + kk] = w.z;
        wt[(m4 * 4 + 3) * kTileM + kk] = w.w;
      }
      __syncthreads();
#pragma unroll 8
      for (int mm = 0; mm < kTileK; ++mm) {
        const float4 w = reinterpret_cast<const float4*>(wt + mm * kTileM)[tx];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float a = A[(ty * RPT + i) * lda + m0 + mm];
          acc[i][0] = fmaf(a, w.x, acc[i][0]);
          acc[i][1] = fmaf(a, w.y, acc[i][1]);
          acc[i][2] = fmaf(a, w.z, acc[i][2]);
          acc[i][3] = fmaf(a, w.w, acc[i][3]);
        }
      }
    }
    if (k0 + tx * 4 < K) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* c = C + (ty * RPT + i) * ldc + k0 + tx * 4 + j;
          *c = accumulate ? *c + acc[i][j] : acc[i][j];
        }
    }
  }
  __syncthreads();
}

// X[r] = LN(X[r] + Y[r]) (or LN(X[r]) when Y is null) for r < n_rows, one
// warp per row; written to dst (row stride ldd), which may be X itself.
// When xhat is not null, the normalised row and its 1/std are also stored
// (xhat row stride d, rstd one value a row), for the backward.
template <int NV>
__device__ void layer_norm_rows(const float* X, int ldx, const float* Y,
                                int ldy, const float* __restrict__ g,
                                const float* __restrict__ b, float* dst,
                                int ldd, int n_rows, int d,
                                float* xhat = nullptr,
                                float* rstd_out = nullptr) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < n_rows; r += kThreads / 32) {
    float v[NV];
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int c = lane + 32 * t;
      v[t] = 0.f;
      if (c < d) {
        v[t] = X[r * ldx + c] + (Y ? Y[r * ldy + c] : 0.f);
        s += v[t];
      }
    }
    const float mean = warp_sum(s) / d;
    float q = 0.f;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int c = lane + 32 * t;
      if (c < d) q += (v[t] - mean) * (v[t] - mean);
    }
    const float rstd = rsqrtf(warp_sum(q) / d + kLnEps);
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int c = lane + 32 * t;
      if (c < d) {
        const float xh = (v[t] - mean) * rstd;
        dst[r * ldd + c] = xh * g[c] + b[c];
        if (xhat) xhat[r * d + c] = xh;
      }
    }
    if (rstd_out && lane == 0) rstd_out[r] = rstd;
  }
  __syncthreads();
}

// layer_norm_rows with the register width NV = ceil(d / 32) rounded up to
// 2, 4 or 8 (d <= 256).
__device__ __forceinline__ void layer_norm_d(
    const float* X, int ldx, const float* Y, int ldy,
    const float* __restrict__ g, const float* __restrict__ b, float* dst,
    int ldd, int n_rows, int d, float* xhat = nullptr,
    float* rstd_out = nullptr) {
  if (d <= 64)
    layer_norm_rows<2>(X, ldx, Y, ldy, g, b, dst, ldd, n_rows, d, xhat,
                       rstd_out);
  else if (d <= 128)
    layer_norm_rows<4>(X, ldx, Y, ldy, g, b, dst, ldd, n_rows, d, xhat,
                       rstd_out);
  else
    layer_norm_rows<8>(X, ldx, Y, ldy, g, b, dst, ldd, n_rows, d, xhat,
                       rstd_out);
}

// A[r, c] = dropout(A[r, c]) for r < n_rows, c < d; element index
// (row0 + r) * d + c of the site's [B, L, d] tensor.
__device__ __forceinline__ void drop_rows(float* A, int lda, int n_rows,
                                          int d, int row0,
                                          const drop::Dropout& dr,
                                          uint32_t key) {
  for (int v = threadIdx.x; v < n_rows * d; v += kThreads) {
    const int r = v / d;
    const int c = v % d;
    A[r * lda + c] = dr.apply(A[r * lda + c], key,
                              static_cast<uint32_t>((row0 + r) * d + c));
  }
  __syncthreads();
}

}  // namespace tower
