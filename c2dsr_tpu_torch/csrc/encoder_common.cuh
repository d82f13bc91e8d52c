// Building blocks of the fused tower forward (encoder.cu): a block of
// kThreads threads holds a tile of rows in shared memory and streams
// weights from L2 in 32x64 tiles.  The saved-activation layout, kNeg and
// kLnEps are shared with the backward (encoder_bwd.cu).
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

// What the forward saves for the backward in training (encoder.cu writes
// it, encoder_bwd.cu reads it): every layer's activations for all N = B·L
// rows of the tower call, dense (row stride d, or 3·d for qkv; p is
// [head][row][key]).  Offsets in floats, each buffer on 256 bytes.
struct SavedLayer {
  size_t qkv, p, o, y1, xhat1, rstd1, fr, fd, xnext, xhat2, rstd2;
};

struct SavedLayout {
  size_t xin0;        // the first layer's input, after the input dropout
  size_t layers;      // layer li at layers + li·per_layer + SavedLayer
  size_t per_layer;
  SavedLayer l;       // qkv; pre-dropout probabilities p; attention out o;
                      // LN1 out y1, xhat1, 1/std; relu(f) before and after
                      // dropout; LN2 out, xhat2, 1/std
  size_t xhat_f, rstd_f, total;   // the final LN's xhat and 1/std
};

// The offset of a buffer of n floats at `at`, which moves past it.
__host__ __device__ inline size_t take(size_t& at, size_t n) {
  const size_t o = at;
  at += (n + 63) & ~size_t(63);
  return o;
}

__host__ __device__ inline SavedLayout saved_layout(size_t N, int d,
                                                   int n_head, int L,
                                                   int n_layers) {
  SavedLayout s;
  size_t at = 0;
  s.xin0 = take(at, N * d);
  s.layers = at;
  at = 0;
  s.l.qkv = take(at, 3 * N * d);
  s.l.p = take(at, (size_t)n_head * N * L);
  s.l.o = take(at, N * d);
  s.l.y1 = take(at, N * d);
  s.l.xhat1 = take(at, N * d);
  s.l.rstd1 = take(at, N);
  s.l.fr = take(at, N * d);
  s.l.fd = take(at, N * d);
  s.l.xnext = take(at, N * d);
  s.l.xhat2 = take(at, N * d);
  s.l.rstd2 = take(at, N);
  s.per_layer = at;
  at = s.layers + (size_t)n_layers * s.per_layer;
  s.xhat_f = take(at, N * d);
  s.rstd_f = take(at, N);
  s.total = at;
  return s;
}

// dst[r·n + c] = src[r·lds + c] for r < R, c < n: a block's rows of a
// shared buffer into the saved activations.  No barrier: a thread reads
// the elements that drop_rows and the element loops give it.
__device__ __forceinline__ void save_rows(float* dst, const float* src,
                                          int lds, int R, int n) {
  for (int v = threadIdx.x; v < R * n; v += kThreads)
    dst[v] = src[(v / n) * lds + v % n];
}

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
// memory.  K % 8 == 0, M % 8 == 0.  Thread (ty, tx) owns rows
// ty*RPT..+RPT-1 and columns m0 + tx*4..+3 of each 64-column chunk; the
// last chunk's columns past M are zero in the tile and not written.  A
// ragged last k chunk (K % 32 != 0) has zero weight rows past K, so the A
// values read there (up to 28 floats past a row's K: its padding and the
// next row's, all finite, since the buffers are zeroed at the start) add
// nothing.  The sum over k runs in order, one FMA a step.
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
        if (k0 + r < K && m0 + c4 * 4 < M)
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
