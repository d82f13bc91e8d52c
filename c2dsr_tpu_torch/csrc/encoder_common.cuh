// What the tower forward (encoder.cu) and backward (encoder_bwd.cu)
// share: the saved-activation layout, kNeg and kLnEps, warp reductions, a
// LayerNorm row held in registers, and the attention kernels' geometry.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dropout.cuh"

namespace tower {

constexpr int kThreads = 256;
constexpr float kNeg = -1e9f;
constexpr float kLnEps = 1e-8f;
constexpr int kMaxL = 64;      // the longest sequence the towers take
constexpr int kCh = 64;        // head columns an attention chunk holds
constexpr int kLdc = kCh + 4;  // chunk row stride: a quarter warp's float4
                               // loads of 8 rows fall in distinct banks

// Sequences a block of the attention kernels holds at length L: the most,
// a power of two up to 8, whose rows fit in 64; a warp serves one of them,
// so 8 / S warps share a sequence.
__host__ __device__ constexpr int attn_seqs(int L) {
  return L <= 8 ? 8 : L <= 16 ? 4 : L <= 32 ? 2 : 1;
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

struct Layer {
  const float *w_qkv, *b_qkv, *w_out, *b_out, *w_ff1, *b_ff1, *w_ff2, *b_ff2;
  const float *ln1_s, *ln1_b, *ln2_s, *ln2_b;
};

// What the forward saves for the backward in training (encoder.cu writes
// it, encoder_bwd.cu reads it): every layer's activations for all N = B·L
// rows of the tower call, dense (row stride d, or 3·d for qkv; p is
// [head][row][key]).  Offsets in floats, each buffer on 256 bytes.  The
// forward's eval workspace has the same layout for one layer.
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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

// s += x with the rounding error of the addition carried into c (2Sum):
// s + c is the sum within a few roundings of the exact one however many
// terms it has.  The attention kernels accumulate q·k and do·v over the
// head's columns so: a partly sharp softmax passes a logit's absolute
// error on to the gradient of its row (encoder.cu), and a plain f32 chain
// over 256 or 512 products errs by several ulps of |q||k|.
__device__ __forceinline__ void add_compensated(float& s, float& c, float x) {
  const float t = s + x;
  const float bp = t - s;
  c += (s - (t - bp)) + (x - bp);
  s = t;
}

// v = LN(v) of one row held by a warp, lane holding columns lane + 32·t
// (t < NV) of d: statistics in f32 (mean, then the mean square about it),
// eps kLnEps.  Writes the row to y, its normalised values to xhat and its
// 1/std to *rstd, each where not null; v holds the output after.
template <int NV>
__device__ __forceinline__ void ln_row(float (&v)[NV], int d,
                                       const float* __restrict__ g,
                                       const float* __restrict__ b, float* y,
                                       float* xhat, float* rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < NV; ++t)
    if (lane + 32 * t < d) s += v[t];
  const float mean = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int t = 0; t < NV; ++t)
    if (lane + 32 * t < d) q += (v[t] - mean) * (v[t] - mean);
  const float rs = rsqrtf(warp_sum(q) / d + kLnEps);
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int c = lane + 32 * t;
    if (c < d) {
      const float xh = (v[t] - mean) * rs;
      v[t] = xh * g[c] + b[c];
      if (y) y[c] = v[t];
      if (xhat) xhat[c] = xh;
    }
  }
  if (rstd && lane == 0) *rstd = rs;
}

}  // namespace tower
