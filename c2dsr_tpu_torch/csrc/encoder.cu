// Fused forward of one causal self-attention tower in eval (no dropout), f32.
//
// Replaces the fused encoder forward Pallas kernel
// (c2dsr_tpu/ops/encoder_pallas.py, _fused_fwd_impl / _fwd_kernel /
// _forward_core).  One block runs every post-norm layer and the final
// LayerNorm for S = 64 / L whole sequences (R = S·L <= 64 rows):
//   per layer: QKV = X·Wqkv + b; per head, causal + key-pad softmax with an
//   ADDED finite -1e9 bias (all-masked rows come out as the uniform average
//   over the L positions, as in c2dsr_tpu/ops/encoder.py); out-proj;
//   X = LN1(X + attn); F = relu(X·W1 + b1); X = LN2(X + F·W2 + b2);
//   then out = LNf(X).  LN statistics in f32, eps 1e-8.
//
// Bound on an H100 by operations (12·N·d² + 4·N·L·d FLOPs for N = B·L rows
// per layer, against the card's FP32 non-tensor-core peak); the bytes are
// one read of the input and one write of the output.  The activations of a
// block never leave shared memory (X, a scratch T and QKV: 5·d floats per
// row, 175 KB at d = 128).  A layer's weights (393 KB at d = 128) do not fit
// beside them, so each matmul streams 32x64 weight tiles from L2 (a tower's
// weights sit there across all blocks) through shared memory; each thread
// accumulates a 4x4 output tile in registers.  Matmuls are FFMA in f32.
// The weights are read where they lie, and in a serving loop other work
// evicts them from L2 between launches: so at its start the grid asks L2 for
// every weight line of the tower at once, and the first blocks' pass over
// the 32x64 tiles does not wait on DRAM once per tile.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;       // rows (positions) held by one block
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

// C[r, m] = act(sum_k A[r, k] W[k, m] + b[m]) for all kRows rows.
// A, C in shared memory (row strides lda, ldc); W [K, M] row-major in global
// memory.  K % 32 == 0, M % 64 == 0.  Thread (ty, tx) owns rows ty*4..+3 and
// columns m0 + tx*4..+3 of each 64-column chunk.
__device__ void gemm(const float* A, int lda, const float* __restrict__ W,
                     const float* __restrict__ bias, int K, int M, float* C,
                     int ldc, bool relu, float* wt) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int m0 = 0; m0 < M; m0 += kTileM) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kTileK) {
      __syncthreads();  // the previous tile is no longer read
      for (int v = tid; v < kTileK * kTileM / 4; v += kThreads) {
        const int r = v / (kTileM / 4);
        const int c4 = v % (kTileM / 4);
        reinterpret_cast<float4*>(wt)[v] = __ldg(
            reinterpret_cast<const float4*>(W + (size_t)(k0 + r) * M + m0) +
            c4);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kTileK; ++kk) {
        const float4 w = reinterpret_cast<const float4*>(wt + kk * kTileM)[tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = A[(ty * 4 + i) * lda + k0 + kk];
          acc[i][0] = fmaf(a, w.x, acc[i][0]);
          acc[i][1] = fmaf(a, w.y, acc[i][1]);
          acc[i][2] = fmaf(a, w.z, acc[i][2]);
          acc[i][3] = fmaf(a, w.w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tx * 4 + j;
      const float b = bias[m];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = acc[i][j] + b;
        if (relu) v = fmaxf(v, 0.f);
        C[(ty * 4 + i) * ldc + m] = v;
      }
    }
  }
  __syncthreads();
}

// X[r] = LN(X[r] + Y[r]) (or LN(X[r]) when Y is null) for r < n_rows, one
// warp per row; written to dst (row stride ldd), which may be X itself.
template <int NV>
__device__ void layer_norm_rows(const float* X, int ldx, const float* Y,
                                int ldy, const float* __restrict__ g,
                                const float* __restrict__ b, float* dst,
                                int ldd, int n_rows, int d) {
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
      if (c < d) dst[r * ldd + c] = (v[t] - mean) * rstd * g[c] + b[c];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
encoder_fwd_kernel(const float* __restrict__ x, const int* __restrict__ seq,
                   Layer l0,
                   size_t s_qkv, size_t s_dd, int n_layers,
                   const float* __restrict__ lnf_s,
                   const float* __restrict__ lnf_b, float* __restrict__ out,
                   int B, int L, int d, int n_head, int idx_pad, int invert) {
  extern __shared__ float4 smem4[];
  float* wt = reinterpret_cast<float*>(smem4);
  const int ldx = d + 4;
  const int ldq = 3 * d + 1;
  float* X = wt + kTileK * kTileM;
  float* T = X + kRows * ldx;
  float* Q = T + kRows * ldx;
  int* key_ok = reinterpret_cast<int*>(Q + kRows * ldq);

  const int S = kRows / L;
  const int seq0 = blockIdx.x * S;
  const int nseq = min(S, B - seq0);
  const int R = nseq * L;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d4 = d / 4;

  prefetch_l2(l0.w_qkv, n_layers * s_qkv);
  prefetch_l2(l0.w_out, n_layers * s_dd);
  prefetch_l2(l0.w_ff1, n_layers * s_dd);
  prefetch_l2(l0.w_ff2, n_layers * s_dd);

  // load the block's rows; zero the pad rows of X and T
  const float* xb = x + (size_t)seq0 * L * d;
  for (int v = tid; v < kRows * d4; v += kThreads) {
    const int r = v / d4;
    const int c4 = v % d4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < R) val = __ldg(reinterpret_cast<const float4*>(xb) + v);
    reinterpret_cast<float4*>(X + r * ldx)[c4] = val;
    reinterpret_cast<float4*>(T + r * ldx)[c4] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int r = tid; r < kRows; r += kThreads) {
    const bool real = r < R && seq[(size_t)seq0 * L + r] != idx_pad;
    key_ok[r] = invert ? !real : real;
  }
  __syncthreads();

  const int dh = d / n_head;
  const float inv_sqrt_dh = 1.f / sqrtf(static_cast<float>(dh));
  for (int li = 0; li < n_layers; ++li) {
    const float* w_qkv = l0.w_qkv + li * s_qkv;
    const float* b_qkv = l0.b_qkv + li * 3 * d;
    const size_t ow = li * s_dd;
    const size_t ob = (size_t)li * d;

    gemm(X, ldx, w_qkv, b_qkv, d, 3 * d, Q, ldq, false, wt);

    // attention: one warp per (head, query row); lane j holds key j
    for (int q = warp; q < n_head * R; q += kThreads / 32) {
      const int h = q / R;
      const int r = q % R;
      const int s = r / L;
      const int i = r % L;
      const int rk = s * L + lane;
      float logit = -CUDART_INF_F;
      if (lane < L) {
        const float* qp = Q + r * ldq + h * dh;
        const float* kp = Q + rk * ldq + d + h * dh;
        float dot = 0.f;
        for (int c = 0; c < dh; ++c) dot = fmaf(qp[c], kp[c], dot);
        const bool ok = lane <= i && key_ok[rk];
        logit = dot * inv_sqrt_dh + (ok ? 0.f : kNeg);
      }
      const float mx = warp_max(logit);
      const float e = lane < L ? expf(logit - mx) : 0.f;
      const float p = e / warp_sum(e);
      for (int c0 = 0; c0 < dh; c0 += 32) {
        const int c = c0 + lane;
        float acc = 0.f;
        for (int j = 0; j < L; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
          if (c < dh) acc = fmaf(pj, Q[(s * L + j) * ldq + 2 * d + h * dh + c], acc);
        }
        if (c < dh) T[r * ldx + h * dh + c] = acc;
      }
    }
    __syncthreads();

    gemm(T, ldx, l0.w_out + ow, l0.b_out + ob, d, d, Q, ldq, false, wt);
    if (d <= 64)
      layer_norm_rows<2>(X, ldx, Q, ldq, l0.ln1_s + ob, l0.ln1_b + ob, X, ldx, R, d);
    else
      layer_norm_rows<4>(X, ldx, Q, ldq, l0.ln1_s + ob, l0.ln1_b + ob, X, ldx, R, d);
    gemm(X, ldx, l0.w_ff1 + ow, l0.b_ff1 + ob, d, d, T, ldx, true, wt);
    gemm(T, ldx, l0.w_ff2 + ow, l0.b_ff2 + ob, d, d, Q, ldq, false, wt);
    if (d <= 64)
      layer_norm_rows<2>(X, ldx, Q, ldq, l0.ln2_s + ob, l0.ln2_b + ob, X, ldx, R, d);
    else
      layer_norm_rows<4>(X, ldx, Q, ldq, l0.ln2_s + ob, l0.ln2_b + ob, X, ldx, R, d);
  }
  float* ob = out + (size_t)seq0 * L * d;
  if (d <= 64)
    layer_norm_rows<2>(X, ldx, nullptr, 0, lnf_s, lnf_b, ob, d, R, d);
  else
    layer_norm_rows<4>(X, ldx, nullptr, 0, lnf_s, lnf_b, ob, d, R, d);
}

}  // namespace

// Shared memory the kernel needs for feature width d, in bytes.
extern "C" int encoder_fwd_smem_bytes(int d) {
  return static_cast<int>(sizeof(float)) *
         (kTileK * kTileM + 2 * kRows * (d + 4) + kRows * (3 * d + 1)) +
         static_cast<int>(sizeof(int)) * kRows;
}

// Weights are stacked over layers: w_qkv [NL, d, 3d], b_qkv [NL, 3d],
// w_out/w_ff1/w_ff2 [NL, d, d], biases and LN params [NL, d]; lnf [d].
// Requires d % 64 == 0, d <= 128, d % n_head == 0, 1 <= L <= 32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int encoder_fwd_f32(
    const float* x, const int* seq, const float* w_qkv, const float* b_qkv,
    const float* w_out, const float* b_out, const float* w_ff1,
    const float* b_ff1, const float* w_ff2, const float* b_ff2,
    const float* ln1_s, const float* ln1_b, const float* ln2_s,
    const float* ln2_b, const float* lnf_s, const float* lnf_b, float* out,
    int B, int L, int d, int n_head, int n_layers, int idx_pad, int invert,
    void* stream) {
  const int smem = encoder_fwd_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Layer l0{w_qkv, b_qkv, w_out, b_out, w_ff1, b_ff1, w_ff2, b_ff2,
           ln1_s, ln1_b, ln2_s, ln2_b};
  const int S = kRows / L;
  const int blocks = (B + S - 1) / S;
  encoder_fwd_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, seq, l0, (size_t)d * 3 * d, (size_t)d * d, n_layers, lnf_s,
      lnf_b, out, B, L, d, n_head, idx_pad, invert);
  return static_cast<int>(cudaGetLastError());
}
