// Fused forward of one causal self-attention tower, f32, in eval or with
// training dropout.
//
// Replaces the fused encoder forward Pallas kernel
// (c2dsr_tpu/ops/encoder_pallas.py, _fused_fwd_impl / _fwd_kernel /
// _forward_core).  One block runs every post-norm layer and the final
// LayerNorm for S = kRows / L whole sequences (R = S·L <= kRows rows;
// kRows = 64 up to d 128, 32 up to d 256, so that the block's buffers fit):
//   per layer: QKV = X·Wqkv + b; per head, causal + key-pad softmax with an
//   ADDED finite -1e9 bias (all-masked rows come out as the uniform average
//   over the L positions, as in c2dsr_tpu/ops/encoder.py); out-proj;
//   X = LN1(X + attn); F = relu(X·W1 + b1); X = LN2(X + F·W2 + b2);
//   then out = LNf(X).  LN statistics in f32, eps 1e-8.
// In training, dropout applies at the five sites of c2dsr_tpu/ops/encoder.py
// (the input, the attention probabilities, the out-projection, the FFN ReLU
// output and the FFN output), each mask drawn from the counter-based hash of
// dropout.cuh keyed by (seed, site, tower, layer) and the element's index in
// the site's tensor, so ops/encoder.py draws the same masks.  At dropout 0
// the kernel takes none of those branches.
//
// Bound on an H100 by operations (12·N·d² + 4·N·L·d FLOPs for N = B·L rows
// per layer, against the card's FP32 non-tensor-core peak); the bytes are
// one read of the input and one write of the output.  The activations of a
// block never leave shared memory (X, a scratch T and QKV: 5·d floats per
// row, 175 KB at d = 128 and 64 rows, 173 KB at d = 256 and 32 rows).  A
// layer's weights (393 KB at d = 128) do not fit beside them, so each
// matmul streams 32x64 weight tiles from L2 (a tower's
// weights sit there across all blocks) through shared memory; each thread
// accumulates a 4x4 output tile in registers.  Matmuls are FFMA in f32.
// The weights are read where they lie, and in a serving loop other work
// evicts them from L2 between launches: so at its start the grid asks L2 for
// every weight line of the tower at once, and the first blocks' pass over
// the 32x64 tiles does not wait on DRAM once per tile.

#include "encoder_common.cuh"

namespace {

using namespace tower;

// Rows (positions) held by one block at width d.
__host__ __device__ constexpr int fwd_rows(int d) { return d <= 128 ? 64 : 32; }

template <int kRows>
__global__ void __launch_bounds__(kThreads, 1)
encoder_fwd_kernel(const float* __restrict__ x, const int* __restrict__ seq,
                   Layer l0,
                   size_t s_qkv, size_t s_dd, int n_layers,
                   const float* __restrict__ lnf_s,
                   const float* __restrict__ lnf_b, float* __restrict__ out,
                   int B, int L, int d, int n_head, int idx_pad, int invert,
                   drop::Dropout dr) {
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
    if (dr.on && r < R) {
      const uint32_t k = dr.key(drop::kInput, 0);
      const uint32_t i0 = static_cast<uint32_t>((seq0 * L + r) * d + c4 * 4);
      val.x = dr.apply(val.x, k, i0);
      val.y = dr.apply(val.y, k, i0 + 1);
      val.z = dr.apply(val.z, k, i0 + 2);
      val.w = dr.apply(val.w, k, i0 + 3);
    }
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

    gemm<kRows / 16>(X, ldx, w_qkv, b_qkv, d, 3 * d, Q, ldq, false, wt);
    const uint32_t k_probs = dr.key(drop::kProbs, li);

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
      float p = e / warp_sum(e);
      if (dr.on)
        p = dr.apply(p, k_probs, static_cast<uint32_t>(
                                     (((seq0 + s) * n_head + h) * L + i) * L +
                                     lane));
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

    gemm<kRows / 16>(T, ldx, l0.w_out + ow, l0.b_out + ob, d, d, Q, ldq,
                     false, wt);
    if (dr.on) drop_rows(Q, ldq, R, d, seq0 * L, dr, dr.key(drop::kAttnOut, li));
    layer_norm_d(X, ldx, Q, ldq, l0.ln1_s + ob, l0.ln1_b + ob, X, ldx, R, d);
    gemm<kRows / 16>(X, ldx, l0.w_ff1 + ow, l0.b_ff1 + ob, d, d, T, ldx, true,
                     wt);
    if (dr.on) drop_rows(T, ldx, R, d, seq0 * L, dr, dr.key(drop::kFfnRelu, li));
    gemm<kRows / 16>(T, ldx, l0.w_ff2 + ow, l0.b_ff2 + ob, d, d, Q, ldq,
                     false, wt);
    if (dr.on) drop_rows(Q, ldq, R, d, seq0 * L, dr, dr.key(drop::kFfnOut, li));
    layer_norm_d(X, ldx, Q, ldq, l0.ln2_s + ob, l0.ln2_b + ob, X, ldx, R, d);
  }
  float* ob = out + (size_t)seq0 * L * d;
  layer_norm_d(X, ldx, nullptr, 0, lnf_s, lnf_b, ob, d, R, d);
}

}  // namespace

// Shared memory the kernel needs for feature width d, in bytes.
extern "C" int encoder_fwd_smem_bytes(int d) {
  const int rows = fwd_rows(d);
  return static_cast<int>(sizeof(float)) *
         (kTileK * kTileM + 2 * rows * (d + 4) + rows * (3 * d + 1)) +
         static_cast<int>(sizeof(int)) * rows;
}

// Weights are stacked over layers: w_qkv [NL, d, 3d], b_qkv [NL, 3d],
// w_out/w_ff1/w_ff2 [NL, d, d], biases and LN params [NL, d]; lnf [d].
// Requires d % 32 == 0, 32 <= d <= 256, d % n_head == 0, 1 <= L <= 32
// (L <= 16 for d > 128: encoder_cuda.supported).
// Dropout: drop_on 0 is eval; else kept values are divided by drop_div
// (f32(1 - p)) where the hash bits reach drop_thr (ops/dropout.threshold).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int encoder_fwd_f32(
    const float* x, const int* seq, const float* w_qkv, const float* b_qkv,
    const float* w_out, const float* b_out, const float* w_ff1,
    const float* b_ff1, const float* w_ff2, const float* b_ff2,
    const float* ln1_s, const float* ln1_b, const float* ln2_s,
    const float* ln2_b, const float* lnf_s, const float* lnf_b, float* out,
    int B, int L, int d, int n_head, int n_layers, int idx_pad, int invert,
    int drop_on, unsigned drop_thr, float drop_div, unsigned seed, int tower_id,
    void* stream) {
  const int smem = encoder_fwd_smem_bytes(d);
  const int rows = fwd_rows(d);
  auto kernel = rows == 64 ? encoder_fwd_kernel<64> : encoder_fwd_kernel<32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Layer l0{w_qkv, b_qkv, w_out, b_out, w_ff1, b_ff1, w_ff2, b_ff2,
           ln1_s, ln1_b, ln2_s, ln2_b};
  const int S = rows / L;
  const int blocks = (B + S - 1) / S;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, seq, l0, (size_t)d * 3 * d, (size_t)d * d, n_layers, lnf_s,
      lnf_b, out, B, L, d, n_head, idx_pad, invert,
      drop::Dropout{drop_on, drop_thr, drop_div, seed, tower_id});
  return static_cast<int>(cudaGetLastError());
}

// The dropout hash's bits of elements 0..n-1 of one stream, for checking the
// kernels' masks against ops/dropout.bits_reference.
__global__ void dropout_bits_kernel(drop::Dropout dr, int site, int layer,
                                    int n, unsigned* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    out[i] = drop::mix32((static_cast<uint32_t>(i) * drop::kGolden) ^
                         dr.key(site, layer));
}

extern "C" int dropout_bits_u32(unsigned seed, int site, int tower_id,
                                int layer, int n, unsigned* out,
                                void* stream) {
  dropout_bits_kernel<<<(n + 255) / 256, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      drop::Dropout{1, 0u, 1.f, seed, tower_id}, site, layer, n, out);
  return static_cast<int>(cudaGetLastError());
}
