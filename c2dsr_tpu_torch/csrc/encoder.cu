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
// the kernel takes none of those branches.  In a training call with a
// `saved` buffer it also writes what the backward (encoder_bwd.cu) reads:
// every layer's activations for its rows (saved_layout, about 11·d floats
// a row), so the backward differentiates this very forward, ReLU masks and
// the -1e9 rounding of all-masked rows included, instead of a recompute.
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
                   float* __restrict__ saved,
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

  // load the block's rows; zero the pad rows of X and T and every row's
  // padding columns (the GEMMs read them at a ragged k chunk)
  const float* xb = x + (size_t)seq0 * L * d;
  const size_t row0 = (size_t)seq0 * L;
  const SavedLayout so = saved_layout((size_t)B * L, d, n_head, L, n_layers);
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
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(X + r * ldx + d)[0] = zero;
    reinterpret_cast<float4*>(T + r * ldx + d)[0] = zero;
  }
  __syncthreads();
  if (saved) save_rows(saved + so.xin0 + row0 * d, X, ldx, R, d);

  const int dh = d / n_head;
  const float inv_sqrt_dh = 1.f / sqrtf(static_cast<float>(dh));
  for (int li = 0; li < n_layers; ++li) {
    const float* w_qkv = l0.w_qkv + li * s_qkv;
    const float* b_qkv = l0.b_qkv + li * 3 * d;
    const size_t ow = li * s_dd;
    const size_t ob = (size_t)li * d;
    float* sv = saved ? saved + so.layers + li * so.per_layer : nullptr;

    gemm<kRows / 16>(X, ldx, w_qkv, b_qkv, d, 3 * d, Q, ldq, false, wt);
    if (sv) save_rows(sv + so.l.qkv + row0 * 3 * d, Q, ldq, R, 3 * d);
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
      if (sv && lane < L)
        sv[so.l.p + ((size_t)h * B * L + row0 + r) * L + lane] = p;
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
    if (sv) save_rows(sv + so.l.o + row0 * d, T, ldx, R, d);

    gemm<kRows / 16>(T, ldx, l0.w_out + ow, l0.b_out + ob, d, d, Q, ldq,
                     false, wt);
    if (dr.on) drop_rows(Q, ldq, R, d, seq0 * L, dr, dr.key(drop::kAttnOut, li));
    layer_norm_d(X, ldx, Q, ldq, l0.ln1_s + ob, l0.ln1_b + ob, X, ldx, R, d,
                 sv ? sv + so.l.xhat1 + row0 * d : nullptr,
                 sv ? sv + so.l.rstd1 + row0 : nullptr);
    if (sv) save_rows(sv + so.l.y1 + row0 * d, X, ldx, R, d);
    gemm<kRows / 16>(X, ldx, l0.w_ff1 + ow, l0.b_ff1 + ob, d, d, T, ldx, true,
                     wt);
    if (sv) save_rows(sv + so.l.fr + row0 * d, T, ldx, R, d);
    if (dr.on) drop_rows(T, ldx, R, d, seq0 * L, dr, dr.key(drop::kFfnRelu, li));
    if (sv) save_rows(sv + so.l.fd + row0 * d, T, ldx, R, d);
    gemm<kRows / 16>(T, ldx, l0.w_ff2 + ow, l0.b_ff2 + ob, d, d, Q, ldq,
                     false, wt);
    if (dr.on) drop_rows(Q, ldq, R, d, seq0 * L, dr, dr.key(drop::kFfnOut, li));
    layer_norm_d(X, ldx, Q, ldq, l0.ln2_s + ob, l0.ln2_b + ob, X, ldx, R, d,
                 sv ? sv + so.l.xhat2 + row0 * d : nullptr,
                 sv ? sv + so.l.rstd2 + row0 : nullptr);
    if (sv) save_rows(sv + so.l.xnext + row0 * d, X, ldx, R, d);
  }
  float* ob = out + (size_t)seq0 * L * d;
  layer_norm_d(X, ldx, nullptr, 0, lnf_s, lnf_b, ob, d, R, d,
               saved ? saved + so.xhat_f + row0 * d : nullptr,
               saved ? saved + so.rstd_f + row0 : nullptr);
}

}  // namespace

// The offsets of saved_layout, in floats: xin0, then per layer (at layers +
// li·per_layer) qkv, p, o, y1, xhat1, rstd1, fr, fd, xnext, xhat2, rstd2,
// then xhat_f, rstd_f and the total; out holds 17 values.
extern "C" void encoder_saved_offsets(int B, int L, int d, int n_head,
                                      int n_layers, long long* out) {
  const SavedLayout s = saved_layout((size_t)B * L, d, n_head, L, n_layers);
  const size_t v[17] = {s.xin0,    s.layers,   s.per_layer, s.l.qkv,
                        s.l.p,     s.l.o,      s.l.y1,      s.l.xhat1,
                        s.l.rstd1, s.l.fr,     s.l.fd,      s.l.xnext,
                        s.l.xhat2, s.l.rstd2,  s.xhat_f,    s.rstd_f,
                        s.total};
  for (int i = 0; i < 17; ++i) out[i] = (long long)v[i];
}

// Shared memory the kernel needs for feature width d, in bytes.
extern "C" int encoder_fwd_smem_bytes(int d) {
  const int rows = fwd_rows(d);
  return static_cast<int>(sizeof(float)) *
         (kTileK * kTileM + 2 * rows * (d + 4) + rows * (3 * d + 1)) +
         static_cast<int>(sizeof(int)) * rows;
}

// Weights are stacked over layers: w_qkv [NL, d, 3d], b_qkv [NL, 3d],
// w_out/w_ff1/w_ff2 [NL, d, d], biases and LN params [NL, d]; lnf [d].
// Requires d % 8 == 0, 8 <= d <= 256, d % n_head == 0, 1 <= L <= 32
// (encoder_cuda.supported): a block's 64 or 32 rows hold one L 30 sequence.
// Dropout: drop_on 0 is eval; else kept values are divided by drop_div
// (f32(1 - p)) where the hash bits reach drop_thr (ops/dropout.threshold).
// saved: null, or encoder_saved_floats floats (16-byte aligned) that
// receive the activations the backward reads.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int encoder_fwd_f32(
    const float* x, const int* seq, const float* w_qkv, const float* b_qkv,
    const float* w_out, const float* b_out, const float* w_ff1,
    const float* b_ff1, const float* w_ff2, const float* b_ff2,
    const float* ln1_s, const float* ln1_b, const float* ln2_s,
    const float* ln2_b, const float* lnf_s, const float* lnf_b, float* out,
    float* saved,
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
      lnf_b, out, saved, B, L, d, n_head, idx_pad, invert,
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
