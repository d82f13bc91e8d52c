// Forward of one causal self-attention tower (post-norm), f32, in eval or
// with training dropout.
//
// Replaces the fused encoder forward Pallas kernel
// (c2dsr_tpu/ops/encoder_pallas.py, _fused_fwd_impl / _fwd_kernel /
// _forward_core): per layer QKV = X·Wqkv + b; per head, causal + key-pad
// softmax with an ADDED finite -1e9 bias (an all-masked row comes out as
// the uniform average over the L positions, as in c2dsr_tpu/ops/encoder.py);
// out-projection; X = LN1(X + attn); F = relu(X·W1 + b1);
// X = LN2(X + F·W2 + b2); then out = LNf(X).  LN statistics in f32, eps
// 1e-8.  In training, dropout applies at the five sites of
// c2dsr_tpu/ops/encoder.py (the input, the attention probabilities, the
// out-projection, the FFN ReLU output and the FFN output), each mask drawn
// from the counter-based hash of dropout.cuh keyed by (seed, site, tower,
// layer) and the element's index in the site's tensor, so ops/encoder.py
// draws the same masks.
//
// Bound on an H100 by operations: 12·N·d² + 4·N·L·d FLOPs a layer for
// N = B·L rows, f32-accurate, against 3xTF32 on the tensor cores.  The
// design is a sequence of kernels over all N rows of the call, the
// structure of the backward (encoder_bwd.cu):
// * The four products with a weight (QKV, out-projection, FF1, FF2) run on
//   the tensor cores at f32 accuracy (3xTF32 on mma.sync.m16n8k8, tc.cuh's
//   gemm_tile, which the backward shares): 64 rows a block, 16 a warp, W
//   read in its [k, m] layout through a 2-stage cp.async ring, 3 blocks an
//   SM, the output columns tiled over the grid.  The
//   epilogue adds the bias and folds in what follows the product: ReLU
//   and its dropout; the dropout, residual add and LayerNorm
//   of a post-norm step (up to d 256 a block holds whole rows and the
//   LayerNorm runs in its registers, the final LN after the last LN2;
//   above, encoder_fwd_ln_kernel does it, a warp a row).
// * Attention: up to 8 whole sequences a block (64 rows), a warp serving
//   one, a lane two of its keys (L <= 64); q, k, v staged a head and 64
//   columns at a time and read as float4, in FFMA, 4 blocks an SM: 4·N·L·d
//   FLOPs, a few percent of the tower.  The logits' sums over the head's
//   columns are compensated (add_compensated), for the reason the QKV
//   product is f32-accurate (encoder_fwd_gemm_kernel).
// * Every intermediate lands in the saved-activation layout (saved_layout):
//   in training the buffer the backward reads, so saving costs nothing
//   beyond the writes each kernel makes anyway; in eval a one-layer
//   workspace of the same layout, with the backward's extras (p, xhat,
//   1/std) not written.
// A one-layer tower call launches 6 kernels up to d 256 (5 in eval without
// dropout: the input kernel only applies dropout or saves the input) and 8
// above; each further layer adds 5, or 7.
//
// The bf16 instantiation (encoder_fwd's bf16; compute_dtype="bfloat16") is
// the Pallas kernel's matmul_dtype=bf16: every product rounds both
// operands to bf16 (round to nearest even) and sums in f32, the four GEMMs
// as gemm_tile's TERMS 1 (one TF32 MMA of bf16 operands a k-step, exact
// products), q·kᵀ and p·v in the attention kernel as FFMA over q, k, v and
// the dropped probabilities rounded as they are staged (a product of two
// bf16 values is exact in f32), the logits scaled after the product.
// LayerNorm, softmax, dropout, the residual adds and every saved
// activation stay f32: the backward (encoder_bwd.cu) rounds them where it
// multiplies them.

#include "encoder_common.cuh"
#include "tc.cuh"

namespace {

using namespace tower;
using namespace tc;

// ------------------------------------------------------------ the GEMM ----

// What follows C = A·W + b, per output element (row r, column c; element
// index r·m + c, which is also the dropout index of a [B, L, d] site).
enum FwdEpi : int {
  kBias = 0,      // c = acc + b
  kRelu = 1,      // c = relu(acc + b); c2 = drop(c) where c2 is not null
  kResidual = 2,  // c = drop(acc + b) + res
  kResLn = 3,     // kResidual's row, then LayerNorm (and the final LN)
};

struct FwdGemm {
  const float* a;      // A [n, k] row-major
  const float* w;      // W [k, m] row-major
  const float* bias;   // [m]
  float* c;            // [n, m] (kResLn: the LN output; may be null)
  float* c2;           // kRelu: the dropped copy, or null
  const float* res;    // kResidual, kResLn: [n, m]
  int n, k, m, epi;
  drop::Dropout dr;    // dropout where dr.on
  uint32_t salt;       // of the epilogue's stream (drop::Dropout::salt)
  // kResLn (the block holds whole rows): LN scale and bias, and where not
  // null the normalised rows and 1/std; with lnf_s the final LN follows,
  // into out, xhat_f and rstd_f.
  const float *ln_s, *ln_b;
  float *xhat, *rstd;
  const float *lnf_s, *lnf_b;
  float *out, *xhat_f, *rstd_f;
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// LayerNorm of fragment row h (acc[j][2h], acc[j][2h + 1]: columns
// 8·j + 2·tq and the next, of m) over the quad that holds the row; acc
// holds the output after.  Writes where live and the pointer is not null.
template <int kNj>
__device__ __forceinline__ void ln_fragment_row(
    float (*acc)[4], int h, int m, int tq, bool live, size_t row,
    const float* __restrict__ g, const float* __restrict__ b, float* y,
    float* xhat, float* rstd) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kNj; ++j)
    if (j * 8 + 2 * tq < m) s += acc[j][2 * h] + acc[j][2 * h + 1];
  const float mean = quad_sum(s) / m;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kNj; ++j) {
    if (j * 8 + 2 * tq < m) {
      const float u = acc[j][2 * h] - mean, w = acc[j][2 * h + 1] - mean;
      q += u * u + w * w;
    }
  }
  const float rs = rsqrtf(quad_sum(q) / m + kLnEps);
#pragma unroll
  for (int j = 0; j < kNj; ++j) {
    const int col = j * 8 + 2 * tq;
    if (col < m) {
      const float2 xh = make_float2((acc[j][2 * h] - mean) * rs,
                                    (acc[j][2 * h + 1] - mean) * rs);
      const float2 gg = *reinterpret_cast<const float2*>(g + col);
      const float2 bb = *reinterpret_cast<const float2*>(b + col);
      acc[j][2 * h] = xh.x * gg.x + bb.x;
      acc[j][2 * h + 1] = xh.y * gg.y + bb.y;
      if (live) {
        const size_t idx = row * m + col;
        if (y)
          *reinterpret_cast<float2*>(y + idx) =
              make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        if (xhat) *reinterpret_cast<float2*>(xhat + idx) = xh;
      }
    }
  }
  if (live && rstd && tq == 0) rstd[row] = rs;
}

// The QKV product takes tc.cuh's 6-term form, f32-accurate; the others
// 3xTF32.  The logits feed a softmax that is partly sharp in training (a
// row's largest p between 0.5 and 0.99), where a row's gradient carries
// the absolute error of its probabilities, and so of its logits, divided
// by 1 - max p: with 3xTF32's q and k, whose tensor-core sums are several
// times further from exact than an f32 GEMM's, a d 256 step's w_qkv
// gradient sat three times further from the exact one than the plain f32
// tower's (an H100's measurement, PERF.md §6).
constexpr int kQkvTerms = 6, kTerms = 3, kBf16Terms = 1;

// kMap: the call's dropout maps its rows (drop::Dropout::mapped).
template <int NT, int TERMS, bool kMap>
__global__ void __launch_bounds__(kGemmThreads, 3)
encoder_fwd_gemm_kernel(const FwdGemm g) {
  constexpr int kNj = NT / 8;
  extern __shared__ float4 smem4[];
  const int row0 = blockIdx.x * kGemmRows;
  const int n0 = blockIdx.y * NT;
  float acc[kNj][4];
  gemm_tile<NT, true, TERMS>(g.a, g.w, g.n, g.k, g.m, row0, n0,
                             reinterpret_cast<float*>(smem4), acc);
  const uint32_t key = g.dr.key(g.salt);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tq = lane & 3;
  const int r_lo = row0 + warp * 16 + (lane >> 2);
  if (g.epi != kResLn) {
    // elements 2h and 2h + 1 of n-tile j as one float2 (m % 8 == 0: both
    // or neither in range)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_lo + 8 * h;
      if (row >= g.n) continue;
      const size_t base = (size_t)row * g.m;
      const uint32_t dbase = kMap ? g.dr.row_index(row, g.m) : 0u;
#pragma unroll
      for (int j = 0; j < kNj; ++j) {
        const int col = n0 + j * 8 + 2 * tq;
        if (col >= g.m) continue;
        const size_t idx = base + col;
        const uint32_t di = kMap ? dbase + col : static_cast<uint32_t>(idx);
        const float2 b = *reinterpret_cast<const float2*>(g.bias + col);
        float2 v = make_float2(acc[j][2 * h] + b.x, acc[j][2 * h + 1] + b.y);
        if (g.epi == kRelu) {
          v.x = fmaxf(v.x, 0.f);
          v.y = fmaxf(v.y, 0.f);
          *reinterpret_cast<float2*>(g.c + idx) = v;
          if (g.c2) {
            if (g.dr.on) {
              v.x = g.dr.apply(v.x, key, di);
              v.y = g.dr.apply(v.y, key, di + 1);
            }
            *reinterpret_cast<float2*>(g.c2 + idx) = v;
          }
          continue;
        }
        if (g.epi == kResidual) {
          if (g.dr.on) {
            v.x = g.dr.apply(v.x, key, di);
            v.y = g.dr.apply(v.y, key, di + 1);
          }
          const float2 r = *reinterpret_cast<const float2*>(g.res + idx);
          v.x += r.x;
          v.y += r.y;
        }
        *reinterpret_cast<float2*>(g.c + idx) = v;
      }
    }
    return;
  }
  // kResLn: one column tile (n0 == 0, NT >= m) holds whole rows; a row's
  // columns lie on the four threads of a quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + 8 * h;
    const bool live = row < g.n;
    const uint32_t dbase = kMap && live ? g.dr.row_index(row, g.m) : 0u;
#pragma unroll
    for (int j = 0; j < kNj; ++j) {
      const int col = j * 8 + 2 * tq;
      float2 v = make_float2(0.f, 0.f);
      if (live && col < g.m) {
        const size_t idx = (size_t)row * g.m + col;
        const uint32_t di = kMap ? dbase + col : static_cast<uint32_t>(idx);
        const float2 b = *reinterpret_cast<const float2*>(g.bias + col);
        v = make_float2(acc[j][2 * h] + b.x, acc[j][2 * h + 1] + b.y);
        if (g.dr.on) {
          v.x = g.dr.apply(v.x, key, di);
          v.y = g.dr.apply(v.y, key, di + 1);
        }
        const float2 r = *reinterpret_cast<const float2*>(g.res + idx);
        v.x += r.x;
        v.y += r.y;
      }
      acc[j][2 * h] = v.x;
      acc[j][2 * h + 1] = v.y;
    }
    ln_fragment_row<kNj>(acc, h, g.m, tq, live, row, g.ln_s, g.ln_b, g.c,
                         g.xhat, g.rstd);
    if (g.lnf_s)
      ln_fragment_row<kNj>(acc, h, g.m, tq, live, row, g.lnf_s, g.lnf_b,
                           g.out, g.xhat_f, g.rstd_f);
  }
}

// ------------------------------------------------------- the attention ----

// Dynamic shared memory of encoder_fwd_attn_kernel at length L, in bytes:
// for R = attn_seqs(L)·L rows, a chunk of q (then v) and of k [R][kLdc],
// the dropped probabilities [R][round4(L)] and the key flags.
__host__ __device__ constexpr int attn_fwd_smem(int L) {
  return 4 * attn_seqs(L) * L * (2 * kLdc + round4(L) + 1);
}

// Per block, S = attn_seqs(L) sequences (blockIdx.x·S + s), per head: warp
// w serves sequence s = w / (8 / S) and its query rows w % (8 / S) +
// (8 / S)·t, a lane the keys lane and lane + 32.  Logits over 64-column
// chunks of q and k (float4 reads), the softmax with the added -1e9 bias,
// the pre-dropout probabilities saved where p_save is not null, dropout,
// then o = P·V over chunks of v (a lane a column).  kBf: q, k, v and the
// dropped probabilities rounded to bf16 as they are staged (the bf16
// instantiation's products); p_save stays f32.
template <bool kBf>
__global__ void __launch_bounds__(kThreads, 4)
encoder_fwd_attn_kernel(const float* __restrict__ qkv,
                        const int* __restrict__ seq, float* __restrict__ o,
                        float* __restrict__ p_save, int B, int L, int d,
                        int n_head, int idx_pad, int invert,
                        drop::Dropout dr, uint32_t salt) {
  extern __shared__ float4 smem4[];
  const uint32_t key = dr.key(salt);
  const int S = attn_seqs(L);
  const int R = S * L;
  const int ldp = round4(L);
  float* QV = reinterpret_cast<float*>(smem4);
  float* K = QV + R * kLdc;
  float* P = K + R * kLdc;
  int* key_ok = reinterpret_cast<int*>(P + R * ldp);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wps = 8 / S;                     // warps a sequence
  const int s = warp / wps;
  const int b = blockIdx.x * S + s;          // this warp's sequence
  const uint32_t gb = dr.batch(b);           // its row of the run's batch
  const bool active = b < B;
  const int seq0 = blockIdx.x * S;
  const int R_in = min(S, B - seq0) * L;     // rows of the block in range
  const size_t grow0 = (size_t)seq0 * L;     // the block's first row
  const size_t N = (size_t)B * L;
  const int dh = d / n_head;
  const int d3 = 3 * d;
  const float inv_sqrt_dh = 1.f / sqrtf(static_cast<float>(dh));
  for (int r = threadIdx.x; r < R_in; r += kThreads) {
    const bool real = seq[grow0 + r] != idx_pad;
    key_ok[r] = invert ? !real : real;
  }
  const float* Ks = K + s * L * kLdc;        // this warp's sequence's rows
  const float* Qs = QV + s * L * kLdc;
  float* Ps = P + s * L * ldp;
  // [R_in rows][4·cw4 columns from col] of qkv into dst (kBf: rounded)
  auto load = [&](float* dst, int col, int cw4) {
    for (int v = threadIdx.x; v < R_in * cw4; v += kThreads) {
      const int r = v / cw4, c = (v % cw4) * 4;
      float4 x =
          *reinterpret_cast<const float4*>(qkv + (grow0 + r) * d3 + col + c);
      if constexpr (kBf)
        x = make_float4(bf16f(x.x), bf16f(x.y), bf16f(x.z), bf16f(x.w));
      *reinterpret_cast<float4*>(dst + r * kLdc + c) = x;
    }
  };
  for (int h = 0; h < n_head; ++h) {
    float acc[8][2], cmp[8][2];          // the logits' sums, compensated
#pragma unroll
    for (int t = 0; t < 8; ++t)
      acc[t][0] = acc[t][1] = cmp[t][0] = cmp[t][1] = 0.f;
    for (int c0 = 0; c0 < dh; c0 += kCh) {
      const int cw4 = min(kCh, dh - c0) / 4;
      __syncthreads();     // the previous chunk's (or head's) readers
      load(QV, h * dh + c0, cw4);
      load(K, d + h * dh + c0, cw4);
      __syncthreads();
      if (!active) continue;
      for (int c4 = 0; c4 < cw4; ++c4) {
        const float4 k0 = lane < L
            ? *reinterpret_cast<const float4*>(Ks + lane * kLdc + 4 * c4)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 k1 =
            lane + 32 < L
                ? *reinterpret_cast<const float4*>(Ks + (lane + 32) * kLdc
                                                   + 4 * c4)
                : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int i = warp % wps + wps * t;
          if (i < L) {
            const float4 q =
                *reinterpret_cast<const float4*>(Qs + i * kLdc + 4 * c4);
            add_compensated(acc[t][0], cmp[t][0], dot4(q, k0, 0.f));
            add_compensated(acc[t][1], cmp[t][1], dot4(q, k1, 0.f));
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int i = warp % wps + wps * t;
        if (i >= L) continue;              // uniform over the warp
        float lg[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = lane + 32 * u;
          lg[u] = -CUDART_INF_F;
          if (j < L)
            lg[u] = (acc[t][u] + cmp[t][u]) * inv_sqrt_dh
                    + (j <= i && key_ok[s * L + j] ? 0.f : kNeg);
        }
        const float mx = warp_max(fmaxf(lg[0], lg[1]));
        float e[2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          e[u] = lane + 32 * u < L ? expf(lg[u] - mx) : 0.f;
        const float sum = warp_sum(e[0] + e[1]);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = lane + 32 * u;
          if (j >= ldp) continue;
          float p = 0.f;                   // zero past L: the P·V pad
          if (j < L) {
            p = e[u] / sum;
            if (p_save)
              p_save[((size_t)h * N + (size_t)b * L + i) * L + j] = p;
            if (dr.on)
              p = dr.apply(p, key, static_cast<uint32_t>(
                                       (((size_t)gb * n_head + h) * L + i) * L
                                       + j));
          }
          Ps[i * ldp + j] = kBf ? bf16f(p) : p;
        }
      }
    }
    for (int c0 = 0; c0 < dh; c0 += kCh) {
      const int cw4 = min(kCh, dh - c0) / 4;
      __syncthreads();     // P written; the previous chunk's readers done
      load(QV, 2 * d + h * dh + c0, cw4);
      __syncthreads();
      if (!active) continue;
      const int cw = cw4 * 4;
      float out[8][2];
#pragma unroll
      for (int t = 0; t < 8; ++t) out[t][0] = out[t][1] = 0.f;
      for (int j4 = 0; j4 < ldp; j4 += 4) {
        float4 p4[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int i = warp % wps + wps * t;
          p4[t] = i < L ? *reinterpret_cast<const float4*>(Ps + i * ldp + j4)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j4 + jj;
          if (j >= L) break;
          const float v0 = lane < cw ? Qs[j * kLdc + lane] : 0.f;
          const float v1 = lane + 32 < cw ? Qs[j * kLdc + lane + 32] : 0.f;
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float pj = jj == 0 ? p4[t].x : jj == 1 ? p4[t].y
                             : jj == 2 ? p4[t].z : p4[t].w;
            out[t][0] = fmaf(pj, v0, out[t][0]);
            out[t][1] = fmaf(pj, v1, out[t][1]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int i = warp % wps + wps * t;
        if (i >= L) continue;
        float* dst = o + ((size_t)b * L + i) * d + h * dh + c0;
        if (lane < cw) dst[lane] = out[t][0];
        if (lane + 32 < cw) dst[lane + 32] = out[t][1];
      }
    }
  }
}

// ----------------------------------------------------- the row kernels ----

// xin = drop(x) (a copy at dropout 0), 4 floats a thread; the input site's
// element index is the flat index into [B, L, d] (kMap: of the run's).
template <bool kMap>
__global__ void __launch_bounds__(kThreads)
encoder_fwd_input_kernel(const float4* __restrict__ x,
                         float4* __restrict__ xin, size_t n4,
                         drop::Dropout dr, uint32_t salt) {
  const uint32_t key = dr.key(salt);
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * kThreads) {
    float4 v = x[i];
    if (dr.on) {
      const uint32_t e = kMap ? dr.flat_index(static_cast<uint32_t>(4 * i))
                              : static_cast<uint32_t>(4 * i);
      v.x = dr.apply(v.x, key, e);
      v.y = dr.apply(v.y, key, e + 1);
      v.z = dr.apply(v.z, key, e + 2);
      v.w = dr.apply(v.w, key, e + 3);
    }
    xin[i] = v;
  }
}

// One warp a row of z [n, d] (d > 256, where no GEMM block holds whole
// rows): y = LN(z) (into y, xhat and rstd, each where not null), and with
// gf the final LN of y after it (into out, xhat_f, rstd_f).  z may be xhat
// itself: a lane reads its columns before it writes them.
template <int NV>
__global__ void __launch_bounds__(kThreads)
encoder_fwd_ln_kernel(const float* z, const float* __restrict__ g,
                      const float* __restrict__ b, float* y, float* xhat,
                      float* rstd, const float* __restrict__ gf,
                      const float* __restrict__ bf, float* out,
                      float* xhat_f, float* rstd_f, int n, int d) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= n) return;
  const size_t at = (size_t)r * d;
  float v[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int c = lane + 32 * t;
    v[t] = c < d ? z[at + c] : 0.f;
  }
  ln_row(v, d, g, b, y ? y + at : nullptr, xhat ? xhat + at : nullptr,
         rstd ? rstd + r : nullptr);
  if (gf)
    ln_row(v, d, gf, bf, out + at, xhat_f ? xhat_f + at : nullptr,
           rstd_f ? rstd_f + r : nullptr);
}

// ------------------------------------------------------------ the host ----

#define TRY(x)                                   \
  do {                                           \
    const cudaError_t e_ = (x);                  \
    if (e_ != cudaSuccess) return e_;            \
  } while (0)

// The output tile width of the narrowest of 64, 128, 256 columns that holds
// d (the width at which the LayerNorm epilogue holds whole rows).
int width_tile(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

// The output tile width of a product with m columns: whole up to 256; above,
// 256 where it divides m, else 128.
int column_tile(int m) {
  return m <= 256 ? width_tile(m) : m % 256 == 0 ? 256 : 128;
}

// Lets each kernel take its dynamic shared memory; once per device.
cudaError_t prepare() {
  static bool done[64] = {};
  int dev = 0;
  TRY(cudaGetDevice(&dev));
  if (dev < 64 && done[dev]) return cudaSuccess;
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<64, kTerms, false>, a,
                           GemmCfg<64, true>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<128, kTerms, false>, a,
                           GemmCfg<128, true>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<256, kTerms, false>, a,
                           GemmCfg<256, true>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<64, kTerms, true>, a,
                           GemmCfg<64, true>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<128, kTerms, true>, a,
                           GemmCfg<128, true>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<256, kTerms, true>, a,
                           GemmCfg<256, true>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<64, kQkvTerms, false>, a,
                           GemmCfg<64, true>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<128, kQkvTerms, false>, a,
                           GemmCfg<128, true>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<256, kQkvTerms, false>, a,
                           GemmCfg<256, true>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<64, kBf16Terms, false>, a,
                           GemmCfg<64, true>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<128, kBf16Terms, false>,
                           a, GemmCfg<128, true>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<256, kBf16Terms, false>,
                           a, GemmCfg<256, true>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<64, kBf16Terms, true>, a,
                           GemmCfg<64, true>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<128, kBf16Terms, true>, a,
                           GemmCfg<128, true>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<256, kBf16Terms, true>, a,
                           GemmCfg<256, true>::kSmem));
  int most = 0;
  for (int L = 1; L <= kMaxL; ++L)
    most = attn_fwd_smem(L) > most ? attn_fwd_smem(L) : most;
  TRY(cudaFuncSetAttribute(encoder_fwd_attn_kernel<false>, a, most));
  TRY(cudaFuncSetAttribute(encoder_fwd_attn_kernel<true>, a, most));
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

template <int NT, int TERMS, bool kMap>
cudaError_t gemm_t(const FwdGemm& g, cudaStream_t s) {
  const dim3 grid((g.n + kGemmRows - 1) / kGemmRows, (g.m + NT - 1) / NT);
  encoder_fwd_gemm_kernel<NT, TERMS, kMap>
      <<<grid, kGemmThreads, GemmCfg<NT, true>::kSmem, s>>>(g);
  return cudaGetLastError();
}

template <int TERMS, bool kMap>
cudaError_t launch_gemm_t(const FwdGemm& g, int nt, cudaStream_t s) {
  return nt == 64    ? gemm_t<64, TERMS, kMap>(g, s)
         : nt == 128 ? gemm_t<128, TERMS, kMap>(g, s)
                     : gemm_t<256, TERMS, kMap>(g, s);
}

// The QKV product, which has no dropout site.
cudaError_t launch_qkv_gemm(const FwdGemm& g, int nt, bool bf16,
                            cudaStream_t s) {
  return bf16 ? launch_gemm_t<kBf16Terms, false>(g, nt, s)
              : launch_gemm_t<kQkvTerms, false>(g, nt, s);
}

// The other products: the row map's instantiation where the call maps its
// rows.
cudaError_t launch_gemm(const FwdGemm& g, int nt, bool bf16, cudaStream_t s) {
  if (bf16)
    return g.dr.mapped() ? launch_gemm_t<kBf16Terms, true>(g, nt, s)
                         : launch_gemm_t<kBf16Terms, false>(g, nt, s);
  return g.dr.mapped() ? launch_gemm_t<kTerms, true>(g, nt, s)
                       : launch_gemm_t<kTerms, false>(g, nt, s);
}

// The LayerNorm kernel's launch (d > 256: 16 columns a lane).
cudaError_t launch_ln(const float* z, const float* g, const float* b,
                      float* y, float* xhat, float* rstd, const float* gf,
                      const float* bf, float* out, float* xhat_f,
                      float* rstd_f, int n, int d, cudaStream_t s) {
  const int blocks = (n + kThreads / 32 - 1) / (kThreads / 32);
  encoder_fwd_ln_kernel<16><<<blocks, kThreads, 0, s>>>(
      z, g, b, y, xhat, rstd, gf, bf, out, xhat_f, rstd_f, n, d);
  return cudaGetLastError();
}

// buf: with save, saved_layout(N, d, n_head, L, n_layers) (every layer's
// activations, for the backward); else a one-layer workspace of the same
// layout, which every layer reuses.  bf16: the bf16 instantiation.
cudaError_t run_fwd(const float* x, const int* seq, const Layer& l0,
                    const float* lnf_s, const float* lnf_b, float* out,
                    float* buf, bool save, int B, int L, int d, int n_head,
                    int n_layers, int idx_pad, int invert, drop::Dropout dr,
                    bool bf16, cudaStream_t s) {
  const size_t N = (size_t)B * L;
  const int n = static_cast<int>(N);
  const SavedLayout so = saved_layout(N, d, n_head, L, save ? n_layers : 1);
  const size_t s_qkv = (size_t)d * 3 * d, s_dd = (size_t)d * d;
  const bool fused_ln = d <= 256;
  TRY(prepare());

  const float* X = x;
  if (save || dr.on) {
    float* xin = buf + so.xin0;
    const size_t n4 = N * d / 4;
    const int blocks = static_cast<int>(
        n4 / kThreads + 1 < 4096 ? n4 / kThreads + 1 : 4096);
    const auto* x4 = reinterpret_cast<const float4*>(x);
    auto* xin4 = reinterpret_cast<float4*>(xin);
    if (dr.mapped())
      encoder_fwd_input_kernel<true><<<blocks, kThreads, 0, s>>>(
          x4, xin4, n4, dr, dr.salt(drop::kInput, 0));
    else
      encoder_fwd_input_kernel<false><<<blocks, kThreads, 0, s>>>(
          x4, xin4, n4, dr, dr.salt(drop::kInput, 0));
    TRY(cudaGetLastError());
    X = xin;
  }
  for (int li = 0; li < n_layers; ++li) {
    float* lb = buf + so.layers + (save ? li * so.per_layer : 0);
    float* qkv = lb + so.l.qkv;
    float* o = lb + so.l.o;
    float* y1 = lb + so.l.y1;
    float* fr = lb + so.l.fr;
    float* fd = lb + so.l.fd;
    float* xhat1 = lb + so.l.xhat1;
    float* xhat2 = lb + so.l.xhat2;
    const bool last = li == n_layers - 1;
    // the eval workspace's last layer writes out, not xnext
    float* xnext = save || !last ? lb + so.l.xnext : nullptr;
    const size_t ob = (size_t)li * d;

    FwdGemm q{};
    q.a = X; q.w = l0.w_qkv + li * s_qkv; q.bias = l0.b_qkv + 3 * ob;
    q.c = qkv; q.n = n; q.k = d; q.m = 3 * d; q.epi = kBias; q.dr = dr;
    TRY(launch_qkv_gemm(q, column_tile(3 * d), bf16, s));

    const int attn_blocks = (B + attn_seqs(L) - 1) / attn_seqs(L);
    if (bf16)
      encoder_fwd_attn_kernel<true>
          <<<attn_blocks, kThreads, attn_fwd_smem(L), s>>>(
              qkv, seq, o, save ? lb + so.l.p : nullptr, B, L, d, n_head,
              idx_pad, invert, dr, dr.salt(drop::kProbs, li));
    else
      encoder_fwd_attn_kernel<false>
          <<<attn_blocks, kThreads, attn_fwd_smem(L), s>>>(
              qkv, seq, o, save ? lb + so.l.p : nullptr, B, L, d, n_head,
              idx_pad, invert, dr, dr.salt(drop::kProbs, li));
    TRY(cudaGetLastError());

    // y1 = LN1(X + drop(o·W_out + b_out)); above d 256 the sum goes to the
    // xhat1 slot first and the LN kernel normalises it there
    FwdGemm w{};
    w.a = o; w.w = l0.w_out + li * s_dd; w.bias = l0.b_out + ob; w.res = X;
    w.n = n; w.k = d; w.m = d; w.dr = dr;
    w.salt = dr.salt(drop::kAttnOut, li);
    if (fused_ln) {
      w.epi = kResLn; w.c = y1; w.ln_s = l0.ln1_s + ob; w.ln_b = l0.ln1_b + ob;
      w.xhat = save ? xhat1 : nullptr;
      w.rstd = save ? lb + so.l.rstd1 : nullptr;
      TRY(launch_gemm(w, width_tile(d), bf16, s));
    } else {
      w.epi = kResidual; w.c = xhat1;
      TRY(launch_gemm(w, column_tile(d), bf16, s));
      TRY(launch_ln(xhat1, l0.ln1_s + ob, l0.ln1_b + ob, y1,
                    save ? xhat1 : nullptr, save ? lb + so.l.rstd1 : nullptr,
                    nullptr, nullptr, nullptr, nullptr, nullptr, n, d, s));
    }

    // fr = relu(y1·W1 + b1); fd = drop(fr) (saved, or read by FF2 under
    // dropout)
    FwdGemm f{};
    f.a = y1; f.w = l0.w_ff1 + li * s_dd; f.bias = l0.b_ff1 + ob; f.c = fr;
    f.c2 = save || dr.on ? fd : nullptr; f.n = n; f.k = d; f.m = d;
    f.epi = kRelu; f.dr = dr; f.salt = dr.salt(drop::kFfnRelu, li);
    TRY(launch_gemm(f, column_tile(d), bf16, s));

    // xnext = LN2(y1 + drop(f·W2 + b2)), then out = LNf(xnext) after the
    // last layer
    FwdGemm f2{};
    f2.a = f.c2 ? fd : fr; f2.w = l0.w_ff2 + li * s_dd; f2.bias = l0.b_ff2 + ob;
    f2.res = y1; f2.n = n; f2.k = d; f2.m = d; f2.dr = dr;
    f2.salt = dr.salt(drop::kFfnOut, li);
    float* rstd2 = save ? lb + so.l.rstd2 : nullptr;
    float* xhat_f = save && last ? buf + so.xhat_f : nullptr;
    float* rstd_f = save && last ? buf + so.rstd_f : nullptr;
    if (fused_ln) {
      f2.epi = kResLn; f2.c = xnext;
      f2.ln_s = l0.ln2_s + ob; f2.ln_b = l0.ln2_b + ob;
      f2.xhat = save ? xhat2 : nullptr; f2.rstd = rstd2;
      if (last) {
        f2.lnf_s = lnf_s; f2.lnf_b = lnf_b; f2.out = out;
        f2.xhat_f = xhat_f; f2.rstd_f = rstd_f;
      }
      TRY(launch_gemm(f2, width_tile(d), bf16, s));
    } else {
      f2.epi = kResidual; f2.c = xhat2;
      TRY(launch_gemm(f2, column_tile(d), bf16, s));
      TRY(launch_ln(xhat2, l0.ln2_s + ob, l0.ln2_b + ob, xnext,
                    save ? xhat2 : nullptr, rstd2, last ? lnf_s : nullptr,
                    lnf_b, out, xhat_f, rstd_f, n, d, s));
    }
    X = xnext;
  }
  return cudaSuccess;
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

// Weights are stacked over layers: w_qkv [NL, d, 3d], b_qkv [NL, 3d],
// w_out/w_ff1/w_ff2 [NL, d, d], biases and LN params [NL, d]; lnf [d].
// Requires d % 8 == 0, 8 <= d <= 512, d % n_head == 0, head dim % 8 == 0,
// 1 <= L <= 64 (encoder_cuda.supported), n_layers >= 1; x, the weights
// and buf 16-byte aligned.  Dropout: drop_on 0 is eval; else kept values
// are divided by drop_div (f32(1 - p)) where the hash bits reach drop_thr
// (ops/dropout.threshold), from the uint32 seed at `seed` in device memory
// (read by each kernel; null at drop_on 0); row_off, row_seg and row_stride place the call's
// rows in the run's batch (drop::Dropout; row_seg 0: the identity).  buf:
// with save != 0, saved_layout for n_layers
// (encoder_saved_offsets), which receives the activations the backward
// reads; else the workspace, saved_layout for one layer.  bf16 != 0: the
// bf16 instantiation (the head of the file), the same layout of f32
// activations.  Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int encoder_fwd(
    const float* x, const int* seq, const float* w_qkv, const float* b_qkv,
    const float* w_out, const float* b_out, const float* w_ff1,
    const float* b_ff1, const float* w_ff2, const float* b_ff2,
    const float* ln1_s, const float* ln1_b, const float* ln2_s,
    const float* ln2_b, const float* lnf_s, const float* lnf_b, float* out,
    float* buf, int save,
    int B, int L, int d, int n_head, int n_layers, int idx_pad, int invert,
    int drop_on, unsigned drop_thr, float drop_div, const unsigned* seed,
    int tower_id, unsigned row_off, unsigned row_seg, unsigned row_stride, int bf16,
    void* stream) {
  const Layer l0{w_qkv, b_qkv, w_out, b_out, w_ff1, b_ff1, w_ff2, b_ff2,
                 ln1_s, ln1_b, ln2_s, ln2_b};
  return static_cast<int>(run_fwd(
      x, seq, l0, lnf_s, lnf_b, out, buf, save != 0, B, L, d, n_head,
      n_layers, idx_pad, invert,
      drop::make(drop_on, drop_thr, drop_div, seed, tower_id, row_off,
                 row_seg, row_stride, L, d),
      bf16 != 0, static_cast<cudaStream_t>(stream)));
}

// The dropout hash's bits of elements 0..n-1 of one stream, for checking the
// kernels' masks against ops/dropout.bits_reference; the seed is read from
// device memory, as the kernels read it.
__global__ void dropout_bits_kernel(drop::Dropout dr, int site, int layer,
                                    int n, unsigned* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    out[i] = drop::mix32((static_cast<uint32_t>(i) * drop::kGolden) ^
                         dr.key(dr.salt(site, layer)));
}

extern "C" int dropout_bits_u32(const unsigned* seed, int site, int tower_id,
                                int layer, int n, unsigned* out,
                                void* stream) {
  dropout_bits_kernel<<<(n + 255) / 256, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      drop::Dropout{1, 0u, 1.f, seed, tower_id}, site, layer, n, out);
  return static_cast<int>(cudaGetLastError());
}
