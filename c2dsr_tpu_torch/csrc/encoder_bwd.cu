// Backward of one causal self-attention tower (post-norm), f32: dx and the
// gradient of every layer weight and of the final LayerNorm.
//
// Replaces the fused encoder backward Pallas kernel
// (c2dsr_tpu/ops/encoder_pallas.py, _fused_bwd / _bwd_kernel).  It walks
// the layers in reverse: final LN, LN2, FFN, LN1, out-projection, the
// per-head softmax through the pre-dropout probabilities, QKV; it
// regenerates the forward's dropout masks from the seed (dropout.cuh: the
// same hash as encoder.cu).  An all-masked query row is the uniform average
// over the L real positions in the forward (as ops/encoder.py and
// encoder.cu have it); the softmax backward follows those probabilities,
// so such rows carry gradient.
//
// Where the Pallas kernel re-runs the forward, this one reads the
// activations that the training forward (encoder.cu) saved for all N = B·L
// rows of the call (saved_layout, about 11·d floats a row), so it
// differentiates the very forward whose output the loss saw.  A recompute
// in another arithmetic (or another summation order) moves ReLU masks and
// the -1e9 rounding of all-masked rows, and with them whole gradient rows:
// at d 256 it put the step's gradients 1e-3 off the plain versions' where
// their own card-against-CPU noise is 1e-4.
//
// Bound on an H100 by operations: 24·N·d² + 8·N·L·d FLOPs per layer.  The
// walk is a sequence of kernels over all N rows, each gradient written once
// and read once through L2 and device memory (about 12·d floats a row of
// working buffers):
// * Every product with a weight (dX = dY·Wᵀ and dW = Xᵀ·dY) runs on the
//   tensor cores at f32 accuracy (3xTF32 on mma.sync.m16n8k8, tc.cuh's
//   gemm_tile, which the forward shares; above d 256 the output columns
//   take two blocks).
//   tc_gemm_kernel takes 64 rows a block, 16 a warp, so every weight tile
//   it stages feeds 64 rows; weight and activation tiles of 32 k-steps
//   arrive through a 2-stage cp.async ring.  Its epilogue folds in what
//   follows the product: the regenerated dropout, ReLU's mask, a residual
//   add.
// * LayerNorm backward (ln_bwd_kernel): one warp a row.
// * Attention backward (attn_bwd_kernel): up to 8 whole sequences a block
//   (64 rows), a warp serving one (L <= 64: a lane holds two keys), a head
//   and 64 of its columns of q, k, v and do in shared memory at a time, in
//   FFMA.  Only this kernel is tied to sequences; the GEMMs are not, so L
//   is not capped by a row tile.
// * Weight gradients (wgrad_kernel): reductions over all N rows of the
//   call, split into row ranges (a multiple of 32 rows each) that fill the
//   SMs in whole waves; each (output tile, split) block writes its partial
//   once, the bias sums beside it and the LayerNorm scale and bias sums as
//   jobs of their own, and sum_partials_kernel adds the partials in split
//   order.  No atomics and no read-modify-write of a partial: two launches
//   on the same inputs give bitwise-equal results.
// A tower call of one layer launches 10 kernels; each further layer adds 8.
//
// The bf16 instantiation (encoder_bwd's bf16; compute_dtype="bfloat16")
// differentiates encoder.cu's bf16 forward as the Pallas kernel's
// _bwd_kernel does with matmul_dtype=bf16: both operands of every product
// are rounded to bf16, the incoming gradient included, and the products
// sum in f32.  The GEMMs and the weight gradients take one TF32 MMA of the
// rounded operands a k-step (tc.cuh, TERMS 1); the attention backward
// rounds v, do, k and q as it stages them and ds and drop(p) as it stores
// them, and keeps the softmax backward (dp·p, ds) in f32, as do the
// LayerNorm backward, the bias and LayerNorm sums and the dropout.

#include <vector>

#include "encoder_common.cuh"
#include "tc.cuh"

namespace {

using namespace tower;
using namespace tc;

// Offsets (in floats) of each gradient in the flat gradient buffer: the
// stacked layer weights in the order of the kernel arguments, then lnf.
struct GradOff {
  size_t w_qkv, b_qkv, w_out, b_out, w_ff1, b_ff1, w_ff2, b_ff2;
  size_t ln1_s, ln1_b, ln2_s, ln2_b, lnf_s, lnf_b, total;
};

GradOff grad_offsets(int d, int nl) {
  GradOff o;
  size_t at = 0;
  o.w_qkv = at; at += (size_t)nl * d * 3 * d;
  o.b_qkv = at; at += (size_t)nl * 3 * d;
  o.w_out = at; at += (size_t)nl * d * d;
  o.b_out = at; at += (size_t)nl * d;
  o.w_ff1 = at; at += (size_t)nl * d * d;
  o.b_ff1 = at; at += (size_t)nl * d;
  o.w_ff2 = at; at += (size_t)nl * d * d;
  o.b_ff2 = at; at += (size_t)nl * d;
  o.ln1_s = at; at += (size_t)nl * d;
  o.ln1_b = at; at += (size_t)nl * d;
  o.ln2_s = at; at += (size_t)nl * d;
  o.ln2_b = at; at += (size_t)nl * d;
  o.lnf_s = at; at += d;
  o.lnf_b = at; at += d;
  o.total = at;
  return o;
}

// ------------------------------------------------------------ the GEMM ----

// C = A·Wᵀ with W [M, K] row-major (tc.cuh's gemm_tile), NT = 64, 128 or
// 256 output columns a block (the narrowest that holds d).

// What follows the product, per output element (row r, column c; element
// index r·M + c, which is also the dropout index of a [B, L, d] site):
enum Epi : int {
  kStore = 0,  // c = acc
  kDrelu = 1,  // c = drop(acc) where aux > 0, else 0 (ReLU's mask)
  kRes = 2,    // c = drop(acc + res)
};

struct GemmArgs {
  const float* a;       // A [n, k] row-major
  const float* w;       // W [m, k] row-major
  float* c;             // [n, m]
  int n, k, m, epi;
  const float* res;     // [n, m]
  const float* aux;     // [n, m]
  drop::Dropout dr;     // dropout where dr.on
  uint32_t salt;        // of the epilogue's stream (drop::Dropout::salt)
};

// kMap: the call's dropout maps its rows (drop::Dropout::mapped); TERMS 3
// is 3xTF32, 1 the bf16 instantiation (tc.cuh gemm_tile).
template <int NT, bool kMap, int TERMS = 3>
__global__ void __launch_bounds__(kGemmThreads)
tc_gemm_kernel(const GemmArgs g) {
  constexpr int kNj = NT / 8;          // n-tiles a warp
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int row0 = blockIdx.x * kGemmRows;
  const int n0 = blockIdx.y * NT;
  float acc[kNj][4];
  gemm_tile<NT, false, TERMS>(g.a, g.w, g.n, g.k, g.m, row0, n0,
                              reinterpret_cast<float*>(smem4), acc);
  const uint32_t key = g.dr.key(g.salt);

  // elements 2h and 2h + 1 of n-tile j: row r_lo + 8·h, columns n0 + 8·j
  // + 2·tq and the next, as one float2 (m % 8 == 0: both or neither in
  // range)
  const int r_lo = row0 + warp * 16 + gq;
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
      float2 v = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      if (g.epi == kRes) {
        const float2 r = *reinterpret_cast<const float2*>(g.res + idx);
        v.x += r.x;
        v.y += r.y;
      }
      if (g.epi != kStore && g.dr.on) {
        v.x = g.dr.apply(v.x, key, di);
        v.y = g.dr.apply(v.y, key, di + 1);
      }
      if (g.epi == kDrelu) {
        const float2 f = *reinterpret_cast<const float2*>(g.aux + idx);
        if (!(f.x > 0.f)) v.x = 0.f;
        if (!(f.y > 0.f)) v.y = 0.f;
      }
      *reinterpret_cast<float2*>(g.c + idx) = v;
    }
  }
}

// ------------------------------------------------------- the attention ----

// Dynamic shared memory of attn_bwd_kernel at length L, in bytes: for
// R = attn_seqs(L)·L rows, three chunks of 64 head columns [R][kLdc] and
// ds and drop(p) of one head ([R][round4(L)] each).
__host__ __device__ constexpr int attn_bwd_smem(int L) {
  return 4 * attn_seqs(L) * L * (3 * kLdc + 2 * round4(L));
}

// Per block, S = attn_seqs(L) sequences (blockIdx.x·S + s), per head:
// dqkv [N, 3d] from the saved qkv and p and the gradient do of the
// attention output: dpd = do·vᵀ, dp = drop(dpd), ds = p·(dp - Σ dp·p),
// dq = ds·k / sqrt(dh), dk = dsᵀ·q / sqrt(dh), dv = drop(p)ᵀ·do.  Warp w
// serves sequence s = w / (8 / S) and its rows w % (8 / S) + (8 / S)·t.
// The head's columns pass in chunks of 64: first do and v for dpd (a lane
// the keys lane and lane + 32, float4 reads), then k, q and do for dq, dk
// and dv of the warp's rows (a lane a column).  kBf: the products' operands
// rounded to bf16 (v, do, k, q as they are staged, ds and drop(p) as they
// are stored).
template <bool kBf>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ p_in,
                const float* __restrict__ d_o, float* __restrict__ dqkv,
                int B, int L, int d, int n_head, drop::Dropout dr,
                uint32_t salt) {
  extern __shared__ float4 smem4[];
  const uint32_t key = dr.key(salt);
  const int S = attn_seqs(L);
  const int R = S * L;
  const int ldp = round4(L);
  float* C1 = reinterpret_cast<float*>(smem4);   // [R][kLdc]: v, then k
  float* C2 = C1 + R * kLdc;                     // [R][kLdc]: do, then q
  float* C3 = C2 + R * kLdc;                     // [R][kLdc]: do
  float* DS = C3 + R * kLdc;                     // ds [query][key]
  float* PD = DS + R * ldp;                      // drop(p), the same layout
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wps = 8 / S;                     // warps a sequence
  const int s = warp / wps;
  const int b = blockIdx.x * S + s;          // this warp's sequence
  const uint32_t gb = dr.batch(b);           // its row of the run's batch
  const bool active = b < B;
  const int seq0 = blockIdx.x * S;
  const int R_in = min(S, B - seq0) * L;     // rows of the block in range
  const size_t grow0 = (size_t)seq0 * L;
  const size_t N = (size_t)B * L;
  const int dh = d / n_head;
  const int d3 = 3 * d;
  const float inv_sqrt_dh = 1.f / sqrtf(static_cast<float>(dh));
  const int so = s * L;                      // the sequence's first row
  // rows r < R_in, columns [col, col + 4·cw4) of a [N, ld] buffer into dst
  // (kBf: rounded)
  auto load = [&](float* dst, const float* src, int ld, int col, int cw4) {
    for (int v = threadIdx.x; v < R_in * cw4; v += kThreads) {
      const int r = v / cw4, c = (v % cw4) * 4;
      float4 x =
          *reinterpret_cast<const float4*>(src + (grow0 + r) * ld + col + c);
      if constexpr (kBf)
        x = make_float4(bf16f(x.x), bf16f(x.y), bf16f(x.z), bf16f(x.w));
      *reinterpret_cast<float4*>(dst + r * kLdc + c) = x;
    }
  };
  for (int h = 0; h < n_head; ++h) {
    const int hc = h * dh;
    float acc[8][2], cmp[8][2];          // dpd's sums, compensated
#pragma unroll
    for (int t = 0; t < 8; ++t)
      acc[t][0] = acc[t][1] = cmp[t][0] = cmp[t][1] = 0.f;
    for (int c0 = 0; c0 < dh; c0 += kCh) {
      const int cw4 = min(kCh, dh - c0) / 4;
      __syncthreads();     // the previous chunk's (or head's) readers
      load(C1, qkv, d3, 2 * d + hc + c0, cw4);
      load(C2, d_o, d, hc + c0, cw4);
      __syncthreads();
      if (!active) continue;
      for (int c4 = 0; c4 < cw4; ++c4) {
        const float4 v0 = lane < L
            ? *reinterpret_cast<const float4*>(C1 + (so + lane) * kLdc + 4 * c4)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 v1 = lane + 32 < L
            ? *reinterpret_cast<const float4*>(C1 + (so + lane + 32) * kLdc
                                               + 4 * c4)
            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int i = warp % wps + wps * t;
          if (i < L) {
            const float4 g = *reinterpret_cast<const float4*>(
                C2 + (so + i) * kLdc + 4 * c4);
            add_compensated(acc[t][0], cmp[t][0], dot4(g, v0, 0.f));
            add_compensated(acc[t][1], cmp[t][1], dot4(g, v1, 0.f));
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int i = warp % wps + wps * t;
        if (i >= L) continue;              // uniform over the warp
        float p[2], dp[2], pd[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = lane + 32 * u;
          p[u] = dp[u] = pd[u] = 0.f;
          if (j < L) {
            p[u] = p_in[((size_t)h * N + (size_t)b * L + i) * L + j];
            dp[u] = acc[t][u] + cmp[t][u];
            pd[u] = p[u];
            if (dr.on) {
              const uint32_t idx = static_cast<uint32_t>(
                  (((size_t)gb * n_head + h) * L + i) * L + j);
              dp[u] = dr.apply(dp[u], key, idx);
              pd[u] = dr.apply(p[u], key, idx);
            }
          }
        }
        const float dot_pp = warp_sum(dp[0] * p[0] + dp[1] * p[1]);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = lane + 32 * u;
          if (j < L) {
            const float ds = p[u] * (dp[u] - dot_pp);
            DS[(so + i) * ldp + j] = kBf ? bf16f(ds) : ds;
            PD[(so + i) * ldp + j] = kBf ? bf16f(pd[u]) : pd[u];
          }
        }
      }
    }
    for (int c0 = 0; c0 < dh; c0 += kCh) {
      const int cw4 = min(kCh, dh - c0) / 4;
      __syncthreads();     // DS, PD written; the previous chunk's readers
      load(C1, qkv, d3, d + hc + c0, cw4);
      load(C2, qkv, d3, hc + c0, cw4);
      load(C3, d_o, d, hc + c0, cw4);
      __syncthreads();
      if (!active) continue;
      const int cw = cw4 * 4;
      float aq[8][2], ak[8][2], av[8][2];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        aq[t][0] = aq[t][1] = ak[t][0] = ak[t][1] = av[t][0] = av[t][1] = 0.f;
      for (int j = 0; j < L; ++j) {
        const float* kr = C1 + (so + j) * kLdc;
        const float* qr = C2 + (so + j) * kLdc;
        const float* gr = C3 + (so + j) * kLdc;
        const float k0 = lane < cw ? kr[lane] : 0.f;
        const float k1 = lane + 32 < cw ? kr[lane + 32] : 0.f;
        const float q0 = lane < cw ? qr[lane] : 0.f;
        const float q1 = lane + 32 < cw ? qr[lane + 32] : 0.f;
        const float g0 = lane < cw ? gr[lane] : 0.f;
        const float g1 = lane + 32 < cw ? gr[lane + 32] : 0.f;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int i = warp % wps + wps * t;
          if (i < L) {
            const float ds_ij = DS[(so + i) * ldp + j];   // i a query row
            const float ds_ji = DS[(so + j) * ldp + i];   // i a key row
            const float pd_ji = PD[(so + j) * ldp + i];
            aq[t][0] = fmaf(ds_ij, k0, aq[t][0]);
            aq[t][1] = fmaf(ds_ij, k1, aq[t][1]);
            ak[t][0] = fmaf(ds_ji, q0, ak[t][0]);
            ak[t][1] = fmaf(ds_ji, q1, ak[t][1]);
            av[t][0] = fmaf(pd_ji, g0, av[t][0]);
            av[t][1] = fmaf(pd_ji, g1, av[t][1]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int i = warp % wps + wps * t;
        if (i >= L) continue;
        float* dst = dqkv + ((size_t)b * L + i) * d3 + hc + c0;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = lane + 32 * u;
          if (c >= cw) continue;
          dst[c] = aq[t][u] * inv_sqrt_dh;
          dst[d + c] = ak[t][u] * inv_sqrt_dh;
          dst[2 * d + c] = av[t][u];
        }
      }
    }
  }
}

// ----------------------------------------------------- the row kernels ----

// LayerNorm backward, one warp per row: dz = rstd·(g·s - mean(g·s) -
// xhat·mean(g·s·xhat)); dzd = drop(dz) where dzd is not null (kMap: the
// dropout maps its rows).
template <int NV, bool kMap>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const float* __restrict__ gin, const float* __restrict__ xhat,
              const float* __restrict__ rstd,
              const float* __restrict__ scale, float* __restrict__ dz,
              float* __restrict__ dzd, int n, int d, drop::Dropout dr,
              uint32_t salt) {
  const uint32_t key = dzd ? dr.key(salt) : 0u;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= n) return;
  const size_t at = (size_t)r * d;
  const uint32_t dat = kMap ? dr.row_index(r, d) : static_cast<uint32_t>(at);
  float gs[NV], xh[NV];
  float m1 = 0.f, m2 = 0.f;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int c = lane + 32 * t;
    gs[t] = xh[t] = 0.f;
    if (c < d) {
      gs[t] = gin[at + c] * scale[c];
      xh[t] = xhat[at + c];
      m1 += gs[t];
      m2 += gs[t] * xh[t];
    }
  }
  m1 = warp_sum(m1) / d;
  m2 = warp_sum(m2) / d;
  const float rs = rstd[r];
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int c = lane + 32 * t;
    if (c < d) {
      const float v = rs * (gs[t] - m1 - xh[t] * m2);
      dz[at + c] = v;
      if (dzd)
        dzd[at + c] = dr.apply(v, key, dat + c);
    }
  }
}

// ------------------------------------------------ the weight gradients ----

constexpr int kWgThreads = 128;    // 4 warps
constexpr int kWgK = 64;           // rows of dW a tile, 16 a warp
constexpr int kWgM = 128;          // columns of dW a tile
constexpr int kWgRows = 32;        // rows of the call a stage
constexpr int kWgStages = 3;
constexpr int kLdx = kWgK + 8;     // strides: fragment loads free of bank
constexpr int kLdy = kWgM + 8;     // conflicts
constexpr int kWgStage = kWgRows * (kLdx + kLdy);
constexpr int kWgSmem = 4 * kWgStages * kWgStage;

// One layer's weight-gradient jobs: product p (qkv, out, ff1, ff2) is
// dW = x[p]ᵀ·y[p] ([d, mw[p]]) with its bias colsum(y[p]), in tiles of
// kWgK x kWgM; then n_ln LayerNorm jobs, colsum(lg·lx) and colsum(lg).
// Outputs are offsets into a split's partial of the flat gradient buffer.
struct WgArgs {
  const float* x[4];
  const float* y[4];
  int mw[4];
  size_t off_w[4], off_b[4];
  const float* lg[3];
  const float* lx[3];
  size_t off_ls[3], off_lb[3];
  int n_ln;
  float* part;          // [splits][total]
  size_t total;
  int n, d, per;        // rows, width, rows a split (a multiple of kWgRows)
};

int wg_tiles(const int* mw, int d) {
  const int tk = (d + kWgK - 1) / kWgK;
  int n = 0;
  for (int p = 0; p < 4; ++p) n += tk * ((mw[p] + kWgM - 1) / kWgM);
  return n;
}

// kBf: the bf16 instantiation, X and Y rounded to bf16 as the fragments
// are read, one MMA a k-step.
template <bool kBf>
__global__ void __launch_bounds__(kWgThreads)
wgrad_kernel(const WgArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int r_begin = blockIdx.y * a.per;
  const int r_end = min(a.n, r_begin + a.per);
  float* part = a.part + (size_t)blockIdx.y * a.total;
  const int tk = (a.d + kWgK - 1) / kWgK;
  int job = blockIdx.x;
  int p = 0;
  for (; p < 4; ++p) {
    const int tiles = tk * ((a.mw[p] + kWgM - 1) / kWgM);
    if (job < tiles) break;
    job -= tiles;
  }
  if (p == 4) {  // a LayerNorm job
    const float* G = a.lg[job];
    const float* X = a.lx[job];
    for (int c = threadIdx.x; c < a.d; c += kWgThreads) {
      float ss = 0.f, sb = 0.f;
#pragma unroll 4
      for (int r = r_begin; r < r_end; ++r) {
        const float gv = G[(size_t)r * a.d + c];
        ss = fmaf(gv, X[(size_t)r * a.d + c], ss);
        sb += gv;
      }
      part[a.off_ls[job] + c] = ss;
      part[a.off_lb[job] + c] = sb;
    }
    return;
  }
  const int M = a.mw[p];
  const int tm = (M + kWgM - 1) / kWgM;
  const int k0 = (job / tm) * kWgK;
  const int m0 = (job % tm) * kWgM;
  const float* X = a.x[p];
  const float* Y = a.y[p];
  const bool with_bias = k0 == 0;
  const int n_chunks = r_end > r_begin ? (r_end - r_begin + kWgRows - 1) /
                                             kWgRows : 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  auto stage = [&](int slot, int chunk) {
    float* xs = smem + slot * kWgStage;
    float* ys = xs + kWgRows * kLdx;
    const int r0 = r_begin + chunk * kWgRows;
    for (int v = threadIdx.x; v < kWgRows * (kWgK / 4); v += kWgThreads) {
      const int r = v / (kWgK / 4), c4 = v % (kWgK / 4);
      const bool ok = r0 + r < r_end && k0 + c4 * 4 < a.d;
      cp_async16(xs + r * kLdx + c4 * 4,
                 ok ? X + (size_t)(r0 + r) * a.d + k0 + c4 * 4 : X, ok);
    }
    for (int v = threadIdx.x; v < kWgRows * (kWgM / 4); v += kWgThreads) {
      const int r = v / (kWgM / 4), c4 = v % (kWgM / 4);
      const bool ok = r0 + r < r_end && m0 + c4 * 4 < M;
      cp_async16(ys + r * kLdy + c4 * 4,
                 ok ? Y + (size_t)(r0 + r) * M + m0 + c4 * 4 : Y, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < n_chunks) stage(s, s);
    cp_async_commit();
  }
  constexpr int kNj = kWgM / 8;
  float acc[kNj][4];
#pragma unroll
  for (int j = 0; j < kNj; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float bsum = 0.f;

  for (int it = 0; it < n_chunks; ++it) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();
    if (it + kWgStages - 1 < n_chunks)
      stage((it + kWgStages - 1) % kWgStages, it + kWgStages - 1);
    cp_async_commit();
    const float* xs = smem + (it % kWgStages) * kWgStage;
    const float* ys = xs + kWgRows * kLdx;
    if (with_bias) {
#pragma unroll 8
      for (int r = 0; r < kWgRows; ++r) bsum += ys[r * kLdy + threadIdx.x];
    }
#pragma unroll
    for (int ks = 0; ks < kWgRows / 8; ++ks) {
      if constexpr (kBf) {
        const float* xp = xs + (ks * 8 + tq) * kLdx + warp * 16 + gq;
        const uint32_t ab[4] = {round_bf16(xp[0]), round_bf16(xp[8]),
                                round_bf16(xp[4 * kLdx]),
                                round_bf16(xp[4 * kLdx + 8])};
#pragma unroll
        for (int j = 0; j < kNj; ++j) {
          const float* yp = ys + (ks * 8 + tq) * kLdy + j * 8 + gq;
          const uint32_t bb[2] = {round_bf16(yp[0]), round_bf16(yp[4 * kLdy])};
          mma_tf32(acc[j], ab, bb);
        }
        continue;
      }
      // A (16 rows of dW x 8 call rows) = Xᵀ: A[g][t] = X[t][g]
      uint32_t ab[4], am[4];
      const float* xp = xs + (ks * 8 + tq) * kLdx + warp * 16 + gq;
      split_tf32(xp[0], ab[0], am[0]);
      split_tf32(xp[8], ab[1], am[1]);
      split_tf32(xp[4 * kLdx], ab[2], am[2]);
      split_tf32(xp[4 * kLdx + 8], ab[3], am[3]);
#pragma unroll
      for (int j0 = 0; j0 < kNj; j0 += 8) {
        uint32_t bb[8][2], bm[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* yp = ys + (ks * 8 + tq) * kLdy + (j0 + j) * 8 + gq;
          split_tf32(yp[0], bb[j][0], bm[j][0]);
          split_tf32(yp[4 * kLdy], bb[j][1], bm[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(acc[j0 + j], am, bb[j]);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(acc[j0 + j], ab, bm[j]);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(acc[j0 + j], ab, bb[j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < kNj; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = k0 + warp * 16 + gq + 8 * (i >> 1);
      const int m = m0 + j * 8 + 2 * tq + (i & 1);
      if (kk < a.d && m < M) part[a.off_w[p] + (size_t)kk * M + m] = acc[j][i];
    }
  }
  if (with_bias && m0 + (int)threadIdx.x < M)
    part[a.off_b[p] + m0 + threadIdx.x] = bsum;
}

// grads[i] = sum over splits s (in order) of part[s][i].
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    int n_parts, size_t total,
                                    float* __restrict__ grads) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < n_parts; ++b) s += part[(size_t)b * total + i];
    grads[i] = s;
  }
}

// ------------------------------------------------------------ the host ----

#define TRY(x)                                   \
  do {                                           \
    const cudaError_t e_ = (x);                  \
    if (e_ != cudaSuccess) return e_;            \
  } while (0)

// The output tile width of the GEMMs: the narrowest of 64, 128, 256 >= d.
int width_tile(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }


// Lets each kernel take its dynamic shared memory; once per device.
cudaError_t prepare() {
  static bool done[64] = {};
  int dev = 0;
  TRY(cudaGetDevice(&dev));
  if (dev < 64 && done[dev]) return cudaSuccess;
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<64, false>, a,
                           GemmCfg<64, false>::kSmem));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<128, false>, a,
                           GemmCfg<128, false>::kSmem));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<256, false>, a,
                           GemmCfg<256, false>::kSmem));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<64, true>, a,
                           GemmCfg<64, false>::kSmem));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<128, true>, a,
                           GemmCfg<128, false>::kSmem));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<256, true>, a,
                           GemmCfg<256, false>::kSmem));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<64, false, 1>, a,
                           GemmCfg<64, false>::kSmem));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<128, false, 1>, a,
                           GemmCfg<128, false>::kSmem));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<256, false, 1>, a,
                           GemmCfg<256, false>::kSmem));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<64, true, 1>, a,
                           GemmCfg<64, false>::kSmem));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<128, true, 1>, a,
                           GemmCfg<128, false>::kSmem));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<256, true, 1>, a,
                           GemmCfg<256, false>::kSmem));
  int most = 0;
  for (int L = 1; L <= kMaxL; ++L)
    most = attn_bwd_smem(L) > most ? attn_bwd_smem(L) : most;
  TRY(cudaFuncSetAttribute(attn_bwd_kernel<false>, a, most));
  TRY(cudaFuncSetAttribute(attn_bwd_kernel<true>, a, most));
  TRY(cudaFuncSetAttribute(wgrad_kernel<false>, a, kWgSmem));
  TRY(cudaFuncSetAttribute(wgrad_kernel<true>, a, kWgSmem));
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

template <int NT, bool kMap, int TERMS>
cudaError_t gemm_t(const GemmArgs& g, cudaStream_t s) {
  const dim3 grid((g.n + kGemmRows - 1) / kGemmRows, (g.m + NT - 1) / NT);
  tc_gemm_kernel<NT, kMap, TERMS>
      <<<grid, kGemmThreads, GemmCfg<NT, false>::kSmem, s>>>(g);
  return cudaGetLastError();
}

template <bool kMap, int TERMS>
cudaError_t launch_gemm_t(const GemmArgs& g, int nt, cudaStream_t s) {
  return nt == 64    ? gemm_t<64, kMap, TERMS>(g, s)
         : nt == 128 ? gemm_t<128, kMap, TERMS>(g, s)
                     : gemm_t<256, kMap, TERMS>(g, s);
}

// The row map's instantiation where the call's dropout maps its rows; bf16:
// the bf16 instantiation.
cudaError_t launch_gemm(const GemmArgs& g, int nt, bool bf16,
                        cudaStream_t s) {
  if (bf16)
    return g.dr.mapped() ? launch_gemm_t<true, 1>(g, nt, s)
                         : launch_gemm_t<false, 1>(g, nt, s);
  return g.dr.mapped() ? launch_gemm_t<true, 3>(g, nt, s)
                       : launch_gemm_t<false, 3>(g, nt, s);
}

template <bool kMap>
cudaError_t ln_bwd_t(const float* gin, const float* xhat, const float* rstd,
                     const float* scale, float* dz, float* dzd, int n, int d,
                     drop::Dropout dr, uint32_t salt, cudaStream_t s) {
  const int blocks = (n + kThreads / 32 - 1) / (kThreads / 32);
  if (d <= 64)
    ln_bwd_kernel<2, kMap><<<blocks, kThreads, 0, s>>>(
        gin, xhat, rstd, scale, dz, dzd, n, d, dr, salt);
  else if (d <= 128)
    ln_bwd_kernel<4, kMap><<<blocks, kThreads, 0, s>>>(
        gin, xhat, rstd, scale, dz, dzd, n, d, dr, salt);
  else if (d <= 256)
    ln_bwd_kernel<8, kMap><<<blocks, kThreads, 0, s>>>(
        gin, xhat, rstd, scale, dz, dzd, n, d, dr, salt);
  else
    ln_bwd_kernel<16, kMap><<<blocks, kThreads, 0, s>>>(
        gin, xhat, rstd, scale, dz, dzd, n, d, dr, salt);
  return cudaGetLastError();
}

cudaError_t ln_bwd(const float* gin, const float* xhat, const float* rstd,
                   const float* scale, float* dz, float* dzd, int n, int d,
                   drop::Dropout dr, uint32_t salt, cudaStream_t s) {
  return dzd && dr.mapped()
             ? ln_bwd_t<true>(gin, xhat, rstd, scale, dz, dzd, n, d, dr, salt,
                              s)
             : ln_bwd_t<false>(gin, xhat, rstd, scale, dz, dzd, n, d, dr,
                               salt, s);
}

// The working buffers of the backward walk (reused by every layer) and the
// partials of the weight gradients, carved from the workspace (a null base
// only counts).
struct Temps {
  float *ga, *gb, *dz2, *dg2, *df, *dy1, *dz1, *da, *d_o, *dqkv, *part;
};

Temps take_temps(float* base, size_t N, int d, size_t part_floats,
                 size_t* total) {
  size_t at = 0;
  auto at_ = [&](size_t n) {
    const size_t o = take(at, n);
    return base ? base + o : nullptr;
  };
  Temps t;
  t.ga = at_(N * d);
  t.gb = at_(N * d);
  t.dz2 = at_(N * d);
  t.dg2 = at_(N * d);
  t.df = at_(N * d);
  t.dy1 = at_(N * d);
  t.dz1 = at_(N * d);
  t.da = at_(N * d);
  t.d_o = at_(N * d);
  t.dqkv = at_(3 * N * d);
  t.part = at_(part_floats);
  if (total) *total = at;
  return t;
}

// The weight gradients' row splits: as many as fit, with one layer's jobs
// (the LayerNorm ones included), in one wave of two blocks per SM, each
// split at least 4·kWgRows rows.
int wg_splits(int N, int d) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int mw[4] = {3 * d, d, d, d};
  const int jobs = wg_tiles(mw, d) + 3;
  int splits = 2 * sms / jobs;
  const int max_splits = (N + 4 * kWgRows - 1) / (4 * kWgRows);
  splits = splits > max_splits ? max_splits : splits;
  return splits < 1 ? 1 : splits;
}

size_t workspace_floats(int B, int L, int d, int n_layers, int splits) {
  size_t total = 0;
  take_temps(nullptr, (size_t)B * L, d,
             (size_t)splits * grad_offsets(d, n_layers).total, &total);
  return total;
}

cudaError_t run_bwd(const float* saved, const float* gout, const Layer& l0,
                    const float* lnf_s, float* dx, float* grads,
                    float* workspace, int splits, int B, int L, int d,
                    int n_head, int n_layers, drop::Dropout dr, bool bf16,
                    cudaStream_t s) {
  const size_t N = (size_t)B * L;
  const int n = static_cast<int>(N);
  const GradOff go = grad_offsets(d, n_layers);
  const SavedLayout so = saved_layout(N, d, n_head, L, n_layers);
  const Temps t = take_temps(workspace, N, d, (size_t)splits * go.total,
                             nullptr);
  const int nt = width_tile(d);
  drop::Dropout off = dr;
  off.on = 0;
  const size_t s_qkv = (size_t)d * 3 * d, s_dd = (size_t)d * d;
  TRY(prepare());
  auto layer = [&](int li, size_t off_in_layer) {
    return saved + so.layers + li * so.per_layer + off_in_layer;
  };

  float* gcur = t.ga;
  float* gnext = t.gb;
  TRY(ln_bwd(gout, saved + so.xhat_f, saved + so.rstd_f, lnf_s, gcur,
             nullptr, n, d, off, 0, s));
  for (int li = n_layers - 1; li >= 0; --li) {
    const float* xin = li ? layer(li - 1, so.l.xnext) : saved + so.xin0;
    // LN2: z2 = y1 + drop(fd·W2 + b2)
    float* dg2 = dr.on ? t.dg2 : t.dz2;
    TRY(ln_bwd(gcur, layer(li, so.l.xhat2), layer(li, so.l.rstd2),
               l0.ln2_s + li * d, t.dz2, dr.on ? t.dg2 : nullptr, n, d, dr,
               dr.salt(drop::kFfnOut, li), s));
    GemmArgs g5{};
    g5.a = dg2; g5.w = l0.w_ff2 + li * s_dd; g5.c = t.df; g5.n = n; g5.k = d;
    g5.m = d; g5.epi = kDrelu; g5.aux = layer(li, so.l.fr);
    g5.dr = dr; g5.salt = dr.salt(drop::kFfnRelu, li);
    TRY(launch_gemm(g5, nt, bf16, s));
    GemmArgs g6{};
    g6.a = t.df; g6.w = l0.w_ff1 + li * s_dd; g6.c = t.dy1; g6.n = n;
    g6.k = d; g6.m = d; g6.epi = kRes; g6.res = t.dz2; g6.dr = off;
    TRY(launch_gemm(g6, nt, bf16, s));
    // LN1: z1 = x_in + drop(o·W_out + b_out)
    float* da = dr.on ? t.da : t.dz1;
    TRY(ln_bwd(t.dy1, layer(li, so.l.xhat1), layer(li, so.l.rstd1),
               l0.ln1_s + li * d, t.dz1, dr.on ? t.da : nullptr, n, d, dr,
               dr.salt(drop::kAttnOut, li), s));
    GemmArgs g7{};
    g7.a = da; g7.w = l0.w_out + li * s_dd; g7.c = t.d_o; g7.n = n; g7.k = d;
    g7.m = d; g7.epi = kStore; g7.dr = off;
    TRY(launch_gemm(g7, nt, bf16, s));
    const int attn_blocks = (B + attn_seqs(L) - 1) / attn_seqs(L);
    if (bf16)
      attn_bwd_kernel<true><<<attn_blocks, kThreads, attn_bwd_smem(L), s>>>(
          layer(li, so.l.qkv), layer(li, so.l.p), t.d_o, t.dqkv, B, L, d,
          n_head, dr, dr.salt(drop::kProbs, li));
    else
      attn_bwd_kernel<false><<<attn_blocks, kThreads, attn_bwd_smem(L), s>>>(
          layer(li, so.l.qkv), layer(li, so.l.p), t.d_o, t.dqkv, B, L, d,
          n_head, dr, dr.salt(drop::kProbs, li));
    TRY(cudaGetLastError());
    // dx of the layer: dz1 + dqkv·Wqkvᵀ, through the input dropout below
    // the first layer
    GemmArgs g8{};
    g8.a = t.dqkv; g8.w = l0.w_qkv + li * s_qkv; g8.c = li ? gnext : dx;
    g8.n = n; g8.k = 3 * d; g8.m = d; g8.epi = kRes; g8.res = t.dz1;
    g8.dr = li ? off : dr; g8.salt = dr.salt(drop::kInput, 0);
    TRY(launch_gemm(g8, nt, bf16, s));

    WgArgs w{};
    const float* xs[4] = {xin, layer(li, so.l.o), layer(li, so.l.y1),
                          layer(li, so.l.fd)};
    const float* ys[4] = {t.dqkv, da, t.df, dg2};
    const size_t ow[4] = {go.w_qkv + li * s_qkv, go.w_out + li * s_dd,
                          go.w_ff1 + li * s_dd, go.w_ff2 + li * s_dd};
    const size_t ob[4] = {go.b_qkv + (size_t)li * 3 * d,
                          go.b_out + (size_t)li * d, go.b_ff1 + (size_t)li * d,
                          go.b_ff2 + (size_t)li * d};
    for (int p = 0; p < 4; ++p) {
      w.x[p] = xs[p];
      w.y[p] = ys[p];
      w.mw[p] = p == 0 ? 3 * d : d;
      w.off_w[p] = ow[p];
      w.off_b[p] = ob[p];
    }
    w.lg[0] = t.dy1; w.lx[0] = layer(li, so.l.xhat1);
    w.off_ls[0] = go.ln1_s + (size_t)li * d;
    w.off_lb[0] = go.ln1_b + (size_t)li * d;
    w.lg[1] = gcur; w.lx[1] = layer(li, so.l.xhat2);
    w.off_ls[1] = go.ln2_s + (size_t)li * d;
    w.off_lb[1] = go.ln2_b + (size_t)li * d;
    w.n_ln = 2;
    if (li == n_layers - 1) {
      w.lg[2] = gout; w.lx[2] = saved + so.xhat_f;
      w.off_ls[2] = go.lnf_s; w.off_lb[2] = go.lnf_b;
      w.n_ln = 3;
    }
    w.part = t.part; w.total = go.total; w.n = n; w.d = d;
    const int per0 = (n + splits - 1) / splits;
    w.per = (per0 + kWgRows - 1) / kWgRows * kWgRows;
    const dim3 wg_grid(wg_tiles(w.mw, d) + w.n_ln, splits);
    if (bf16)
      wgrad_kernel<true><<<wg_grid, kWgThreads, kWgSmem, s>>>(w);
    else
      wgrad_kernel<false><<<wg_grid, kWgThreads, kWgSmem, s>>>(w);
    TRY(cudaGetLastError());
    float* tmp = gcur;
    gcur = gnext;
    gnext = tmp;
  }
  sum_partials_kernel<<<(int)((go.total + 255) / 256), 256, 0, s>>>(
      t.part, splits, go.total, grads);
  return cudaGetLastError();
}

}  // namespace

// The weight gradients' row splits for B sequences of length L at width d.
extern "C" int encoder_bwd_grid(int B, int L, int d) {
  return wg_splits(B * L, d);
}

// Floats of the workspace the backward needs: its working buffers for all
// B·L rows and the weight-gradient partials of `grid` row splits.
extern "C" long long encoder_bwd_workspace_floats(int B, int L, int d,
                                                  int n_layers, int grid) {
  return (long long)workspace_floats(B, L, d, n_layers, grid);
}

// Floats of the flat gradient buffer (grad_offsets: the stacked layer
// weights in argument order, then lnf scale and bias).
extern "C" long long encoder_bwd_grad_floats(int d, int n_layers) {
  return (long long)grad_offsets(d, n_layers).total;
}

// The backward of the training forward encoder_fwd that wrote `saved`
// (encoder_saved_floats, with the same weights, shapes and dropout
// arguments, the row map included): gout the gradient of the tower's
// output, dx [B, L, d] out, grads the flat buffer, workspace of
// encoder_bwd_workspace_floats for `grid` row splits (all pointers 16-byte
// aligned).  bf16 != 0: the bf16 instantiation, the backward of
// encoder_fwd's bf16 one (the head of the file).  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int encoder_bwd(
    const float* saved, const float* gout, const float* w_qkv,
    const float* b_qkv, const float* w_out, const float* b_out,
    const float* w_ff1, const float* b_ff1, const float* w_ff2,
    const float* b_ff2, const float* ln1_s, const float* ln1_b,
    const float* ln2_s, const float* ln2_b, const float* lnf_s,
    const float* lnf_b, float* dx, float* grads, float* workspace, int grid,
    int B, int L, int d, int n_head, int n_layers, int drop_on,
    unsigned drop_thr, float drop_div, const unsigned* seed, int tower_id,
    unsigned row_off, unsigned row_seg, unsigned row_stride, int bf16,
    void* stream) {
  (void)lnf_b;
  const Layer l0{w_qkv, b_qkv, w_out, b_out, w_ff1, b_ff1, w_ff2, b_ff2,
                 ln1_s, ln1_b, ln2_s, ln2_b};
  return static_cast<int>(run_bwd(
      saved, gout, l0, lnf_s, dx, grads, workspace, grid, B, L, d, n_head,
      n_layers,
      drop::make(drop_on, drop_thr, drop_div, seed, tower_id, row_off,
                 row_seg, row_stride, L, d),
      bf16 != 0, static_cast<cudaStream_t>(stream)));
}
