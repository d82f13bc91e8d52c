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
//   tensor cores at f32 accuracy (3xTF32).  dX up to d 256 (kWideD) on
//   tc.cuh's gemm_tile (mma.sync.m16n8k8), which the forward shares:
//   tc_gemm_kernel takes 64 rows a block, 16 a warp, so every weight tile
//   it stages feeds 64 rows; weight and activation tiles of 32 k-steps
//   arrive through a 2-stage cp.async ring.  Past d 256 on wgmma.cuh's
//   wg::tile (tc_gemm_kernel_wgmma): 128 x 128 blocks of two warpgroups
//   running wgmma from a ring of TMA stages; W [m, k] is already K-major,
//   the layout a TF32 B operand must have, so the call's pre-pass
//   (encoder_bwd_split_kernel) only splits it into its TF32 parts, once a
//   call (bf16: the call's bf16 copy as it lies).  Both epilogues fold in
//   what follows the product: the regenerated dropout, ReLU's mask, a
//   residual add.  The weight gradients stay on wgrad_kernel at every d.
// * LayerNorm backward (ln_bwd_kernel): one warp a row, any width.
// * Attention backward up to L 64 (attn_bwd_seq_kernel): up to 8 whole
//   sequences a block, a warp serving one, a lane two keys, ds and drop(p)
//   in shared memory, one kernel, in FFMA.  Past L 64 (any L:
//   attn_bwd_dq_kernel, then attn_bwd_dkv_kernel) the four products run
//   on the tensor cores (encoder_common.cuh attn_qk, attn_mm): a block a
//   head and a tile of 64 query (then key) rows of one sequence, 16 a
//   warp, the other side in chunks of 64.  do·vᵀ in tc.cuh's 6-term form
//   (as K2's q·kᵀ: a sharp softmax passes its error on), each k-step's
//   partial Kahan-added, ds·k, dsᵀ·q and drop(p)ᵀ·do in 3xTF32, each
//   k-step's partial added in f32.  dp, then
//   ds, go through an H·B·L² buffer of the workspace, which the second
//   kernel reads transposed into shared memory: no row of the softmax
//   need fit on chip, and each of dq, dk, dv is written once with no
//   atomics.  8·N·L·d FLOPs.  Only these kernels are tied to sequences;
//   the GEMMs are not.
// * Weight gradients (wgrad_kernel): reductions over all N rows of the
//   call, split into row ranges (a multiple of 32 rows each) that fill the
//   SMs in whole waves; each (output tile, split) block writes its partial
//   once, the bias sums beside it and the LayerNorm scale and bias sums as
//   jobs of their own (a block for each kWgThreads columns, a thread a
//   column, its adds in row order, first in the grid: each is a chain as
//   long as a split's rows, with kLnBatch rows' loads in flight), and
//   sum_partials_kernel adds the partials in split order.  No atomics and
//   no read-modify-write of a partial: two launches on the same inputs
//   give bitwise-equal results.
// A tower call of one layer launches 10 kernels up to L 64, 11 past it;
// each further layer adds 8, or 9; the bf16 instantiation one more a call
// (the weights' bf16 copy), and so does the f32 one past d 256 (the
// weights' TF32 parts).
//
// The bf16 instantiation (encoder_bwd's bf16; compute_dtype="bfloat16")
// differentiates encoder.cu's bf16 forward as the Pallas kernel's
// _bwd_kernel does with matmul_dtype=bf16: both operands of every product
// are rounded to bf16, the incoming gradient included, and the products
// sum in f32.  The GEMMs and the weight gradients run on the bf16 tensor
// cores, operands rounded as they are staged (the weights once a call,
// into a buffer the wrapper allocates), read by ldmatrix, one m16n8k16
// bf16 MMA a k16 step, each 32-k chunk's exact products summed from a
// zeroed accumulator and added in f32 (tc.cuh gemm_tile_bf16;
// wg_tile_bf16); the attention backward rounds v, do, k and q as it
// stages them and ds and drop(p) as it stores them (past L 64 on the bf16
// tensor cores, each k16 step from a zeroed partial added in f32), and
// keeps the softmax backward (dp·p, ds) in f32, as do the LayerNorm
// backward, the bias and LayerNorm sums and the dropout.

#include <type_traits>
#include <vector>

#include "encoder_common.cuh"
#include "tc.cuh"
#include "wgmma.cuh"

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
  const uint16_t* w16;  // the bf16 instantiation's: W in bf16
  float* c;             // [n, m]
  int n, k, m, epi;
  const float* res;     // [n, m]
  const float* aux;     // [n, m]
  drop::Dropout dr;     // dropout where dr.on
  uint32_t salt;        // of the epilogue's stream (drop::Dropout::salt)
};

// The epilogue: acc in the m16n8 C layout, the thread's rows r_lo and
// r_lo + 8 of n-tiles j at columns n0 + 8·j + 2·tq and the next, as
// gemm_tile and wg::tile leave it; elements 2h and 2h + 1 of n-tile j as
// one float2 (m % 8 == 0: both or neither in range).
template <int kNj, bool kMap>
__device__ __forceinline__ void bwd_epilogue(const GemmArgs& g,
                                             const float (&acc)[kNj][4],
                                             int r_lo, int n0, int tq,
                                             uint32_t key) {
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

// kMap: the call's dropout maps its rows (drop::Dropout::mapped); TERMS 3
// is 3xTF32 (tc.cuh gemm_tile), 1 the bf16 instantiation (gemm_tile_bf16).
// Up to d 256 (kWideD).
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
  if constexpr (TERMS == 1)
    gemm_tile_bf16<NT, false>(g.a, g.w16, g.n, g.k, g.m, row0, n0,
                              reinterpret_cast<uint16_t*>(smem4), acc);
  else
    gemm_tile<NT, false, TERMS>(g.a, g.w, g.n, g.k, g.m, row0, n0,
                                reinterpret_cast<float*>(smem4), acc);
  bwd_epilogue<kNj, kMap>(g, acc, row0 + warp * 16 + gq, n0, tq,
                          g.dr.key(g.salt));
}

// Past d 256 (kWideD): wg::tile (wgmma.cuh), MODE 3 (3xTF32: tb the
// weight's TF32 parts, [2][M][K], which the call's pre-pass splits) or 1
// (bf16: tb the call's bf16 copy [M][K]); W [M, K] is already K-major.
template <int MODE, bool kMap>
__global__ void __launch_bounds__(wg::kThreads, 1)
tc_gemm_kernel_wgmma(const GemmArgs g, const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb) {
  extern __shared__ float4 smem4[];
  const int tiles_m = (g.m + wg::kCols - 1) / wg::kCols;
  const int row0 = (blockIdx.x / tiles_m) * wg::kRows;
  const int n0 = (blockIdx.x % tiles_m) * wg::kCols;
  float acc[wg::kNj][4];
  if (!wg::tile<MODE>(&ta, &tb, g.k, row0, n0,
                      reinterpret_cast<uint8_t*>(smem4), acc))
    return;
  const int lane = threadIdx.x & 31;
  bwd_epilogue<wg::kNj, kMap>(g, acc,
                             row0 + (threadIdx.x >> 5) * 16 + (lane >> 2),
                             n0, lane & 3, g.dr.key(g.salt));
}

// The f32 pre-pass past d 256: each weight stack's TF32 parts
// (parts_layout, wgmma.cuh split_weights).
__global__ void __launch_bounds__(kThreads)
encoder_bwd_split_kernel(const wg::SplitJobs js) {
  wg::split_weights(js);
}

// ------------------------------------------------------- the attention ----

// Dynamic shared memory of the two attention backward kernels at head dim
// dh, bytes: attn_bwd_dq_kernel two staged chunks [kAttnRows][attn_ld] (do;
// v, then k); attn_bwd_dkv_kernel one (q, then do) and a transposed tile
// [kAttnRows][attn_ldp] (ds, then drop(p)).
__host__ __device__ constexpr int attn_dq_smem(int dh, bool bf) {
  return 2 * kAttnRows * attn_ld(attn_cw(dh), bf) * (bf ? 2 : 4);
}
__host__ __device__ constexpr int attn_dkv_smem(int dh, bool bf) {
  return kAttnRows * (attn_ld(attn_cw(dh), bf) + attn_ldp(bf)) * (bf ? 2 : 4);
}

// The attention backward past kSeqL (any L), in two kernels over tiles of
// kAttnRows query (then key) rows of one sequence, a block a head
// (blockIdx.y), 16 rows a warp in the m16n8 fragments, the other side in
// chunks of kAttnRows (encoder_common.cuh's tensor-core attention):
// dpd = do·vᵀ, dp = drop(dpd), ds = p·(dp - Σ dp·p), dq = ds·k / sqrt(dh),
// dk = dsᵀ·q / sqrt(dh), dv = drop(p)ᵀ·do, from the saved qkv and p and
// the gradient do of the attention output.
//
// attn_bwd_dq_kernel, a query tile: per key chunk, dpd (attn_qk over do
// and v) in the C fragments, dropped into dp, written to dsbuf
// [head][row][key], each row's Σ dp·p kept (a thread's share, then the
// quad); then, for each kHc columns of dq, per key chunk dp and p read
// back at the fragments' places, ds = p·(dp - Σ) (kBf: rounded) written
// over dp on the first pass, and dq += ds·k (attn_mm, ds's fragments as
// the A operand).  attn_bwd_dkv_kernel, a key tile (after the first
// kernel, which wrote all of ds): for each kHc columns, dk over the query
// chunks (q and a transposed tile of ds staged), then dv (do and drop(p),
// rounded in kBf).  kBf: the products' operands rounded to bf16 (v, do, k,
// q as they are staged, ds and drop(p) as they are stored); the softmax
// backward stays f32.
template <bool kBf>
__global__ void __launch_bounds__(kAttnThreads, kBf ? 3 : 2)
attn_bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ p_in,
                   const float* __restrict__ d_o, float* __restrict__ dqkv,
                   float* __restrict__ dsbuf, int B, int L, int d, int n_head,
                   drop::Dropout dr, uint32_t salt) {
  using T = typename std::conditional<kBf, uint16_t, float>::type;
  constexpr int kAs = kBf ? kAsBf16 : kAsF32;
  extern __shared__ float4 smem4[];
  const int dh = d / n_head;
  const int ld = attn_ld(attn_cw(dh), kBf);
  T* G = reinterpret_cast<T*>(smem4);          // [kAttnRows][ld]: do
  T* C = G + kAttnRows * ld;                   // v, then k
  const uint32_t key = dr.key(salt);
  const int tiles = attn_tiles(L);
  const int b = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * kAttnRows;
  const int nr = min(kAttnRows, L - r0);
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const bool live = warp * 16 < nr;
  const size_t N = (size_t)B * L;
  const size_t row_b = (size_t)b * L;
  const uint32_t gb = dr.batch(b);
  const int d3 = 3 * d;
  const int hc = h * dh;
  const bool g_once = dh <= kHc;
  const float inv_sqrt_dh = 1.f / sqrtf(static_cast<float>(dh));
  const int i0 = r0 + warp * 16 + gq;
  auto at = [&](int i, int j) {
    return ((size_t)h * N + row_b + i) * L + j;
  };
  if (g_once) attn_stage<kAs>(G, ld, d_o, d, row_b + r0, nr, hc, dh);

  float dpp[2] = {0.f, 0.f};             // Σ dp·p, the thread's share
  for (int kc = 0; kc < L; kc += kAttnRows) {
    const int nk = min(kAttnRows, L - kc);
    float S[8][4], Sc[8][4];       // dpd, and its Kahan compensation
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[j][e] = Sc[j][e] = 0.f;
    for (int c0 = 0; c0 < dh; c0 += kHc) {
      const int cw = min(kHc, dh - c0);
      __syncthreads();     // the buffers' readers done
      if (!g_once)
        attn_stage<kAs>(G, ld, d_o, d, row_b + r0, nr, hc + c0, cw);
      attn_stage<kAs>(C, ld, qkv, d3, row_b + kc, nk, 2 * d + hc + c0, cw);
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      __syncthreads();
      if (live) attn_qk<kBf>(G, C, ld, cw, S, Sc);
    }
    if (!live) continue;
    attn_sum(S, Sc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jc = 8 * j + 2 * tq + (e & 1);
        const int i = i0 + 8 * (e >> 1);
        if (jc >= nk || i >= r0 + nr) continue;
        float dp = S[j][e];
        if (dr.on)
          dp = dr.apply(dp, key, static_cast<uint32_t>(
                                     (((size_t)gb * n_head + h) * L + i) * L
                                     + kc + jc));
        dsbuf[at(i, kc + jc)] = dp;
        dpp[e >> 1] += dp * p_in[at(i, kc + jc)];
      }
  }
  dpp[0] = quad_sum(dpp[0]);
  dpp[1] = quad_sum(dpp[1]);
  for (int c0 = 0; c0 < dh; c0 += kHc) {
    const int cw = min(kHc, dh - c0);
    float acc[kAttnNt][4];
#pragma unroll
    for (int n = 0; n < kAttnNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int kc = 0; kc < L; kc += kAttnRows) {
      const int nk = min(kAttnRows, L - kc);
      __syncthreads();     // the previous chunk's readers done
      attn_stage<kAs>(C, ld, qkv, d3, row_b + kc, nk, d + hc + c0, cw);
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      __syncthreads();
      if (!live) continue;
      // the chunk's ds at the fragments' places; on the first pass from dp
      // (written back)
      float S[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jc = 8 * j + 2 * tq + (e & 1);
          const int i = i0 + 8 * (e >> 1);
          float ds = 0.f;
          if (jc < nk && i < r0 + nr) {
            const size_t k = at(i, kc + jc);
            ds = dsbuf[k];
            if (c0 == 0) {
              ds = p_in[k] * (ds - dpp[e >> 1]);
              if constexpr (kBf) ds = bf16f(ds);
              dsbuf[k] = ds;
            }
          }
          S[j][e] = ds;
        }
      attn_mm<kBf>(RegsA{S}, C, ld, cw, acc);
    }
    if (!live) continue;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + 8 * u;
      if (i >= r0 + nr) continue;
      float* dst = dqkv + (row_b + i) * d3 + hc + c0 + 2 * tq;
#pragma unroll
      for (int n = 0; n < kAttnNt; ++n)
        if (8 * n < cw)
          *reinterpret_cast<float2*>(dst + 8 * n) =
              make_float2(acc[n][2 * u] * inv_sqrt_dh,
                          acc[n][2 * u + 1] * inv_sqrt_dh);
    }
  }
}

template <bool kBf>
__global__ void __launch_bounds__(kAttnThreads, 2)
attn_bwd_dkv_kernel(const float* __restrict__ qkv,
                    const float* __restrict__ p_in,
                    const float* __restrict__ d_o, float* __restrict__ dqkv,
                    const float* __restrict__ dsbuf, int B, int L, int d,
                    int n_head, drop::Dropout dr, uint32_t salt) {
  using T = typename std::conditional<kBf, uint16_t, float>::type;
  constexpr int kAs = kBf ? kAsBf16 : kAsF32;
  extern __shared__ float4 smem4[];
  const int dh = d / n_head;
  const int ld = attn_ld(attn_cw(dh), kBf);
  constexpr int ldp = attn_ldp(kBf);
  T* X = reinterpret_cast<T*>(smem4);          // [kAttnRows][ld]: q, do
  T* P = X + kAttnRows * ld;                   // [query][key]: ds, drop(p)
  const uint32_t key = dr.key(salt);
  const int tiles = attn_tiles(L);
  const int b = blockIdx.x / tiles;
  const int j0 = (blockIdx.x % tiles) * kAttnRows;   // the key tile
  const int nr = min(kAttnRows, L - j0);
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tq = lane & 3;
  const bool live = warp * 16 < nr;
  const size_t N = (size_t)B * L;
  const size_t row_b = (size_t)b * L;
  const uint32_t gb = dr.batch(b);
  const int d3 = 3 * d;
  const int hc = h * dh;
  const float inv_sqrt_dh = 1.f / sqrtf(static_cast<float>(dh));
  const int r_lo = j0 + warp * 16 + (lane >> 2);   // this thread's keys
  for (int c0 = 0; c0 < dh; c0 += kHc) {
    const int cw = min(kHc, dh - c0);
    // pass 0: dk = dsᵀ·q; pass 1: dv = drop(p)ᵀ·do
    for (int pass = 0; pass < 2; ++pass) {
      float acc[kAttnNt][4];
#pragma unroll
      for (int n = 0; n < kAttnNt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      for (int qc = 0; qc < L; qc += kAttnRows) {
        const int nq = min(kAttnRows, L - qc);
        __syncthreads();   // the previous chunk's readers done
        if (pass == 0)
          attn_stage<kAs>(X, ld, qkv, d3, row_b + qc, nq, hc + c0, cw);
        else
          attn_stage<kAs>(X, ld, d_o, d, row_b + qc, nq, hc + c0, cw);
        // the chunk's ds or drop(p), [query][key] as they lie in dsbuf and
        // the p slot, two keys a thread, zero past nq and nr
        for (int v = threadIdx.x; v < kAttnRows * kAttnRows / 2;
             v += kAttnThreads) {
          const int r = v / (kAttnRows / 2), c = 2 * (v % (kAttnRows / 2));
          float x[2] = {0.f, 0.f};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (r >= nq || c + u >= nr) continue;
            const int i = qc + r, j = j0 + c + u;
            const size_t k = ((size_t)h * N + row_b + i) * L + j;
            if (pass == 0) {
              x[u] = dsbuf[k];
            } else {
              x[u] = p_in[k];
              if (dr.on)
                x[u] = dr.apply(x[u], key, static_cast<uint32_t>(
                                               (((size_t)gb * n_head + h) * L
                                                + i) * L + j));
            }
          }
          if constexpr (kBf)
            *reinterpret_cast<uint32_t*>(P + r * ldp + c) =
                pack_bf16(x[0], x[1]);
          else
            *reinterpret_cast<float2*>(P + r * ldp + c) =
                make_float2(x[0], x[1]);
        }
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        __syncthreads();
        if (live) attn_mm<kBf>(TransA<kBf>{P}, X, ld, cw, acc);
      }
      if (!live) continue;
      const float scale = pass == 0 ? inv_sqrt_dh : 1.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = r_lo + 8 * u;
        if (j >= j0 + nr) continue;
        float* dst = dqkv + (row_b + j) * d3 + (pass + 1) * d + hc + c0
                     + 2 * tq;
#pragma unroll
        for (int n = 0; n < kAttnNt; ++n)
          if (8 * n < cw)
            *reinterpret_cast<float2*>(dst + 8 * n) =
                make_float2(acc[n][2 * u] * scale, acc[n][2 * u + 1] * scale);
      }
    }
  }
}

// ---- up to L 64: whole sequences in shared memory ----
//
// Dynamic shared memory of attn_bwd_seq_kernel at length L, in bytes: for
// R = attn_seqs(L)·L rows, three chunks of 64 head columns [R][kLdc] and
// ds and drop(p) of one head ([R][round4(L)] each).
__host__ __device__ constexpr int attn_seq_bwd_smem(int L) {
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
attn_bwd_seq_kernel(const float* __restrict__ qkv, const float* __restrict__ p_in,
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

// LayerNorm backward, one warp per row, any width (a lane takes columns
// lane + 32·t in order, gin and xhat read twice, the second time from L1
// or L2): dz = rstd·(g·s - mean(g·s) - xhat·mean(g·s·xhat)); dzd =
// drop(dz) where dzd is not null (kMap: the dropout maps its rows).
template <bool kMap>
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
  float m1 = 0.f, m2 = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float gs = gin[at + c] * scale[c];
    m1 += gs;
    m2 += gs * xhat[at + c];
  }
  m1 = warp_sum(m1) / d;
  m2 = warp_sum(m2) / d;
  const float rs = rstd[r];
  for (int c = lane; c < d; c += 32) {
    const float gs = gin[at + c] * scale[c];
    const float v = rs * (gs - m1 - xhat[at + c] * m2);
    dz[at + c] = v;
    if (dzd) dzd[at + c] = dr.apply(v, key, dat + c);
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
// The bf16 tile's (wg_tile_bf16): two slots of X and Y rounded to bf16,
// rows of an odd count of 16-byte units (ldmatrix phases free of bank
// conflicts), then two slots of Y's f32 values for the bias sum.
constexpr int kLdx16 = kWgK + 8;
constexpr int kLdy16 = kWgM + 8;
constexpr int kWgStage16 = kWgRows * (kLdx16 + kLdy16);    // elements
constexpr int kWgSmemBf = 2 * 2 * kWgStage16 + 2 * 4 * kWgRows * kWgM;
static_assert((2 * kLdx16) % 32 == 16 && (2 * kLdy16) % 32 == 16,
              "rows of an odd count of 16-byte units");

// One layer's weight-gradient jobs: first n_ln LayerNorm sums,
// colsum(lg·lx) and colsum(lg), a job for each kWgThreads columns; then
// product p (qkv, out, ff1, ff2), dW = x[p]ᵀ·y[p] ([d, mw[p]]) with its
// bias colsum(y[p]), in tiles of kWgK x kWgM.  Outputs are offsets into a
// split's partial of the flat gradient buffer.
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

// Rows of a LayerNorm job whose loads are in flight at once.  A column's
// sums over a split's rows are chains of dependent adds, as long as the
// split: a few rows a round trip to memory, with one block for all of d,
// set wgrad_kernel's time (an H100's profile, PERF.md §6).
constexpr int kLnBatch = 16;

// Column blocks of a LayerNorm job.
__host__ __device__ inline int wg_ln_cols(int d) {
  return (d + kWgThreads - 1) / kWgThreads;
}

int wg_tiles(const int* mw, int d) {
  const int tk = (d + kWgK - 1) / kWgK;
  int n = 0;
  for (int p = 0; p < 4; ++p) n += tk * ((mw[p] + kWgM - 1) / kWgM);
  return n;
}

// The bf16 instantiation's tile: acc = X[rows, k0 ..]ᵀ·Y[rows, m0 ..] over
// the split's rows in stages of kWgRows, in the m16n8k16 C layout (warp w
// holds dW rows k0 + 16·w + g and + 8).  A stage of X and of Y is loaded
// as float4s into registers while the block multiplies the stage before,
// then rounded to bf16 (cvt.rn.bf16x2: round_bf16's rounding) and stored.
// Both run along the call's rows, the product's k, so ldmatrix reads both
// transposed; one mma.sync.m16n8k16 bf16 a k16 step.  A stage's two k16
// steps sum in a zeroed accumulator and that partial is added to acc in
// f32, to nearest (as tc.cuh gemm_tile_bf16): no chain longer than a
// stage stays in the accumulator, whose adds truncate.  With the bias,
// Y's f32 values also go to shared memory, where thread t adds column
// m0 + t row by row, as the f32 tile does.
__device__ __forceinline__ void wg_tile_bf16(
    const float* __restrict__ X, const float* __restrict__ Y, int d, int M,
    int k0, int m0, int r_begin, int r_end, bool with_bias, uint16_t* smem,
    float (&acc)[kWgM / 8][4], float& bsum) {
  constexpr int kNj = kWgM / 8;             // n-tiles a warp
  constexpr int kNb = 4;                    // n-tiles a partial
  constexpr int kXv = kWgRows * kWgK / 4 / kWgThreads;   // float4s a
  constexpr int kYv = kWgRows * kWgM / 4 / kWgThreads;   // thread
  float* yf = reinterpret_cast<float*>(smem + 2 * kWgStage16);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_chunks = r_end > r_begin ? (r_end - r_begin + kWgRows - 1) /
                                             kWgRows : 0;
  // float4 i of this thread: v = threadIdx.x + i·kWgThreads, X's at row
  // v / (kWgK / 4) of the stage, columns 4·(v % (kWgK / 4)) + 0..3 of the
  // tile; Y's likewise with kWgM
  float4 xv[kXv], yv[kYv];
  auto load = [&](int chunk) {
    const int r0 = r_begin + chunk * kWgRows;
#pragma unroll
    for (int i = 0; i < kXv; ++i) {
      const int v = threadIdx.x + i * kWgThreads;
      const int r = r0 + v / (kWgK / 4), c = k0 + (v % (kWgK / 4)) * 4;
      xv[i] = r < r_end && c < d
                  ? *reinterpret_cast<const float4*>(X + (size_t)r * d + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kYv; ++i) {
      const int v = threadIdx.x + i * kWgThreads;
      const int r = r0 + v / (kWgM / 4), c = m0 + (v % (kWgM / 4)) * 4;
      yv[i] = r < r_end && c < M
                  ? *reinterpret_cast<const float4*>(Y + (size_t)r * M + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&](int slot) {
    uint16_t* xs = smem + slot * kWgStage16;
    uint16_t* ys = xs + kWgRows * kLdx16;
#pragma unroll
    for (int i = 0; i < kXv; ++i) {
      const int v = threadIdx.x + i * kWgThreads;
      *reinterpret_cast<uint2*>(xs + v / (kWgK / 4) * kLdx16 +
                                (v % (kWgK / 4)) * 4) =
          make_uint2(pack_bf16(xv[i].x, xv[i].y),
                     pack_bf16(xv[i].z, xv[i].w));
    }
#pragma unroll
    for (int i = 0; i < kYv; ++i) {
      const int v = threadIdx.x + i * kWgThreads;
      *reinterpret_cast<uint2*>(ys + v / (kWgM / 4) * kLdy16 +
                                (v % (kWgM / 4)) * 4) =
          make_uint2(pack_bf16(yv[i].x, yv[i].y),
                     pack_bf16(yv[i].z, yv[i].w));
      if (with_bias)
        *reinterpret_cast<float4*>(yf + slot * kWgRows * kWgM + 4 * v) =
            yv[i];
    }
  };

  if (n_chunks > 0) {
    load(0);
    store(0);
  }
#pragma unroll
  for (int j = 0; j < kNj; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  // this lane's ldmatrix row (lanes 8·q .. 8·q + 7 address matrix q): A =
  // Xᵀ's four are k 0-7 of dW rows 0-7 and 8-15, then k 8-15 (the m16n8k16
  // A fragment); Y's four k 0-7 and 8-15 of n-tile j, then of j + 1
  const int q = lane >> 3, r8 = lane & 7;
  const int a_off = ((q >> 1) * 8 + r8) * kLdx16 + warp * 16 + (q & 1) * 8;
  const int b_off = ((q & 1) * 8 + r8) * kLdy16 + (q >> 1) * 8;
  for (int it = 0; it < n_chunks; ++it) {
    __syncthreads();     // stage it in its slot; the other slot read
    const bool more = it + 1 < n_chunks;
    if (more) load(it + 1);
    const uint16_t* xs = smem + (it & 1) * kWgStage16;
    const uint16_t* ys = xs + kWgRows * kLdx16;
    if (with_bias) {
      const float* yfs = yf + (it & 1) * kWgRows * kWgM;
#pragma unroll 8
      for (int r = 0; r < kWgRows; ++r) bsum += yfs[r * kWgM + threadIdx.x];
    }
    uint32_t af[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldsm_x4<true>(af[ks], xs + a_off + 16 * ks * kLdx16);
#pragma unroll
    for (int j0 = 0; j0 < kNj; j0 += kNb) {
      float part[kNb][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int jp = 0; jp < kNb / 2; ++jp) {
          uint32_t b[4];
          ldsm_x4<true>(b, ys + b_off + 16 * ks * kLdy16 + 8 * (j0 + 2 * jp));
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
    if (more) store((it + 1) & 1);
  }
}

// kBf: the bf16 instantiation, on wg_tile_bf16.
template <bool kBf>
__global__ void __launch_bounds__(kWgThreads)
wgrad_kernel(const WgArgs a) {
  extern __shared__ float4 smem4[];
  const int r_begin = blockIdx.y * a.per;
  const int r_end = min(a.n, r_begin + a.per);
  float* part = a.part + (size_t)blockIdx.y * a.total;
  const int ln_cols = wg_ln_cols(a.d);
  int job = blockIdx.x;
  if (job < a.n_ln * ln_cols) {  // a LayerNorm job: a thread a column
    const int ln = job / ln_cols;
    const int c = (job % ln_cols) * kWgThreads + threadIdx.x;
    if (c >= a.d) return;
    const float* G = a.lg[ln];
    const float* X = a.lx[ln];
    float ss = 0.f, sb = 0.f;
    int r = r_begin;
    for (; r + kLnBatch <= r_end; r += kLnBatch) {
      float gv[kLnBatch], xv[kLnBatch];
#pragma unroll
      for (int i = 0; i < kLnBatch; ++i) {
        gv[i] = G[(size_t)(r + i) * a.d + c];
        xv[i] = X[(size_t)(r + i) * a.d + c];
      }
#pragma unroll
      for (int i = 0; i < kLnBatch; ++i) {
        ss = fmaf(gv[i], xv[i], ss);
        sb += gv[i];
      }
    }
    for (; r < r_end; ++r) {
      const float gv = G[(size_t)r * a.d + c];
      ss = fmaf(gv, X[(size_t)r * a.d + c], ss);
      sb += gv;
    }
    part[a.off_ls[ln] + c] = ss;
    part[a.off_lb[ln] + c] = sb;
    return;
  }
  job -= a.n_ln * ln_cols;
  const int tk = (a.d + kWgK - 1) / kWgK;
  int p = 0;
  for (; p < 4; ++p) {
    const int tiles = tk * ((a.mw[p] + kWgM - 1) / kWgM);
    if (job < tiles) break;
    job -= tiles;
  }
  const int M = a.mw[p];
  const int tm = (M + kWgM - 1) / kWgM;
  const int k0 = (job / tm) * kWgK;
  const int m0 = (job % tm) * kWgM;
  const float* X = a.x[p];
  const float* Y = a.y[p];
  const bool with_bias = k0 == 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  constexpr int kNj = kWgM / 8;
  float acc[kNj][4];
  float bsum = 0.f;
  if constexpr (kBf) {
    wg_tile_bf16(X, Y, a.d, M, k0, m0, r_begin, r_end, with_bias,
                 reinterpret_cast<uint16_t*>(smem4), acc, bsum);
  } else {
    float* smem = reinterpret_cast<float*>(smem4);
    const int n_chunks = r_end > r_begin ? (r_end - r_begin + kWgRows - 1) /
                                               kWgRows : 0;
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
#pragma unroll
    for (int j = 0; j < kNj; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

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
  }

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

// The bf16 instantiation's copy of the call's weights (encoder_common.cuh
// round_weights_bf16), its first launch.
__global__ void __launch_bounds__(kThreads)
encoder_bwd_weights_bf16_kernel(const Layer l0, int d, int n_layers,
                                uint16_t* w16) {
  round_weights_bf16(l0, d, n_layers, w16);
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
                           gemm_smem<64, false, 1>()));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<128, false, 1>, a,
                           gemm_smem<128, false, 1>()));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<256, false, 1>, a,
                           gemm_smem<256, false, 1>()));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<64, true, 1>, a,
                           gemm_smem<64, false, 1>()));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<128, true, 1>, a,
                           gemm_smem<128, false, 1>()));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel<256, true, 1>, a,
                           gemm_smem<256, false, 1>()));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel_wgmma<3, false>, a,
                           wg::Cfg<3>::kSmem));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel_wgmma<3, true>, a,
                           wg::Cfg<3>::kSmem));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel_wgmma<1, false>, a,
                           wg::Cfg<1>::kSmem));
  TRY(cudaFuncSetAttribute(tc_gemm_kernel_wgmma<1, true>, a,
                           wg::Cfg<1>::kSmem));
  int most = 0;
  for (int L = 1; L <= kSeqL; ++L)
    most = attn_seq_bwd_smem(L) > most ? attn_seq_bwd_smem(L) : most;
  TRY(cudaFuncSetAttribute(attn_bwd_seq_kernel<false>, a, most));
  TRY(cudaFuncSetAttribute(attn_bwd_seq_kernel<true>, a, most));
  TRY(cudaFuncSetAttribute(attn_bwd_dq_kernel<false>, a,
                           attn_dq_smem(kHc, false)));
  TRY(cudaFuncSetAttribute(attn_bwd_dq_kernel<true>, a,
                           attn_dq_smem(kHc, true)));
  TRY(cudaFuncSetAttribute(attn_bwd_dkv_kernel<false>, a,
                           attn_dkv_smem(kHc, false)));
  TRY(cudaFuncSetAttribute(attn_bwd_dkv_kernel<true>, a,
                           attn_dkv_smem(kHc, true)));
  TRY(cudaFuncSetAttribute(wgrad_kernel<false>, a, kWgSmem));
  TRY(cudaFuncSetAttribute(wgrad_kernel<true>, a, kWgSmemBf));
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

template <int NT, bool kMap, int TERMS>
cudaError_t gemm_t(const GemmArgs& g, cudaStream_t s) {
  const dim3 grid((g.n + kGemmRows - 1) / kGemmRows, (g.m + NT - 1) / NT);
  tc_gemm_kernel<NT, kMap, TERMS>
      <<<grid, kGemmThreads, gemm_smem<NT, false, TERMS>(), s>>>(g);
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

// A product past kWideD on wg::tile: b the weight's TF32 parts [2][m][k]
// or (bf16) its bf16 copy [m][k].
template <int MODE, bool kMap>
cudaError_t wide_t(const GemmArgs& g, const void* b, cudaStream_t s) {
  CUtensorMap ta, tb;
  TRY(wg::map_a(&ta, g.a, g.n, g.k));
  TRY(wg::map_b<MODE>(&tb, b, g.m, g.k));
  tc_gemm_kernel_wgmma<MODE, kMap>
      <<<wg::blocks(g.n, g.m), wg::kThreads, wg::Cfg<MODE>::kSmem, s>>>(
          g, ta, tb);
  return cudaGetLastError();
}

cudaError_t launch_wide(const GemmArgs& g, const void* b, bool bf16,
                        cudaStream_t s) {
  if (bf16)
    return g.dr.mapped() ? wide_t<1, true>(g, b, s) : wide_t<1, false>(g, b, s);
  return g.dr.mapped() ? wide_t<3, true>(g, b, s) : wide_t<3, false>(g, b, s);
}

// The f32 pre-pass of a call past kWideD: each weight stack's 3xTF32
// parts into parts, as it lies (parts_layout(d, true)).
cudaError_t split_weights(const Layer& l0, int d, int n_layers, float* parts,
                          cudaStream_t s) {
  const PartsLayout po = parts_layout(d, true);
  const float* src[4] = {l0.w_qkv, l0.w_out, l0.w_ff1, l0.w_ff2};
  const size_t at[4] = {po.qkv, po.out, po.ff1, po.ff2};
  wg::SplitJobs js{};
  js.n_jobs = 4;
  js.mats = n_layers;
  for (int j = 0; j < 4; ++j) {
    const int cols = j == 0 ? 3 * d : d;
    js.job[j] = wg::SplitJob{src[j], parts + at[j], d, cols, 2,
                             (size_t)d * cols, po.per_layer};
  }
  encoder_bwd_split_kernel<<<wg::split_grid(js), kThreads, 0, s>>>(js);
  return cudaGetLastError();
}

template <bool kMap>
cudaError_t ln_bwd_t(const float* gin, const float* xhat, const float* rstd,
                     const float* scale, float* dz, float* dzd, int n, int d,
                     drop::Dropout dr, uint32_t salt, cudaStream_t s) {
  const int blocks = (n + kThreads / 32 - 1) / (kThreads / 32);
  ln_bwd_kernel<kMap><<<blocks, kThreads, 0, s>>>(gin, xhat, rstd, scale, dz,
                                                  dzd, n, d, dr, salt);
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
  float *ga, *gb, *dz2, *dg2, *df, *dy1, *dz1, *da, *d_o, *dqkv, *ds, *part;
};

Temps take_temps(float* base, size_t N, int d, int n_head, int L,
                 size_t part_floats, size_t* total) {
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
  t.ds = at_((size_t)n_head * N * L);     // the attention's dp, then ds
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

size_t workspace_floats(int B, int L, int d, int n_head, int n_layers,
                        int splits) {
  size_t total = 0;
  take_temps(nullptr, (size_t)B * L, d, n_head, L,
             (size_t)splits * grad_offsets(d, n_layers).total, &total);
  return total;
}

// wcopy (weights_copy_bytes(d, n_layers, bf16, true)): bf16, the bf16
// instantiation first rounds the weights into it; f32 past kWideD the
// pre-pass writes wg::tile's parts there (parts_layout(d, true)).
cudaError_t run_bwd(const float* saved, const float* gout, const Layer& l0,
                    const float* lnf_s, float* dx, float* grads,
                    float* workspace, int splits, int B, int L, int d,
                    int n_head, int n_layers, drop::Dropout dr, bool bf16,
                    void* wcopy, cudaStream_t s) {
  const size_t N = (size_t)B * L;
  const int n = static_cast<int>(N);
  const GradOff go = grad_offsets(d, n_layers);
  const SavedLayout so = saved_layout(N, d, n_head, L, n_layers);
  const Temps t = take_temps(workspace, N, d, n_head, L,
                             (size_t)splits * go.total, nullptr);
  const int nt = width_tile(d);
  drop::Dropout off = dr;
  off.on = 0;
  const size_t s_qkv = (size_t)d * 3 * d, s_dd = (size_t)d * d;
  TRY(prepare());
  uint16_t* w16 = static_cast<uint16_t*>(wcopy);
  Weights16 w16s{};
  if (bf16) {
    encoder_bwd_weights_bf16_kernel<<<weights_bf16_blocks(d, n_layers),
                                      kThreads, 0, s>>>(l0, d, n_layers, w16);
    TRY(cudaGetLastError());
    w16s = weights16(w16, d, n_layers);
  }
  const bool wide = d > kWideD;
  const PartsLayout po = parts_layout(d, true);
  if (wide && !bf16)
    TRY(split_weights(l0, d, n_layers, static_cast<float*>(wcopy), s));
  // a product dX = dY·Wᵀ: W's parts (f32 past kWideD) at offset `at` of
  // layer li, or the gemm_tile launch
  auto gemm = [&](const GemmArgs& g, size_t at, int li) {
    if (!wide) return launch_gemm(g, nt, bf16, s);
    return launch_wide(g, bf16 ? static_cast<const void*>(g.w16)
                               : static_cast<const float*>(wcopy) +
                                     li * po.per_layer + at,
                       bf16, s);
  };
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
    g5.w16 = bf16 ? w16s.w_ff2 + li * s_dd : nullptr;
    g5.m = d; g5.epi = kDrelu; g5.aux = layer(li, so.l.fr);
    g5.dr = dr; g5.salt = dr.salt(drop::kFfnRelu, li);
    TRY(gemm(g5, po.ff2, li));
    GemmArgs g6{};
    g6.a = t.df; g6.w = l0.w_ff1 + li * s_dd; g6.c = t.dy1; g6.n = n;
    g6.w16 = bf16 ? w16s.w_ff1 + li * s_dd : nullptr;
    g6.k = d; g6.m = d; g6.epi = kRes; g6.res = t.dz2; g6.dr = off;
    TRY(gemm(g6, po.ff1, li));
    // LN1: z1 = x_in + drop(o·W_out + b_out)
    float* da = dr.on ? t.da : t.dz1;
    TRY(ln_bwd(t.dy1, layer(li, so.l.xhat1), layer(li, so.l.rstd1),
               l0.ln1_s + li * d, t.dz1, dr.on ? t.da : nullptr, n, d, dr,
               dr.salt(drop::kAttnOut, li), s));
    GemmArgs g7{};
    g7.a = da; g7.w = l0.w_out + li * s_dd; g7.c = t.d_o; g7.n = n; g7.k = d;
    g7.w16 = bf16 ? w16s.w_out + li * s_dd : nullptr;
    g7.m = d; g7.epi = kStore; g7.dr = off;
    TRY(gemm(g7, po.out, li));
    const dim3 attn_grid(B * attn_tiles(L), n_head);
    const uint32_t salt = dr.salt(drop::kProbs, li);
    const int dh = d / n_head;
    if (L <= kSeqL) {
      const int blocks = (B + attn_seqs(L) - 1) / attn_seqs(L);
      if (bf16)
        attn_bwd_seq_kernel<true>
            <<<blocks, kThreads, attn_seq_bwd_smem(L), s>>>(
                layer(li, so.l.qkv), layer(li, so.l.p), t.d_o, t.dqkv, B, L,
                d, n_head, dr, salt);
      else
        attn_bwd_seq_kernel<false>
            <<<blocks, kThreads, attn_seq_bwd_smem(L), s>>>(
                layer(li, so.l.qkv), layer(li, so.l.p), t.d_o, t.dqkv, B, L,
                d, n_head, dr, salt);
    } else if (bf16) {
      attn_bwd_dq_kernel<true>
          <<<attn_grid, kAttnThreads, attn_dq_smem(dh, true), s>>>(
              layer(li, so.l.qkv), layer(li, so.l.p), t.d_o, t.dqkv, t.ds, B,
              L, d, n_head, dr, salt);
      attn_bwd_dkv_kernel<true>
          <<<attn_grid, kAttnThreads, attn_dkv_smem(dh, true), s>>>(
              layer(li, so.l.qkv), layer(li, so.l.p), t.d_o, t.dqkv, t.ds, B,
              L, d, n_head, dr, salt);
    } else {
      attn_bwd_dq_kernel<false>
          <<<attn_grid, kAttnThreads, attn_dq_smem(dh, false), s>>>(
              layer(li, so.l.qkv), layer(li, so.l.p), t.d_o, t.dqkv, t.ds, B,
              L, d, n_head, dr, salt);
      attn_bwd_dkv_kernel<false>
          <<<attn_grid, kAttnThreads, attn_dkv_smem(dh, false), s>>>(
              layer(li, so.l.qkv), layer(li, so.l.p), t.d_o, t.dqkv, t.ds, B,
              L, d, n_head, dr, salt);
    }
    TRY(cudaGetLastError());
    // dx of the layer: dz1 + dqkv·Wqkvᵀ, through the input dropout below
    // the first layer
    GemmArgs g8{};
    g8.a = t.dqkv; g8.w = l0.w_qkv + li * s_qkv; g8.c = li ? gnext : dx;
    g8.w16 = bf16 ? w16s.w_qkv + li * s_qkv : nullptr;
    g8.n = n; g8.k = 3 * d; g8.m = d; g8.epi = kRes; g8.res = t.dz1;
    g8.dr = li ? off : dr; g8.salt = dr.salt(drop::kInput, 0);
    TRY(gemm(g8, po.qkv, li));

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
    const dim3 wg_grid(w.n_ln * wg_ln_cols(d) + wg_tiles(w.mw, d), splits);
    if (bf16)
      wgrad_kernel<true><<<wg_grid, kWgThreads, kWgSmemBf, s>>>(w);
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
// B·L rows (the attention's H·B·L² among them) and the weight-gradient
// partials of `grid` row splits.
extern "C" long long encoder_bwd_workspace_floats(int B, int L, int d,
                                                  int n_head, int n_layers,
                                                  int grid) {
  return (long long)workspace_floats(B, L, d, n_head, n_layers, grid);
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
// encoder_fwd's bf16 one (the head of the file).  w16: a buffer of
// encoder_weights_copy_bytes(d, n_layers, bf16, 1) bytes (16-byte aligned,
// encoder.cu) that receives the weights' bf16 copy or, f32 past d 256,
// their TF32 parts (null where that is 0).  Returns cudaGetLastError()
// after the launches (0 = launched).
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
    void* w16, void* stream) {
  (void)lnf_b;
  const Layer l0{w_qkv, b_qkv, w_out, b_out, w_ff1, b_ff1, w_ff2, b_ff2,
                 ln1_s, ln1_b, ln2_s, ln2_b};
  return static_cast<int>(run_bwd(
      saved, gout, l0, lnf_s, dx, grads, workspace, grid, B, L, d, n_head,
      n_layers,
      drop::make(drop_on, drop_thr, drop_div, seed, tower_id, row_off,
                 row_seg, row_stride, L, d),
      bf16 != 0, w16, static_cast<cudaStream_t>(stream)));
}

// One backward product on its own, for holding wg::tile against
// gemm_tile: c = A·Wᵀ, W [m, k] f32, with epilogue epi (kStore, kDrelu
// with aux, kRes with res; the dropout stream of `site` at layer 0, the
// row map of a [B, L, m] site); bf16 1 the bf16 instantiation; wide 1:
// wg::tile, else gemm_tile at width_tile(m).  scratch: the weight's copy,
// at least 2·k·m floats.  Returns cudaGetLastError() after the launches.
extern "C" int encoder_gemm_bwd(
    const float* a, const float* w, const float* res, const float* aux,
    float* c, void* scratch, int n, int k, int m, int epi, int bf16,
    int wide, int drop_on, unsigned drop_thr, float drop_div,
    const unsigned* seed, int tower_id, unsigned row_off, unsigned row_seg,
    unsigned row_stride, int L, int site, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  TRY(prepare());
  GemmArgs g{};
  g.a = a; g.w = w; g.res = res; g.aux = aux; g.c = c;
  g.n = n; g.k = k; g.m = m; g.epi = epi;
  g.dr = drop::make(drop_on, drop_thr, drop_div, seed, tower_id, row_off,
                    row_seg, row_stride, L, m);
  g.salt = g.dr.salt(site, 0);
  if (wide || bf16) {
    wg::SplitJobs js{};
    js.n_jobs = 1;
    js.mats = 1;
    js.bf16 = bf16;
    js.job[0] = wg::SplitJob{w, scratch, m, k, bf16 ? 1 : 2, (size_t)k * m,
                             (size_t)k * m};
    encoder_bwd_split_kernel<<<wg::split_grid(js), kThreads, 0, s>>>(js);
    TRY(cudaGetLastError());
    g.w16 = static_cast<const uint16_t*>(scratch);
  }
  if (wide) return static_cast<int>(launch_wide(g, scratch, bf16 != 0, s));
  return static_cast<int>(launch_gemm(g, width_tile(m), bf16 != 0, s));
}
