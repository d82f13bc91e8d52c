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
//   the tensor cores at f32 accuracy (3xTF32).  Up to d 256 (kWideD) on
//   tc.cuh's gemm_tile, which the backward shares: mma.sync.m16n8k8, 64
//   rows a block, 16 a warp, W read in its [k, m] layout through a
//   2-stage cp.async ring, 3 blocks an SM, a block holding whole rows so
//   that the LayerNorm runs in its registers (the final LN after the last
//   LN2).  Past d 256 on wgmma.cuh's wg::tile
//   (encoder_fwd_gemm_wgmma_kernel): 128 x 128 blocks of two warpgroups
//   running wgmma from a ring of TMA stages that a producer warp fills; a
//   TF32 B operand is read only K-major, so the call's first launch
//   (encoder_fwd_split_kernel) writes each weight's TF32 parts as Wᵀ, once
//   a call; encoder_fwd_ln_kernel does the LayerNorm, a warp a row at any
//   width.  Each epilogue adds the bias and folds in what follows the
//   product: ReLU and its dropout; the dropout and residual add of a
//   post-norm step (and up to d 256 its LayerNorm).
// * Attention up to L 64 (encoder_fwd_attn_seq_kernel): up to 8 whole
//   sequences a block (64 rows), a warp serving one, a lane two of its
//   keys, the probabilities in shared memory, q·kᵀ and p·v in FFMA over
//   64-column chunks of q, k, v (float4 reads), 4 blocks an SM; at L 15 it
//   is the faster (kSeqL).  The logits' sums over the head's columns are
//   compensated (add_compensated), for the reason the QKV product is
//   f32-accurate (encoder_fwd_gemm_kernel).
// * Past L 64 (any L: encoder_fwd_attn_kernel) both products run on the
//   tensor cores (encoder_common.cuh attn_qk, attn_mm; the bf16
//   instantiation's p·v in FFMA, below): a block a head and
//   a tile of 64 query rows of one sequence, 4 warps of 16 rows in the
//   m16n8 fragments, keys in chunks of 64.  The logits stay in registers,
//   each as two f32 parts (its compensated sum, scaled): a first pass over
//   the key chunks keeps each row's online max and sum (shuffles across
//   the quad that holds a row), a second recomputes them (the same bits),
//   writes p to the saved slot once in training, drops it and takes its
//   fragments as the A operand of p·v as they lie.  q·kᵀ
//   in tc.cuh's 6-term form (f32-accurate, as the QKV product), each
//   k-step's partial Kahan-added, p·v in 3xTF32, each k-step's partial
//   added in f32.  4·N·L·d FLOPs (all
//   L keys of every query: an all-masked row averages over all of them)
//   and 4 bytes a probability written in training.
// * Every intermediate lands in the saved-activation layout (saved_layout):
//   in training the buffer the backward reads, so saving costs nothing
//   beyond the writes each kernel makes anyway; in eval a one-layer
//   workspace of the same layout, with the backward's extras (xhat, 1/std,
//   p) not written.
// A one-layer tower call launches 6 kernels up to d 256 (5 in eval without
// dropout: the input kernel only applies dropout or saves the input) and 9
// above (the weights' pre-pass among them); each further layer adds 5, or
// 7; the bf16 instantiation up to d 256 one more a call (the weights' bf16
// copy; past d 256 the pre-pass writes it, transposed).
//
// The bf16 instantiation (encoder_fwd's bf16; compute_dtype="bfloat16") is
// the Pallas kernel's matmul_dtype=bf16: every product rounds both
// operands to bf16 (round to nearest even) and sums in f32.  The four
// GEMMs run on the bf16 tensor cores (tc.cuh gemm_tile_bf16: W from the
// call's bf16 copy of its weights, made by the call's first launch, A
// rounded as it is staged, ldmatrix and one m16n8k16 bf16 MMA a k16 step,
// exact products, each 32-k chunk's sum added in f32; past d 256
// wg::tile's bf16 mode, wgmma m64n128k16 on the copy transposed, the same
// chunk sums), at twice the TF32 rate, and so does q·kᵀ past L 64 (q and k rounded as they are staged,
// each k16 step from a zeroed partial, Kahan-added, scaled after the
// product); p·v there, and both products up to L 64 (the whole-sequence
// kernel), run FFMA over the same rounded operands (a product of two bf16
// values is exact in f32), an f32 chain over the keys (why:
// encoder_fwd_attn_kernel).  LayerNorm, softmax, dropout, the residual adds and every saved
// activation stay f32: the backward (encoder_bwd.cu) rounds them where it
// multiplies them.

#include <type_traits>

#include "encoder_common.cuh"
#include "tc.cuh"
#include "wgmma.cuh"

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
  const uint16_t* w16; // the bf16 instantiation's: W in bf16
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
// tower's (an H100's measurement, PERF.md §6).  kBf16Terms names the bf16
// instantiation, which takes tc.cuh's gemm_tile_bf16.
constexpr int kQkvTerms = 6, kTerms = 3, kBf16Terms = 1;

// The epilogue of every product but kResLn: acc in the m16n8 C layout, the
// thread's rows r_lo and r_lo + 8 of n-tiles j at columns n0 + 8·j + 2·tq
// and the next (tc.cuh's mma_tf32 note), as gemm_tile and wg::tile leave
// it; elements 2h and 2h + 1 of n-tile j as one float2 (m % 8 == 0: both
// or neither in range).
template <int kNj, bool kMap>
__device__ __forceinline__ void fwd_epilogue(const FwdGemm& g,
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
}

// kMap: the call's dropout maps its rows (drop::Dropout::mapped).  Three
// blocks an SM, two for the bf16 tile at NT 256, whose A chunk in flight
// (16 registers) joins its 128 accumulators.  Up to d 256 (kWideD).
template <int NT, int TERMS, bool kMap>
__global__ void __launch_bounds__(kGemmThreads,
                                  TERMS == kBf16Terms && NT == 256 ? 2 : 3)
encoder_fwd_gemm_kernel(const FwdGemm g) {
  constexpr int kNj = NT / 8;
  extern __shared__ float4 smem4[];
  const int row0 = blockIdx.x * kGemmRows;
  const int n0 = blockIdx.y * NT;
  float acc[kNj][4];
  if constexpr (TERMS == kBf16Terms)
    gemm_tile_bf16<NT, true>(g.a, g.w16, g.n, g.k, g.m, row0, n0,
                             reinterpret_cast<uint16_t*>(smem4), acc);
  else
    gemm_tile<NT, true, TERMS>(g.a, g.w, g.n, g.k, g.m, row0, n0,
                               reinterpret_cast<float*>(smem4), acc);
  const uint32_t key = g.dr.key(g.salt);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tq = lane & 3;
  const int r_lo = row0 + warp * 16 + (lane >> 2);
  if (g.epi != kResLn) {
    fwd_epilogue<kNj, kMap>(g, acc, r_lo, n0, tq, key);
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

// Past d 256 (kWideD) the four products run wg::tile (wgmma.cuh): a block
// of 128 rows and 128 columns, MODE 6 for QKV, 3 for the others, 1 in
// bf16; the grid's blocks column tiles fastest.  ta is A's map, tb the
// weight's parts (or bf16 copy), K-major.  No kResLn: past d 256 the
// LayerNorm runs in encoder_fwd_ln_kernel.
template <int MODE, bool kMap>
__global__ void __launch_bounds__(wg::kThreads, 1)
encoder_fwd_gemm_wgmma_kernel(const FwdGemm g,
                              const __grid_constant__ CUtensorMap ta,
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
  fwd_epilogue<wg::kNj, kMap>(g, acc,
                             row0 + (threadIdx.x >> 5) * 16 + (lane >> 2),
                             n0, lane & 3, g.dr.key(g.salt));
}

// The weights' copy a call makes first (wgmma.cuh split_weights): the
// bf16 instantiation's (weights16's layout; past d 256 each matrix
// transposed, K-major for wg::tile) or, f32 past d 256, wg::tile's parts
// (fwd_parts).
__global__ void __launch_bounds__(kThreads)
encoder_fwd_split_kernel(const wg::SplitJobs js) {
  wg::split_weights(js);
}

// ------------------------------------------------------- the attention ----

// Dynamic shared memory of encoder_fwd_attn_kernel at head dim dh, in
// bytes: staged chunks of q and k [kAttnRows][attn_ld] and of v; kBf: v in
// f32 (its values rounded) and the chunk's dropped p [kAttnRows][attn_ldp]
// for p·v in FFMA; the key chunk's flags.
__host__ __device__ constexpr int attn_fwd_smem(int dh, bool bf) {
  return kAttnRows * (2 * attn_ld(attn_cw(dh), bf) * (bf ? 2 : 4)
                      + 4 * attn_ld(attn_cw(dh), false)
                      + (bf ? 4 * attn_ldp(false) : 0) + 4);
}

// Past kSeqL (any L): per block one head (blockIdx.y) and a tile of
// kAttnRows query rows of one sequence (blockIdx.x: sequence, tile), 16 a
// warp; the keys in chunks of kAttnRows, the head's columns kHc at a time
// (q staged once up to head dim 128).  Each key chunk's logits S = q·kᵀ
// (attn_qk) stay in the warp's m16n8 C fragments, scaled after the
// product, plus the added -1e9 bias where the key is later than the query
// or masked; a row's values lie on a quad.
// 1. Every chunk's logits give each row's max and sum of exp(s - max),
//    online (the sum rescaled when a chunk raises the max), reduced across
//    the quad by shuffles; nothing is written.
// 2. For each kHc columns of the output (one pass up to head dim 128):
//    every chunk's logits again (the same bits), p = exp(s - max) / sum,
//    written once to the p slot in training (the pre-dropout
//    probabilities K3 reads, [head][row][key]; not in eval, where nothing
//    reads it), dropped, and o += drop(p)·v (attn_mm, p's fragments as
//    the A operand as they lie).
// All L keys of every query (an all-masked row averages over all of them:
// no causal skip of a tile's later chunks).  kBf: q, k and v staged and
// drop(p) taken rounded to bf16 (the bf16 instantiation's products), q·kᵀ
// on the bf16 tensor cores; p·v in FFMA, a lane four output columns of a
// warp's 16 rows, one fused multiply-add a key in order (the whole-sequence
// kernel's chain): on an H100 the m16n8k16's truncating sums of p·v moved
// more of o's bf16 roundings across float64's than an f32 chain does,
// enough to put K2 bf16's output past chip_smoke.py's BF16_F64_K at L 65
// (PERF.md §6).  The softmax, dropout and the p slot stay f32.
template <bool kBf>
__global__ void __launch_bounds__(kAttnThreads, 2)
encoder_fwd_attn_kernel(const float* __restrict__ qkv,
                        const int* __restrict__ seq, float* __restrict__ o,
                        float* __restrict__ pbuf, int B, int L, int d,
                        int n_head, int idx_pad, int invert, int save,
                        drop::Dropout dr, uint32_t salt) {
  using T = typename std::conditional<kBf, uint16_t, float>::type;
  constexpr int kAs = kBf ? kAsBf16 : kAsF32;
  constexpr int ldp = attn_ldp(false);
  static_assert(kAttnNt == 16, "kBf's acc holds a warp's 16 rows");
  extern __shared__ float4 smem4[];
  const int dh = d / n_head;
  const int ld = attn_ld(attn_cw(dh), kBf);
  const int ldv = attn_ld(attn_cw(dh), false);
  T* Q = reinterpret_cast<T*>(smem4);          // [kAttnRows][ld]
  T* K = Q + kAttnRows * ld;
  float* V = reinterpret_cast<float*>(K + kAttnRows * ld);   // [.][ldv]
  float* P = V + kAttnRows * ldv;              // kBf: [kAttnRows][ldp]
  int* key_ok = reinterpret_cast<int*>(P + (kBf ? kAttnRows * ldp : 0));
  const uint32_t key = dr.key(salt);
  const int tiles = attn_tiles(L);
  const int b = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * kAttnRows;
  const int nr = min(kAttnRows, L - r0);
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const bool live = warp * 16 < nr;         // the warp holds a query row
  const size_t N = (size_t)B * L;
  const size_t row_b = (size_t)b * L;       // the sequence's first row
  const uint32_t gb = dr.batch(b);
  const int d3 = 3 * d;
  const int hc = h * dh;
  const bool q_once = dh <= kHc;
  const float inv_sqrt_dh = 1.f / sqrtf(static_cast<float>(dh));
  // this thread's query rows (fragment rows g and g + 8)
  const int i0 = r0 + warp * 16 + gq;
  if (q_once) attn_stage<kAs>(Q, ld, qkv, d3, row_b + r0, nr, hc, dh);

  // S + L = the logits of key chunk kc (nk keys) for the warp's rows: the
  // compensated sum of q·k, scaled, as a high part S and a low part L, so
  // that a logit's difference from the row's largest keeps more than f32's
  // bits (an f32 logit of 16 to 32 is a few 1e-6 off, which moves a large p
  // across a bf16 rounding boundary as often as the plain tower's sums
  // do).  A masked logit is f32's S·scale - 1e9 (L 0), whose rounding to
  // steps of 64 decides an all-masked row; -inf past nk.  With vcol >= 0
  // also stages v's columns [vcol, vcol + vcw).
  auto logits = [&](int kc, int nk, float (&S)[8][4], float (&Sc)[8][4],
                    int vcol, int vcw) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[j][e] = Sc[j][e] = 0.f;
    for (int c0 = 0; c0 < dh; c0 += kHc) {
      const int cw = min(kHc, dh - c0);
      __syncthreads();     // the buffers' readers done
      if (!q_once)
        attn_stage<kAs>(Q, ld, qkv, d3, row_b + r0, nr, hc + c0, cw);
      attn_stage<kAs>(K, ld, qkv, d3, row_b + kc, nk, d + hc + c0, cw);
      if (c0 == 0) {
        if (vcol >= 0)
          attn_stage<kBf ? kAsRoundedF32 : kAsF32>(V, ldv, qkv, d3,
                                                   row_b + kc, nk, vcol, vcw);
        for (int r = threadIdx.x; r < nk; r += kAttnThreads) {
          const bool real = seq[row_b + kc + r] != idx_pad;
          key_ok[r] = invert ? !real : real;
        }
      }
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      __syncthreads();
      if (live) attn_qk<kBf>(Q, K, ld, cw, S, Sc);
    }
    if (!live) return;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jc = 8 * j + 2 * tq + (e & 1);
        const int i = i0 + 8 * (e >> 1);
        // the sum S - Sc as hi + lo (|Sc| <= an ulp of S)
        const float hi = S[j][e] - Sc[j][e];
        const float lo = (S[j][e] - hi) - Sc[j][e];
        const float l = hi * inv_sqrt_dh;
        if (jc >= nk) {
          S[j][e] = -CUDART_INF_F;
          Sc[j][e] = 0.f;
        } else if (kc + jc <= i && key_ok[jc]) {
          S[j][e] = l;
          Sc[j][e] = fmaf(hi, inv_sqrt_dh, -l) + lo * inv_sqrt_dh;
        } else {
          S[j][e] = l + kNeg;
          Sc[j][e] = 0.f;
        }
      }
  };
  // the larger of two logits (high part first, then low), into (m, ml)
  auto larger = [](float& m, float& ml, float o, float ol) {
    if (o > m || (o == m && ol > ml)) {
      m = o;
      ml = ol;
    }
  };

  // 1. each row's max (mx + mxl, the largest logit's two parts) and sum of
  // exp(logit - max), online over the key chunks
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, mxl[2] = {0.f, 0.f};
  float sum[2] = {0.f, 0.f};
  for (int kc = 0; kc < L; kc += kAttnRows) {
    float S[8][4], Sc[8][4];
    logits(kc, min(kAttnRows, L - kc), S, Sc, -1, 0);
    if (!live) continue;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float m = mx[u], ml = mxl[u];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * u; e < 2 * u + 2; ++e) larger(m, ml, S[j][e], Sc[j][e]);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        larger(m, ml, __shfl_xor_sync(0xffffffffu, m, off),
               __shfl_xor_sync(0xffffffffu, ml, off));
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 2 * u; x < 2 * u + 2; ++x)
          e += expf((S[j][x] - m) + (Sc[j][x] - ml));
      sum[u] = sum[u] * expf((mx[u] - m) + (mxl[u] - ml)) + quad_sum(e);
      mx[u] = m;
      mxl[u] = ml;
    }
  }
  // 2. o = drop(p)·v, kHc output columns a pass
  for (int c0 = 0; c0 < dh; c0 += kHc) {
    const int cw = min(kHc, dh - c0);
    // f32: o's m16n8 fragments, acc[n-tile][element]; kBf: acc[row][m],
    // the warp's row 16·warp + r at column lane + 32·m
    float acc[kAttnNt][4];
#pragma unroll
    for (int n = 0; n < kAttnNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int kc = 0; kc < L; kc += kAttnRows) {
      const int nk = min(kAttnRows, L - kc);
      float S[8][4], Sc[8][4];
      logits(kc, nk, S, Sc, 2 * d + hc + c0, cw);
      if (!live) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = e >> 1;
          const int jc = 8 * j + 2 * tq + (e & 1);
          const int i = i0 + 8 * u;
          float p = expf((S[j][e] - mx[u]) + (Sc[j][e] - mxl[u])) /
                    sum[u];                           // 0 past nk
          if (jc < nk && i < r0 + nr) {
            const size_t at = (size_t)(kc + jc);
            if (save && c0 == 0)
              pbuf[((size_t)h * N + row_b + i) * L + at] = p;
            if (dr.on)
              p = dr.apply(p, key, static_cast<uint32_t>(
                                       (((size_t)gb * n_head + h) * L + i)
                                       * L + at));
          }
          S[j][e] = p;
        }
      if constexpr (kBf) {
        // the warp's rows of drop(p), rounded, to its rows of P; acc[r][m]
        // += P[r][key]·v[key][lane + 32·m], one key at a time
        float* pw = P + warp * 16 * ldp;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            *reinterpret_cast<float2*>(pw + (gq + 8 * u) * ldp + 8 * j +
                                       2 * tq) =
                make_float2(bf16f(S[j][2 * u]), bf16f(S[j][2 * u + 1]));
        __syncwarp();
        for (int k = 0; k < nk; ++k) {
          const float* vr = V + k * ldv + lane;
          float v[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) v[m] = lane + 32 * m < cw ? vr[32 * m] : 0.f;
#pragma unroll
          for (int r = 0; r < 16; ++r) {
            const float pk = pw[r * ldp + k];
#pragma unroll
            for (int m = 0; m < 4; ++m) acc[r][m] = fmaf(pk, v[m], acc[r][m]);
          }
        }
        __syncwarp();
      } else {
        attn_mm<false>(RegsA{S}, V, ld, cw, acc);
      }
    }
    if (!live) continue;
    if constexpr (kBf) {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int i = r0 + warp * 16 + r;
        if (i >= r0 + nr) continue;
        float* dst = o + (row_b + i) * d + hc + c0 + lane;
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (lane + 32 * m < cw) dst[32 * m] = acc[r][m];
      }
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + 8 * u;
        if (i >= r0 + nr) continue;
        float* dst = o + (row_b + i) * d + hc + c0 + 2 * tq;
#pragma unroll
        for (int n = 0; n < kAttnNt; ++n)
          if (8 * n < cw)
            *reinterpret_cast<float2*>(dst + 8 * n) =
                make_float2(acc[n][2 * u], acc[n][2 * u + 1]);
      }
    }
  }
}

// ---- up to L 64: whole sequences in shared memory ----
//
// Dynamic shared memory of encoder_fwd_attn_seq_kernel at length L, in bytes:
// for R = attn_seqs(L)·L rows, a chunk of q (then v) and of k [R][kLdc],
// the dropped probabilities [R][round4(L)] and the key flags.
__host__ __device__ constexpr int attn_seq_fwd_smem(int L) {
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
encoder_fwd_attn_seq_kernel(const float* __restrict__ qkv,
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
// rows; any width): y = LN(z) (into y, xhat and rstd, each where not null),
// and with gf the final LN of y after it (into out, xhat_f, rstd_f; with y
// null the first LN's row goes to out and the final LN takes it there).  z
// may be xhat itself: a lane reads its columns before it writes them.
__global__ void __launch_bounds__(kThreads)
encoder_fwd_ln_kernel(const float* z, const float* __restrict__ g,
                      const float* __restrict__ b, float* y, float* xhat,
                      float* rstd, const float* __restrict__ gf,
                      const float* __restrict__ bf, float* out,
                      float* xhat_f, float* rstd_f, int n, int d) {
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= n) return;
  const size_t at = (size_t)r * d;
  float* y1 = y ? y + at : out + at;
  ln_row(z + at, d, g, b, y1, xhat ? xhat + at : nullptr,
         rstd ? rstd + r : nullptr);
  if (gf)
    ln_row(y1, d, gf, bf, out + at, xhat_f ? xhat_f + at : nullptr,
           rstd_f ? rstd_f + r : nullptr);
}

// The bf16 instantiation's copy of the call's weights (encoder_common.cuh
// round_weights_bf16), its first launch.
__global__ void __launch_bounds__(kThreads)
encoder_fwd_weights_bf16_kernel(const Layer l0, int d, int n_layers,
                                uint16_t* w16) {
  round_weights_bf16(l0, d, n_layers, w16);
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
                           gemm_smem<64, true, kBf16Terms>()));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<128, kBf16Terms, false>,
                           a, gemm_smem<128, true, kBf16Terms>()));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<256, kBf16Terms, false>,
                           a, gemm_smem<256, true, kBf16Terms>()));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<64, kBf16Terms, true>, a,
                           gemm_smem<64, true, kBf16Terms>()));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<128, kBf16Terms, true>, a,
                           gemm_smem<128, true, kBf16Terms>()));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_kernel<256, kBf16Terms, true>, a,
                           gemm_smem<256, true, kBf16Terms>()));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_wgmma_kernel<6, false>, a,
                           wg::Cfg<6>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_wgmma_kernel<3, false>, a,
                           wg::Cfg<3>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_wgmma_kernel<3, true>, a,
                           wg::Cfg<3>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_wgmma_kernel<1, false>, a,
                           wg::Cfg<1>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_gemm_wgmma_kernel<1, true>, a,
                           wg::Cfg<1>::kSmem));
  TRY(cudaFuncSetAttribute(encoder_fwd_attn_kernel<false>, a,
                           attn_fwd_smem(kHc, false)));
  TRY(cudaFuncSetAttribute(encoder_fwd_attn_kernel<true>, a,
                           attn_fwd_smem(kHc, true)));
  int most = 0;
  for (int L = 1; L <= kSeqL; ++L)
    most = attn_seq_fwd_smem(L) > most ? attn_seq_fwd_smem(L) : most;
  TRY(cudaFuncSetAttribute(encoder_fwd_attn_seq_kernel<false>, a, most));
  TRY(cudaFuncSetAttribute(encoder_fwd_attn_seq_kernel<true>, a, most));
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

template <int NT, int TERMS, bool kMap>
cudaError_t gemm_t(const FwdGemm& g, cudaStream_t s) {
  const dim3 grid((g.n + kGemmRows - 1) / kGemmRows, (g.m + NT - 1) / NT);
  encoder_fwd_gemm_kernel<NT, TERMS, kMap>
      <<<grid, kGemmThreads, gemm_smem<NT, true, TERMS>(), s>>>(g);
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

// A product past kWideD on wg::tile: MODE 6 (QKV), 3 or, bf16, 1; b the
// weight's parts or bf16 copy, K-major [m][k].
template <int MODE, bool kMap>
cudaError_t wide_t(const FwdGemm& g, const void* b, cudaStream_t s) {
  CUtensorMap ta, tb;
  TRY(wg::map_a(&ta, g.a, g.n, g.k));
  TRY(wg::map_b<MODE>(&tb, b, g.m, g.k));
  encoder_fwd_gemm_wgmma_kernel<MODE, kMap>
      <<<wg::blocks(g.n, g.m), wg::kThreads, wg::Cfg<MODE>::kSmem, s>>>(
          g, ta, tb);
  return cudaGetLastError();
}

// The QKV product past kWideD (no dropout site).
cudaError_t launch_wide_qkv(const FwdGemm& g, const void* b, bool bf16,
                            cudaStream_t s) {
  return bf16 ? wide_t<1, false>(g, b, s) : wide_t<6, false>(g, b, s);
}

// The other products past kWideD.
cudaError_t launch_wide(const FwdGemm& g, const void* b, bool bf16,
                        cudaStream_t s) {
  if (bf16)
    return g.dr.mapped() ? wide_t<1, true>(g, b, s) : wide_t<1, false>(g, b, s);
  return g.dr.mapped() ? wide_t<3, true>(g, b, s) : wide_t<3, false>(g, b, s);
}

// The pre-pass of a call past kWideD (f32 or bf16) into wcopy: each
// weight stack K-major for wg::tile (transposed), as parts_layout's f32
// parts or in bf16 in weights16's layout.
cudaError_t split_weights(const Layer& l0, int d, int n_layers, bool bf16,
                          void* wcopy, cudaStream_t s) {
  const size_t dd = (size_t)d * d, nd = n_layers * dd;
  const PartsLayout po = parts_layout(d, false);
  const float* src[4] = {l0.w_qkv, l0.w_out, l0.w_ff1, l0.w_ff2};
  const size_t at16[4] = {0, 3 * nd, 4 * nd, 5 * nd};
  const size_t at32[4] = {po.qkv, po.out, po.ff1, po.ff2};
  wg::SplitJobs js{};
  js.n_jobs = 4;
  js.mats = n_layers;
  js.transpose = 1;
  js.bf16 = bf16;
  for (int j = 0; j < 4; ++j) {
    const int cols = j == 0 ? 3 * d : d;
    wg::SplitJob& jb = js.job[j];
    jb.src = src[j];
    jb.dst = bf16 ? static_cast<void*>(static_cast<uint16_t*>(wcopy) +
                                       at16[j])
                  : static_cast<void*>(static_cast<float*>(wcopy) + at32[j]);
    jb.rows = d;
    jb.cols = cols;
    jb.parts = bf16 ? 1 : j == 0 ? 3 : 2;
    jb.src_stride = (size_t)d * cols;
    jb.dst_stride = bf16 ? (size_t)d * cols : po.per_layer;
  }
  encoder_fwd_split_kernel<<<wg::split_grid(js), kThreads, 0, s>>>(js);
  return cudaGetLastError();
}

// The LayerNorm kernel's launch (d > 256).
cudaError_t launch_ln(const float* z, const float* g, const float* b,
                      float* y, float* xhat, float* rstd, const float* gf,
                      const float* bf, float* out, float* xhat_f,
                      float* rstd_f, int n, int d, cudaStream_t s) {
  const int blocks = (n + kThreads / 32 - 1) / (kThreads / 32);
  encoder_fwd_ln_kernel<<<blocks, kThreads, 0, s>>>(
      z, g, b, y, xhat, rstd, gf, bf, out, xhat_f, rstd_f, n, d);
  return cudaGetLastError();
}

// buf: with save, saved_layout(N, d, n_head, L, n_layers) (every layer's
// activations, for the backward); else a one-layer workspace of the same
// layout, which every layer reuses.  wcopy (weights_copy_bytes(d,
// n_layers, bf16, false)): the bf16 instantiation first rounds the
// weights into it (past kWideD transposed); f32 past kWideD the pre-pass
// writes wg::tile's parts there (parts_layout).
cudaError_t run_fwd(const float* x, const int* seq, const Layer& l0,
                    const float* lnf_s, const float* lnf_b, float* out,
                    float* buf, bool save, int B, int L, int d, int n_head,
                    int n_layers, int idx_pad, int invert, drop::Dropout dr,
                    bool bf16, void* wcopy, cudaStream_t s) {
  const size_t N = (size_t)B * L;
  const int n = static_cast<int>(N);
  const SavedLayout so = saved_layout(N, d, n_head, L, save ? n_layers : 1);
  const size_t s_qkv = (size_t)d * 3 * d, s_dd = (size_t)d * d;
  const bool fused_ln = d <= kWideD;
  const bool wide = d > kWideD;
  TRY(prepare());
  uint16_t* w16 = static_cast<uint16_t*>(wcopy);
  Weights16 w16s{};
  if (wide) {
    TRY(split_weights(l0, d, n_layers, bf16, wcopy, s));
  } else if (bf16) {
    encoder_fwd_weights_bf16_kernel<<<weights_bf16_blocks(d, n_layers),
                                      kThreads, 0, s>>>(l0, d, n_layers, w16);
    TRY(cudaGetLastError());
  }
  if (bf16) w16s = weights16(w16, d, n_layers);
  const PartsLayout po = parts_layout(d, false);
  // the wide tile's B of product p (0 QKV, 1 out, 2 FF1, 3 FF2) at layer li
  auto wide_b = [&](int p, int li) -> const void* {
    if (bf16) {
      const uint16_t* w[4] = {w16s.w_qkv, w16s.w_out, w16s.w_ff1, w16s.w_ff2};
      return w[p] + li * (p == 0 ? s_qkv : s_dd);
    }
    const size_t at[4] = {po.qkv, po.out, po.ff1, po.ff2};
    return static_cast<const float*>(wcopy) + li * po.per_layer + at[p];
  };

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
    q.w16 = bf16 ? w16s.w_qkv + li * s_qkv : nullptr;
    q.c = qkv; q.n = n; q.k = d; q.m = 3 * d; q.epi = kBias; q.dr = dr;
    TRY(wide ? launch_wide_qkv(q, wide_b(0, li), bf16, s)
             : launch_qkv_gemm(q, column_tile(3 * d), bf16, s));

    if (L <= kSeqL) {
      const int blocks = (B + attn_seqs(L) - 1) / attn_seqs(L);
      float* p_save = save ? lb + so.l.p : nullptr;
      if (bf16)
        encoder_fwd_attn_seq_kernel<true>
            <<<blocks, kThreads, attn_seq_fwd_smem(L), s>>>(
                qkv, seq, o, p_save, B, L, d, n_head, idx_pad, invert, dr,
                dr.salt(drop::kProbs, li));
      else
        encoder_fwd_attn_seq_kernel<false>
            <<<blocks, kThreads, attn_seq_fwd_smem(L), s>>>(
                qkv, seq, o, p_save, B, L, d, n_head, idx_pad, invert, dr,
                dr.salt(drop::kProbs, li));
    } else {
      const dim3 attn_grid(B * attn_tiles(L), n_head);
      const int dh = d / n_head;
      if (bf16)
        encoder_fwd_attn_kernel<true>
            <<<attn_grid, kAttnThreads, attn_fwd_smem(dh, true), s>>>(
                qkv, seq, o, lb + so.l.p, B, L, d, n_head, idx_pad, invert,
                save, dr, dr.salt(drop::kProbs, li));
      else
        encoder_fwd_attn_kernel<false>
            <<<attn_grid, kAttnThreads, attn_fwd_smem(dh, false), s>>>(
                qkv, seq, o, lb + so.l.p, B, L, d, n_head, idx_pad, invert,
                save, dr, dr.salt(drop::kProbs, li));
    }
    TRY(cudaGetLastError());

    // y1 = LN1(X + drop(o·W_out + b_out)); above d 256 the sum goes to the
    // xhat1 slot first and the LN kernel normalises it there
    FwdGemm w{};
    w.a = o; w.w = l0.w_out + li * s_dd; w.bias = l0.b_out + ob; w.res = X;
    w.w16 = bf16 ? w16s.w_out + li * s_dd : nullptr;
    w.n = n; w.k = d; w.m = d; w.dr = dr;
    w.salt = dr.salt(drop::kAttnOut, li);
    if (fused_ln) {
      w.epi = kResLn; w.c = y1; w.ln_s = l0.ln1_s + ob; w.ln_b = l0.ln1_b + ob;
      w.xhat = save ? xhat1 : nullptr;
      w.rstd = save ? lb + so.l.rstd1 : nullptr;
      TRY(launch_gemm(w, width_tile(d), bf16, s));
    } else {
      w.epi = kResidual; w.c = xhat1;
      TRY(launch_wide(w, wide_b(1, li), bf16, s));
      TRY(launch_ln(xhat1, l0.ln1_s + ob, l0.ln1_b + ob, y1,
                    save ? xhat1 : nullptr, save ? lb + so.l.rstd1 : nullptr,
                    nullptr, nullptr, nullptr, nullptr, nullptr, n, d, s));
    }

    // fr = relu(y1·W1 + b1); fd = drop(fr) (saved, or read by FF2 under
    // dropout)
    FwdGemm f{};
    f.a = y1; f.w = l0.w_ff1 + li * s_dd; f.bias = l0.b_ff1 + ob; f.c = fr;
    f.w16 = bf16 ? w16s.w_ff1 + li * s_dd : nullptr;
    f.c2 = save || dr.on ? fd : nullptr; f.n = n; f.k = d; f.m = d;
    f.epi = kRelu; f.dr = dr; f.salt = dr.salt(drop::kFfnRelu, li);
    TRY(wide ? launch_wide(f, wide_b(2, li), bf16, s)
             : launch_gemm(f, column_tile(d), bf16, s));

    // xnext = LN2(y1 + drop(f·W2 + b2)), then out = LNf(xnext) after the
    // last layer
    FwdGemm f2{};
    f2.a = f.c2 ? fd : fr; f2.w = l0.w_ff2 + li * s_dd; f2.bias = l0.b_ff2 + ob;
    f2.w16 = bf16 ? w16s.w_ff2 + li * s_dd : nullptr;
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
      TRY(launch_wide(f2, wide_b(3, li), bf16, s));
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
// Requires d % n_head == 0, head dim % 8 == 0, L >= 1, fewer than 2^31
// elements in x and in the probabilities (encoder_cuda.supported and
// _check), n_layers >= 1; x, the weights
// and buf 16-byte aligned.  Dropout: drop_on 0 is eval; else kept values
// are divided by drop_div (f32(1 - p)) where the hash bits reach drop_thr
// (ops/dropout.threshold), from the uint32 seed at `seed` in device memory
// (read by each kernel; null at drop_on 0); row_off, row_seg and row_stride place the call's
// rows in the run's batch (drop::Dropout; row_seg 0: the identity).  buf:
// with save != 0, saved_layout for n_layers
// (encoder_saved_offsets), which receives the activations the backward
// reads; else the workspace, saved_layout for one layer.  bf16 != 0: the
// bf16 instantiation (the head of the file), the same layout of f32
// activations.  w16: a buffer of encoder_weights_copy_bytes(d, n_layers,
// bf16, 0) bytes (16-byte aligned) that receives the weights' bf16 copy
// or, f32 past d 256, their TF32 parts (null where that is 0).  Returns
// cudaGetLastError() after the launches (0 = launched).
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
    void* w16, void* stream) {
  const Layer l0{w_qkv, b_qkv, w_out, b_out, w_ff1, b_ff1, w_ff2, b_ff2,
                 ln1_s, ln1_b, ln2_s, ln2_b};
  return static_cast<int>(run_fwd(
      x, seq, l0, lnf_s, lnf_b, out, buf, save != 0, B, L, d, n_head,
      n_layers, idx_pad, invert,
      drop::make(drop_on, drop_thr, drop_div, seed, tower_id, row_off,
                 row_seg, row_stride, L, d),
      bf16 != 0, w16, static_cast<cudaStream_t>(stream)));
}

// Bytes of the weights' copy a call of the forward (bwd 0) or of the
// backward makes first (encoder_common.cuh weights_copy_bytes): the bf16
// copy, or f32 past d 256 wg::tile's parts; 0: none (w16 may be null).
extern "C" long long encoder_weights_copy_bytes(int d, int n_layers, int bf16,
                                                int bwd) {
  return (long long)weights_copy_bytes(d, n_layers, bf16 != 0, bwd != 0);
}

// One forward product on its own, for holding wg::tile against gemm_tile:
// c = A·W + b with epilogue epi (kBias, kRelu with c2, kResidual with res;
// the dropout stream of `site` at layer 0, the row map of a [B, L, m]
// site), W [k, m] f32; mode 6 (the 6-term split), 3 (3xTF32) or 1 (bf16);
// wide 1: wg::tile, else gemm_tile at the column tile the tower gives m.
// scratch: the weight's copy, at least k·m·3 floats.  Returns
// cudaGetLastError() after the launches.
extern "C" int encoder_gemm_fwd(
    const float* a, const float* w, const float* bias, const float* res,
    float* c, float* c2, void* scratch, int n, int k, int m, int epi,
    int mode, int wide, int drop_on, unsigned drop_thr, float drop_div,
    const unsigned* seed, int tower_id, unsigned row_off, unsigned row_seg,
    unsigned row_stride, int L, int site, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  TRY(prepare());
  FwdGemm g{};
  g.a = a; g.w = w; g.bias = bias; g.res = res; g.c = c; g.c2 = c2;
  g.n = n; g.k = k; g.m = m; g.epi = epi;
  g.dr = drop::make(drop_on, drop_thr, drop_div, seed, tower_id, row_off,
                    row_seg, row_stride, L, m);
  g.salt = g.dr.salt(site, 0);
  const bool bf16 = mode == kBf16Terms;
  if (wide || bf16) {
    wg::SplitJobs js{};
    js.n_jobs = 1;
    js.mats = 1;
    js.transpose = wide;
    js.bf16 = bf16;
    js.job[0] = wg::SplitJob{w, scratch, k, m, bf16 ? 1 : mode == 6 ? 3 : 2,
                             (size_t)k * m, (size_t)k * m};
    encoder_fwd_split_kernel<<<wg::split_grid(js), kThreads, 0, s>>>(js);
    TRY(cudaGetLastError());
    g.w16 = static_cast<const uint16_t*>(scratch);
  }
  if (wide) {
    if (mode == 6) return static_cast<int>(wide_t<6, false>(g, scratch, s));
    return static_cast<int>(launch_wide(g, scratch, bf16, s));
  }
  if (mode == 6)
    return static_cast<int>(launch_qkv_gemm(g, column_tile(m), false, s));
  return static_cast<int>(launch_gemm(g, column_tile(m), bf16, s));
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
