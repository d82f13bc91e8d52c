// What the tower forward (encoder.cu) and backward (encoder_bwd.cu)
// share: the saved-activation layout, the bf16 copy of a call's weights,
// kNeg and kLnEps, warp reductions, a LayerNorm row walked by a warp, and
// the attention kernels' tiles.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dropout.cuh"
#include "tc.cuh"

namespace tower {

constexpr int kThreads = 256;
constexpr float kNeg = -1e9f;
constexpr float kLnEps = 1e-8f;
constexpr int kCh = 64;        // head columns a whole-sequence chunk holds
constexpr int kLdc = kCh + 4;  // chunk row stride: a quarter warp's float4
                               // loads of 8 rows fall in distinct banks

// Sequences a whole-sequence attention block holds at length L: the most,
// a power of two up to 8, whose rows fit in 64; a warp serves one of them,
// so 8 / S warps share a sequence.  Past L 32 one sequence.
__host__ __device__ constexpr int attn_seqs(int L) {
  return L <= 8 ? 8 : L <= 16 ? 4 : L <= 32 ? 2 : 1;
}

// The longest L at which the whole-sequence attention kernels run (a lane
// two keys of a sequence, its probabilities in shared memory); past it the
// tensor-core kernels.  At FK's L 15 the whole-sequence kernels are the
// faster (PERF.md §6: K2 0.8415 against 0.9628 ms a step on an H100).
constexpr int kSeqL = 64;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------ attention on the tensor cores ----
// The attention kernels past kSeqL (encoder.cu encoder_fwd_attn_kernel,
// encoder_bwd.cu attn_bwd_dq_kernel and attn_bwd_dkv_kernel) take a block
// of 4 warps for one head and a tile of kAttnRows rows of one sequence (of
// queries, or of keys), 16 rows a warp in the mma.sync m16n8 fragments;
// the other side passes in chunks of kAttnRows positions.  The head's
// columns are staged kHc at a time (one chunk up to head dim 128) into
// rows of stride attn_ld, zero past the chunk's columns up to a multiple
// of 32 and past its rows up to kAttnRows, so every k-step and n-tile of a
// product runs whole and zeros add nothing.
//
// Products (the Pallas tower's _bmm: operands in mm_dtype, f32 sums):
// * attn_qk, q·kᵀ and do·vᵀ: f32 in tc.cuh's 6-term form, each k8-step's
//   six MMAs from a zeroed partial; bf16 by ldmatrix, each k16 step's
//   m16n8k16 from a zeroed partial.  The partials are Kahan-added to the
//   sum in f32: a partly sharp softmax passes a logit's absolute error on
//   to its row's gradient (encoder.cu), and in bf16 to the rounding of p.
// * attn_mm, p·v, ds·k, dsᵀ·q and drop(p)ᵀ·do over one chunk of 64
//   positions: f32 3xTF32, each k8-step's three MMAs from a zeroed partial
//   added to the sum in f32; bf16 each k16 step's MMA from a zeroed
//   partial added in f32.  The A operand comes from a functor: a
//   product's own C fragments (p, ds), or a transposed tile in shared
//   memory (dsᵀ, drop(p)ᵀ).
// No chain of MMAs longer than a k-step stays in the tensor cores'
// accumulator, whose adds truncate: on an H100 the chains of a 64-position
// chunk put K3's dx at chip_smoke.py's LONG_STEP past 1.25x the FFMA
// kernels' distance from float64, and K2 bf16's output past BF16_F64_K
// (PERF.md §6).
// tests/test_torch_attn_mma.py emulates both orders against float64.
constexpr int kAttnThreads = 128;   // 4 warps
constexpr int kAttnRows = 64;       // rows a tile; positions a chunk
constexpr int kHc = 128;            // head columns a staged chunk holds
constexpr int kAttnNt = kHc / 8;    // n-tiles of an output row block

// Head columns of a staged chunk at head dim dh.
__host__ __device__ constexpr int attn_cw(int dh) {
  return dh < kHc ? dh : kHc;
}

// Row stride, in elements, of a staged chunk of at most cw columns: f32
// rows of 4 mod 32 floats, so a warp's fragment loads (rows g at column t,
// or rows 2t at column g) meet each bank once; bf16 rows of an odd count
// of 16-byte units, so each 8-row phase of an ldmatrix meets every bank
// once.
__host__ __device__ constexpr int attn_ld(int cw, bool bf) {
  return (cw + 31) / 32 * 32 + (bf ? 8 : 4);
}

// Row stride of a kAttnRows x kAttnRows tile (dsᵀ, drop(p)ᵀ) in shared
// memory.
__host__ __device__ constexpr int attn_ldp(bool bf) {
  return attn_ld(kAttnRows, bf);
}

// Tiles of kAttnRows rows of a sequence of length L.
__host__ __device__ constexpr int attn_tiles(int L) {
  return (L + kAttnRows - 1) / kAttnRows;
}

// How attn_stage stores a chunk: f32 as it is (by cp.async: the caller
// commits and waits), bf16 rows (round_bf16's rounding), or f32 rows of
// values rounded to bf16 (K2 bf16's v, which its p·v takes in FFMA).
enum StageAs : int { kAsF32 = 0, kAsBf16 = 1, kAsRoundedF32 = 2 };

// Rows row0 .. row0 + n - 1 (n <= kAttnRows), columns [col, col + cw) of
// src [rows, ld_src] into dst [kAttnRows][ld], zero past n rows and past cw
// columns up to a multiple of 32; by the whole block.
template <int kAs>
__device__ __forceinline__ void attn_stage(void* dst, int ld,
                                           const float* __restrict__ src,
                                           int ld_src, size_t row0, int n,
                                           int col, int cw) {
  const int c4n = (cw + 31) / 32 * 8;    // float4s a staged row
  for (int v = threadIdx.x; v < kAttnRows * c4n; v += kAttnThreads) {
    const int r = v / c4n, c = (v % c4n) * 4;
    const bool ok = r < n && c < cw;
    const float* s = ok ? src + (row0 + r) * ld_src + col + c : src;
    if constexpr (kAs == kAsF32) {
      tc::cp_async16(static_cast<float*>(dst) + r * ld + c, s, ok);
    } else {
      const float4 x = ok ? *reinterpret_cast<const float4*>(s)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kAs == kAsBf16)
        *reinterpret_cast<uint2*>(static_cast<uint16_t*>(dst) + r * ld +
                                  c) =
            make_uint2(tc::pack_bf16(x.x, x.y), tc::pack_bf16(x.z, x.w));
      else
        *reinterpret_cast<float4*>(static_cast<float*>(dst) + r * ld + c) =
            make_float4(tc::bf16f(x.x), tc::bf16f(x.y), tc::bf16f(x.z),
                        tc::bf16f(x.w));
    }
  }
}

// s += x with Kahan's compensation c: the sum is s - c (attn_sum), within
// an ulp of the exact one, as whole-sequence kernels' add_compensated.
__device__ __forceinline__ void add_kahan(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// S[j] += A·Bᵀ over the first cw columns of two staged chunks, A [rows][k]
// (the warp's 16 rows from 16·warp) and B [64 positions][k]: the warp's 16
// x 64 tile in the m16n8 C layout (n-tile j: positions 8j ..), each
// k-step's partial Kahan-added with the compensation in C (the product is
// attn_sum's S - C).
template <bool kBf>
__device__ __forceinline__ void attn_qk(const void* A, const void* Bm, int ld,
                                        int cw, float (&S)[8][4],
                                        float (&C)[8][4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if constexpr (kBf) {
    const uint16_t* a = static_cast<const uint16_t*>(A);
    const uint16_t* b = static_cast<const uint16_t*>(Bm);
    // ldmatrix rows (lanes 8·q .. 8·q + 7 address matrix q), as
    // tc::gemm_tile_bf16's A and its W [m, k]
    const int q = lane >> 3, r8 = lane & 7;
    const int a_off = (warp * 16 + (q & 1) * 8 + r8) * ld + (q >> 1) * 8;
    const int b_off = ((q >> 1) * 8 + r8) * ld + (q & 1) * 8;
    for (int k0 = 0; k0 < cw; k0 += 16) {
      uint32_t af[4];
      tc::ldsm_x4<false>(af, a + a_off + k0);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bf[4];
        tc::ldsm_x4<false>(bf, b + b_off + 16 * jp * ld + k0);
        float part[2][4];
        tc::mma_bf16_zero(part[0], af, bf[0], bf[1]);
        tc::mma_bf16_zero(part[1], af, bf[2], bf[3]);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            add_kahan(S[2 * jp + u][i], C[2 * jp + u][i], part[u][i]);
      }
    }
  } else {
    const float* a = static_cast<const float*>(A);
    const float* b = static_cast<const float*>(Bm);
    const int gq = lane >> 2, tq = lane & 3;
    for (int ks = 0; ks < cw / 8; ++ks) {
      uint32_t ap[3][4];
      {
        const float* src = a + (warp * 16 + gq) * ld + ks * 8 + tq;
        const float x[4] = {src[0], src[8 * ld], src[4], src[8 * ld + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t p[3];
          tc::split_parts<6>(x[e], p);
#pragma unroll
          for (int t = 0; t < 3; ++t) ap[t][e] = p[t];
        }
      }
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += 2) {     // B's parts 2 n-tiles at a time
        uint32_t bp[3][2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* src = b + ((j0 + j) * 8 + gq) * ld + ks * 8 + tq;
          const float x[2] = {src[0], src[4]};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            uint32_t p[3];
            tc::split_parts<6>(x[e], p);
#pragma unroll
            for (int t = 0; t < 3; ++t) bp[t][j][e] = p[t];
          }
        }
        // tc::gemm_tile's 6-term order: mid·mid, small·big, big·small,
        // mid·big, big·mid, big·big into a zeroed partial
        float part[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) tc::mma_tf32_zero(part[j], ap[1], bp[1][j]);
#pragma unroll
        for (int j = 0; j < 2; ++j) tc::mma_tf32(part[j], ap[2], bp[0][j]);
#pragma unroll
        for (int j = 0; j < 2; ++j) tc::mma_tf32(part[j], ap[0], bp[2][j]);
#pragma unroll
        for (int j = 0; j < 2; ++j) tc::mma_tf32(part[j], ap[1], bp[0][j]);
#pragma unroll
        for (int j = 0; j < 2; ++j) tc::mma_tf32(part[j], ap[0], bp[1][j]);
#pragma unroll
        for (int j = 0; j < 2; ++j) tc::mma_tf32(part[j], ap[0], bp[0][j]);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            add_kahan(S[j0 + j][i], C[j0 + j][i], part[j][i]);
      }
    }
  }
}

// attn_qk's sum: S - C, into S.
__device__ __forceinline__ void attn_sum(float (&S)[8][4],
                                         const float (&C)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) S[j][i] -= C[j][i];
}

// A f32 fragment functor of a product's own C fragments C[8][4] (64
// positions) as the next product's A, for attn_mm: k8-step s takes n-tile
// s, whose columns 2t and 2t + 1 attn_mm pairs with B's rows 2t and 2t + 1.
struct RegsA {
  const float (&c)[8][4];
  __device__ __forceinline__ void operator()(int s, float (&a)[4]) const {
    a[0] = c[s][0];
    a[1] = c[s][2];
    a[2] = c[s][1];
    a[3] = c[s][3];
  }
  // the bf16 A fragment of k16-step ks of 32-position half h: two n-tiles'
  // C fragments rounded and packed in pairs, as they lie
  __device__ __forceinline__ void operator()(int h, int ks,
                                             uint32_t (&a)[4]) const {
    const int s = 4 * h + 2 * ks;
    a[0] = tc::pack_bf16(c[s][0], c[s][1]);
    a[1] = tc::pack_bf16(c[s][2], c[s][3]);
    a[2] = tc::pack_bf16(c[s + 1][0], c[s + 1][1]);
    a[3] = tc::pack_bf16(c[s + 1][2], c[s + 1][3]);
  }
};

// A fragment functor of a transposed tile T [64 positions k][64 rows m] in
// shared memory (row stride attn_ldp): A = Tᵀ, the warp's 16 rows from
// 16·warp; f32 rows 2t and 2t + 1 of a k8-step (attn_mm's pairing), bf16
// by ldmatrix.trans.
template <bool kBf>
struct TransA {
  const void* t;
  __device__ __forceinline__ void operator()(int s, float (&a)[4]) const {
    const int lane = threadIdx.x & 31;
    const float* src = static_cast<const float*>(t) +
                       (8 * s + 2 * (lane & 3)) * attn_ldp(false) +
                       (threadIdx.x >> 5) * 16 + (lane >> 2);
    a[0] = src[0];
    a[1] = src[8];
    a[2] = src[attn_ldp(false)];
    a[3] = src[attn_ldp(false) + 8];
  }
  __device__ __forceinline__ void operator()(int h, int ks,
                                             uint32_t (&a)[4]) const {
    const int lane = threadIdx.x & 31;
    const int q = lane >> 3, r8 = lane & 7;
    // as encoder_bwd.cu wg_tile_bf16's Xᵀ
    tc::ldsm_x4<true>(a, static_cast<const uint16_t*>(t) +
                             (32 * h + 16 * ks + (q >> 1) * 8 + r8) *
                                 attn_ldp(true) +
                             (threadIdx.x >> 5) * 16 + (q & 1) * 8);
  }
};

// O[n] += A·B for one chunk of 64 positions k, A from the functor (16 rows a
// warp) and B [64 positions][columns] staged (row stride ld), over the
// first cw columns (n-tiles of 8, kAttnNt at most), in batches of 4
// n-tiles.  f32: 3xTF32 (small·big, big·small, big·big), each k8-step's
// three MMAs from a zeroed partial added to O in f32; A's logical columns
// t and t + 4 of a k8-step pair with B's rows 2t and 2t + 1 (the C layout
// of a product, whose thread t holds columns 2t and 2t + 1).  bf16: B by
// ldmatrix.trans, each k16-step's m16n8k16 from a zeroed partial added in
// f32.
template <bool kBf, class AF>
__device__ __forceinline__ void attn_mm(const AF& afrag, const void* Bm,
                                        int ld, int cw,
                                        float (&O)[kAttnNt][4]) {
  const int lane = threadIdx.x & 31;
  if constexpr (kBf) {
    const uint16_t* b = static_cast<const uint16_t*>(Bm);
    uint32_t a[2][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) afrag(h, ks, a[h][ks]);
    const int q = lane >> 3, r8 = lane & 7;
    // as tc::gemm_tile_bf16's W [k, m]
    const int b_off = ((q & 1) * 8 + r8) * ld + (q >> 1) * 8;
#pragma unroll
    for (int nb = 0; nb < kAttnNt; nb += 4) {
      if (8 * nb >= cw) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t bf[4];
            tc::ldsm_x4<true>(bf, b + b_off + (32 * h + 16 * ks) * ld +
                                      8 * (nb + 2 * jp));
            float part[2][4];
            tc::mma_bf16_zero(part[0], a[h][ks], bf[0], bf[1]);
            tc::mma_bf16_zero(part[1], a[h][ks], bf[2], bf[3]);
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int i = 0; i < 4; ++i) O[nb + 2 * jp + u][i] += part[u][i];
          }
        }
      }
    }
  } else {
    const float* b = static_cast<const float*>(Bm);
    const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int nb = 0; nb < kAttnNt; nb += 4) {
      if (8 * nb >= cw) break;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        uint32_t ab[4], as[4];
        {
          float x[4];
          afrag(s, x);
#pragma unroll
          for (int e = 0; e < 4; ++e) tc::split_tf32(x[e], ab[e], as[e]);
        }
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* src = b + (8 * s + 2 * tq) * ld + 8 * (nb + j) + gq;
          tc::split_tf32(src[0], bb[j][0], bs[j][0]);
          tc::split_tf32(src[ld], bb[j][1], bs[j][1]);
        }
        float part[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) tc::mma_tf32_zero(part[j], as, bb[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) tc::mma_tf32(part[j], ab, bs[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) tc::mma_tf32(part[j], ab, bb[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) O[nb + j][i] += part[j][i];
      }
    }
  }
}

struct Layer {
  const float *w_qkv, *b_qkv, *w_out, *b_out, *w_ff1, *b_ff1, *w_ff2, *b_ff2;
  const float *ln1_s, *ln1_b, *ln2_s, *ln2_b;
};

// The bf16 instantiations' copy of a call's weight products (tc.cuh
// gemm_tile_bf16 stages it by cp.async): w_qkv, w_out, w_ff1, w_ff2, each
// stacked over the layers as its f32 argument, one after the other,
// rounded to bf16 to nearest (round_bf16's rounding).  6·n_layers·d²
// elements; each layer's matrix starts on 16 bytes (d % 8 == 0).  Each
// bf16 call of either kernel makes its own copy first, one launch, into a
// buffer its wrapper allocates.
__host__ __device__ inline size_t weights_bf16_elems(int d, int n_layers) {
  return (size_t)6 * n_layers * d * d;
}

struct Weights16 {
  const uint16_t *w_qkv, *w_out, *w_ff1, *w_ff2;
};

__host__ __device__ inline Weights16 weights16(const uint16_t* base, int d,
                                               int n_layers) {
  const size_t dd = (size_t)n_layers * d * d;
  return {base, base + 3 * dd, base + 4 * dd, base + 5 * dd};
}

// The copy, four f32 elements a thread a step (a kernel of each file calls
// it: encoder.cu encoder_fwd_weights_bf16_kernel, encoder_bwd.cu
// encoder_bwd_weights_bf16_kernel).
__device__ __forceinline__ void round_weights_bf16(const Layer& l0, int d,
                                                   int n_layers,
                                                   uint16_t* out) {
  const size_t dd = (size_t)n_layers * d * d;
  const size_t n4 = weights_bf16_elems(d, n_layers) / 4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = 4 * i;
    const float* src = e < 3 * dd   ? l0.w_qkv + e
                       : e < 4 * dd ? l0.w_out + (e - 3 * dd)
                       : e < 5 * dd ? l0.w_ff1 + (e - 4 * dd)
                                    : l0.w_ff2 + (e - 5 * dd);
    const float4 x = *reinterpret_cast<const float4*>(src);
    *reinterpret_cast<uint2*>(out + e) =
        make_uint2(tc::pack_bf16(x.x, x.y), tc::pack_bf16(x.z, x.w));
  }
}

// Blocks of the copy's launch (kThreads each).
__host__ inline int weights_bf16_blocks(int d, int n_layers) {
  const size_t n4 = weights_bf16_elems(d, n_layers) / 4;
  const size_t b = (n4 + kThreads - 1) / kThreads;
  return static_cast<int>(b < 2048 ? b : 2048);
}

// Past this width the towers' products with a weight run wgmma.cuh's tile
// (wg::tile, wgmma from a TMA ring; no block holds a whole row, so the
// forward's LayerNorm runs in a kernel of its own); up to it tc.cuh's
// 64-row gemm_tile and gemm_tile_bf16, whose forward epilogue holds whole
// rows for the LayerNorm.
constexpr int kWideD = 256;

// Where a call's f32 weights' TF32 parts lie for wg::tile past kWideD, in
// floats (each part of a matrix K-major, [P][m][k], the parts one after
// the other): the forward's Wᵀ, QKV in three parts (its 6-term split) and
// the others in two (3xTF32); the backward's W as it lies (dX = dY·Wᵀ), in
// two.  Layer li at li·per_layer.
struct PartsLayout {
  size_t qkv, out, ff1, ff2, per_layer;
};

__host__ __device__ inline PartsLayout parts_layout(int d, bool bwd) {
  const size_t dd = (size_t)d * d;
  return bwd ? PartsLayout{0, 6 * dd, 8 * dd, 10 * dd, 12 * dd}
             : PartsLayout{0, 9 * dd, 11 * dd, 13 * dd, 15 * dd};
}

// Bytes of the weights' copy a call of the forward (bwd false) or the
// backward makes first, into a buffer its wrapper allocates: the bf16
// copy (weights_bf16_elems), f32 past kWideD the parts, else none.
__host__ __device__ inline size_t weights_copy_bytes(int d, int n_layers,
                                                     bool bf16, bool bwd) {
  if (bf16) return 2 * weights_bf16_elems(d, n_layers);
  return d > kWideD ? 4 * n_layers * parts_layout(d, bwd).per_layer : 0;
}

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
// terms it has.  The whole-sequence attention kernels accumulate q·k and
// do·v over the head's columns so: a partly sharp softmax passes a
// logit's absolute error on to the gradient of its row (encoder.cu), and
// a plain f32 chain over 256 or 512 products errs by several ulps of
// |q||k|.
__device__ __forceinline__ void add_compensated(float& s, float& c, float x) {
  const float t = s + x;
  const float bp = t - s;
  c += (s - (t - bp)) + (x - bp);
  s = t;
}

// y = LN(z) of one row of d columns walked by a warp, lane taking columns
// lane + 32·t in order: statistics in f32 (the mean, then the mean square
// about it), eps kLnEps.  Writes y, the normalised values to xhat and
// 1/std to *rstd, each where not null.  Any width: z is read once a pass
// (three passes, the second and third from L1 or L2).  z may be y or xhat:
// a lane reads a column before it writes it.
__device__ __forceinline__ void ln_row(const float* z, int d,
                                       const float* __restrict__ g,
                                       const float* __restrict__ b, float* y,
                                       float* xhat, float* rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += z[c];
  const float mean = warp_sum(s) / d;
  float q = 0.f;
  for (int c = lane; c < d; c += 32) q += (z[c] - mean) * (z[c] - mean);
  const float rs = rsqrtf(warp_sum(q) / d + kLnEps);
  for (int c = lane; c < d; c += 32) {
    const float xh = (z[c] - mean) * rs;
    if (y) y[c] = xh * g[c] + b[c];
    if (xhat) xhat[c] = xh;
  }
  if (rstd && lane == 0) *rstd = rs;
}

}  // namespace tower
