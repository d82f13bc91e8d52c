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
constexpr int kCh = 64;        // head columns an attention chunk holds
constexpr int kLdc = kCh + 4;  // chunk row stride: a quarter warp's float4
                               // loads of 8 rows fall in distinct banks
constexpr int kTile = 64;      // rows (queries or keys) an attention block
                               // holds, and positions a chunk of the other
                               // side holds: a lane takes two of them
constexpr int kLdp = kTile + 4;  // row stride of a probability tile

// Sequences a block of the attention kernels holds at length L: the most,
// a power of two up to 8, whose rows fit in kTile; a warp serves one of
// them, so 8 / S warps share a sequence.  Past L 32 one sequence, and past
// L 64 a block takes kTile of its rows.
__host__ __device__ constexpr int attn_seqs(int L) {
  return L <= 8 ? 8 : L <= 16 ? 4 : L <= 32 ? 2 : 1;
}

// The longest L at which the whole-sequence attention kernels run (a lane
// two keys of a sequence, its probabilities in shared memory); past it the
// chunked kernels.  At FK's L 15 the whole-sequence kernels are the faster
// (PERF.md §6: K2 0.8415 against 0.9628 ms a step on an H100).
constexpr int kSeqL = 64;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Blocks of a chunked attention kernel over B sequences of length L: groups of
// attn_seqs(L) sequences, each group cut into tiles of kTile rows (one tile
// up to L 64).  A kernel's grid is (attn_blocks, heads).
__host__ __device__ constexpr int attn_tiles(int L) {
  return (L + kTile - 1) / kTile;
}
inline int attn_blocks(int B, int L) {
  return (B + attn_seqs(L) - 1) / attn_seqs(L) * attn_tiles(L);
}

// Where an attention block and a thread of it work: the block holds rows
// r0 .. r0 + nr - 1 of sequences seq0 .. seq0 + ns - 1 (those in range, S
// at most), row r of sequence s at tile row s·Lt + r - r0; warp w serves
// sequence s = w / wps and its tile rows w % wps + wps·t (t < 8, while
// below nr).  The other side (keys of a query tile, queries of a key tile)
// passes in chunks of Lt positions, a lane the chunk's positions lane and
// lane + 32.
struct AttnTile {
  int S, Lt, wps, seq0, ns, r0, nr, s, b;
  bool active;         // this warp's sequence is in range
};

__device__ __forceinline__ AttnTile attn_tile(int B, int L) {
  AttnTile a;
  a.S = attn_seqs(L);
  a.Lt = L < kTile ? L : kTile;
  const int T = attn_tiles(L);
  a.r0 = (blockIdx.x % T) * kTile;
  a.nr = min(a.Lt, L - a.r0);
  a.seq0 = (blockIdx.x / T) * a.S;
  a.ns = min(a.S, B - a.seq0);
  a.wps = 8 / a.S;
  const int warp = threadIdx.x >> 5;
  a.s = warp / a.wps;
  a.b = a.seq0 + a.s;
  a.active = a.s < a.ns;
  return a;
}

// Rows start .. start + n - 1 of each of the tile's ns sequences, columns
// [col, col + 4·cw4) of src [B·L, ld], into dst [s·Lt + r][kLdc] (kBf:
// rounded to bf16), by the whole block.
template <bool kBf>
__device__ __forceinline__ void attn_stage(float* dst, const float* src,
                                           int ld, int col, int cw4,
                                           const AttnTile& a, int L,
                                           int start, int n) {
  for (int v = threadIdx.x; v < a.ns * n * cw4; v += kThreads) {
    const int c = (v % cw4) * 4;
    const int r = (v / cw4) % n;
    const int s = v / (cw4 * n);
    float4 x = *reinterpret_cast<const float4*>(
        src + ((size_t)(a.seq0 + s) * L + start + r) * ld + col + c);
    if constexpr (kBf)
      x = make_float4(tc::bf16f(x.x), tc::bf16f(x.y), tc::bf16f(x.z),
                      tc::bf16f(x.w));
    *reinterpret_cast<float4*>(dst + (s * a.Lt + r) * kLdc + c) = x;
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
