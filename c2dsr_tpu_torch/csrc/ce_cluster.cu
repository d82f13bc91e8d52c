// K5, the fused CE's backward, past d 256: one thread-block cluster over d.
//
// Replaces, with ce.cu's kernels at the other widths, the split backward
// of the fused CE Pallas kernels (c2dsr_tpu/ops/fused_ce.py:
// _bwd_dh_kernel, dh = dlogits·Wᵀ, and _bwd_dw_kernel, dW = hᵀ·dlogits
// and db), which the TPU takes once dh outgrows VMEM.  Like them it keeps
// every logit and dlogit out of device memory.
//
// What bounds it on an H100: operations.  Each of its two kernels does
// 4·N·V·d f32-accurate FLOPs (the logits once, then one product), at most
// 165 TFLOP/s on the tensor cores in 3xTF32 (tc.cuh), or at the bf16 rate
// (989 TFLOP/s) in the bf16 instantiation.  ce.cu's resident kernels hold
// a warp's output row in registers and its X rows in shared memory, which
// stops at 512 columns, and its wide kernels recompute the logits for each
// 256 output columns ((2c + 2)·N·V·d FLOPs for c parts) from tiles that
// stream every k-column from L2.
//
// The design: a cluster of c = ceil(d / 256) blocks (at most 8, the
// portable cluster size: d <= 2,048) takes one X tile of 64 rows and the Y
// tiles of one split (dh: X = h, Y = Wᵀ; dW: X = Wᵀ, Y = h, as ce.cu), and
// block r of the cluster owns slice r of d, w columns wide (w a multiple of
// 8 with c·w >= d, the last slice the rest: d 264 is 136 + 128), and rows
// [64·r / c, 64·(r + 1) / c) of the tile in the exchange.  The block keeps
// its slice of the X tile resident in shared memory and streams only its
// slice of each Y tile through a cp.async ring.  For each Y tile of 32
// entities:
// 1. it computes the partial logits S_r = X_r·Y_rᵀ over its slice, each
//    32-column step (bf16: 16-column) a partial added in f32 (ce_fwd.cuh
//    logit_tile: the tensor cores' accumulator truncates), into its
//    exchange tile in shared memory; a cluster barrier;
// 2. for the rows it owns, it reads every block's partial through
//    distributed shared memory and adds them in rank order 0..c-1 (the bf16
//    instantiation with Kahan's compensation, as it adds its partials),
//    forms their dlogits (ce_bwd.cuh dlogits' arithmetic, a lane an entity;
//    the dW pass's db summed here, a row's 32 entities by a fixed shuffle
//    tree) and writes them to its own shared memory; a cluster barrier;
// 3. each warp reads the dlogits of its rows from their owners and adds
//    dlogits·Y_r into its outputs in registers, from the Y slice staged.
// A reduce-scatter then an all-gather: a block reads 3 tiles of 64 x 32
// values from the cluster a tile (its owned rows' partials, and each half
// of its warps all the dlogits), where every warp reading every block's
// partial reads 2·c of them; on an H100 the distributed reads, not the
// barriers, set the pace past two blocks (tests/ce_cluster_variants.py
// times both ways, PERF.md §6).  The exchange tile and the
// dlogits are each written once a tile and read between the two barriers
// that follow, so one buffer of each suffices.  With c == 2 a second
// barrier costs more than it saves (the same script): there every warp
// reads both blocks' partials of its rows, adds them (block 0's first) and
// forms their dlogits itself, and the partials alternate between the two
// exchange tiles, so that one barrier separates tiles (a block writes tile
// t's partials after the barrier of tile t - 1, which every block passes
// only after reading tile t - 2's).
// The logits cost 2·N·V·d FLOPs across the cluster, not once per output
// part, and a block reads 64 + 32 rows of w columns a tile where the wide
// kernel reads them for every 32 columns of each part.
//
// A block is 8 warps: warp (m, half) computes the partial logits of rows
// 16·m.. (m < 4) and entities 16·half.., and the product for the same rows
// and output columns [half·WS/2, (half + 1)·WS/2) of the slice, WS the
// compile-time slice width (160, 192, 224 or 256; the columns past w are
// zero in shared memory).  f32: 3xTF32 MMAs (m16n8k8),
// X split as it is read, Y split once by the pre-pass (big and small
// parts): 216 KB of shared memory at WS 256, one block an SM.  bf16
// (compute_dtype="bfloat16" or a bf16 classifier): h and Wᵀ rounded to
// bf16 by the pre-pass, 87 KB of shared memory and two blocks an SM (at
// most 128 registers a thread; faster than one block despite the spills,
// tests/ce_cluster_variants.py), mma.sync.m16n8k16 bf16 with f32
// accumulators, the
// operands read by ldmatrix (the second product's Y transposed on the
// load), the dlogits rounded to bf16 and exchanged in packed pairs, which
// are the A fragment of the product as they lie (two adjacent n-tiles of
// the logits' C layout), with no permutation; each tile's products summed
// in a zeroed accumulator and added to the output in f32, as ce.cu's bf16
// instantiations do.
//
// Plans (ops/fused_ce_cuda.cluster_plan): the grid is (X tiles · c,
// splits), clusters (c, 1, 1); the splits keep the chain caps of every K5
// plan (MAX_CHAIN vocab columns for dh, MAX_ROW_CHAIN rows for dW), and
// the ordered merge (ce_bwd.cuh bwd_passes, which also runs the pre-pass)
// adds their partials.  No atomics: each output element is
// written once, and two launches give bitwise-equal results.  An entry
// refuses a plan it cannot launch, and a refused launch returns its error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ce_bwd.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCThreads = 256;   // 8 warps: 4 m-tiles x 2 column halves
constexpr int kCBx = 64;         // X rows a cluster
constexpr int kCBy = 32;         // Y entities a tile
constexpr int kCMaxRanks = 8;    // the portable cluster size
constexpr int kXld = kCBy + 8;   // exchange row stride in floats: the
                                 // 8-byte accesses of a half-warp fall on
                                 // 32 distinct banks
constexpr int kPld = kCBy / 2 + 4;   // a bf16 dlogit row, in words of
                                     // two: the fragment loads of a warp
                                     // fall on 32 distinct banks
constexpr int kOwnRows = 4;      // exchange rows a warp owns at most
                                 // (ceil(64 / c / 8), c >= 2)

// The layout of a block's shared memory at slice width WS: its X slice
// (resident), two ring stages of its Y slice (big and small parts in f32,
// the bf16 rows in bf16) with 4·kCBy floats of per-entity values each,
// then two exchange tiles of kCBx x kXld floats: the partial logits, and
// the dlogits of the rows the block owns (bf16: kPld words of two a row)
// or, where c == 2, the next tile's partials.
template <int WS, bool kBf>
struct Cluster {
  using T = typename std::conditional<kBf, uint16_t, float>::type;
  static constexpr int ld = kBf ? WS + 8 : WS + 4;   // elements a row
  static constexpr int kYParts = kBf ? 1 : 2;
  static constexpr int kXBytes = static_cast<int>(sizeof(T)) * kCBx * ld;
  static constexpr int kStageBytes =
      static_cast<int>(sizeof(T)) * kYParts * kCBy * ld + 16 * kCBy;
  static constexpr int kExBytes = 2 * 4 * kCBx * kXld;
  static constexpr int kSmem = kXBytes + 2 * kStageBytes + kExBytes;
  static_assert(WS % 32 == 0, "whole 32-column logit partials");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

// The compile-time slice width that computes a slice of w columns.
constexpr int slice_width(int w) {
  return w <= 160 ? 160 : w <= 192 ? 192 : w <= 224 ? 224 : 256;
}

// Rows [e0, e0 + kN) x columns [col0, col0 + w) of src [n_src, d] into dst
// (row stride ld, WS columns), zero past n_src and past w, by 16-byte
// cp.async over the block (w and col0 multiples of 8).
template <int kN, int WS, int ld, typename T>
__device__ __forceinline__ void stage_slice(T* dst, const T* src, int e0,
                                            int n_src, int d, int col0,
                                            int w) {
  constexpr int kE = 16 / static_cast<int>(sizeof(T));   // elements a piece
  constexpr int kP = WS / kE;                            // pieces a row
  for (int v = threadIdx.x; v < kN * kP; v += kCThreads) {
    const int e = v / kP, c = (v % kP) * kE;
    const bool ok = e0 + e < n_src && c < w;
    cp_async16(reinterpret_cast<float*>(dst + e * ld + c),
               reinterpret_cast<const float*>(
                   ok ? src + (size_t)(e0 + e) * d + col0 + c : src),
               ok);
  }
}

// ------------------------------------------------- bf16 tensor cores ----

// The bf16 partial logits of X rows 16·m .. 16·m + 15 and Y entities
// 16·half .. + 15 over the slice's WS columns (s [1][2][4], the C layout of
// two n-tiles): each k16 step's products summed in a zeroed accumulator,
// the partials added with Kahan's compensation (logit_tile's bf16 scheme,
// ce_fwd.cuh, which takes 32 columns a partial).  Partials of 32 columns,
// two k16 MMAs chained in the truncating accumulator, left db further from
// float64 than the plain bf16 CE's on 71 of 200 seeds at d 512, and 16 on
// 49 (tests/ce_bf16_seeds.py, an H100, PERF.md §6): the logits' error
// reaches db through every dlogit, in f32.
template <int WS>
__device__ __forceinline__ void slice_logits_bf16(float (&s)[1][2][4],
                                                  const uint16_t* xs,
                                                  const uint16_t* yb, int m,
                                                  int half, int lane) {
  constexpr int ld = Cluster<WS, true>::ld;
  // A: matrix q = lane / 8 is rows 8·(q & 1).., columns 8·(q >> 1)..; B:
  // entities 8·(q >> 1).., columns 8·(q & 1)..
  const uint16_t* xl = xs + (16 * m + (lane & 15)) * ld + 8 * (lane >> 4);
  const uint16_t* yl =
      yb + (16 * half + 8 * (lane >> 4) + (lane & 7)) * ld +
      8 * ((lane >> 3) & 1);
  float c[2][4];
#pragma unroll
  for (int k0 = 0; k0 < WS; k0 += 16) {
    float p[2][4];
    {
      uint32_t a[4], b[4];
      ldsm_x4<false>(a, xl + k0);
      ldsm_x4<false>(b, yl + k0);
      mma_bf16_zero(p[0], a, b[0], b[1]);
      mma_bf16_zero(p[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k0 == 0) {
          s[0][j][i] = p[j][i];
          c[j][i] = 0.f;
        } else {
          const float y = p[j][i] - c[j][i];
          const float u = s[0][j][i] + y;
          c[j][i] = (u - s[0][j][i]) - y;
          s[0][j][i] = u;
        }
      }
  }
}

// o += P·Y[:, col .. col + 8·kNo): P the bf16 dlogits of the warp's 16 rows
// and the tile's 32 entities, a[J] the A fragment of k16 step J (the C
// fragments of logit n-tiles 2J and 2J + 1, rounded and packed in pairs:
// no permutation), Y the bf16 tile rows (row stride ld), read transposed
// by ldmatrix; the tile's products in a zeroed accumulator, added to o in
// f32.
template <int WS, int kNo>
__device__ __forceinline__ void slice_product_bf16(float (&o)[1][kNo][4],
                                                   const uint32_t (&a)[2][4],
                                                   const uint16_t* yb,
                                                   int col, int lane) {
  constexpr int ld = Cluster<WS, true>::ld;
  static_assert(kNo % 2 == 0, "pairs of n-tiles");
  // matrix q = lane / 8: entities 8·(q & 1).., columns 8·(q >> 1)..
  const uint16_t* yl =
      yb + (8 * ((lane >> 3) & 1) + (lane & 7)) * ld + col + 8 * (lane >> 4);
#pragma unroll
  for (int n0 = 0; n0 < kNo; n0 += 2) {
    float p[2][4];
#pragma unroll
    for (int J = 0; J < 2; ++J) {
      uint32_t b[4];
      ldsm_x4<true>(b, yl + 16 * J * ld + 8 * n0);
      if (J == 0) {
        mma_bf16_zero(p[0], a[J], b[0], b[1]);
        mma_bf16_zero(p[1], a[J], b[2], b[3]);
      } else {
        mma_bf16(p[0], a[J], b[0], b[1]);
        mma_bf16(p[1], a[J], b[2], b[3]);
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[0][n0 + q][i] += p[q][i];
  }
}

// ------------------------------------------------------------ kernel ----

// The block of the cluster that owns X row `row` of the tile in the
// exchange: block r owns rows [row_begin(r), row_begin(r + 1)).
__device__ __forceinline__ int row_begin(int r, int c) {
  return (kCBx * r) / c;
}
__device__ __forceinline__ int row_owner(int row, int c) {
  return (row * c + c - 1) / kCBx;
}

// One backward pass (the dh kernel for kRowsX, else the dW/db kernel) of
// the cluster design: block rank r of cluster blockIdx.x / c takes slice r
// (columns [r·w, min((r + 1)·w, d))) of X tile blockIdx.x / c and of the Y
// tiles of split blockIdx.y, and owns rows [row_begin(r), row_begin(r +
// 1)) of the tile in the exchange.  kGather: the exchange of c == 2 (every
// warp reads every block's partials), else the scatter; an instantiation
// each, so that neither carries the other's code and registers.
template <int WS, bool kRowsX, bool kBf, bool kGather>
__global__ void __launch_bounds__(kCThreads, kBf ? 2 : 1)
ce_bwd_cluster_kernel(const BwdArgs a, const int c, const int w) {
  using C = Cluster<WS, kBf>;
  using T = typename C::T;
  constexpr int ld = C::ld;
  constexpr int kNo = WS / 16;          // output n-tiles a warp: half the
                                        // slice's columns
  extern __shared__ float4 smem4[];
  T* xs = reinterpret_cast<T*>(smem4);
  char* ring = reinterpret_cast<char*>(smem4) + C::kXBytes;
  float* ex = reinterpret_cast<float*>(ring + 2 * C::kStageBytes);
  float* pbuf = ex + kCBx * kXld;       // the owned rows' dlogits (bf16:
                                        // packed pairs, kPld words a row),
                                        // or the gather's second exchange
                                        // tile
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m = warp & 3;               // the warp's m-tile
  const int half = warp >> 2;           // its entities' and columns' half
  const int x0 = (blockIdx.x / c) * kCBx;
  const int col0 = rank * w;
  const int w_r = min(w, a.d - col0);   // this block's slice width
  const int y_tiles = (a.n_y + kCBy - 1) / kCBy;
  const int per = (y_tiles + gridDim.y - 1) / gridDim.y;
  const int t_begin = min(y_tiles, (int)blockIdx.y * per);
  const int n_tiles = min(y_tiles, t_begin + per) - t_begin;

  // the owned rows this warp turns into dlogits, a lane an entity: row
  // own0 + warp + 8·i, and their values (dh: lse, in log2 units in f32,
  // dlse, dt, target; dW: the vocab entry's bias in rl)
  const int own0 = row_begin(rank, c);
  const int own1 = row_begin(rank + 1, c);
  float rl[kOwnRows], rg[kOwnRows], rt[kOwnRows];
  int rtg[kOwnRows];
  float dbr[kOwnRows];                  // dW: db of each owned row
#pragma unroll
  for (int i = 0; i < kOwnRows; ++i) {
    const int x = x0 + own0 + warp + 8 * i;
    const bool ok = own0 + warp + 8 * i < own1 && x < a.n_x;
    rl[i] = rg[i] = rt[i] = dbr[i] = 0.f;
    rtg[i] = -1;
    if (ok) {
      if (kRowsX) {
        rl[i] = kBf ? a.lse[x] : a.lse[x] * kLog2e;
        rg[i] = a.dlse[x];
        rt[i] = a.dt[x];
        rtg[i] = a.tgt[x];
      } else {
        rl[i] = a.b[x];
      }
    }
  }

  const T* xsrc;
  const T* ybig;
  if constexpr (kBf) {
    xsrc = a.xh;
    ybig = a.yh;
  } else {
    xsrc = a.x;
    ybig = a.y_big;
  }
  auto stage = [&](int slot, int tile) {
    T* st = reinterpret_cast<T*>(ring + slot * C::kStageBytes);
    const int y0 = tile * kCBy;
    stage_slice<kCBy, WS, ld>(st, ybig, y0, a.n_y, a.d, col0, w_r);
    if constexpr (!kBf)
      stage_slice<kCBy, WS, ld>(st + kCBy * ld, a.y_small, y0, a.n_y, a.d,
                                col0, w_r);
    stage_info<kCBy, kRowsX, kCThreads>(
        reinterpret_cast<float*>(st + C::kYParts * kCBy * ld), a, y0);
  };
  stage_slice<kCBx, WS, ld>(xs, xsrc, x0, a.n_x, a.d, col0, w_r);
  if (n_tiles > 0) stage(0, t_begin);
  cp_async_commit();

  float o[1][kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[0][n][i] = 0.f;
  // the gather's values of the warp's fragment rows xa, xa + 8
  const int xa = x0 + 16 * m + g;
  float xl[1][2], xg[1][2], xt[1][2], xb[1][2];
  int xtg[1][2];
  bool xok[1][2];
  x_values<1, kRowsX, kBf>(a, xa, xl, xg, xt, xb, xtg, xok);
  float dbs[2] = {};                    // the gather's db of rows xa, xa + 8

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) stage((it + 1) & 1, t_begin + it + 1);
    cp_async_commit();
    const T* yb =
        reinterpret_cast<const T*>(ring + (it & 1) * C::kStageBytes);
    const T* ys = yb + kCBy * ld;
    const float* inf =
        reinterpret_cast<const float*>(yb + C::kYParts * kCBy * ld);
    const int y0 = (t_begin + it) * kCBy;
    // the gather alternates two exchange tiles; the scatter takes the
    // first for the partials and the second for the owned dlogits
    float* ex_it = kGather && (it & 1) ? pbuf : ex;

    // 1. this slice's partial logits of the warp's rows and entities, into
    // the block's exchange tile
    {
      float sp[1][2][4];
      if constexpr (kBf)
        slice_logits_bf16<WS>(sp, xs, yb, m, half, lane);
      else
        logit_tile<WS, 1, 2>(sp, xs + (16 * m + g) * ld + t,
                             yb + 16 * half * ld, ys + 16 * half * ld, g, t);
      float* e = ex_it + (16 * m + g) * kXld + 16 * half + 2 * t;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        *reinterpret_cast<float2*>(e + 8 * j) =
            make_float2(sp[0][j][0], sp[0][j][1]);
        *reinterpret_cast<float2*>(e + 8 * kXld + 8 * j) =
            make_float2(sp[0][j][2], sp[0][j][3]);
      }
    }
    cluster.sync();

    // the dlogits of the warp's 16 rows and the tile's 32 entities: f32 in
    // s (the logits' C layout), bf16 rounded and packed in ap
    float s[1][4][4];
    uint32_t ap[2][4];
    if constexpr (kGather) {
      // 2g. the gather: every warp reads every block's partials of its
      // rows and adds them in rank order, and forms their dlogits
      // (ce_bwd.cuh dlogits); the next tile's partials go to the other
      // exchange tile, so one barrier separates tiles
      float comp[4][4];                 // kBf: the sum's lost low part
#pragma unroll
      for (int r = 0; r < kCMaxRanks; ++r) {
        if (r >= c) break;
        const float* e = cluster.map_shared_rank(ex_it, r) +
                         (16 * m + g) * kXld + 2 * t;
        float2 u[4], v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          u[j] = *reinterpret_cast<const float2*>(e + 8 * j);
          v[j] = *reinterpret_cast<const float2*>(e + 8 * kXld + 8 * j);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p[4] = {u[j].x, u[j].y, v[j].x, v[j].y};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (r == 0) {
              s[0][j][i] = p[i];
              comp[j][i] = 0.f;
            } else if constexpr (kBf) {
              const float y = p[i] - comp[j][i];
              const float sum = s[0][j][i] + y;
              comp[j][i] = (sum - s[0][j][i]) - y;
              s[0][j][i] = sum;
            } else {
              s[0][j][i] += p[i];
            }
          }
        }
      }
      // the dW pass's db: each tile's sum of a row's 32 dlogits (the
      // thread's 8, then its quad by a fixed shuffle tree), added to the
      // row's total, as the scatter sums them; not one long chain
      float db_tile[1][2] = {};
      dlogits<1, 4, kCBy, kRowsX, kBf>(s, inf, y0, a.n_y, xa, xl, xg, xt,
                                       xb, xtg, xok, db_tile, t);
      if (!kRowsX) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v = db_tile[0][r];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          dbs[r] += v;
        }
      }
      if constexpr (kBf) {
#pragma unroll
        for (int J = 0; J < 2; ++J) {
          ap[J][0] = pack_bf16(s[0][2 * J][0], s[0][2 * J][1]);
          ap[J][1] = pack_bf16(s[0][2 * J][2], s[0][2 * J][3]);
          ap[J][2] = pack_bf16(s[0][2 * J + 1][0], s[0][2 * J + 1][1]);
          ap[J][3] = pack_bf16(s[0][2 * J + 1][2], s[0][2 * J + 1][3]);
        }
      }
    } else {
      // 2s. the scatter: the owned rows' logits, every block's partial in
      // rank order (all c loads of a row issued at once), and their
      // dlogits (dlogits' arithmetic, a lane an entity) into pbuf
      const int y = y0 + lane;
      float ye[4] = {};                 // the entity's values (dW: lse,
                                        // dlse, dt, target; dh: bias)
#pragma unroll
      for (int q = 0; q < (kRowsX ? 1 : 4); ++q) ye[q] = inf[q * kCBy + lane];
#pragma unroll
      for (int i = 0; i < kOwnRows; ++i) {
        const int row = own0 + warp + 8 * i;
        if (row >= own1) break;
        float v[kCMaxRanks];
#pragma unroll
        for (int r = 0; r < kCMaxRanks; ++r)
          v[r] = r < c ? cluster.map_shared_rank(ex, r)[row * kXld + lane]
                       : 0.f;
        float sum = v[0], comp = 0.f;
#pragma unroll
        for (int r = 1; r < kCMaxRanks; ++r) {
          if (r >= c) break;
          if constexpr (kBf) {
            const float yk = v[r] - comp;
            const float u = sum + yk;
            comp = (u - sum) - yk;
            sum = u;
          } else {
            sum += v[r];
          }
        }
        const int x = x0 + row;
        float p;
        if (kRowsX) {
          if (kBf)
            p = rg[i] * expf((sum + ye[0]) - rl[i]);
          else
            p = rg[i] * exp2_approx(fmaf(sum + ye[0], kLog2e, -rl[i]));
          if (y == rtg[i]) p += rt[i];
        } else {
          if (kBf)
            p = ye[1] * expf((sum + rl[i]) - ye[0]);
          else
            p = ye[1] * exp2_approx((sum + rl[i] - ye[0]) * kLog2e);
          if (x == __float_as_int(ye[3])) p += ye[2];
        }
        p = (x < a.n_x && y < a.n_y) ? p : 0.f;
        if (!kRowsX) {
          float row_sum = p;
#pragma unroll
          for (int o2 = 16; o2 >= 1; o2 >>= 1)
            row_sum += __shfl_xor_sync(0xffffffffu, row_sum, o2);
          dbr[i] += row_sum;
        }
        if constexpr (kBf) {
          const float q = __shfl_down_sync(0xffffffffu, p, 1);
          if (!(lane & 1))
            reinterpret_cast<uint32_t*>(pbuf)[row * kPld + (lane >> 1)] =
                pack_bf16(p, q);
        } else {
          pbuf[row * kXld + lane] = p;
        }
      }
      cluster.sync();
      // 3s. the dlogits of the warp's rows from their owners
      const int own_a = row_owner(16 * m + g, c);
      const int own_b = row_owner(16 * m + g + 8, c);
      if constexpr (kBf) {
        const uint32_t* pa = reinterpret_cast<const uint32_t*>(
            cluster.map_shared_rank(pbuf, own_a)) + (16 * m + g) * kPld + t;
        const uint32_t* pb = reinterpret_cast<const uint32_t*>(
            cluster.map_shared_rank(pbuf, own_b)) +
            (16 * m + g + 8) * kPld + t;
#pragma unroll
        for (int J = 0; J < 2; ++J) {
          ap[J][0] = pa[8 * J];
          ap[J][1] = pb[8 * J];
          ap[J][2] = pa[8 * J + 4];
          ap[J][3] = pb[8 * J + 4];
        }
      } else {
        const float* pa = cluster.map_shared_rank(pbuf, own_a) +
                          (16 * m + g) * kXld + 2 * t;
        const float* pb = cluster.map_shared_rank(pbuf, own_b) +
                          (16 * m + g + 8) * kXld + 2 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 u = *reinterpret_cast<const float2*>(pa + 8 * j);
          const float2 v = *reinterpret_cast<const float2*>(pb + 8 * j);
          s[0][j][0] = u.x;
          s[0][j][1] = u.y;
          s[0][j][2] = v.x;
          s[0][j][3] = v.y;
        }
      }
    }

    // 3. the product with this block's slice of the Y tile
    if constexpr (kBf)
      slice_product_bf16<WS, kNo>(o, ap, yb, half * (WS / 2), lane);
    else
      add_py<1, 4, kNo, ld, false>(o, s, yb, ys, half * (WS / 2), g, t);
  }
  cp_async_wait<0>();
  // no block leaves while another may still read its shared memory
  cluster.sync();
  float no_db[1][2] = {};
  bwd_write<1, kNo, kRowsX>(o, no_db, a, xa, col0 + half * (WS / 2),
                            col0 + w_r, false, t);
  // db: the gather's every block and half hold the same sums, so rank 0's
  // first half writes them; the scatter's owners their rows'
  if (!kRowsX && kGather && rank == 0 && half == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (xa + 8 * r < a.n_x)
        a.db[(size_t)blockIdx.y * a.V + xa + 8 * r] = dbs[r];
  }
  if (!kRowsX && !kGather && lane == 0) {
#pragma unroll
    for (int i = 0; i < kOwnRows; ++i) {
      const int x = x0 + own0 + warp + 8 * i;
      if (own0 + warp + 8 * i < own1 && x < a.n_x)
        a.db[(size_t)blockIdx.y * a.V + x] = dbr[i];
    }
  }
}

// ------------------------------------------------------------- host ----

// The launch of one pass: grid (X tiles · c, splits), clusters (c, 1, 1).
template <int WS, bool kRowsX, bool kBf, bool kGather>
cudaError_t launch_ws(const BwdArgs& a, int c, int w, int splits,
                      cudaStream_t s, int* active = nullptr) {
  auto kernel = ce_bwd_cluster_kernel<WS, kRowsX, kBf, kGather>;
  constexpr int kSmem = Cluster<WS, kBf>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.n_x + kCBx - 1) / kCBx) * c, splits, 1);
  cfg.blockDim = dim3(kCThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active)   // the occupancy query: how many such clusters fit at once
    return cudaOccupancyMaxActiveClusters(
        active, reinterpret_cast<const void*>(kernel), &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, a, c, w);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// The pass at the compile-time slice width of w, by the gather for two
// blocks a cluster and the scatter for more.  A scatter's slices are wider
// than 170 columns (d > 512 over at most 8 blocks): it has no WS 160.
template <bool kRowsX, bool kBf>
cudaError_t launch_pass(const BwdArgs& a, int c, int w, int splits,
                        cudaStream_t s, int* active = nullptr) {
  const bool gather = c == 2;
  switch (slice_width(w)) {
    case 160:
      return gather ? launch_ws<160, kRowsX, kBf, true>(a, c, w, splits, s,
                                                        active)
                    : cudaErrorInvalidValue;
    case 192:
      return gather
                 ? launch_ws<192, kRowsX, kBf, true>(a, c, w, splits, s,
                                                     active)
                 : launch_ws<192, kRowsX, kBf, false>(a, c, w, splits, s,
                                                      active);
    case 224:
      return gather
                 ? launch_ws<224, kRowsX, kBf, true>(a, c, w, splits, s,
                                                     active)
                 : launch_ws<224, kRowsX, kBf, false>(a, c, w, splits, s,
                                                      active);
    default:
      return gather
                 ? launch_ws<256, kRowsX, kBf, true>(a, c, w, splits, s,
                                                     active)
                 : launch_ws<256, kRowsX, kBf, false>(a, c, w, splits, s,
                                                      active);
  }
}

// Whether (c, w, splits) is a plan these kernels launch at N, d, V: 2 <= c
// <= 8 slices of w columns (a multiple of 8, at most 256) that cover d with
// a non-empty last one, d % 8 == 0, V % 4 == 0, at least one split each.
bool plan_ok(int N, int d, int V, int c, int w, int split_h, int split_w) {
  return N > 0 && V > 0 && V % 4 == 0 && d > 0 && d % 8 == 0 && c >= 2 &&
         c <= kCMaxRanks && w > 0 && w % 8 == 0 && w <= 256 &&
         (c - 1) * w < d && c * w >= d && split_h >= 1 && split_w >= 1;
}

}  // namespace

// The cluster kernels' shared memory a block at slice width w (bytes), for
// the f32 (bf16 0) or bf16 instantiation; -1 for a width they refuse.
extern "C" int ce_bwd_cluster_smem(int w, int bf16) {
  if (w <= 0 || w > 256) return -1;
  switch (slice_width(w)) {
    case 160:
      return bf16 ? Cluster<160, true>::kSmem : Cluster<160, false>::kSmem;
    case 192:
      return bf16 ? Cluster<192, true>::kSmem : Cluster<192, false>::kSmem;
    case 224:
      return bf16 ? Cluster<224, true>::kSmem : Cluster<224, false>::kSmem;
    default:
      return bf16 ? Cluster<256, true>::kSmem : Cluster<256, false>::kSmem;
  }
}

// How many clusters of c blocks at slice width w fit on the device at once
// (cudaOccupancyMaxActiveClusters) into *active; the plan's slots.  Returns
// a CUDA error code (0 = answered).
extern "C" int ce_bwd_cluster_slots(int c, int w, int bf16, int* active) {
  if (c < 2 || c > kCMaxRanks || w <= 0 || w > 256 || w % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{};
  a.n_x = kCBx;
  const cudaError_t err =
      bf16 ? launch_pass<true, true>(a, c, w, 1, nullptr, active)
           : launch_pass<true, false>(a, c, w, 1, nullptr, active);
  return static_cast<int>(err);
}

// K5 by the cluster kernels, f32 (3xTF32): ce.cu's ce_bwd_f32 with the plan
// (c slices of w columns, split_h vocab splits of the dh pass, split_w row
// splits of the dW pass) given.  workspace as ce_bwd_f32's (ce_bwd.cuh
// bwd_passes).  All pointers 16-byte aligned.  Returns a CUDA error code (0
// = launched): cudaErrorInvalidValue for a plan plan_ok refuses.
extern "C" int ce_bwd_cluster_f32(const float* h, const float* w,
                                  const float* b, const float* lse,
                                  const float* dlse, const float* dt,
                                  const int* tgt, float* dh, float* dw,
                                  float* db, float* workspace, int c,
                                  int sw, int split_h, int split_w, int N,
                                  int d, int V, void* stream) {
  if (!plan_ok(N, d, V, c, sw, split_h, split_w))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bwd_passes<false>(
      h, w, 0, b, lse, dlse, dt, tgt, dh, dw, db, workspace, split_h,
      split_w, N, d, V, s, [&](const BwdArgs& a, int splits, bool rows_x) {
        return rows_x ? launch_pass<true, false>(a, c, sw, splits, s)
                      : launch_pass<false, false>(a, c, sw, splits, s);
      }));
}

// K5's bf16 instantiation by the cluster kernels: ce.cu's ce_bwd_bf16 with
// the plan given (as ce_bwd_cluster_f32); w f32, or bf16 where w_bf16.
// workspace as ce_bwd_bf16's.  Returns a CUDA error code (0 = launched).
extern "C" int ce_bwd_cluster_bf16(const float* h, const void* w,
                                   const float* b, const float* lse,
                                   const float* dlse, const float* dt,
                                   const int* tgt, float* dh, float* dw,
                                   float* db, float* workspace, int w_bf16,
                                   int c, int sw, int split_h, int split_w,
                                   int N, int d, int V, void* stream) {
  if (!plan_ok(N, d, V, c, sw, split_h, split_w))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bwd_passes<true>(
      h, w, w_bf16, b, lse, dlse, dt, tgt, dh, dw, db, workspace, split_h,
      split_w, N, d, V, s, [&](const BwdArgs& a, int splits, bool rows_x) {
        return rows_x ? launch_pass<true, true>(a, c, sw, splits, s)
                      : launch_pass<false, true>(a, c, sw, splits, s);
      }));
}
