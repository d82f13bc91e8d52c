// K5, the fused CE's backward, at d <= 128 in f32 as one pass: each logit
// tile of h·Wᵀ + b is computed once and feeds dh, dW and db.
//
// Replaces, with ce.cu's and ce_cluster.cu's kernels at the other widths
// and in bf16, the fused CE backward Pallas kernel
// c2dsr_tpu/ops/fused_ce.py:_bwd_merged_kernel, which computes each logit
// block once and takes dh, dW and db from it (where dh fits in VMEM).
//
// What bounds it on an H100: operations, 6·N·V·d f32-accurate FLOPs (the
// logits, then dh = P·W and dW = Pᵀ·h from the same dlogits P) at most
// 165 TFLOP/s on the tensor cores in 3xTF32 (tc.cuh).  ce.cu's pair of
// kernels (a dh pass and a dW pass) each recompute the logits: 8·N·V·d.
// With mma.sync every operand fragment comes from shared memory, whose
// bandwidth, not the tensor cores, sets the pair's pace (ce.cu), so the
// design counts shared-memory bytes a multiply-add.
//
// The problem: dh sums over the vocab and dW over the rows, and neither
// fits on one SM at FK (dh 5.2 MB, dW 34.6 MB).  So a block keeps dh of its
// rows in registers over its vocab split, and dW leaves the block a tile
// at a time.  A block is ce.cu's dh pass with a dW product added:
// * It holds kORows = 256 rows of h (X) in shared memory and streams the
//   vocab in tiles of kOBy = 32 entities: Wᵀ's TF32 parts (split once by
//   the pre-pass) and the biases through ce.cu's cp.async ring.
// * Per tile, warp w computes the logits of its 32 rows and all 32
//   entities (ce_fwd.cuh logit_tile: 3xTF32 mma.sync, partials of 4
//   k-steps added in f32) and their dlogits P (ce_bwd.cuh dlogits) in
//   registers, and adds P·W_tile into dh of its 32 rows and all of d, in
//   registers, P's C layout being the A fragment with k permuted (ce_bwd.cuh
//   add_py), chained over the split's <= MAX_CHAIN columns, as the pair's
//   dh pass does.  Its column sums (db) go by a fixed shuffle tree.
// * P goes to shared memory once, transposed (Pᵀ [32][256 + 8], a float2
//   per A fragment's two k).  At DT 128 it takes the Y parts of the tile's
//   own stage, which are exactly as large and which both products have
//   read by then (a barrier first); there is no room for it elsewhere.
// * dW: warp w computes 16 entities x d/4 columns of the block's dW tile
//   Pᵀ·h from a zeroed accumulator, k over the block's 256 rows (a chain
//   within MAX_ROW_CHAIN); Pᵀ and h are split as read.
// * dW leaves the block a tile at a time: each block writes its tile
//   straight to its own row block's partial of dW and db, with no barrier
//   between blocks (FK: 40 partials a domain, 634 and 761 MB; 1M items
//   9.65 GiB).  Where those partials would pass ONEPASS_PARTIAL_BYTES (a
//   vocabulary past about 624,000 items at FK's rows), K5 runs the pair
//   (ops/fused_ce_cuda.onepass_plan).  Clusters of 2-8 blocks that summed
//   their dW tiles through distributed shared memory before writing were
//   built and measured: slower than a block a row block at FK and at 1M
//   items, and at 1M slower than the pair (PERF.md §6).
// So a block takes each logit tile once and one product's dlogits from
// registers, at the pair's warp tiles for the logits and dh (32 x 32 and
// 32 x d), where the pair takes two logit tiles: about 0.85 of the pair's
// shared-memory reads for 0.75 of its multiply-adds, with three block
// barriers a tile where the pair has one.  The MMAs are mma.sync, not
// wgmma: wgmma's TF32 operands come K-major from shared memory, and one
// pass would need h and hᵀ (for the logits and dW) and Wᵀ and a k-permuted
// W (for the logits and dh) there in their TF32 parts, 256 KB at 128 rows
// before the ring, beside dh.
//
// Partials: dh one per vocab split (split_h·N·d floats), dW and db one per
// row block ((d + 1)·V floats each), summed in split order by ce_bwd.cuh's
// merge; no atomics: every element is written once in a fixed order, and
// two launches give bitwise-equal results.  The plan (vocab splits) is made
// in Python (ops/fused_ce_cuda.onepass_plan) from the blocks the card holds
// at once (ce_bwd_onepass_slots).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ce_bwd.cuh"

namespace {

constexpr int kOThreads = 256;         // 8 warps of 32 rows
constexpr int kORows = 256;            // h rows a block
constexpr int kOBy = 32;               // vocab entities a tile
constexpr int kPTld = kORows + 8;      // a row of Pᵀ: its float2 reads of a
                                       // half-warp on 32 banks

// A block's shared memory at width DT: h's rows (resident), the ring of
// Wᵀ tiles (ce_fwd.cuh Tile's stages), Pᵀ [kOBy][kPTld] (at DT 128 in the
// Y parts of the tile's own stage, which its products have read by then;
// the stage is as large: 2 x 32 x 132 floats) and the eight warps' column
// sums.
template <int DT>
struct OnePass {
  static_assert(DT == 64 || DT == 128, "the one pass takes DT 64 and 128");
  static_assert(BwdCfg<DT>::kBy == kOBy && BwdCfg<DT>::kBx == kORows &&
                    BwdCfg<DT>::kThreads == kOThreads,
                "the pair's tiles");
  using L = Tile<DT, false>;
  static constexpr int ld = L::ld;
  static constexpr int kStages = BwdCfg<DT>::kStages;
  static constexpr int kStageBytes = L::kStageBytes;
  static constexpr int kPTBytes = 4 * kOBy * kPTld;
  static constexpr bool kPInStage = 4 * 2 * kOBy * ld >= kPTBytes;
  static constexpr int kXBytes = 4 * kORows * ld;
  static constexpr int kSmem = kXBytes + kStages * kStageBytes +
                               (kPInStage ? 0 : kPTBytes) + 4 * 8 * kOBy;
  static_assert(kSmem <= 232448, "a block's shared memory");
  static_assert(kStageBytes % 16 == 0, "alignment");
};

// One k8-step (rows 8·ks..) of dw_tile into q.  A is Pᵀ's rows e0 + g and
// e0 + g + 8, k permuted within each 8 rows (t <-> 2t, t + 4 <-> 2t + 1) so
// that a thread's two k of a row are one float2; B is h's rows read with
// the same permutation (they fall on 32 banks).  Both are split as read.
template <int DT, int kNw>
__device__ __forceinline__ void dw_step(float (&q)[kNw][4], int ks,
                                        bool first, const float* pt,
                                        const float* xs, int e0, int c0,
                                        int g, int t) {
  constexpr int ld = DT + 4;
  const float* at = pt + (e0 + g) * kPTld + 8 * ks + 2 * t;
  const float2 lo = *reinterpret_cast<const float2*>(at);
  const float2 hi = *reinterpret_cast<const float2*>(at + 8 * kPTld);
  uint32_t ab[4], as[4], bb[kNw][2], bs[kNw][2];
  split_tf32(lo.x, ab[0], as[0]);
  split_tf32(hi.x, ab[1], as[1]);
  split_tf32(lo.y, ab[2], as[2]);
  split_tf32(hi.y, ab[3], as[3]);
#pragma unroll
  for (int n = 0; n < kNw; ++n) {
    const float* xr = xs + (8 * ks + 2 * t) * ld + c0 + 8 * n + g;
    split_tf32(xr[0], bb[n][0], bs[n][0]);
    split_tf32(xr[ld], bb[n][1], bs[n][1]);
  }
#pragma unroll
  for (int n = 0; n < kNw; ++n) {
    if (first)
      mma_tf32_zero(q[n], as, bb[n]);
    else
      mma_tf32(q[n], as, bb[n]);
  }
#pragma unroll
  for (int n = 0; n < kNw; ++n) mma_tf32(q[n], ab, bs[n]);
#pragma unroll
  for (int n = 0; n < kNw; ++n) mma_tf32(q[n], ab, bb[n]);
}

// q = Pᵀ·h over the block's kORows rows: [16 entities from e0 x 8·kNw
// columns from c0], in 3xTF32 from a zeroed accumulator: a chain of 256
// rows (within MAX_ROW_CHAIN), kNw independent output tiles in flight.
template <int DT, int kNw>
__device__ __forceinline__ void dw_tile(float (&q)[kNw][4], const float* pt,
                                        const float* xs, int e0, int c0,
                                        int g, int t) {
#pragma unroll 4
  for (int ks = 0; ks < kORows / 8; ++ks)
    dw_step<DT, kNw>(q, ks, ks == 0, pt, xs, e0, c0, g, t);
}

// The one pass over row block blockIdx.x and the vocab tiles of split
// blockIdx.y: dh's partial through a.out (as ce.cu's dh pass), the row
// block's partials of dW and db into dw_part [d][V] and db_part [V] (each
// a.d·a.V and a.V floats a row block).
template <int DT>
__global__ void __launch_bounds__(kOThreads, 1)
ce_bwd_onepass_kernel(const BwdArgs a, float* __restrict__ dw_part,
                      float* __restrict__ db_part) {
  using C = OnePass<DT>;
  constexpr int ld = C::ld;
  constexpr int kStages = C::kStages;
  constexpr int kNy = kOBy / 8;        // n-tiles of S, k-steps of dh
  constexpr int kNo = DT / 8;          // dh's n-tiles a warp (all of d)
  constexpr int kNw = DT / 32;         // dW's n-tiles a warp (a quarter)
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  char* ring = reinterpret_cast<char*>(xs + kORows * ld);
  float* pt_own = reinterpret_cast<float*>(ring + kStages * C::kStageBytes);
  float* dbw = pt_own + (C::kPInStage ? 0 : kOBy * kPTld);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int x0 = blockIdx.x * kORows;
  const size_t row_block = blockIdx.x;
  const int y_tiles = (a.n_y + kOBy - 1) / kOBy;
  const int per = (y_tiles + gridDim.y - 1) / gridDim.y;
  const int t_begin = min(y_tiles, (int)blockIdx.y * per);
  const int n_tiles = min(y_tiles, t_begin + per) - t_begin;

  const int xa = x0 + 32 * warp + g;
  float xl[2][2], xg[2][2], xt[2][2], xb[2][2];
  int xtg[2][2];
  bool xok[2][2];
  x_values<2, true, false>(a, xa, xl, xg, xt, xb, xtg, xok);

  auto stage = [&](int slot, int tile) {
    float* st = reinterpret_cast<float*>(ring + slot * C::kStageBytes);
    const int y0 = tile * kOBy;
    stage_rows<DT, kOBy>(st, a.y_big, y0, a.n_y, a.d);
    stage_rows<DT, kOBy>(st + kOBy * ld, a.y_small, y0, a.n_y, a.d);
    stage_info<kOBy, true, kOThreads>(st + 2 * kOBy * ld, a, y0);
  };
  stage_rows<DT, kORows>(xs, a.x, x0, a.n_x, a.d);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) stage(s, t_begin + s);
    cp_async_commit();
  }

  float o[2][kNo][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < kNo; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[m][n][i] = 0.f;
  float no_db[2][2] = {};
  const float* xw = xs + (32 * warp + g) * ld + t;
  const int e0 = 16 * (warp & 1);            // dW: entities e0..
  const int c0 = (DT / 4) * (warp >> 1);     // and columns c0..

  for (int it = 0; it < n_tiles; ++it) {
    // the tile has landed, and every warp is past the last tile's dW,
    // which read the stage refilled next
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < n_tiles)
      stage((it + kStages - 1) % kStages, t_begin + it + kStages - 1);
    cp_async_commit();
    float* yb = reinterpret_cast<float*>(ring + (it % kStages) * C::kStageBytes);
    const float* ys = yb + kOBy * ld;
    const float* bias = yb + 2 * kOBy * ld;
    const int y0 = (t_begin + it) * kOBy;

    // the logits and dlogits of the warp's 32 rows and the tile's 32
    // entities, and the warp's column sums (db: rows g, g + 8, g + 16,
    // g + 24 of the thread, then the lanes' g by a shuffle tree)
    float s[2][kNy][4];
    logit_tile<DT, 2, kNy>(s, xw, yb, ys, g, t);
    dlogits<2, kNy, kOBy, true, false>(s, bias, y0, a.n_y, xa, xl, xg, xt,
                                       xb, xtg, xok, no_db, t);
#pragma unroll
    for (int j = 0; j < kNy; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = ((s[0][j][c] + s[0][j][2 + c]) + s[1][j][c]) +
                  s[1][j][2 + c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) dbw[warp * kOBy + 8 * j + 2 * t + c] = v;
      }

    // dh += P · W_tile from registers, as ce.cu's dh pass
    add_py<2, kNy, kNo, ld, false>(o, s, yb, ys, 0, g, t);

    // P into Pᵀ: at DT 128 over the stage's Y parts, once every warp has
    // read them
    float* pt = C::kPInStage ? yb : pt_own;
    if (C::kPInStage) __syncthreads();
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < kNy; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pt[(8 * j + 2 * t + (i & 1)) * kPTld + 32 * warp + 16 * m + g +
             8 * (i >> 1)] = s[m][j][i];
    __syncthreads();

    // this block's dW tile, and db's row, to its row block's partials
    float q[kNw][4];
    dw_tile<DT, kNw>(q, pt, xs, e0, c0, g, t);
    float dbv = 0.f;
    if (warp == 0) {
      dbv = dbw[lane];
#pragma unroll
      for (int w = 1; w < 8; ++w) dbv += dbw[w * kOBy + lane];
    }
    float* dw_rb = dw_part + row_block * a.d * a.V;
#pragma unroll
    for (int n = 0; n < kNw; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = c0 + 8 * n + 2 * t + (i & 1);
        const int v = y0 + e0 + 8 * (i >> 1) + g;
        if (kk < a.d && v < a.V) dw_rb[(size_t)kk * a.V + v] = q[n][i];
      }
    if (warp == 0 && y0 + lane < a.V)
      db_part[row_block * a.V + y0 + lane] = dbv;
  }
  cp_async_wait<0>();
  bwd_write<2, kNo, true>(o, no_db, a, xa, 0, a.d, false, t);
}

// The launch: grid (row blocks, split_h vocab splits).
template <int DT>
cudaError_t launch(const BwdArgs& a, float* dw_part, float* db_part,
                   int split_h, cudaStream_t s) {
  constexpr int kSmem = OnePass<DT>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      ce_bwd_onepass_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_x + kORows - 1) / kORows, split_h);
  ce_bwd_onepass_kernel<DT><<<grid, kOThreads, kSmem, s>>>(a, dw_part,
                                                           db_part);
  return cudaGetLastError();
}

// Blocks of the one pass an SM at width DT.
template <int DT>
cudaError_t per_sm(int* out) {
  const cudaError_t err = cudaFuncSetAttribute(
      ce_bwd_onepass_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      OnePass<DT>::kSmem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, ce_bwd_onepass_kernel<DT>, kOThreads, OnePass<DT>::kSmem);
}

}  // namespace

// How many blocks of the one pass at width d the device holds at once into
// *out: the plan's slots.  Returns a CUDA error code (0 = answered).
extern "C" int ce_bwd_onepass_slots(int d, int* out) {
  if (d <= 0 || d > 128) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = d <= 64 ? per_sm<64>(&per) : per_sm<128>(&per);
  *out = sms * per;
  return static_cast<int>(err);
}

// K5 by the one pass, f32 (3xTF32): ce.cu's ce_bwd_f32's function with the
// plan given (split_h vocab splits).  workspace: Wᵀ's TF32 parts (2·V·d
// floats), then split_h·N·d floats of dh partials where split_h > 1, then,
// where there is more than one row block (ceil(N / 256)), their d·V floats
// of dW partials each and V of db.  All pointers 16-byte aligned; d % 8 ==
// 0, d <= 128, V % 4 == 0.  Returns a CUDA error code (0 = launched):
// cudaErrorInvalidValue for a plan or shape it refuses.
extern "C" int ce_bwd_onepass_f32(const float* h, const float* w,
                                  const float* b, const float* lse,
                                  const float* dlse, const float* dt,
                                  const int* tgt, float* dh, float* dw,
                                  float* db, float* workspace, int split_h,
                                  int N, int d, int V, void* stream) {
  if (N <= 0 || d <= 0 || d % 8 || d > 128 || V <= 0 || V % 4 || split_h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t vd = (size_t)V * d, nd = (size_t)N * d;
  const int n_rb = (N + kORows - 1) / kORows;
  float* wt_big = workspace;
  float* wt_small = wt_big + vd;
  float* part_h = wt_small + vd;
  float* part_w = part_h + (split_h > 1 ? (size_t)split_h * nd : 0);
  float* part_b = part_w + (n_rb > 1 ? (size_t)n_rb * vd : 0);
  cudaError_t err = transpose_split(w, nullptr, wt_big, wt_small, d, V, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  BwdArgs a{};
  a.x = h;
  a.y_big = wt_big;
  a.y_small = wt_small;
  a.b = b;
  a.lse = lse;
  a.dlse = dlse;
  a.dt = dt;
  a.tgt = tgt;
  a.out = split_h > 1 ? part_h : dh;
  a.out_split = nd;
  a.sx = d;
  a.sk = 1;
  a.n_x = N;
  a.n_y = V;
  a.d = d;
  a.V = V;
  float* dw_out = n_rb > 1 ? part_w : dw;
  float* db_out = n_rb > 1 ? part_b : db;
  err = d <= 64 ? launch<64>(a, dw_out, db_out, split_h, s)
                : launch<128>(a, dw_out, db_out, split_h, s);
  if (err == cudaSuccess && split_h > 1) err = merge(part_h, split_h, nd, dh, s);
  if (err == cudaSuccess && n_rb > 1) err = merge(part_w, n_rb, vd, dw, s);
  if (err == cudaSuccess && n_rb > 1)
    err = merge(part_b, n_rb, (size_t)V, db, s);
  return static_cast<int>(err);
}
