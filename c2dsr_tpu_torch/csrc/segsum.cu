// Ordered segment sum (K7): the backward of a table lookup,
// out[r, :] = sum of g[i, :] over the i with ids[i] == r, in the order of i,
// every table row written once (zero where r is absent).
//
// K7 ports no Pallas kernel: the JAX package's lookup is jnp.take, whose
// gradient XLA computes as a deterministic scatter-add.  The port's lookup
// backward was index_add_, whose CUDA form adds with atomics in an order
// that changes from run to run, so two training runs from one seed drifted
// apart.  K7 takes that order away: its result is bitwise CPU index_add_'s
// (which adds in index order), on every launch.
//
// The caller stable-sorts the ids (torch.sort(stable=True); perm[j] is the
// position of the j-th smallest id, ties in input order).  Then:
//   1. segsum_starts_kernel: start[r] = the first sorted position whose id
//      is >= r, r in [0, n_rows] (a binary search a row), so that row r's
//      gradient rows are perm[start[r] .. start[r + 1]).
//   2. segsum_rows_kernel: a warp a table row; each lane holds 4 contiguous
//      columns, ids come in 32 at a time (one a lane, broadcast by shuffle)
//      and kUnroll 16-byte loads are in flight before their adds, which
//      keep the segment's order.  Rows with more than kHeavy ids are left
//      to the next kernel.
//   3. segsum_gather_kernel: the gradient rows in sorted order (gs), then
//      segsum_heavy_kernel: the rows with more than kHeavy ids (the padding
//      id and position 0 take thousands at FK shapes).  A sum in order is
//      one chain of dependent adds a column, so the chain cannot be split;
//      what can be made parallel is the reading, and zero rows can be left
//      out of the chain.  A block takes one such row and 32 of its columns:
//      its threads copy kStageIds gradient rows at a time into shared
//      memory by cp.async, kStages stages in flight, while one warp adds
//      each stage's non-zero rows into its 32 running sums.  Heavy row r goes
//      to the block of slot ceil(start[r] / kHeavy): a segment longer than
//      kHeavy holds exactly one multiple of kHeavy at or after its start, so
//      each heavy row has one block, and no list or atomic is needed.
//
// Bound by bytes on an H100: g (n·d·4) and the ids read once and the table
// gradient (n_rows·d·4) written once; at FK shapes the write dominates
// (64,094 x 128 x 4 B = 33 MB, 0.01 ms at 3.35 TB/s).  No atomics; the
// order of every sum depends only on the ids.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeavy = 64;        // a row with more ids: the heavy kernel
constexpr int kUnroll = 8;        // loads in flight a lane (rows kernel)
constexpr int kRowsWarps = 8;     // warps a block (rows kernel)
constexpr int kStageIds = 128;    // gradient rows a stage (heavy kernel)
constexpr int kStages = 4;        // stages in flight (heavy kernel)
constexpr int kChunk = 32;        // columns a heavy block

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// start[r] = the first j with sorted[j] >= r, r in [0, n_rows].
__global__ void segsum_starts_kernel(const int* __restrict__ sorted, int n,
                                     int n_rows, int* __restrict__ start) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r > n_rows) return;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorted[mid] < r)
      lo = mid + 1;
    else
      hi = mid;
  }
  start[r] = lo;
}

// A warp a table row with at most kHeavy ids; lane c holds columns
// [4c, 4c + 4) of each 128-column chunk.
__global__ void __launch_bounds__(kRowsWarps * 32)
segsum_rows_kernel(const int* __restrict__ start,
                   const int64_t* __restrict__ perm,
                   const float4* __restrict__ g, float4* __restrict__ out,
                   int n_rows, int d4) {
  const int row = blockIdx.x * kRowsWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int lo = start[row], hi = start[row + 1];
  if (hi - lo > kHeavy) return;                 // segsum_heavy_kernel's
  for (int c0 = 0; c0 < d4; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < d4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e0 = lo; e0 < hi; e0 += 32) {
      const int n_e = min(32, hi - e0);
      const int64_t mine = lane < n_e ? perm[e0 + lane] : 0;
      for (int k0 = 0; k0 < n_e; k0 += kUnroll) {
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t src = __shfl_sync(0xffffffffu, mine, (k0 + u) & 31);
          v[u] = active && k0 + u < n_e ? g[src * d4 + c]
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (k0 + u < n_e) add4(acc, v[u]);
      }
    }
    if (active) out[(size_t)row * d4 + c] = acc;
  }
}

// gs[j, :] = g[perm[j], :]: the gradient rows in sorted order, so that the
// heavy kernel streams contiguous rows whose addresses need no lookup.
__global__ void segsum_gather_kernel(const int64_t* __restrict__ perm,
                                     const float4* __restrict__ g,
                                     float4* __restrict__ gs, int n, int d4) {
  const size_t total = (size_t)n * d4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t j = i / d4;
    gs[i] = g[perm[j] * d4 + (i - j * d4)];
  }
}

// A block a (heavy row, 32-column chunk): slot blockIdx.x, chunk
// blockIdx.y, over the row's segment of the sorted gradient rows gs.  A
// stage is kStageIds rows; each row's 32 columns (128 bytes) are copied
// into shared memory by 8 neighbouring threads, 16 bytes each, so that a
// warp's copy reads 4 whole lines, kStages stages in flight; thread k marks
// whether row k holds a non-zero in these columns.  Warp 0 adds the rows
// in order, lane l into column c0 + l, and skips every 32 rows of which
// none is marked.  Skipping a zero row is exact: the sum starts at +0.0 and
// so is never -0.0, and adding +0.0 or -0.0 to anything else leaves it as
// it is.  The heavy rows of a step are mostly zeros (the padding id's and
// position 0's rows get no gradient), so their chains are short.
__global__ void __launch_bounds__(kStageIds)
segsum_heavy_kernel(const int* __restrict__ sorted,
                    const int* __restrict__ start,
                    const float* __restrict__ gs, float* __restrict__ out,
                    int n, int d) {
  constexpr int kC4 = kChunk / 4;           // 16-byte pieces a row chunk
  constexpr int kLd4 = kC4 + 1;             // row stride in float4, padded
  extern __shared__ float4 ring[];          // [kStages][kStageIds][kLd4]
  __shared__ uint32_t live[kStageIds / 32];
  const int q = blockIdx.x;
  const int p = q * kHeavy;
  if (p >= n) return;
  const int row = sorted[p];
  const int lo = start[row], hi = start[row + 1];
  if (hi - lo <= kHeavy || (lo + kHeavy - 1) / kHeavy != q) return;
  const int c0 = blockIdx.y * kChunk;
  const int n_st = (hi - lo + kStageIds - 1) / kStageIds;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  auto issue = [&](int st) {
    float4* slot = ring + (st % kStages) * kStageIds * kLd4;
#pragma unroll
    for (int i = 0; i < kC4; ++i) {
      const int piece = i * kStageIds + threadIdx.x;
      const int k = piece / kC4, c4 = piece % kC4;
      const int j = lo + st * kStageIds + k;
      const int col = c0 + 4 * c4;
      const bool ok = j < hi && col < d;
      cp_async16(slot + k * kLd4 + c4, ok ? gs + (size_t)j * d + col : gs,
                 ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st) issue(s);
    cp_async_commit();
  }
  float acc = 0.f;
  for (int it = 0; it < n_st; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the slot refilled here was last read before this barrier
    if (it + kStages - 1 < n_st) issue(it + kStages - 1);
    cp_async_commit();
    const float4* stage = ring + (it % kStages) * kStageIds * kLd4;
    {
      // row threadIdx.x of the stage: any non-zero bit but the sign's
      const uint4* mine =
          reinterpret_cast<const uint4*>(stage + threadIdx.x * kLd4);
      uint32_t bits = 0;
#pragma unroll
      for (int c4 = 0; c4 < kC4; ++c4) {
        const uint4 v = mine[c4];
        bits |= (v.x | v.y | v.z | v.w) & 0x7fffffffu;
      }
      const uint32_t m = __ballot_sync(0xffffffffu, bits != 0);
      if (lane == 0) live[warp] = m;
    }
    __syncthreads();
    if (warp == 0) {
      // 32 rows at a time: a group with no marked row is skipped; in the
      // others the unmarked rows' zeros are added too, which is as exact
      const float* st = reinterpret_cast<const float*>(stage);
#pragma unroll 1
      for (int w = 0; w < kStageIds / 32; ++w) {
        if (live[w] == 0) continue;
        float v[32];
#pragma unroll
        for (int u = 0; u < 32; ++u)
          v[u] = st[(w * 32 + u) * 4 * kLd4 + lane];
#pragma unroll
        for (int u = 0; u < 32; ++u) acc += v[u];
      }
    }
  }
  cp_async_wait<0>();
  if (threadIdx.x < 32 && c0 + lane < d)
    out[(size_t)row * d + c0 + lane] = acc;
}

}  // namespace

// out [n_rows, d] = the ordered segment sums of g [n, d] over the stably
// sorted ids `sorted` [n] (int32, each in [0, n_rows)) and their positions
// `perm` [n] (int64).  workspace: n_rows + 1 ints, then (16-byte aligned)
// n·d floats for the sorted gradient rows.  g and out 16-byte aligned,
// d % 4 == 0.  Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int segsum_f32(const int* sorted, const int64_t* perm,
                          const float* g, float* out, void* workspace, int n,
                          int n_rows, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* start = static_cast<int*>(workspace);
  float* gs = static_cast<float*>(workspace) + ((n_rows + 1 + 3) / 4) * 4;
  segsum_starts_kernel<<<(n_rows + 1 + 255) / 256, 256, 0, s>>>(sorted, n,
                                                                n_rows, start);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segsum_rows_kernel<<<(n_rows + kRowsWarps - 1) / kRowsWarps,
                       kRowsWarps * 32, 0, s>>>(
      start, perm, reinterpret_cast<const float4*>(g),
      reinterpret_cast<float4*>(out), n_rows, d / 4);
  err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  const size_t n4 = (size_t)n * (d / 4);
  const size_t want = (n4 + 255) / 256;
  segsum_gather_kernel<<<static_cast<int>(want < 4096 ? want : 4096), 256, 0,
                         s>>>(perm, reinterpret_cast<const float4*>(g),
                              reinterpret_cast<float4*>(gs), n, d / 4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kSmem = kStages * kStageIds * (kChunk + 4) * sizeof(float);
  err = cudaFuncSetAttribute(segsum_heavy_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  segsum_heavy_kernel<<<dim3((n + kHeavy - 1) / kHeavy,
                             (d + kChunk - 1) / kChunk),
                        kStageIds, kSmem, s>>>(sorted, start, gs, out, n, d);
  return static_cast<int>(cudaGetLastError());
}
