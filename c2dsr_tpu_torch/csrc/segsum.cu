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
// A sum in order is one chain of dependent adds a column, so a table row's
// chain cannot be split; what can be made parallel is the reading, and zero
// gradient rows can be left out of the chain.  Leaving one out is exact: a
// chain starts at +0.0 and so is never -0.0, and adding +0.0 or -0.0 to
// anything else leaves it as it is.  At FK shapes the padding id and
// position 0 take about a third of a step's ids, and their gradient rows
// are all zero.  Three launches at most, no sort, no float atomics:
//   1. segsum_mark_kernel (every gradient row once, a warp kMarkRows rows,
//      at full width): key[i] = ids[i] where row i holds a non-zero (sign
//      bits aside), else -1.  For a large table it also counts the
//      non-zero rows of each id (an integer atomicAdd: the counts do not
//      depend on the atomics' order), files row i into its id's list of
//      kCap slots in the order the atomics return, lists each id once as
//      touched at its first row, and lists it once as heavy when its count
//      passes kCap.  Neither list's order reaches the result.
//   2. segsum_rows_kernel (large tables): zero warps write the rows with no
//      non-zero gradient row as zeros, kZeroRows a warp; touched warps take
//      one touched row each, and if it has at most kCap non-zero rows, rank
//      its list by index, which puts the slots back in input order whatever
//      order the atomics took, and add them in that order (kUnroll loads in
//      flight a lane).  A heavy row is left to the next kernel.
//   3. segsum_scan_kernel (a block a (row, 32-column chunk)): for every row
//      of a small table (the wrapper passes no counts or lists for one of
//      at most 64 rows: ops/segsum_cuda.SMALL_ROWS), or for each heavy row
//      of a large one.  Its threads sweep the marks in tiles of 1,024
//      (coalesced, kTileBatch tiles in flight) and place the row's matches
//      in input order by a block scan a tile; then they copy those rows'
//      32 columns into shared memory by cp.async, kStages stages in flight,
//      while one warp adds each stage in order, a lane a column.  Only the
//      non-zero rows are read.  It also zeroes the counts for the next call.
// The workspace is kept between calls on a stream and left ready by each:
// counts zero, touched entries -1, and the counters (ctr) reset by the
// kernel after the last one that reads them, so no launch clears it.
//
// Bound on an H100 by bytes (g and the ids read once, the table gradient
// written once; at FK shapes the 33 MB write of the item table's gradient,
// 0.01 ms at 3.35 TB/s) or by the order: the longest chain of non-zero rows
// into one table row, one FADD latency each.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kCap = 32;          // list slots a table row (a warp's lanes)
constexpr int kUnroll = 8;        // loads in flight a lane (rows kernel)
constexpr int kWarps = 8;         // warps a block (mark and rows kernels)
constexpr int kMarkRows = 4;      // gradient rows a warp (mark kernel)
constexpr int kZeroRows = 32;     // table rows a zero warp (rows kernel)
constexpr int kScanThreads = 256; // threads a block (scan kernel)
constexpr int kTileBatch = 8;     // key tiles in flight (scan kernel)
constexpr int kStageRows = 128;   // gradient rows a stage (scan kernel)
constexpr int kStages = 4;        // stages in flight (scan kernel)
constexpr int kChunk = 32;        // columns a scan block
constexpr int kList = 4096;       // row indices the scan block holds at once
constexpr int kScanBlocks = 64;   // scan blocks a column chunk (heavy rows)
constexpr int kSmem = (kStages * kStageRows * kChunk + kList) * 4;

// ctr[]: the workspace's counters
constexpr int kHeavyCount = 0;    // heavy rows appended (mark kernel)
constexpr int kHeavyScan = 1;     // the same, moved aside for the scan kernel
constexpr int kTouchedCount = 2;  // touched rows appended (mark kernel)

// g is read four floats a load: the wrapper takes d % 4 == 0 and g 16-byte
// aligned
constexpr int kVec = 4;
__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void add4(float4& a, const float4 v) {
  a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
}
__device__ __forceinline__ uint32_t bits4(const float4 v) {  // sign bits aside
  return (__float_as_uint(v.x) | __float_as_uint(v.y) |
          __float_as_uint(v.z) | __float_as_uint(v.w)) & 0x7fffffffu;
}

// 16 bytes, or zero bytes where !ok
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
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

struct Work {
  int* keys;       // [n rounded up to 4], the tail -1
  int* counts;     // [n_rows], zero between calls (large tables)
  int* lists;      // [n_rows * kCap]
  int* heavy;      // [n / (kCap + 1) + 1]
  int* touched;    // [min(n, n_rows)], -1 between calls
  int* ctr;        // [4], zero between calls
};

// A warp kMarkRows gradient rows (their loads in flight together); lane k
// then does row i0 + k's bookkeeping (see the top of the file).
__global__ void __launch_bounds__(kWarps * 32)
segsum_mark_kernel(const int64_t* __restrict__ ids,
                   const float* __restrict__ g, int n, int d, int n_rows,
                   Work w) {
  const int i0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kMarkRows;
  const int lane = threadIdx.x & 31;
  if (i0 >= n) return;
  const int i = i0 + lane;
  const bool mine = lane < kMarkRows && i < n;
  const int64_t id = mine ? ids[i] : -1;
  const int dv = d / kVec;
  const float4* gv = reinterpret_cast<const float4*>(g);
  uint32_t bits[kMarkRows] = {};
#pragma unroll 2
  for (int c = lane; c < dv; c += 32) {
#pragma unroll
    for (int k = 0; k < kMarkRows; ++k)
      if (i0 + k < n)
        bits[k] |= bits4(__ldg(gv + static_cast<size_t>(i0 + k) * dv + c));
  }
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < kMarkRows; ++k)
    live |= __any_sync(0xffffffffu, bits[k] != 0) ? 1u << k : 0u;
  if (!mine) return;
  const bool nz = (live >> lane) & 1u;
  const int key = nz && id >= 0 && id < n_rows ? static_cast<int>(id) : -1;
  w.keys[i] = key;
  if (key < 0 || w.lists == nullptr) return;
  const int s = atomicAdd(w.counts + key, 1);
  if (s < kCap) w.lists[static_cast<size_t>(key) * kCap + s] = i;
  if (s == 0) w.touched[atomicAdd(w.ctr + kTouchedCount, 1)] = key;
  if (s == kCap) w.heavy[atomicAdd(w.ctr + kHeavyCount, 1)] = key;
}

// Large tables.  Warps [0, n_zero): table rows [kZeroRows z, kZeroRows z +
// kZeroRows) with no non-zero gradient row, written as zeros.  The n_touch
// warps past them: touched entry t, its row's at most kCap non-zero
// gradient rows ranked into input order and added in that order, lane c
// holding the 4 columns [4 c, 4 c + 4) of each 128-column chunk.
__global__ void __launch_bounds__(kWarps * 32)
segsum_rows_kernel(Work w, int n_zero, int n_touch,
                   const float* __restrict__ g, float* __restrict__ out,
                   int n_rows, int d) {
  __shared__ int order[kWarps][kCap];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int z = blockIdx.x * kWarps + warp;
  const int dv = d / kVec;
  float4* ov = reinterpret_cast<float4*>(out);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    w.ctr[kHeavyScan] = w.ctr[kHeavyCount];   // the scan kernel's count
    w.ctr[kHeavyCount] = 0;                   // the next call's
    w.ctr[kTouchedCount] = 0;
  }
  if (z < n_zero) {
    const int r = z * kZeroRows + lane;
    unsigned empty = __ballot_sync(0xffffffffu,
                                   r < n_rows && w.counts[r] == 0);
    while (empty != 0u) {
      const int k = __ffs(empty) - 1;
      empty &= empty - 1u;
      float4* orow = ov + static_cast<size_t>(z * kZeroRows + k) * dv;
      for (int c = lane; c < dv; c += 32) orow[c] = zero4();
    }
    return;
  }
  const int t = z - n_zero;
  if (t >= n_touch) return;
  const int r = w.touched[t];
  if (r < 0) return;                          // past the touched rows
  const int c = w.counts[r];
  __syncwarp();
  if (lane == 0) w.touched[t] = -1;           // ready for the next call
  if (c > kCap) return;                       // segsum_scan_kernel's
  const int mine = lane < c ? w.lists[static_cast<size_t>(r) * kCap + lane]
                            : INT_MAX;
  int rank = 0;
  for (int m = 0; m < c; ++m)
    rank += __shfl_sync(0xffffffffu, mine, m) < mine;
  if (lane < c) order[warp][rank] = mine;
  __syncwarp();
  const int src_i = lane < c ? order[warp][lane] : 0;
  const float4* gv = reinterpret_cast<const float4*>(g);
  float4* orow = ov + static_cast<size_t>(r) * dv;
  for (int c0 = 0; c0 < dv; c0 += 32) {
    const int col = c0 + lane;
    const bool active = col < dv;
    float4 acc = zero4();
    for (int k0 = 0; k0 < c; k0 += kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int src = __shfl_sync(0xffffffffu, src_i, (k0 + u) & 31);
        v[u] = active && k0 + u < c
                   ? __ldg(gv + static_cast<size_t>(src) * dv + col)
                   : zero4();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (k0 + u < c) add4(acc, v[u]);
    }
    if (active) orow[col] = acc;
  }
}

// A block a (table row, 32-column chunk): entry e = blockIdx.x, +gridDim.x,
// ... of the heavy list (w.lists != nullptr, count ctr[kHeavyScan]) or of
// all n_rows rows of a small table.
__global__ void __launch_bounds__(kScanThreads)
segsum_scan_kernel(Work w, int n, int n_rows, const float* __restrict__ g,
                   float* __restrict__ out, int d) {
  extern __shared__ float4 smem4[];
  // ring: [kStages][kStageRows][kChunk] floats, then idx: kList ints
  float* ring = reinterpret_cast<float*>(smem4);
  int* idx = reinterpret_cast<int*>(ring + kStages * kStageRows * kChunk);
  __shared__ int warp_total[kScanThreads / 32];
  constexpr int kPieces = kChunk / kVec;          // copies a row chunk
  const bool small = w.lists == nullptr;
  if (!small) {                       // the counts, ready for the next call
    const int nb = gridDim.x * gridDim.y;
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    for (int r = b * kScanThreads + threadIdx.x; r < n_rows;
         r += nb * kScanThreads)
      w.counts[r] = 0;
  }
  const int count = small ? n_rows : w.ctr[kHeavyScan];
  const int c0 = blockIdx.y * kChunk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n4 = (n + 3) / 4;
  const int n_tiles = (n4 + kScanThreads - 1) / kScanThreads;
  const int4* keys4 = reinterpret_cast<const int4*>(w.keys);

  for (int e = blockIdx.x; e < count; e += gridDim.x) {
    const int r = small ? e : w.heavy[e];
    float acc = 0.f;
    int total = 0;
    for (int base = 0; base == 0 || base < total; base += kList) {
      // the row's matches in input order; those at [base, base + kList)
      // into idx.  Tile q holds keys [1024 q, 1024 q + 1024), int4 tid of it
      // in thread tid, so a tile's matches are in thread order.
      int running = 0;
      for (int q0 = 0; q0 < n_tiles; q0 += kTileBatch) {
        int4 k[kTileBatch];
#pragma unroll
        for (int b = 0; b < kTileBatch; ++b) {
          const int q = (q0 + b) * kScanThreads + tid;
          k[b] = q0 + b < n_tiles && q < n4 ? __ldg(keys4 + q)
                                            : make_int4(-1, -1, -1, -1);
        }
#pragma unroll
        for (int b = 0; b < kTileBatch; ++b) {
          if (q0 + b >= n_tiles) break;
          const int hits = (k[b].x == r) | (k[b].y == r) << 1 |
                           (k[b].z == r) << 2 | (k[b].w == r) << 3;
          const int cnt = __popc(hits);
          int incl = cnt;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += v;
          }
          if (lane == 31) warp_total[warp] = incl;
          __syncthreads();
          int before = running, tile = 0;
#pragma unroll
          for (int u = 0; u < kScanThreads / 32; ++u) {
            const int s = warp_total[u];
            before += u < warp ? s : 0;
            tile += s;
          }
          int o = before + incl - cnt - base;
          const int key0 = 4 * ((q0 + b) * kScanThreads + tid);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if ((hits >> j) & 1) {
              if (o >= 0 && o < kList) idx[o] = key0 + j;
              ++o;
            }
          }
          running += tile;
          __syncthreads();                    // warp_total is rewritten
        }
      }
      total = running;
      const int m = min(total - base, kList);
      const int n_st = m > 0 ? (m + kStageRows - 1) / kStageRows : 0;
      auto issue = [&](int st) {
        float* slot = ring + (st % kStages) * kStageRows * kChunk;
        for (int p = tid; p < kStageRows * kPieces; p += kScanThreads) {
          const int k = p / kPieces, c = (p % kPieces) * kVec;
          const int j = st * kStageRows + k;
          const bool ok = j < m && c0 + c < d;
          cp_async(slot + k * kChunk + c,
                      ok ? g + static_cast<size_t>(idx[j]) * d + c0 + c : g,
                      ok);
        }
      };
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < n_st) issue(s);
        cp_async_commit();
      }
      for (int it = 0; it < n_st; ++it) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        // the slot refilled here was last read before this barrier
        if (it + kStages - 1 < n_st) issue(it + kStages - 1);
        cp_async_commit();
        if (warp == 0) {
          const float* st = ring + (it % kStages) * kStageRows * kChunk;
          const int rows = min(kStageRows, m - it * kStageRows);
#pragma unroll 1
          for (int k0 = 0; k0 < rows; k0 += 32) {
            float v[32];
#pragma unroll
            for (int u = 0; u < 32; ++u) v[u] = st[(k0 + u) * kChunk + lane];
#pragma unroll
            for (int u = 0; u < 32; ++u)
              if (k0 + u < rows) acc += v[u];
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();                        // idx and the ring are reused
    }
    if (warp == 0 && c0 + lane < d)
      out[static_cast<size_t>(r) * d + c0 + lane] = acc;
  }
}

int launch(const int64_t* ids, const float* g, float* out, const Work& w,
           int n, int n_rows, int d, cudaStream_t s) {
  const bool small = w.lists == nullptr;
  if (n > 0) {
    const int warps = (n + kMarkRows - 1) / kMarkRows;
    segsum_mark_kernel<<<(warps + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
        ids, g, n, d, n_rows, w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int scan_rows = n_rows;
  if (!small) {
    const int n_zero = (n_rows + kZeroRows - 1) / kZeroRows;
    const int n_touch = min(n, n_rows);
    const int warps = n_zero + n_touch;
    segsum_rows_kernel<<<(warps + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
        w, n_zero, n_touch, g, out, n_rows, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // at most n / (kCap + 1) heavy rows; each block loops over its share
    scan_rows = min(n / (kCap + 1) + 1, kScanBlocks);
  }
  segsum_scan_kernel<<<dim3(scan_rows, (d + kChunk - 1) / kChunk),
                       kScanThreads, kSmem, s>>>(w, n, n_rows, g, out, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Once per device, before the first segsum_f32 there: lets the scan kernel
// take its kSmem bytes of shared memory.  Returns the CUDA error (0 = set).
extern "C" int segsum_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      segsum_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem));
}

// out [n_rows, d] = the ordered segment sums of g [n, d] (f32, contiguous,
// 16-byte aligned, d % 4 == 0) over the n int64 ids (an id outside
// [0, n_rows) adds nothing).  The workspace (int32, kept between calls on one stream, each
// call leaving it as it found it): keys [n rounded up to a multiple of 4]
// with the tail -1; for a large table (lists != nullptr) counts [n_rows]
// zero, lists [n_rows * 32], heavy [n / 33 + 1], touched [min(n, n_rows)]
// -1 and ctr [4] zero; for a small one, nullptr for all but keys.  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int segsum_f32(const int64_t* ids, const float* g, float* out,
                          int* keys, int* counts, int* lists, int* heavy,
                          int* touched, int* ctr, int n, int n_rows, int d,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Work w{keys, counts, lists, heavy, touched, ctr};
  return launch(ids, g, out, w, n, n_rows, d, s);
}
