// CSR SpMM for the GCN propagation: out = A @ h, A row-normalised, f32,
// dense (K1) or batch-sparse (K6).
//
// Replaces the blocked SpMM Pallas kernel (c2dsr_tpu/ops/spmm_pallas.py,
// blocked_spmm_impl / _kernel), reached densely through make_blocked_spmm
// (K1) and with a row flag through make_blocked_spmm_flagged (K6).  Bound
// by bytes on an H100: each hop reads the referenced table rows and writes
// every output row once.
//
// The work is split on the host, once per graph (ops/spmm.py plan), into
// warp tasks of at most heavy_deg edges (32 by default), in row order:
//   * a run of up to 32 consecutive whole rows (tasks[t] = {r0, n, e0, e1}:
//     rows [r0, r0 + n), edges [e0, e1)).  The warp loads the run's row ends
//     (one a lane) and its edges 32 at a time (one a lane) in coalesced
//     sweeps, and walks the edges in CSR order across the rows: the gathers
//     of kGathers / NC edges are issued before their FMAs, whichever rows
//     they belong to, so the gathers of several short rows are in flight
//     together (FK rows average 2.8 edges).  Passing a row's end stores its
//     sum; a row without edges is stored as zeros.
//   * a segment of a row with more than heavy_deg edges ({r0, -1 - slot, e0,
//     e1}): the row's edges are cut into near-equal contiguous segments,
//     each summed in CSR order by one warp into a partial row `slot` of a
//     scratch table.  Degrees are Zipf-skewed (the FK share graph's largest
//     row has 5,445 edges), so a heavy row is spread over as many warps as
//     it has segments.  A second launch, spmm_combine_kernel, gives each
//     split row a block: warp w adds the w-th of 8 contiguous runs of its
//     partials in order, and warp 0 adds the runs' sums in run order.
// Each lane holds NC float4 of the row (d / 4 <= 32·NC: one pass over the
// edges for any d up to 1,024).  Blocks are 8 warps at 64 registers a
// thread, so 4 blocks (32 warps) are resident an SM, and the tasks kernel
// never synchronises.  Warps past the tasks write the zero rows [n_graph,
// n_rows).  No atomics; the summation order depends only on the graph, so
// the result is bitwise repeatable.
//
// The batch-sparse modes (K6) take a 0/1 byte per table row, flag:
//   * kDest (a hop's forward over A): an unflagged output row is written as
//     zeros and issues no gathers (its edges are dropped before the gathers;
//     a split row's segments write nothing and the combine writes zeros); a
//     flagged row sums every edge in the order kDense does, bitwise.
//   * kSrc (the hop's backward over the CSR of A^T, whose incoming gradient
//     is zero on unflagged rows): in each 32-edge window every lane loads its
//     edge's column and flag[col], a ballot keeps the flagged ones, and only
//     those are gathered, in CSR order.  A masked edge would add an exact
//     zero, so the sum is the dense one.
//
// The bf16 instantiations (kBf; compute_dtype="bfloat16") take the JAX
// Pallas SpMM's bf16 gather (spmm_pallas.py:166-172): each gathered
// product is bf16(bf16(h[col])·bf16(val)), rounded to nearest even (the
// product of two bf16 values is exact in f32, then rounded once, as a
// bf16 multiply), and the sums stay f32.  They read the f32 table as the
// f32 ones do and round as they gather: the same bytes, the JAX numerics.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

constexpr int kWarps = 8;       // warps a block
constexpr int kMinBlocks = 4;   // resident blocks an SM (64 registers)
constexpr int kRunRows = 32;    // rows a task at most (one end a lane)
constexpr int kGathers = 4;     // float4 gathers in flight a lane (tasks)

constexpr int kDense = 0;       // K1
constexpr int kDest = 1;        // K6, edges masked by their output row's flag
constexpr int kSrc = 2;         // K6, edges masked by their gathered row's flag

__device__ __forceinline__ void add4(float4& acc, const float4 x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

__device__ __forceinline__ void fma4(float4& acc, float v, const float4 x) {
  acc.x = fmaf(v, x.x, acc.x);
  acc.y = fmaf(v, x.y, acc.y);
  acc.z = fmaf(v, x.z, acc.z);
  acc.w = fmaf(v, x.w, acc.w);
}

// acc += bf16(v·bf16(x)) elementwise, v already a bf16 value.
__device__ __forceinline__ void add_bf16_products(float4& acc, float v,
                                                  const float4 x) {
  acc.x += tc::bf16f(v * tc::bf16f(x.x));
  acc.y += tc::bf16f(v * tc::bf16f(x.y));
  acc.z += tc::bf16f(v * tc::bf16f(x.z));
  acc.w += tc::bf16f(v * tc::bf16f(x.w));
}

// One warp a task (see the top of the file); lane l holds float4 columns
// cb + l + 32 j, j < NC, of each column pass cb.
template <int kMode, int NC, bool kBf>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
spmm_tasks_kernel(const int4* __restrict__ tasks, int n_tasks,
                  const int* __restrict__ rowptr, const int* __restrict__ cols,
                  const float* __restrict__ vals,
                  const uint8_t* __restrict__ flag,
                  const float4* __restrict__ h, float4* __restrict__ out,
                  float4* __restrict__ part, int n_graph, int n_rows,
                  int d4) {
  constexpr int kUnroll = NC >= kGathers ? 1 : kGathers / NC;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= n_tasks) {                           // the rows past the graph
    const int r0 = n_graph + (t - n_tasks) * kRunRows;
    const int r1 = min(r0 + kRunRows, n_rows);
    for (int r = r0; r < r1; ++r)
      for (int c = lane; c < d4; c += 32)
        out[static_cast<size_t>(r) * d4 + c] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int4 task = tasks[t];
  const bool seg = task.y < 0;
  const int r0 = task.x, nr = seg ? 1 : task.y, e0 = task.z, e1 = task.w;
  float4* dst = seg ? part + static_cast<size_t>(-1 - task.y) * d4
                    : out + static_cast<size_t>(r0) * d4;
  // lane l: the end of the run's row l
  const int my_end = lane < nr ? (seg ? e1 : rowptr[r0 + lane + 1]) : e1;
  unsigned live = 0xffffffffu;                  // kDest: the flagged rows
  if constexpr (kMode == kDest) {
    live = __ballot_sync(0xffffffffu, lane < nr && flag[r0 + lane] != 0);
    if (seg && live == 0u) return;              // the combine writes zeros
  }

  for (int cb = 0; cb < d4; cb += 32 * NC) {
    float4 acc[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    int row = 0;
    int row_end = __shfl_sync(0xffffffffu, my_end, 0);
    // store the rows that end at or before edge p (warp-uniform)
    auto close_before = [&](int p) {
      while (row < nr && row_end <= p) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = cb + lane + 32 * j;
          if (c < d4) dst[static_cast<size_t>(row) * d4 + c] = acc[j];
          acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        ++row;
        row_end = __shfl_sync(0xffffffffu, my_end, row & 31);
      }
    };
    for (int w0 = e0; w0 < e1; w0 += 32) {
      const int n_e = min(32, e1 - w0);
      int my_col = 0;
      float my_val = 0.f;
      bool keep = lane < n_e;
      if (keep) {
        my_col = cols[w0 + lane];
        my_val = vals[w0 + lane];
      }
      if constexpr (kMode == kSrc) keep = keep && flag[my_col] != 0;
      if constexpr (kMode == kDest) {
        // this lane's edge's row in the run: the first end past it
        const int p = w0 + lane;
        int lo = 0, hi = nr - 1;
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          const int mid = (lo + hi) >> 1;
          if (__shfl_sync(0xffffffffu, my_end, mid) > p)
            hi = mid;
          else
            lo = mid + 1;
        }
        keep = keep && ((live >> min(lo, 31)) & 1u);
      }
      // the kept edges of this window, lowest lane (earliest edge) first
      unsigned kept = __ballot_sync(0xffffffffu, keep);
      while (kept != 0u) {
        float4 x[kUnroll][NC];
        float v[kUnroll];
        int pos[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool on = kept != 0u;
          const int src = on ? __ffs(kept) - 1 : 0;
          kept &= kept - 1u;                    // stays 0 once empty
          const int col = __shfl_sync(0xffffffffu, my_col, src);
          v[u] = __shfl_sync(0xffffffffu, my_val, src);
          if constexpr (kBf) v[u] = tc::bf16f(v[u]);
          pos[u] = on ? w0 + src : INT_MAX;
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            const int c = cb + lane + 32 * j;
            x[u][j] = on && c < d4
                          ? __ldg(h + static_cast<size_t>(col) * d4 + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (pos[u] != INT_MAX) {
            close_before(pos[u]);
#pragma unroll
            for (int j = 0; j < NC; ++j) {
              if constexpr (kBf)
                add_bf16_products(acc[j], v[u], x[u][j]);
              else
                fma4(acc[j], v[u], x[u][j]);
            }
          }
        }
      }
    }
    close_before(INT_MAX);
  }
}

// A block a split row: out[row] = its partial rows added in an order fixed
// by the graph.  Warp w sums the w-th of kWarps contiguous runs of them in
// order; warp 0 then adds the runs' sums in run order.
template <int kMode, int NC>
__global__ void __launch_bounds__(kWarps * 32)
spmm_combine_kernel(const int* __restrict__ heavy_rows,
                    const int* __restrict__ heavy_slots,
                    const uint8_t* __restrict__ flag,
                    const float4* __restrict__ part, float4* __restrict__ out,
                    int d4) {
  constexpr int kUnroll = NC >= 16 ? 1 : 16 / NC;
  __shared__ float4 run_sum[kWarps][32 * NC];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = heavy_rows[blockIdx.x];
  const int s0 = heavy_slots[blockIdx.x];
  int n_part = heavy_slots[blockIdx.x + 1] - s0;
  if (kMode == kDest && flag[row] == 0) n_part = 0;       // zeros
  const int per = (n_part + kWarps - 1) / kWarps;
  const int runs = per > 0 ? (n_part + per - 1) / per : 0;
  const int r0 = s0 + warp * per, r1 = s0 + min(n_part, (warp + 1) * per);
  for (int cb = 0; cb < d4; cb += 32 * NC) {
    float4 acc[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = r0; s < r1; s += kUnroll) {
      float4 x[kUnroll][NC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = cb + lane + 32 * j;
          x[u][j] = s + u < r1 && c < d4
                        ? part[static_cast<size_t>(s + u) * d4 + c]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (s + u < r1)
#pragma unroll
          for (int j = 0; j < NC; ++j) add4(acc[j], x[u][j]);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) run_sum[warp][lane + 32 * j] = acc[j];
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float4 total = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int w = 0; w < runs; ++w) add4(total, run_sum[w][lane + 32 * j]);
        const int c = cb + lane + 32 * j;
        if (c < d4) out[static_cast<size_t>(row) * d4 + c] = total;
      }
    }
    __syncthreads();
  }
}

struct Args {
  const int4* tasks;
  int n_tasks;
  const int* rowptr;
  const int* cols;
  const float* vals;
  const int* heavy_rows;
  const int* heavy_slots;
  int n_heavy;
  const uint8_t* flag;
  const float4* h;
  float4* out;
  float4* part;
  int n_graph, n_rows, d4;
  cudaStream_t stream;
};

template <int kMode, int NC, bool kBf>
int launch(const Args& a) {
  const int tail = (a.n_rows - a.n_graph + kRunRows - 1) / kRunRows;
  const int warps = a.n_tasks + tail;
  if (warps > 0) {
    spmm_tasks_kernel<kMode, NC, kBf><<<(warps + kWarps - 1) / kWarps,
                                        kWarps * 32, 0, a.stream>>>(
        a.tasks, a.n_tasks, a.rowptr, a.cols, a.vals, a.flag, a.h, a.out,
        a.part, a.n_graph, a.n_rows, a.d4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.n_heavy > 0)
    spmm_combine_kernel<kMode, NC><<<a.n_heavy, kWarps * 32, 0, a.stream>>>(
        a.heavy_rows, a.heavy_slots, a.flag, a.part, a.out, a.d4);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode, bool kBf>
int by_width(const Args& a) {
  if (a.d4 <= 32) return launch<kMode, 1, kBf>(a);
  if (a.d4 <= 64) return launch<kMode, 2, kBf>(a);
  if (a.d4 <= 128) return launch<kMode, 4, kBf>(a);
  return launch<kMode, 8, kBf>(a);            // d > 1,024: column passes
}

template <bool kBf>
int flagged(const Args& a, int mode) {
  if (mode == kDest) return by_width<kDest, kBf>(a);
  if (mode == kSrc) return by_width<kSrc, kBf>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const int* tasks, int n_tasks, const int* rowptr,
               const int* cols, const float* vals, const int* heavy_rows,
               const int* heavy_slots, int n_heavy, const uint8_t* flag,
               const float* h, float* out, float* part, int n_graph,
               int n_rows, int d, void* stream) {
  return Args{reinterpret_cast<const int4*>(tasks), n_tasks, rowptr, cols,
              vals, heavy_rows, heavy_slots, n_heavy, flag,
              reinterpret_cast<const float4*>(h),
              reinterpret_cast<float4*>(out), reinterpret_cast<float4*>(part),
              n_graph, n_rows, d / 4, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// tasks: int32 [n_tasks, 4] (16-byte aligned), the plan of ops/spmm.py;
// heavy_rows [n_heavy] the split rows, heavy_slots [n_heavy + 1] their
// first partial rows; part: scratch [partial rows, d].  h, out and part
// 16-byte aligned, d % 4 == 0.  Launches one kernel, or two where rows are
// split.  Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int spmm_csr_f32(const int* tasks, int n_tasks, const int* rowptr,
                            const int* cols, const float* vals,
                            const int* heavy_rows, const int* heavy_slots,
                            int n_heavy, const float* h, float* out,
                            float* part, int n_graph, int n_rows, int d,
                            void* stream) {
  return by_width<kDense, false>(make_args(
      tasks, n_tasks, rowptr, cols, vals, heavy_rows, heavy_slots, n_heavy,
      nullptr, h, out, part, n_graph, n_rows, d, stream));
}

// spmm_csr_f32 with the bf16 gather (the top of the file).
extern "C" int spmm_csr_bf16(const int* tasks, int n_tasks, const int* rowptr,
                             const int* cols, const float* vals,
                             const int* heavy_rows, const int* heavy_slots,
                             int n_heavy, const float* h, float* out,
                             float* part, int n_graph, int n_rows, int d,
                             void* stream) {
  return by_width<kDense, true>(make_args(
      tasks, n_tasks, rowptr, cols, vals, heavy_rows, heavy_slots, n_heavy,
      nullptr, h, out, part, n_graph, n_rows, d, stream));
}

// The batch-sparse hop (K6): flag holds one 0/1 byte per table row (n_rows);
// mode 1 masks edges by their output row's flag, mode 2 by their gathered
// row's flag.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue (1) for another mode.
extern "C" int spmm_csr_flagged_f32(const int* tasks, int n_tasks,
                                    const int* rowptr, const int* cols,
                                    const float* vals, const int* heavy_rows,
                                    const int* heavy_slots, int n_heavy,
                                    const uint8_t* flag, const float* h,
                                    float* out, float* part, int n_graph,
                                    int n_rows, int d, int mode,
                                    void* stream) {
  return flagged<false>(make_args(tasks, n_tasks, rowptr, cols, vals,
                                  heavy_rows, heavy_slots, n_heavy, flag, h,
                                  out, part, n_graph, n_rows, d, stream),
                        mode);
}

// spmm_csr_flagged_f32 with the bf16 gather.
extern "C" int spmm_csr_flagged_bf16(const int* tasks, int n_tasks,
                                     const int* rowptr, const int* cols,
                                     const float* vals, const int* heavy_rows,
                                     const int* heavy_slots, int n_heavy,
                                     const uint8_t* flag, const float* h,
                                     float* out, float* part, int n_graph,
                                     int n_rows, int d, int mode,
                                     void* stream) {
  return flagged<true>(make_args(tasks, n_tasks, rowptr, cols, vals,
                                 heavy_rows, heavy_slots, n_heavy, flag, h,
                                 out, part, n_graph, n_rows, d, stream),
                       mode);
}
