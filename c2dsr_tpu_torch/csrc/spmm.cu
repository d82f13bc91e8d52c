// CSR SpMM for the GCN propagation: out = A @ h, A row-normalised, f32,
// dense (K1) or batch-sparse (K6).
//
// Replaces the blocked SpMM Pallas kernel (c2dsr_tpu/ops/spmm_pallas.py,
// blocked_spmm_impl / _kernel), reached densely through make_blocked_spmm
// (K1) and with a row flag through make_blocked_spmm_flagged (K6).  Bound
// by bytes on an H100: each hop reads the referenced table rows and writes
// every output row once.
//
// A warp accumulates a row's edges over one 128-feature chunk: each lane
// holds 4 contiguous features in registers and gathers them with one
// 16-byte load per edge, so the warp reads a 512-byte row per edge.  Edge
// ids and weights come in 32 at a time (one per lane) and are broadcast by
// shuffle; the gathers of 8 edges are issued before their 8 FMAs, so 8
// loads are in flight per lane while the sum keeps its sequential order.
//
// Row degrees are skewed (a Zipf item has thousands of successors), and a
// warp walking such a row alone would set the kernel's time.  So the rows
// with more than heavy_deg edges (listed by the host, heavy_rows) get a
// whole block each: its 32 warps take 32 contiguous segments of the row and
// the partial sums are added in segment order.  Every other row gets one
// warp.  No atomics; the summation order depends only on the graph, so the
// result is deterministic.  Rows in [n_graph, n_rows) have no edges and are
// written as zeros.
//
// The batch-sparse modes (K6) take a 0/1 byte per table row, flag:
//   * kDest (a hop's forward over A): an unflagged output row is written as
//     zeros and issues no gathers, in the warp and the heavy-row path alike;
//     a flagged row sums every edge in CSR order, bitwise as kDense does.
//   * kSrc (the hop's backward over the CSR of A^T, whose incoming gradient
//     is zero on unflagged rows): in each 32-edge window every lane loads its
//     edge's column and flag[col], a ballot keeps the flagged ones, and the
//     gather loop walks only those, in CSR order.  A masked edge would add an
//     exact zero, so the sum is the dense one; only the kept edges issue the
//     16-byte row gathers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 32;      // warps per block
constexpr int kUnroll = 8;      // gathers in flight per lane

constexpr int kDense = 0;       // K1
constexpr int kDest = 1;        // K6, edges masked by their output row's flag
constexpr int kSrc = 2;         // K6, edges masked by their gathered row's flag

// acc += sum over edges [begin, end) of vals[e] * h[cols[e], chunk], in
// order; kSrc skips the edges whose gathered row is unflagged.
template <int kMode>
__device__ __forceinline__ float4 row_chunk(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const uint8_t* __restrict__ flag, const float4* __restrict__ h, int d4,
    int c, int begin, int end) {
  const int lane = threadIdx.x & 31;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool active = c < d4;
  for (int e0 = begin; e0 < end; e0 += 32) {
    const int n_e = min(32, end - e0);
    int my_col = 0;
    float my_val = 0.f;
    if (lane < n_e) {
      my_col = cols[e0 + lane];
      my_val = vals[e0 + lane];
    }
    if constexpr (kMode == kSrc) {
      // the kept edges of this window, lowest lane (earliest edge) first
      unsigned kept = __ballot_sync(0xffffffffu,
                                    lane < n_e && flag[my_col] != 0);
      while (kept != 0u) {
        float4 x[kUnroll];
        float v[kUnroll];
        bool on[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          on[u] = kept != 0u;
          const int src = on[u] ? __ffs(kept) - 1 : 0;
          kept &= kept - 1u;                 // stays 0 once empty
          const int col = __shfl_sync(0xffffffffu, my_col, src);
          v[u] = __shfl_sync(0xffffffffu, my_val, src);
          x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (active && on[u])
            x[u] = __ldg(h + static_cast<size_t>(col) * d4 + c);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (on[u]) {
            acc.x = fmaf(v[u], x[u].x, acc.x);
            acc.y = fmaf(v[u], x[u].y, acc.y);
            acc.z = fmaf(v[u], x[u].z, acc.z);
            acc.w = fmaf(v[u], x[u].w, acc.w);
          }
        }
      }
    } else {
      for (int t0 = 0; t0 < n_e; t0 += kUnroll) {
        float4 x[kUnroll];
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int col = __shfl_sync(0xffffffffu, my_col, (t0 + u) & 31);
          v[u] = __shfl_sync(0xffffffffu, my_val, (t0 + u) & 31);
          x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (active && t0 + u < n_e)
            x[u] = __ldg(h + static_cast<size_t>(col) * d4 + c);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t0 + u < n_e) {
            acc.x = fmaf(v[u], x[u].x, acc.x);
            acc.y = fmaf(v[u], x[u].y, acc.y);
            acc.z = fmaf(v[u], x[u].z, acc.z);
            acc.w = fmaf(v[u], x[u].w, acc.w);
          }
        }
      }
    }
  }
  return acc;
}

template <int kMode>
__global__ void __launch_bounds__(kWarps * 32)
spmm_csr_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
                const float* __restrict__ vals,
                const int* __restrict__ heavy_rows, int n_heavy,
                int heavy_deg, const uint8_t* __restrict__ flag,
                const float4* __restrict__ h, float4* __restrict__ out,
                int n_graph, int n_rows, int d4) {
  __shared__ float4 part[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (blockIdx.x < n_heavy) {
    // one heavy row per block, split into kWarps contiguous segments
    const int row = heavy_rows[blockIdx.x];
    const int begin = rowptr[row];
    int deg = rowptr[row + 1] - begin;
    if (kMode == kDest && flag[row] == 0) deg = 0;   // zeros, no gathers
    const int seg = (deg + kWarps - 1) / kWarps;
    const int s_begin = begin + min(deg, warp * seg);
    const int s_end = begin + min(deg, (warp + 1) * seg);
    for (int c0 = 0; c0 < d4; c0 += 32) {
      part[warp][lane] = row_chunk<kMode>(cols, vals, flag, h, d4, c0 + lane,
                                          s_begin, s_end);
      __syncthreads();
      if (warp == 0 && c0 + lane < d4) {
        float4 acc = part[0][lane];
        for (int w = 1; w < kWarps; ++w) {
          acc.x += part[w][lane].x;
          acc.y += part[w][lane].y;
          acc.z += part[w][lane].z;
          acc.w += part[w][lane].w;
        }
        out[static_cast<size_t>(row) * d4 + c0 + lane] = acc;
      }
      __syncthreads();
    }
    return;
  }
  const int row = (blockIdx.x - n_heavy) * kWarps + warp;
  if (row >= n_rows) return;
  const int begin = row < n_graph ? rowptr[row] : 0;
  int end = row < n_graph ? rowptr[row + 1] : 0;
  if (end - begin > heavy_deg) return;          // a heavy block owns it
  if (kMode == kDest && flag[row] == 0) end = begin;   // zeros, no gathers
  for (int c0 = 0; c0 < d4; c0 += 32) {
    const int c = c0 + lane;
    const float4 acc = row_chunk<kMode>(cols, vals, flag, h, d4, c, begin,
                                        end);
    if (c < d4) out[static_cast<size_t>(row) * d4 + c] = acc;
  }
}

template <int kMode>
int launch(const int* rowptr, const int* cols, const float* vals,
           const int* heavy_rows, const uint8_t* flag, const float* h,
           float* out, int n_heavy, int heavy_deg, int n_graph, int n_rows,
           int d, void* stream) {
  const int blocks = n_heavy + (n_rows + kWarps - 1) / kWarps;
  spmm_csr_kernel<kMode><<<blocks, kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      rowptr, cols, vals, heavy_rows, n_heavy, heavy_deg, flag,
      reinterpret_cast<const float4*>(h), reinterpret_cast<float4*>(out),
      n_graph, n_rows, d / 4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// heavy_rows: the n_heavy rows with more than heavy_deg edges, ascending.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spmm_csr_f32(const int* rowptr, const int* cols,
                            const float* vals, const int* heavy_rows,
                            const float* h, float* out, int n_heavy,
                            int heavy_deg, int n_graph, int n_rows, int d,
                            void* stream) {
  return launch<kDense>(rowptr, cols, vals, heavy_rows, nullptr, h, out,
                        n_heavy, heavy_deg, n_graph, n_rows, d, stream);
}

// The batch-sparse hop (K6): flag holds one 0/1 byte per table row (n_rows);
// mode 1 masks edges by their output row's flag, mode 2 by their gathered
// row's flag.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue (1) for another mode.
extern "C" int spmm_csr_flagged_f32(const int* rowptr, const int* cols,
                                    const float* vals, const int* heavy_rows,
                                    const uint8_t* flag, const float* h,
                                    float* out, int n_heavy, int heavy_deg,
                                    int n_graph, int n_rows, int d, int mode,
                                    void* stream) {
  if (mode == kDest)
    return launch<kDest>(rowptr, cols, vals, heavy_rows, flag, h, out,
                         n_heavy, heavy_deg, n_graph, n_rows, d, stream);
  if (mode == kSrc)
    return launch<kSrc>(rowptr, cols, vals, heavy_rows, flag, h, out,
                        n_heavy, heavy_deg, n_graph, n_rows, d, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
