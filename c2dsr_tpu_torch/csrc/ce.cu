// Fused linear + softmax cross-entropy over [h·W + b_masked | pad], f32:
// the forward (K4) and the two backward kernels (K5).
//
// Replaces the fused CE Pallas kernels (c2dsr_tpu/ops/fused_ce.py):
// _fwd_kernel (forward), _bwd_merged_kernel, _bwd_dh_kernel and
// _bwd_dw_kernel (backward).  None of them writes a logit to device memory:
// each recomputes its [64 x 64] tile of h·W + b in registers.
//
// Bound on an H100 by operations: the forward does 2·N·V·d FLOPs, the
// backward 4·N·V·d (dh and dW/db) plus the recomputed logits, in f32 FFMA;
// the bytes (h, W once, a few floats a row) are small beside them.
//
// * ce_fwd_kernel: a block holds 64 rows of h in shared memory and sweeps
//   one split of V in 64-column tiles of W (staged in shared memory); the
//   splits (ce_splits: about 8 waves of blocks, since N / 64 row tiles alone
//   leave most SMs with one block) are merged per row by a second small
//   kernel, in split order.  Each thread keeps a
//   4x4 logit tile in registers and, for its 4 rows, a running (max,
//   sum-exp) merged over the 16 threads of a row group by shuffles.  The
//   target logit is picked where the column matches; the pad-class logit is
//   folded in at the merge, as in _fwd_kernel at its last vocab block.  The TPU's vocab padding and
//   _pick_blocks stripes do not carry over: V is taken as stored (V % 4 ==
//   0) and the ragged last tile is masked.  A target >= V (an ignored row
//   whose ignore index n_real equals V) matches no column: its target logit
//   is 0, and the caller masks it.
// * ce_dh_kernel: the same row tiles and vocab splits; dlogits = dlse·p +
//   dt·onehot goes through shared memory into dh += dlogits · W_tileᵀ; the
//   splits' partial dh are summed in split order by a second kernel.
// * ce_dw_kernel: a block holds 64 columns of W and sweeps the rows; dW +=
//   h_tileᵀ · dlogits, db += column sums of dlogits.
// Each output element is written once, by one thread, for any N: no atomics,
// a deterministic result, and the merged and split backward paths of the
// Pallas version are one path here.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;           // rows per tile
constexpr int kBV = 64;           // vocab columns per tile
constexpr int kLdw = kBV + 4;     // W tile row stride (float4-aligned)
constexpr int kLdp = kBV + 4;     // dlogits tile row stride

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// hs[r, k] = h[row0 + r, k] for r < kBN (zero past N); row stride d + 4.
__device__ void load_h(float* hs, const float* __restrict__ h, int row0,
                       int N, int d) {
  const int d4 = d / 4;
  for (int v = threadIdx.x; v < kBN * d4; v += kThreads) {
    const int r = v / d4;
    const int c4 = v % d4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < N)
      val = __ldg(reinterpret_cast<const float4*>(h + (size_t)(row0 + r) * d) +
                  c4);
    *reinterpret_cast<float4*>(hs + r * (d + 4) + c4 * 4) = val;
  }
}

// ws[k, c] = W[k, v0 + c] for c < kBV (zero past V).
__device__ void load_w(float* ws, const float* __restrict__ w, int v0, int V,
                       int d) {
  for (int v = threadIdx.x; v < d * (kBV / 4); v += kThreads) {
    const int k = v / (kBV / 4);
    const int c4 = v % (kBV / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (v0 + c4 * 4 < V)
      val = __ldg(reinterpret_cast<const float4*>(w + (size_t)k * V + v0) + c4);
    *reinterpret_cast<float4*>(ws + k * kLdw + c4 * 4) = val;
  }
}

// Component i of v (i a compile-time constant after unrolling).
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][j] = logit of row ty*4+i, column v0 + tx*4+j: h·W + b, or -inf past
// V.  The sum over k runs in order; h is read 4 k-steps at a time as float4,
// so a warp's k-step costs 3 shared-memory wavefronts for 16 FMAs a thread.
__device__ __forceinline__ void logit_tile(const float* hs, const float* ws,
                                           const float* __restrict__ b,
                                           int v0, int V, int d,
                                           float acc[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < d; k += 4) {
    float4 a4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a4[i] = *reinterpret_cast<const float4*>(hs + (ty * 4 + i) * (d + 4) + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w4 =
          *reinterpret_cast<const float4*>(ws + (k + kk) * kLdw + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = comp(a4[i], kk);
        acc[i][0] = fmaf(a, w4.x, acc[i][0]);
        acc[i][1] = fmaf(a, w4.y, acc[i][1]);
        acc[i][2] = fmaf(a, w4.z, acc[i][2]);
        acc[i][3] = fmaf(a, w4.w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = v0 + tx * 4 + j;
    const float bj = col < V ? b[col] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[i][j] = col < V ? acc[i][j] + bj : -CUDART_INF_F;
  }
}

// The vocab range [v_begin, v_end) of split blockIdx.y: whole 64-column
// tiles, the splits as even as the tile count allows.
__device__ __forceinline__ void split_range(int V, int& v_begin, int& v_end) {
  const int tiles = (V + kBV - 1) / kBV;
  const int per = (tiles + gridDim.y - 1) / gridDim.y;
  v_begin = min(V, blockIdx.y * per * kBV);
  v_end = min(V, (blockIdx.y + 1) * per * kBV);
}

// Per row and split: the running max, sum-exp and target logit over the
// split's columns, into part [3][splits][N].
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
              const float* __restrict__ b, const int* __restrict__ tgt,
              float* __restrict__ part, int N, int d, int V) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);
  float* ws = hs + kBN * (d + 4);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kBN;
  load_h(hs, h, row0, N, d);
  float m[4], s[4], t[4];
  int tg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    m[i] = -CUDART_INF_F;
    s[i] = 0.f;
    t[i] = 0.f;
    tg[i] = row < N ? tgt[row] : -1;
  }
  int v_begin, v_end;
  split_range(V, v_begin, v_end);
  for (int v0 = v_begin; v0 < v_end; v0 += kBV) {
    __syncthreads();
    load_w(ws, w, v0, V, d);
    __syncthreads();
    float acc[4][4];
    logit_tile(hs, ws, b, v0, V, d, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mx = fmaxf(mx, acc[i][j]);
        const int col = v0 + tx * 4 + j;
        if (col < V && col == tg[i]) t[i] = acc[i][j];
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) e += expf(acc[i][j] - m_new);
      s[i] = s[i] * expf(m[i] - m_new) + group16_sum(e);
      m[i] = m_new;
    }
  }
  const size_t at = (size_t)blockIdx.y * N;
  const size_t plane = (size_t)gridDim.y * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    const float tl = group16_sum(t[i]);
    if (tx == 0 && row < N) {
      part[at + row] = m[i];
      part[plane + at + row] = s[i];
      part[2 * plane + at + row] = tl;
    }
  }
}

// Merges the splits' partials in split order, folds in the pad-class logit
// (as _fwd_kernel does at its last vocab block) and writes lse and tlog.
__global__ void ce_fwd_merge_kernel(const float* __restrict__ part,
                                    const float* __restrict__ pad,
                                    int splits, int N,
                                    float* __restrict__ lse,
                                    float* __restrict__ tlog) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t plane = (size_t)splits * N;
  float m = -CUDART_INF_F;
  for (int k = 0; k < splits; ++k) m = fmaxf(m, part[(size_t)k * N + row]);
  float s = 0.f, t = 0.f;
  for (int k = 0; k < splits; ++k) {
    const float mk = part[(size_t)k * N + row];
    if (mk > -CUDART_INF_F) s += part[plane + (size_t)k * N + row] * expf(mk - m);
    t += part[2 * plane + (size_t)k * N + row];
  }
  const float p = pad[row];
  const float m_fin = fmaxf(m, p);
  const float s_fin = s * expf(m - m_fin) + expf(p - m_fin);
  lse[row] = m_fin + logf(s_fin);
  tlog[row] = t;
}

// dlogits of the tile into P[r, c] (row stride kLdp): dlse·exp(logit - lse)
// + dt where the column is the target; zero past N and past V.
__device__ __forceinline__ void dlogit_tile(
    const float acc[4][4], const float* __restrict__ lse,
    const float* __restrict__ dlse, const float* __restrict__ dt,
    const int* __restrict__ tgt, int row0, int v0, int N, int V, float* P) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int row = row0 + r;
    const bool ok = row < N;
    const float l = ok ? lse[row] : 0.f;
    const float gl = ok ? dlse[row] : 0.f;
    const float gt = ok ? dt[row] : 0.f;
    const int tg = ok ? tgt[row] : -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = v0 + tx * 4 + j;
      float g = ok ? gl * expf(acc[i][j] - l) : 0.f;
      if (col < V && col == tg) g += gt;
      P[r * kLdp + tx * 4 + j] = g;
    }
  }
}

// dh: a block per 64 rows and vocab split; thread (ty, tx) owns rows
// ty*4..+3 and columns k = tx + 16·jj of dh (jj < d / 16).  Each split
// writes its partial dh into part [splits][N][d].
__global__ void __launch_bounds__(kThreads)
ce_dh_kernel(const float* __restrict__ h, const float* __restrict__ w,
             const float* __restrict__ b, const float* __restrict__ lse,
             const float* __restrict__ dlse, const float* __restrict__ dt,
             const int* __restrict__ tgt, float* __restrict__ part, int N,
             int d, int V) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);
  float* ws = hs + kBN * (d + 4);
  float* P = ws + d * kLdw;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kBN;
  const int nk = d / 16;
  load_h(hs, h, row0, N, d);
  float out[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) out[i][jj] = 0.f;
  int v_begin, v_end;
  split_range(V, v_begin, v_end);
  for (int v0 = v_begin; v0 < v_end; v0 += kBV) {
    __syncthreads();
    load_w(ws, w, v0, V, d);
    __syncthreads();
    float acc[4][4];
    logit_tile(hs, ws, b, v0, V, d, acc);
    dlogit_tile(acc, lse, dlse, dt, tgt, row0, v0, N, V, P);
    __syncthreads();
    // 4 columns at a time: dlogit rows and W rows as float4, in column order
    for (int c = 0; c < kBV; c += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(P + (ty * 4 + i) * kLdp + c);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (jj < nk) {
          const float4 wk =
              *reinterpret_cast<const float4*>(ws + (tx + 16 * jj) * kLdw + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float o = out[i][jj];
            o = fmaf(pr[i].x, wk.x, o);
            o = fmaf(pr[i].y, wk.y, o);
            o = fmaf(pr[i].z, wk.z, o);
            out[i][jj] = fmaf(pr[i].w, wk.w, o);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= N) continue;
    float* dst = part + ((size_t)blockIdx.y * N + row) * d;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      if (jj < nk) dst[tx + 16 * jj] = out[i][jj];
  }
}

// dh[i] = sum over splits k, in order, of part[k][i].
__global__ void ce_dh_merge_kernel(const float* __restrict__ part,
                                   int splits, size_t n,
                                   float* __restrict__ dh) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < splits; ++k) acc += part[(size_t)k * n + i];
    dh[i] = acc;
  }
}

// dW, db: a block per 64 vocab columns; thread (ty, tx) owns columns
// tx*4..+3 and rows k = ty*8..+7 of dW (read from h as two float4s a row);
// threads of ty == 0 also own db.
__global__ void __launch_bounds__(kThreads)
ce_dw_kernel(const float* __restrict__ h, const float* __restrict__ w,
             const float* __restrict__ b, const float* __restrict__ lse,
             const float* __restrict__ dlse, const float* __restrict__ dt,
             const int* __restrict__ tgt, float* __restrict__ dw,
             float* __restrict__ db, int N, int d, int V) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);
  float* ws = hs + kBN * (d + 4);
  float* P = ws + d * kLdw;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int v0 = blockIdx.x * kBV;
  const int k0 = ty * 8;                 // d % 8 == 0: all 8 rows or none
  load_w(ws, w, v0, V, d);
  float out[8][4], dbs[4];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[jj][j] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) dbs[j] = 0.f;
  for (int row0 = 0; row0 < N; row0 += kBN) {
    __syncthreads();
    load_h(hs, h, row0, N, d);
    __syncthreads();
    float acc[4][4];
    logit_tile(hs, ws, b, v0, V, d, acc);
    dlogit_tile(acc, lse, dlse, dt, tgt, row0, v0, N, V, P);
    __syncthreads();
    for (int r = 0; r < kBN; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(P + r * kLdp + tx * 4);
      if (k0 < d) {
        const float4 h4[2] = {
            *reinterpret_cast<const float4*>(hs + r * (d + 4) + k0),
            *reinterpret_cast<const float4*>(hs + r * (d + 4) + k0 + 4)};
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float a = comp(h4[jj / 4], jj % 4);
          out[jj][0] = fmaf(a, p4.x, out[jj][0]);
          out[jj][1] = fmaf(a, p4.y, out[jj][1]);
          out[jj][2] = fmaf(a, p4.z, out[jj][2]);
          out[jj][3] = fmaf(a, p4.w, out[jj][3]);
        }
      }
      if (ty == 0) {
        dbs[0] += p4.x;
        dbs[1] += p4.y;
        dbs[2] += p4.z;
        dbs[3] += p4.w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = v0 + tx * 4 + j;
    if (col >= V) continue;
    if (k0 < d) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) dw[(size_t)(k0 + jj) * V + col] = out[jj][j];
    }
    if (ty == 0) db[col] = dbs[j];
  }
}

int tile_smem(int d, bool with_p) {
  return static_cast<int>(sizeof(float)) *
         (kBN * (d + 4) + d * kLdw + (with_p ? kBN * kLdp : 0));
}

}  // namespace

// The number of vocab splits for N rows and V columns: enough blocks for
// about 8 waves of one block per SM, at most one 64-column tile a split.
extern "C" int ce_splits(int N, int V) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int row_tiles = (N + kBN - 1) / kBN;
  const int v_tiles = (V + kBV - 1) / kBV;
  const int want = (8 * sms + row_tiles - 1) / row_tiles;
  return want < 1 ? 1 : (want > v_tiles ? v_tiles : want);
}

// h [N, d], w [d, V] row-major, b [V] (-1e9 on padded columns), pad [N],
// tgt [N] -> lse [N], tlog [N]; workspace of 3 · splits · N floats.
// d % 16 == 0, d <= 128, V % 4 == 0.  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int ce_fwd_f32(const float* h, const float* w, const float* b,
                          const float* pad, const int* tgt, float* lse,
                          float* tlog, float* workspace, int splits, int N,
                          int d, int V, void* stream) {
  const int smem = tile_smem(d, false);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_fwd_kernel<<<dim3((N + kBN - 1) / kBN, splits), kThreads, smem, s>>>(
      h, w, b, tgt, workspace, N, d, V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_fwd_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(workspace, pad, splits,
                                                      N, lse, tlog);
  return static_cast<int>(cudaGetLastError());
}

// The backward from the forward's inputs, its lse and the gradients dlse,
// dt of (lse, tlog): dh [N, d], dw [d, V], db [V]; workspace of
// splits · N · d floats.  Same shape rules.
extern "C" int ce_bwd_f32(const float* h, const float* w, const float* b,
                          const float* lse, const float* dlse,
                          const float* dt, const int* tgt, float* dh,
                          float* dw, float* db, float* workspace, int splits,
                          int N, int d, int V, void* stream) {
  const int smem = tile_smem(d, true);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      ce_dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        ce_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_dh_kernel<<<dim3((N + kBN - 1) / kBN, splits), kThreads, smem, s>>>(
      h, w, b, lse, dlse, dt, tgt, workspace, N, d, V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = (size_t)N * d;
  ce_dh_merge_kernel<<<(int)((n + 255) / 256), 256, 0, s>>>(workspace, splits,
                                                            n, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_dw_kernel<<<(V + kBV - 1) / kBV, kThreads, smem, s>>>(
      h, w, b, lse, dlse, dt, tgt, dw, db, N, d, V);
  return static_cast<int>(cudaGetLastError());
}
