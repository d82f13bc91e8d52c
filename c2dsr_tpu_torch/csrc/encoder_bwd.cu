// Backward of one causal self-attention tower (post-norm), f32: dx and the
// gradient of every layer weight and of the final LayerNorm.
//
// Replaces the fused encoder backward Pallas kernel
// (c2dsr_tpu/ops/encoder_pallas.py, _fused_bwd / _bwd_kernel).  Like it, a
// block re-runs the forward of its rows (activations are cheaper to
// recompute than to keep from the forward launch), regenerates the forward's
// dropout masks from the seed (dropout.cuh: the same hash as encoder.cu), and
// walks the layers in reverse: final LN, LN2, FFN, LN1, out-projection, the
// per-head softmax through the pre-dropout probabilities, QKV.  An
// all-masked query row is the uniform average over the L real positions in
// the forward (as ops/encoder.py and encoder.cu have it); the softmax
// backward follows those probabilities, so such rows carry gradient.
//
// Bound on an H100 by operations: the backward proper does 24·N·d² + 8·N·L·d
// FLOPs per layer (N = B·L rows), the recomputed forward 12·N·d² + 4·N·L·d
// more, all in f32 FFMA.
//
// Shared memory.  The backward needs, besides the QKV rows, each layer's
// saved activations (x_in, qkv, p, o, xhat1, y1, f_pre, xhat2 and the two
// 1/std): about 10·d floats a row, which with the working buffers would
// overflow a block's 227 KB at 64 rows.  So a block holds kRowsB rows
// (kRowsB / L whole sequences; 32 rows up to d 128, 16 up to d 256) in six
// buffers (X, T, G, H of d + 4 floats a row, Q and D of 3·d + 1; 174 KB at
// d = 128, 173 KB at d = 256) and keeps the saved activations of its
// current rows in a per-block slice of a global workspace, where they stay
// in L2 between the forward recompute and the reverse walk.
//
// Weight gradients.  The TPU accumulated them over its sequential grid in a
// resident output block; blocks on the card run in parallel.  Here the grid
// is fixed at one block per SM (or fewer, when the tower has fewer row
// tiles); block b walks a contiguous range of row tiles and accumulates its
// own gradient partial in a workspace slice (written on its first tile,
// added to after).  A second kernel sums the partials in block order.  No
// atomics: the result is deterministic.

#include "encoder_common.cuh"

namespace {

using namespace tower;

// Rows held by one block at width d.
__host__ __device__ constexpr int bwd_rows(int d) { return d <= 128 ? 32 : 16; }

// Offsets (in floats) of each gradient in the flat gradient buffer: the
// stacked layer weights in the order of the kernel arguments, then lnf.
struct GradOff {
  size_t w_qkv, b_qkv, w_out, b_out, w_ff1, b_ff1, w_ff2, b_ff2;
  size_t ln1_s, ln1_b, ln2_s, ln2_b, lnf_s, lnf_b, total;
};

__host__ __device__ inline GradOff grad_offsets(int d, int nl) {
  GradOff o;
  size_t at = 0;
  o.w_qkv = at; at += (size_t)nl * d * 3 * d;
  o.b_qkv = at; at += (size_t)nl * 3 * d;
  o.w_out = at; at += (size_t)nl * d * d;
  o.b_out = at; at += (size_t)nl * d;
  o.w_ff1 = at; at += (size_t)nl * d * d;
  o.b_ff1 = at; at += (size_t)nl * d;
  o.w_ff2 = at; at += (size_t)nl * d * d;
  o.b_ff2 = at; at += (size_t)nl * d;
  o.ln1_s = at; at += (size_t)nl * d;
  o.ln1_b = at; at += (size_t)nl * d;
  o.ln2_s = at; at += (size_t)nl * d;
  o.ln2_b = at; at += (size_t)nl * d;
  o.lnf_s = at; at += d;
  o.lnf_b = at; at += d;
  o.total = at;
  return o;
}

// Offsets (in floats) of one layer's saved activations in a block's slice
// of `rows` rows; rows are dense (stride d, or 3·d for qkv), p is
// [head][row][key].  The slice is written and read again within one launch,
// so no pointer into it is __restrict__: the read-only cache path would not
// see the new values.
struct SaveOff {
  size_t x_in, qkv, p, o, xhat1, y1, f_pre, xhat2, r1, r2, layer;
};

__host__ __device__ inline SaveOff save_offsets(int d, int n_head, int L,
                                                int rows) {
  const size_t rd = (size_t)rows * d;
  SaveOff s;
  s.x_in = 0;
  s.qkv = rd;
  s.p = 4 * rd;
  s.o = s.p + (size_t)n_head * rows * L;
  s.xhat1 = s.o + rd;
  s.y1 = s.xhat1 + rd;
  s.f_pre = s.y1 + rd;
  s.xhat2 = s.f_pre + rd;
  s.r1 = s.xhat2 + rd;
  s.r2 = s.r1 + rows;
  s.layer = s.r2 + rows;
  return s;
}

// A block's saved slice: n_layers layers, then xhat and 1/std of the final LN.
__host__ __device__ inline size_t save_floats(int d, int n_head, int L,
                                              int n_layers) {
  const int rows = bwd_rows(d);
  return (size_t)n_layers * save_offsets(d, n_head, L, rows).layer +
         (size_t)rows * d + rows;
}

__device__ __forceinline__ void put(float* dst, float v, bool first) {
  *dst = first ? v : *dst + v;
}

// dst[k, m] (+)= sum_{r < R} A[r, k] B[r, m]: a weight gradient into the
// block's partial (global, row-major [K, M]).  K, M multiples of 4.
__device__ void gemm_tn_acc(const float* A, int lda, const float* B, int ldb,
                            int R, int K, int M, float* dst, bool first) {
  const int m4n = M / 4;
  for (int t = threadIdx.x; t < (K / 4) * m4n; t += kThreads) {
    const int k0 = (t / m4n) * 4;
    const int m0 = (t % m4n) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int r = 0; r < R; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = A[r * lda + k0 + i];
        b[i] = B[r * ldb + m0 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        put(dst + (size_t)(k0 + i) * M + m0 + j, acc[i][j], first);
  }
}

// dst[c] (+)= sum_{r < R} B[r, c]: a bias gradient into the partial.
__device__ void colsum_acc(const float* B, int ldb, int R, int M, float* dst,
                           bool first) {
  for (int c = threadIdx.x; c < M; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += B[r * ldb + c];
    put(dst + c, s, first);
  }
}

// LayerNorm backward, in place on G (row stride ldg) for r < R, with the
// saved xhat (stride d) and 1/std: the scale and bias gradients go into the
// partial, then G = rstd · (g·s - mean(g·s) - xhat · mean(g·s·xhat)).
template <int NV>
__device__ void ln_bwd(float* G, int ldg, const float* xhat,
                       const float* rstd,
                       const float* __restrict__ scale, int R, int d,
                       float* d_scale, float* d_bias, bool first) {
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float ss = 0.f, sb = 0.f;
    for (int r = 0; r < R; ++r) {
      const float g = G[r * ldg + c];
      ss = fmaf(g, xhat[r * d + c], ss);
      sb += g;
    }
    put(d_scale + c, ss, first);
    put(d_bias + c, sb, first);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += kThreads / 32) {
    float gs[NV], xh[NV];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int c = lane + 32 * t;
      gs[t] = xh[t] = 0.f;
      if (c < d) {
        gs[t] = G[r * ldg + c] * scale[c];
        xh[t] = xhat[r * d + c];
        m1 += gs[t];
        m2 += gs[t] * xh[t];
      }
    }
    m1 = warp_sum(m1) / d;
    m2 = warp_sum(m2) / d;
    const float rs = rstd[r];
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int c = lane + 32 * t;
      if (c < d) G[r * ldg + c] = rs * (gs[t] - m1 - xh[t] * m2);
    }
  }
  __syncthreads();
}

// dst[r, c] = src[r, c] for r < R, c < n (src in global memory, stride n).
__device__ void load_rows(float* dst, int ldd, const float* src, int R,
                          int n) {
  for (int v = threadIdx.x; v < R * n; v += kThreads)
    dst[(v / n) * ldd + v % n] = src[v];
  __syncthreads();
}

__device__ void store_rows(float* dst, const float* src, int lds, int R,
                           int n) {
  for (int v = threadIdx.x; v < R * n; v += kThreads)
    dst[v] = src[(v / n) * lds + v % n];
  __syncthreads();
}

template <int NV, int kRowsB>
__global__ void __launch_bounds__(kThreads, 1)
encoder_bwd_kernel(const float* __restrict__ x, const int* __restrict__ seq,
                   const float* __restrict__ gout, Layer l0, size_t s_qkv,
                   size_t s_dd, int n_layers, const float* __restrict__ lnf_s,
                   const float* __restrict__ lnf_b, float* __restrict__ dx,
                   float* saved_all, float* part_all,
                   int B, int L, int d, int n_head, int idx_pad, int invert,
                   drop::Dropout dr) {
  constexpr int kRpt = kRowsB / 16;
  extern __shared__ float4 smem4[];
  float* wt = reinterpret_cast<float*>(smem4);
  const int ldx = d + 4;
  const int ldq = 3 * d + 1;
  float* X = wt + kTileK * kTileM;
  float* T = X + kRowsB * ldx;
  float* G = T + kRowsB * ldx;
  float* H = G + kRowsB * ldx;
  float* Q = H + kRowsB * ldx;
  float* D = Q + kRowsB * ldq;
  int* key_ok = reinterpret_cast<int*>(D + kRowsB * ldq);

  const int S = kRowsB / L;
  const int n_tiles = (B + S - 1) / S;
  const int t_begin = (int)((long long)n_tiles * blockIdx.x / gridDim.x);
  const int t_end = (int)((long long)n_tiles * (blockIdx.x + 1) / gridDim.x);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dh = d / n_head;
  const float inv_sqrt_dh = 1.f / sqrtf(static_cast<float>(dh));
  const SaveOff so = save_offsets(d, n_head, L, kRowsB);
  const GradOff go = grad_offsets(d, n_layers);
  float* saved = saved_all + (size_t)blockIdx.x * save_floats(d, n_head, L,
                                                               n_layers);
  float* part = part_all + (size_t)blockIdx.x * go.total;
  float* xhat_f = saved + (size_t)n_layers * so.layer;
  float* rstd_f = xhat_f + (size_t)kRowsB * d;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const bool first = tile == t_begin;
    const int seq0 = tile * S;
    const int R = min(S, B - seq0) * L;
    const int row0 = seq0 * L;

    // ---- forward recompute, saving what the backward reads ----
    for (int v = tid; v < kRowsB * d; v += kThreads) {
      const int r = v / d;
      const int c = v % d;
      float val = 0.f;
      if (r < R) {
        val = x[(size_t)row0 * d + v];
        if (dr.on)
          val = dr.apply(val, dr.key(drop::kInput, 0),
                         static_cast<uint32_t>(row0 * d + v));
      }
      X[r * ldx + c] = val;
      T[r * ldx + c] = 0.f;
    }
    for (int r = tid; r < kRowsB; r += kThreads) {
      const bool real = r < R && seq[(size_t)row0 + r] != idx_pad;
      key_ok[r] = invert ? !real : real;
    }
    __syncthreads();

    for (int li = 0; li < n_layers; ++li) {
      float* sv = saved + (size_t)li * so.layer;
      const size_t ow = li * s_dd;
      const size_t ob = (size_t)li * d;
      store_rows(sv + so.x_in, X, ldx, R, d);
      gemm<kRpt>(X, ldx, l0.w_qkv + li * s_qkv, l0.b_qkv + li * 3 * d, d,
                 3 * d, Q, ldq, false, wt);
      store_rows(sv + so.qkv, Q, ldq, R, 3 * d);
      const uint32_t k_probs = dr.key(drop::kProbs, li);
      for (int q = warp; q < n_head * R; q += kThreads / 32) {
        const int h = q / R;
        const int r = q % R;
        const int s = r / L;
        const int i = r % L;
        const int rk = s * L + lane;
        float logit = -CUDART_INF_F;
        if (lane < L) {
          const float* qp = Q + r * ldq + h * dh;
          const float* kp = Q + rk * ldq + d + h * dh;
          float dot = 0.f;
          for (int c = 0; c < dh; ++c) dot = fmaf(qp[c], kp[c], dot);
          const bool ok = lane <= i && key_ok[rk];
          logit = dot * inv_sqrt_dh + (ok ? 0.f : kNeg);
        }
        const float mx = warp_max(logit);
        const float e = lane < L ? expf(logit - mx) : 0.f;
        float p = e / warp_sum(e);
        if (lane < L) sv[so.p + ((size_t)h * kRowsB + r) * L + lane] = p;
        if (dr.on)
          p = dr.apply(p, k_probs, static_cast<uint32_t>(
                                       (((seq0 + s) * n_head + h) * L + i) *
                                           L + lane));
        for (int c0 = 0; c0 < dh; c0 += 32) {
          const int c = c0 + lane;
          float acc = 0.f;
          for (int j = 0; j < L; ++j) {
            const float pj = __shfl_sync(0xffffffffu, p, j);
            if (c < dh)
              acc = fmaf(pj, Q[(s * L + j) * ldq + 2 * d + h * dh + c], acc);
          }
          if (c < dh) T[r * ldx + h * dh + c] = acc;
        }
      }
      __syncthreads();
      store_rows(sv + so.o, T, ldx, R, d);
      gemm<kRpt>(T, ldx, l0.w_out + ow, l0.b_out + ob, d, d, Q, ldq, false,
                 wt);
      if (dr.on) drop_rows(Q, ldq, R, d, row0, dr, dr.key(drop::kAttnOut, li));
      layer_norm_rows<NV>(X, ldx, Q, ldq, l0.ln1_s + ob, l0.ln1_b + ob, X, ldx, R, d,
                 sv + so.xhat1, sv + so.r1);
      store_rows(sv + so.y1, X, ldx, R, d);
      gemm<kRpt>(X, ldx, l0.w_ff1 + ow, l0.b_ff1 + ob, d, d, T, ldx, false,
                 wt);
      store_rows(sv + so.f_pre, T, ldx, R, d);
      {
        const uint32_t k = dr.key(drop::kFfnRelu, li);
        for (int v = tid; v < R * d; v += kThreads) {
          float* t = T + (v / d) * ldx + v % d;
          const float f = fmaxf(*t, 0.f);
          *t = dr.on ? dr.apply(f, k, static_cast<uint32_t>(row0 * d + v)) : f;
        }
        __syncthreads();
      }
      gemm<kRpt>(T, ldx, l0.w_ff2 + ow, l0.b_ff2 + ob, d, d, Q, ldq, false,
                 wt);
      if (dr.on) drop_rows(Q, ldq, R, d, row0, dr, dr.key(drop::kFfnOut, li));
      layer_norm_rows<NV>(X, ldx, Q, ldq, l0.ln2_s + ob, l0.ln2_b + ob, X, ldx, R, d,
                 sv + so.xhat2, sv + so.r2);
    }
    // final LN statistics (its output is not needed)
    layer_norm_rows<NV>(X, ldx, nullptr, 0, lnf_s, lnf_b, T, ldx, R, d, xhat_f, rstd_f);

    // ---- backward ----
    load_rows(G, ldx, gout + (size_t)row0 * d, R, d);
    ln_bwd<NV>(G, ldx, xhat_f, rstd_f, lnf_s, R, d, part + go.lnf_s,
               part + go.lnf_b, first);

    for (int li = n_layers - 1; li >= 0; --li) {
      const float* sv = saved + (size_t)li * so.layer;
      const size_t ow = li * s_dd;
      const size_t ob = (size_t)li * d;
      // LN2: z2 = y1 + drop(f_d W2 + b2)
      ln_bwd<NV>(G, ldx, sv + so.xhat2, sv + so.r2, l0.ln2_s + ob, R, d,
                 part + go.ln2_s + ob, part + go.ln2_b + ob, first);
      {
        const uint32_t kg = dr.key(drop::kFfnOut, li);
        const uint32_t kf = dr.key(drop::kFfnRelu, li);
        for (int v = tid; v < R * d; v += kThreads) {
          const int r = v / d;
          const int c = v % d;
          const uint32_t idx = static_cast<uint32_t>(row0 * d + v);
          const float g = G[r * ldx + c];
          T[r * ldx + c] = dr.on ? dr.apply(g, kg, idx) : g;
          const float f = fmaxf(sv[so.f_pre + v], 0.f);
          X[r * ldx + c] = dr.on ? dr.apply(f, kf, idx) : f;
        }
        __syncthreads();
      }
      gemm_tn_acc(X, ldx, T, ldx, R, d, d, part + go.w_ff2 + li * s_dd, first);
      colsum_acc(T, ldx, R, d, part + go.b_ff2 + ob, first);
      gemm_nt<kRpt>(T, ldx, l0.w_ff2 + ow, d, d, H, ldx, false, wt);
      {
        const uint32_t kf = dr.key(drop::kFfnRelu, li);
        for (int v = tid; v < R * d; v += kThreads) {
          const int r = v / d;
          const int c = v % d;
          float g = H[r * ldx + c];
          if (dr.on) g = dr.apply(g, kf, static_cast<uint32_t>(row0 * d + v));
          H[r * ldx + c] = sv[so.f_pre + v] > 0.f ? g : 0.f;
          X[r * ldx + c] = sv[so.y1 + v];
        }
        __syncthreads();
      }
      gemm_tn_acc(X, ldx, H, ldx, R, d, d, part + go.w_ff1 + li * s_dd, first);
      colsum_acc(H, ldx, R, d, part + go.b_ff1 + ob, first);
      gemm_nt<kRpt>(H, ldx, l0.w_ff1 + ow, d, d, G, ldx, true, wt);
      // LN1: z1 = x_in + drop(o W_out + b_out)
      ln_bwd<NV>(G, ldx, sv + so.xhat1, sv + so.r1, l0.ln1_s + ob, R, d,
                 part + go.ln1_s + ob, part + go.ln1_b + ob, first);
      {
        const uint32_t ka = dr.key(drop::kAttnOut, li);
        for (int v = tid; v < R * d; v += kThreads) {
          const int r = v / d;
          const int c = v % d;
          const float g = G[r * ldx + c];
          T[r * ldx + c] =
              dr.on ? dr.apply(g, ka, static_cast<uint32_t>(row0 * d + v)) : g;
          X[r * ldx + c] = sv[so.o + v];
        }
        __syncthreads();
      }
      gemm_tn_acc(X, ldx, T, ldx, R, d, d, part + go.w_out + li * s_dd, first);
      colsum_acc(T, ldx, R, d, part + go.b_out + ob, first);
      gemm_nt<kRpt>(T, ldx, l0.w_out + ow, d, d, H, ldx, false, wt);  // d_o
      load_rows(Q, ldq, sv + so.qkv, R, 3 * d);

      // attention backward, head by head; X and T (contiguous, free until
      // x_in is reloaded below) hold ds and the dropped probs, 2·kRowsB·L
      // floats, which T alone would not hold for L > (d + 4) / 2
      float* DS = X;
      float* PD = X + kRowsB * L;
      const uint32_t k_probs = dr.key(drop::kProbs, li);
      for (int h = 0; h < n_head; ++h) {
        // per query row r = (s, i): ds over keys j, and dq
        for (int r = warp; r < R; r += kThreads / 32) {
          const int s = r / L;
          const int i = r % L;
          const int rk = s * L + lane;
          float p = 0.f, dp = 0.f, pd = 0.f;
          if (lane < L) {
            p = sv[so.p + ((size_t)h * kRowsB + r) * L + lane];
            float dot = 0.f;
            for (int c = 0; c < dh; ++c)
              dot = fmaf(H[r * ldx + h * dh + c],
                         Q[rk * ldq + 2 * d + h * dh + c], dot);
            dp = dot;
            pd = p;
            if (dr.on) {
              const uint32_t idx = static_cast<uint32_t>(
                  (((seq0 + s) * n_head + h) * L + i) * L + lane);
              dp = dr.apply(dot, k_probs, idx);
              pd = dr.apply(p, k_probs, idx);
            }
          }
          const float dot_pp = warp_sum(dp * p);
          const float ds = p * (dp - dot_pp);
          if (lane < L) {
            DS[r * L + lane] = ds;
            PD[r * L + lane] = pd;
          }
          for (int c0 = 0; c0 < dh; c0 += 32) {
            const int c = c0 + lane;
            float acc = 0.f;
            for (int j = 0; j < L; ++j) {
              const float dsj = __shfl_sync(0xffffffffu, ds, j);
              if (c < dh)
                acc = fmaf(dsj, Q[(s * L + j) * ldq + d + h * dh + c], acc);
            }
            if (c < dh) D[r * ldq + h * dh + c] = acc * inv_sqrt_dh;
          }
        }
        __syncthreads();
        // per key row r = (s, j): dk and dv
        for (int r = warp; r < R; r += kThreads / 32) {
          const int s = r / L;
          const int j = r % L;
          const int ri = s * L + lane;
          const float ds = lane < L ? DS[ri * L + j] : 0.f;
          const float pd = lane < L ? PD[ri * L + j] : 0.f;
          for (int c0 = 0; c0 < dh; c0 += 32) {
            const int c = c0 + lane;
            float ak = 0.f, av = 0.f;
            for (int i = 0; i < L; ++i) {
              const float dsi = __shfl_sync(0xffffffffu, ds, i);
              const float pdi = __shfl_sync(0xffffffffu, pd, i);
              if (c < dh) {
                ak = fmaf(dsi, Q[(s * L + i) * ldq + h * dh + c], ak);
                av = fmaf(pdi, H[(s * L + i) * ldx + h * dh + c], av);
              }
            }
            if (c < dh) {
              D[r * ldq + d + h * dh + c] = ak * inv_sqrt_dh;
              D[r * ldq + 2 * d + h * dh + c] = av;
            }
          }
        }
        __syncthreads();
      }
      load_rows(X, ldx, sv + so.x_in, R, d);
      gemm_tn_acc(X, ldx, D, ldq, R, d, 3 * d, part + go.w_qkv + li * s_qkv,
                  first);
      colsum_acc(D, ldq, R, 3 * d, part + go.b_qkv + (size_t)li * 3 * d,
                 first);
      gemm_nt<kRpt>(D, ldq, l0.w_qkv + li * s_qkv, d, 3 * d, G, ldx, true, wt);
    }
    // input dropout, then dx
    const uint32_t k_in = dr.key(drop::kInput, 0);
    for (int v = tid; v < R * d; v += kThreads) {
      const float g = G[(v / d) * ldx + v % d];
      dx[(size_t)row0 * d + v] =
          dr.on ? dr.apply(g, k_in, static_cast<uint32_t>(row0 * d + v)) : g;
    }
    __syncthreads();
  }
}

// grads[i] = sum over blocks b (in order) of part[b][i].
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    int n_parts, size_t total,
                                    float* __restrict__ grads) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < n_parts; ++b) s += part[(size_t)b * total + i];
    grads[i] = s;
  }
}

int smem_bytes(int d) {
  const int rows = bwd_rows(d);
  return static_cast<int>(sizeof(float)) *
             (kTileK * kTileM + 4 * rows * (d + 4) + 2 * rows * (3 * d + 1)) +
         static_cast<int>(sizeof(int)) * rows;
}

}  // namespace

// The backward's grid for B sequences of length L at width d: one block per
// SM, or one per row tile when there are fewer tiles.
extern "C" int encoder_bwd_grid(int B, int L, int d) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int S = bwd_rows(d) / L;
  const int tiles = (B + S - 1) / S;
  return tiles < sms ? tiles : sms;
}

// Floats of the workspace the backward needs: per block, the saved
// activations of its rows and its gradient partial.
extern "C" long long encoder_bwd_workspace_floats(int d, int n_head, int L,
                                                  int n_layers, int grid) {
  return (long long)grid * (save_floats(d, n_head, L, n_layers) +
                            grad_offsets(d, n_layers).total);
}

// Floats of the flat gradient buffer (grad_offsets: the stacked layer
// weights in argument order, then lnf scale and bias).
extern "C" long long encoder_bwd_grad_floats(int d, int n_layers) {
  return (long long)grad_offsets(d, n_layers).total;
}

// Same weights, shapes and requirements as encoder_fwd_f32; gout the
// gradient of the tower's output, dx [B, L, d] out, grads the flat buffer,
// workspace of encoder_bwd_workspace_floats for `grid` blocks.  The dropout
// arguments must be those of the forward launch.  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int encoder_bwd_f32(
    const float* x, const int* seq, const float* gout, const float* w_qkv,
    const float* b_qkv, const float* w_out, const float* b_out,
    const float* w_ff1, const float* b_ff1, const float* w_ff2,
    const float* b_ff2, const float* ln1_s, const float* ln1_b,
    const float* ln2_s, const float* ln2_b, const float* lnf_s,
    const float* lnf_b, float* dx, float* grads, float* workspace, int grid,
    int B, int L, int d, int n_head, int n_layers, int idx_pad, int invert,
    int drop_on, unsigned drop_thr, float drop_div, unsigned seed,
    int tower_id, void* stream) {
  const int smem = smem_bytes(d);
  auto kernel = d <= 64    ? encoder_bwd_kernel<2, bwd_rows(64)>
                : d <= 128 ? encoder_bwd_kernel<4, bwd_rows(128)>
                           : encoder_bwd_kernel<8, bwd_rows(256)>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Layer l0{w_qkv, b_qkv, w_out, b_out, w_ff1, b_ff1, w_ff2, b_ff2,
           ln1_s, ln1_b, ln2_s, ln2_b};
  const size_t saved = (size_t)grid * save_floats(d, n_head, L, n_layers);
  float* part = workspace + saved;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<grid, kThreads, smem, s>>>(
      x, seq, gout, l0, (size_t)d * 3 * d, (size_t)d * d, n_layers, lnf_s,
      lnf_b, dx, workspace, part, B, L, d, n_head, idx_pad, invert,
      drop::Dropout{drop_on, drop_thr, drop_div, seed, tower_id});
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = grad_offsets(d, n_layers).total;
  sum_partials_kernel<<<(int)((total + 255) / 256), 256, 0, s>>>(
      part, grid, total, grads);
  return static_cast<int>(cudaGetLastError());
}
