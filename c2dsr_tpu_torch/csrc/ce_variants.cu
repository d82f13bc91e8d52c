// K4's experiment variants (ce_fwd.cuh, Variant) at DT 128: the CUDA
// counterpart of the TPU experiment kernels of bench/ce_experiments.py
// (_mk_kernel, built per variant by variant_fn), which time the CE forward
// with one per-logit operation taken away at a time.  They run only in the
// port's bench (c2dsr_tpu_torch/bench/ce_variants.py), never in training,
// and live in their own library so that the production one (ce.cu) does
// not grow.  Each call runs the production pre-pass (Wᵀ's TF32 split), the
// variant's kernel at the split count the caller passes (ce_fwd_plan's),
// and a merge of the splits in split order: base, nomatch and bf16exp by
// the production merge, exp2 (lse in log2 units, pad already scaled) and
// matmulonly (a plain sum of the partial row sums) by their own.  Bound
// as K4: operations (2·N·V·d FLOPs as 3xTF32 on the tensor cores).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ce_fwd.cuh"

namespace {

constexpr int kDT = 128;

template <int VARIANT>
__global__ void ce_variant_merge_kernel(const float* __restrict__ part,
                                        const float* __restrict__ pad,
                                        int splits, int N,
                                        float* __restrict__ lse,
                                        float* __restrict__ tlog) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t plane = (size_t)splits * N;
  if (VARIANT == kMatmulOnly) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[plane + (size_t)k * N + row];
    lse[row] = s;
    tlog[row] = 0.f;
    return;
  }
  // kExp2: the production merge without the scales into and out of log2
  // units
  float m = -CUDART_INF_F;
  for (int k = 0; k < splits; ++k) m = fmaxf(m, part[(size_t)k * N + row]);
  float s = 0.f, t = 0.f;
  for (int k = 0; k < splits; ++k) {
    s += part[plane + (size_t)k * N + row] *
         exp2f(part[(size_t)k * N + row] - m);
    t += part[2 * plane + (size_t)k * N + row];
  }
  const float p = pad[row];
  const float m_fin = fmaxf(m, p);
  const float s_fin = s * exp2f(m - m_fin) + exp2f(p - m_fin);
  lse[row] = m_fin + log2f(s_fin);
  tlog[row] = t;
}

template <int VARIANT>
cudaError_t launch(const FwdArgs& a, const float* pad, float* lse,
                   float* tlog, int splits, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      ce_fwd_kernel<kDT, VARIANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tile_smem<kDT>());
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_x + BwdCfg<kDT>::kBx - 1) / BwdCfg<kDT>::kBx, splits);
  ce_fwd_kernel<kDT, VARIANT>
      <<<grid, BwdCfg<kDT>::kThreads, tile_smem<kDT>(), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = (a.n_x + 255) / 256;
  if (VARIANT == kExp2 || VARIANT == kMatmulOnly)
    ce_variant_merge_kernel<VARIANT>
        <<<blocks, 256, 0, s>>>(a.part, pad, splits, a.n_x, lse, tlog);
  else
    ce_fwd_merge_kernel<<<blocks, 256, 0, s>>>(a.part, pad, splits, a.n_x,
                                                lse, tlog);
  return cudaGetLastError();
}

}  // namespace

// Variant `variant` (0 base, 1 nomatch, 2 exp2, 3 bf16exp, 4 matmulonly)
// of K4 over h [N, d], w [d, V], b [V], pad [N], tgt [N] -> lse [N],
// tlog [N], with `splits` vocab splits.  workspace: 2·V·d + 3·splits·N
// floats.  All pointers 16-byte aligned; d % 4 == 0, d <= 128, V % 4 == 0.
// Returns cudaGetLastError() after the launches (0 = launched; 1 for a
// variant or width this library does not have).
extern "C" int ce_variant_fwd_f32(int variant, const float* h, const float* w,
                                  const float* b, const float* pad,
                                  const int* tgt, float* lse, float* tlog,
                                  float* workspace, int splits, int N, int d,
                                  int V, void* stream) {
  if (d > kDT || variant < 0 || variant > kMatmulOnly) return 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t vd = (size_t)V * d;
  float* wt_big = workspace;
  float* wt_small = wt_big + vd;
  float* part = wt_small + vd;
  transpose_split_kernel<<<dim3((V + 31) / 32, (d + 31) / 32), dim3(32, 8), 0,
                           s>>>(w, nullptr, wt_big, wt_small, d, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const FwdArgs a{h, wt_big, wt_small, b, tgt, part, N, d, V};
  switch (variant) {
    case kBase: err = launch<kBase>(a, pad, lse, tlog, splits, s); break;
    case kNoMatch: err = launch<kNoMatch>(a, pad, lse, tlog, splits, s); break;
    case kExp2: err = launch<kExp2>(a, pad, lse, tlog, splits, s); break;
    case kBf16Exp: err = launch<kBf16Exp>(a, pad, lse, tlog, splits, s); break;
    default: err = launch<kMatmulOnly>(a, pad, lse, tlog, splits, s); break;
  }
  return static_cast<int>(err);
}
