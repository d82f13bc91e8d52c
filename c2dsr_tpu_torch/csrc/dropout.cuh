// Counter-based dropout keep decision shared by the encoder kernels
// (encoder.cu, encoder_bwd.cu, whose host code computes the keys too).  The
// same function in integer tensor ops is c2dsr_tpu_torch/ops/dropout.py,
// which documents it: a kernel and its plain version draw bit-identical
// masks, and a backward regenerates its forward's masks from the seed
// alone, with no mask in device memory.
#pragma once

#include <cstdint>

namespace drop {

constexpr uint32_t kGolden = 0x9E3779B1u;

// dropout sites (ops/dropout.py)
constexpr int kInput = 0, kProbs = 1, kAttnOut = 2, kFfnRelu = 3, kFfnOut = 4;

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// One tower call's dropout: rate p as a threshold on 32 random bits and the
// divisor f32(1 - p) of kept values.  on == 0 is eval.
//
// The element index is that of the run's whole batch, of which a data rank's
// tower call holds some rows: with seg != 0, the call's batch row b is row
// batch(b) = (b / seg) * stride + off + b % seg of the run's (a rank's
// B / n_data rows at offset off of each of the call's stacked segments of
// stride rows; the shared tower stacks three).  seg == 0 is the identity: a
// one-process call.  The kernels whose sites index elements by row take the
// map as a template argument (kMap, true where mapped()), so that a call
// without it runs the one-process index arithmetic and nothing more;
// row_index and flat_index are the mapped indices, for kMap only.  L is the
// sequence length, row_x = L * d the elements of a batch row of a [B, L, d]
// site.
struct Dropout {
  int on;
  uint32_t thr;
  float div;
  uint32_t seed;
  int tower;
  uint32_t off, seg, stride, L, row_x;

  __host__ __device__ __forceinline__ uint32_t key(int site,
                                                   int layer) const {
    return mix32(seed ^ mix32(static_cast<uint32_t>(site + 8 * layer +
                                                    1024 * tower) + kGolden));
  }
  // whether the call's rows are mapped: its kernels take kMap
  __host__ __device__ __forceinline__ bool mapped() const {
    return on && seg != 0;
  }
  // the run's batch row of this call's batch row b (once a sequence, in
  // the attention kernels, which are not templated on the map)
  __device__ __forceinline__ uint32_t batch(uint32_t b) const {
    return seg == 0 ? b : (b / seg) * stride + off + b % seg;
  }
  // mapped(): the index of element 0 of row r of a [B * L, m] site
  // (wrapping mod 2^32 as ops/dropout.py does)
  __device__ __forceinline__ uint32_t row_index(uint32_t r,
                                                uint32_t m) const {
    return (batch(r / L) * L + r % L) * m;
  }
  // mapped(): the index of flat element i of a [B, L, d] site
  __device__ __forceinline__ uint32_t flat_index(uint32_t i) const {
    const uint32_t b = i / row_x;
    return batch(b) * row_x + (i - b * row_x);
  }
  // x dropped at element `index` of the stream `key`; also the backward of
  // the same mask applied to a gradient.
  __device__ __forceinline__ float apply(float x, uint32_t k,
                                         uint32_t index) const {
    return mix32((index * kGolden) ^ k) >= thr ? x / div : 0.f;
  }
};

// The dropout of a tower call (L, d) from the C entry points' arguments.
inline Dropout make(int on, uint32_t thr, float div, uint32_t seed,
                    int tower, uint32_t off, uint32_t seg, uint32_t stride,
                    int L, int d) {
  return Dropout{on, thr, div, seed, tower, off, seg, stride,
                 static_cast<uint32_t>(L),
                 static_cast<uint32_t>(L) * static_cast<uint32_t>(d)};
}

}  // namespace drop
