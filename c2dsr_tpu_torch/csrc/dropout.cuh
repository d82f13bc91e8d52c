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
struct Dropout {
  int on;
  uint32_t thr;
  float div;
  uint32_t seed;
  int tower;

  __host__ __device__ __forceinline__ uint32_t key(int site,
                                                   int layer) const {
    return mix32(seed ^ mix32(static_cast<uint32_t>(site + 8 * layer +
                                                    1024 * tower) + kGolden));
  }
  // x dropped at element `index` of the stream `key`; also the backward of
  // the same mask applied to a gradient.
  __device__ __forceinline__ float apply(float x, uint32_t k,
                                         uint32_t index) const {
    return mix32((index * kGolden) ^ k) >= thr ? x / div : 0.f;
  }
};

}  // namespace drop
