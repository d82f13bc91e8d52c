// The towers' GEMM tile past d 256 (encoder.cu's products with a weight,
// encoder_bwd.cu's dX = dY·Wᵀ), written for Hopper: warpgroup MMAs (wgmma)
// on operands that the Tensor Memory Accelerator (TMA) brings into a ring
// of shared-memory stages.  Up to d 256 the towers keep tc.cuh's 64-row
// mma.sync tile (gemm_tile, gemm_tile_bf16), whose LayerNorm epilogue holds
// whole rows; past it nothing ties the tile to d.
//
// A block of kThreads threads computes a kRows x kCols tile of C = A·B over
// all of k, A [n, k] f32 row-major and B the product's weight as
// [m, k] rows, k contiguous ("K-major"), with row-wise C out of the
// accumulators in the m16n8 C layout (tc.cuh's mma_tf32 note), so the
// kernels' epilogues take it as they took gemm_tile's:
// * kWarpgroups consumer warpgroups (two: warps 0-7) of 64 rows each run
//   wgmma.mma_async m64n128 with A from registers and B from shared
//   memory, each accumulator the 16 n8-tiles of its warps' 16 rows.
// * The warp after them is the producer: one lane starts
//   cp.async.bulk.tensor (TMA) loads of each k-stage's A tile and B tile
//   into a ring of kStages stages, each guarded by two mbarriers (full:
//   the bytes arrived; empty: every consumer warp has read the stage).
//   The tiles land in TMA's 128-byte swizzle, rows of 128 bytes, which is
//   wgmma's SW128 K-major layout for B; a consumer reads its A fragments
//   out of the swizzle by hand (conflict-free for the f32 fragments).
//   Rows past n or m and k-steps past k arrive as zeros.
// * The grid runs column tiles fastest: the blocks of one row tile run
//   together and share its A tile in L2, and a weight (a few MB) stays in
//   L2 for the whole product.
// Three consumer warpgroups a block, a ring of two stages, row tiles
// fastest or a group of wgmmas kept in flight made it no faster on an H100
// (tests/wide_gemm_variants.py, PERF.md §6).
//
// The numerics are gemm_tile's and gemm_tile_bf16's:
// * f32 (MODE 3): 3xTF32, small·big + big·small + big·big a k8-step into
//   the tensor cores' accumulator.  A TF32 B operand can only be read
//   K-major from shared memory, already split: a per-call pre-pass writes
//   each weight's parts once (big, small), K-major (Wᵀ for the forward's
//   [k, m] weights), so each weight element is split once a call and not
//   once a warp and a row tile; A is split in registers, once a block.
// * MODE 6 (the QKV product): three parts a side (big, mid, small), the
//   six products down to mid·mid of a k8-step from a zeroed accumulator
//   (wgmma's scale-d 0), added to the sum in f32, rounded to nearest.
// * bf16 (MODE 1): A rounded to bf16 (to nearest even) as it leaves
//   shared memory, B the call's bf16 copy of the weight, K-major; each
//   32-k chunk's two k16 steps from a zeroed accumulator, added in f32.
// Needs sm_90a (wgmma); k % 4 == 0 (f32) or k % 8 == 0 (bf16) and
// pointers 16-byte aligned (TMA's strides and addresses).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc.cuh"

namespace wg {

constexpr int kWarpgroups = 2;  // consumer warpgroups a block
constexpr int kConsumerWarps = 4 * kWarpgroups;
constexpr int kThreads = 32 * kConsumerWarps + 32;   // and a producer warp
constexpr int kRows = 64 * kWarpgroups;   // block tile rows
constexpr int kRowBytes = 128;  // a staged row: the swizzle's span
constexpr int kKf = kRowBytes / 4;   // f32 k-steps a staged row

constexpr int kCols = 128;      // block tile columns: wgmma's n
constexpr int kNj = kCols / 8;  // n8-tiles of a consumer thread's sum

// MODE 3: 3xTF32; 6: the 6-term split; 1: bf16.
template <int MODE>
struct Cfg {
  static_assert(MODE == 3 || MODE == 6 || MODE == 1, "3xTF32, 6-term, bf16");
  static constexpr int kParts = MODE == 6 ? 3 : MODE == 3 ? 2 : 1;
  static constexpr int kStageK = MODE == 1 ? 2 * kKf : kKf;   // k a stage
  static constexpr int kABytes = kRows * kStageK * 4;         // A in f32
  static constexpr int kBPart = kCols * kRowBytes;            // one part
  static constexpr int kStageBytes = kABytes + kParts * kBPart;
  static constexpr int kStages = MODE == 6 ? 3 : 4;
  // the ring, 1,024 bytes to align it (the swizzle's period) and the
  // barriers
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 16 * kStages;
  static_assert(kSmem <= 232448, "a block's shared memory on an H100");
};

// ------------------------------------------------------------- device ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Until the phase of the barrier with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// A TMA load of map's box at coordinates (c0 innermost, c1[, c2]) into dst,
// completing bytes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The shared-memory descriptor of a K-major operand in the 128-byte
// swizzle at shared address s (its 8-row atom on 1,024 bytes; s advanced
// by 32 bytes a k-step within the row): start address, leading offset 1
// (unused for this layout), 1,024 bytes between 8-row groups, swizzle
// 128B.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t s) {
  return static_cast<uint64_t>((s & 0x3ffff) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Until the warpgroup's committed wgmmas are done.
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of an accumulator across a
// wgmma's launch and its wait.
__device__ __forceinline__ void fence_acc(float (&d)[kNj][4]) {
#pragma unroll
  for (int j = 0; j < kNj; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

#define WG_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define WG_D64                                                            \
  WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3), WG_D4(4), WG_D4(5), WG_D4(6),   \
      WG_D4(7), WG_D4(8), WG_D4(9), WG_D4(10), WG_D4(11), WG_D4(12),      \
      WG_D4(13), WG_D4(14), WG_D4(15)
#define WG_REGS64                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "

// d (+)= a·b, m64n128k8, TF32 in, f32 accumulate: a the warp's m16n8k8 A
// fragment (tc.cuh mma_tf32), b a descriptor; d = a·b where scale_d is 0.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kNj][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_REGS64
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The same, m64n128k16 bf16 in (a the m16n8k16 A fragment, tc.cuh
// mma_bf16), B K-major.
__device__ __forceinline__ void wgmma_bf16(float (&d)[kNj][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef WG_D4
#undef WG_D64
#undef WG_REGS64

// f32 element (r, c) of a staged A tile [rows][kKf] in the 128-byte
// swizzle: 16-byte unit c / 4 of row r sits at unit (c / 4) ^ (r % 8).
__device__ __forceinline__ int swz(int r, int c) {
  return r * kKf + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

// The ring of a block: stage s's bytes and its two barriers.
template <int MODE>
struct Ring {
  uint8_t* smem;
  uint64_t *full, *empty;
  __device__ __forceinline__ const float* a(int s) const {
    return reinterpret_cast<const float*>(smem + s * Cfg<MODE>::kStageBytes);
  }
  __device__ __forceinline__ uint32_t b(int s) const {
    return smem_u32(smem + s * Cfg<MODE>::kStageBytes + Cfg<MODE>::kABytes);
  }
};

// The consumers' loop: each chunk of k (a stage) waited for, multiplied
// and released; r the thread's fragment rows r and r + 8 of the block, t
// its column in the quad.  Each group of wgmmas is waited for before the
// next is started: keeping one in flight (two register sets of A; in the
// 6-term mode two partials, at n 96 to fit the registers) was no faster
// in 3xTF32 and slower in the 6-term mode (PERF.md §6).
template <int MODE>
__device__ __forceinline__ void consume(const Ring<MODE>& ring, int n_chunks,
                                        int r, int t, float (&acc)[kNj][4]) {
  using C = Cfg<MODE>;
  float part[kNj][4];
#pragma unroll
  for (int j = 0; j < kNj; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
  auto add_part = [&] {
    fence_acc(part);
#pragma unroll
    for (int j = 0; j < kNj; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  };
  for (int it = 0; it < n_chunks; ++it) {
    const int s = it % C::kStages;
    mbar_wait(&ring.full[s], (it / C::kStages) & 1);
    const float* as = ring.a(s);
    const uint32_t bs = ring.b(s);
    if constexpr (MODE == 3) {
      // A's fragments of the stage's four k8-steps: (r, t), (r + 8, t),
      // (r, t + 4), (r + 8, t + 4) of each, split; small·big, big·small,
      // big·big a k8-step (gemm_tile's order) into acc
      uint32_t ab[4][4], am[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tc::split_tf32(as[swz(r + 8 * (e & 1), 8 * ks + t + 4 * (e >> 1))],
                         ab[ks][e], am[ks][e]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_tf32(acc, am[ks], desc_sw128(bs + 32 * ks), 1);
        wgmma_tf32(acc, ab[ks], desc_sw128(bs + C::kBPart + 32 * ks), 1);
        wgmma_tf32(acc, ab[ks], desc_sw128(bs + 32 * ks), 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_acc(acc);
    } else if constexpr (MODE == 6) {
      // a k8-step's six products down to mid·mid (mid·mid, small·big,
      // big·small, mid·big, big·mid, big·big: gemm_tile<..., 6>'s order)
      // into a zeroed partial, added to acc in f32
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t pa[3][4];   // big, mid, small
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t p[3];
          tc::split_parts<6>(
              as[swz(r + 8 * (e & 1), 8 * ks + t + 4 * (e >> 1))], p);
#pragma unroll
          for (int q = 0; q < 3; ++q) pa[q][e] = p[q];
        }
        const uint32_t b0 = bs + 32 * ks, b1 = b0 + C::kBPart,
                       b2 = b0 + 2 * C::kBPart;
        wgmma_fence();
        wgmma_tf32(part, pa[1], desc_sw128(b1), 0);
        wgmma_tf32(part, pa[2], desc_sw128(b0), 1);
        wgmma_tf32(part, pa[0], desc_sw128(b2), 1);
        wgmma_tf32(part, pa[1], desc_sw128(b0), 1);
        wgmma_tf32(part, pa[0], desc_sw128(b1), 1);
        wgmma_tf32(part, pa[0], desc_sw128(b0), 1);
        wgmma_commit();
        wgmma_wait();
        add_part();
      }
    } else {
      // bf16: two 32-k chunks a stage (A's two boxes), each two k16 steps
      // from a zeroed partial added in f32; A's fragment (r, 2t..2t+1),
      // (r + 8, ..), (r, 2t + 8..), (r + 8, 2t + 8..) of each step,
      // rounded in pairs
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* ah = as + h * kRows * kKf;
        uint32_t a[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 v = *reinterpret_cast<const float2*>(
                ah + swz(r + 8 * (e & 1), 16 * ks + 2 * t + 8 * (e >> 1)));
            a[ks][e] = tc::pack_bf16(v.x, v.y);
          }
        wgmma_fence();
        wgmma_bf16(part, a[0], desc_sw128(bs + 64 * h), 0);
        wgmma_bf16(part, a[1], desc_sw128(bs + 64 * h + 32), 1);
        wgmma_commit();
        wgmma_wait();
        add_part();
      }
    }
    // the stage read by this warp: one lane arrives for it
    if ((threadIdx.x & 31) == 0) mbar_arrive(&ring.empty[s]);
  }
}

// acc = A[row0 .. row0 + kRows - 1, :]·B[:, n0 .. n0 + kCols - 1] by the
// block, with ta A's map (f32, box kKf x kRows) and tb B's (MODE 3, 6:
// the parts [P][m][k] f32, box kKf x kCols x 1; MODE 1: [m][k] bf16, box
// 2·kKf x kCols).  Returns false on the producer warp, which holds no
// rows; a consumer thread's acc[j] holds rows row0 + 16·warp + g (and + 8)
// of n-tile j.  smem: Cfg<MODE>::kSmem bytes of dynamic shared memory.
template <int MODE>
__device__ __forceinline__ bool tile(const CUtensorMap* ta,
                                     const CUtensorMap* tb, int k, int row0,
                                     int n0, uint8_t* smem_raw,
                                     float (&acc)[kNj][4]) {
  using C = Cfg<MODE>;
  Ring<MODE> ring;
  ring.smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  ring.full = reinterpret_cast<uint64_t*>(ring.smem + C::kStages *
                                                          C::kStageBytes);
  ring.empty = ring.full + C::kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_chunks = (k + C::kStageK - 1) / C::kStageK;

  if (warp == kConsumerWarps) {   // the producer
    if (lane == 0) {
      for (int it = 0; it < n_chunks; ++it) {
        const int s = it % C::kStages;
        if (it >= C::kStages)
          mbar_wait(&ring.empty[s], ((it / C::kStages) & 1) ^ 1);
        uint8_t* st = ring.smem + s * C::kStageBytes;
        uint64_t* bar = &ring.full[s];
        mbar_expect_tx(bar, C::kStageBytes);
        const int k0 = it * C::kStageK;
#pragma unroll
        for (int h = 0; h < C::kStageK / kKf; ++h)
          tma_load(st + h * kRows * kRowBytes, ta, bar, k0 + h * kKf, row0);
        if constexpr (MODE == 1) {
          tma_load(st + C::kABytes, tb, bar, k0, n0);
        } else {
#pragma unroll
          for (int q = 0; q < C::kParts; ++q)
            tma_load(st + C::kABytes + q * C::kBPart, tb, bar, k0, n0, q);
        }
      }
    }
    return false;
  }

#pragma unroll
  for (int j = 0; j < kNj; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  consume(ring, n_chunks, warp * 16 + (lane >> 2), lane & 3, acc);
  return true;
}

// --------------------------------------------------------------- host ----

// cuTensorMapEncodeTiled of libcuda, found through the CUDA runtime's
// entry-point query (the library links no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

// A tiled map of a rank-2 or rank-3 row-major tensor (dims innermost
// first, byte strides of the outer dims), 128-byte swizzle, zeros out of
// bounds.
inline cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type,
                            int rank, const void* base,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(base), dims,
                        strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A [n, k] f32, box kKf x kRows.
inline cudaError_t map_a(CUtensorMap* map, const float* a, int n, int k) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 4};
  const cuuint32_t box[2] = {kKf, kRows};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a, dims, strides,
                  box);
}

// B's MODE parts [P][m][k] f32 (MODE 3, 6), box kKf x kCols x 1; or
// (MODE 1) [m][k] bf16, box 2·kKf x kCols.
template <int MODE>
inline cudaError_t map_b(CUtensorMap* map, const void* b, int m, int k) {
  if constexpr (MODE == 1) {
    const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
    const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
    const cuuint32_t box[2] = {2 * kKf, kCols};
    return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, dims,
                    strides, box);
  } else {
    const cuuint64_t dims[3] = {(cuuint64_t)k, (cuuint64_t)m,
                                (cuuint64_t)Cfg<MODE>::kParts};
    const cuuint64_t strides[2] = {(cuuint64_t)k * 4, (cuuint64_t)m * k * 4};
    const cuuint32_t box[3] = {kKf, kCols, 1};
    return make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, b, dims,
                    strides, box);
  }
}

// Blocks of a product of n rows and m columns (column tiles fastest).
inline int blocks(int n, int m) {
  return ((n + kRows - 1) / kRows) * ((m + kCols - 1) / kCols);
}

// --------------------------------------------------- the weight pre-pass ----

// One weight of the pre-pass: src [rows][cols] f32 for each of `mats`
// matrices (src_stride floats apart), written as dst [P][cols][rows]
// (transposed: the forward's [k, m] weights made K-major) or
// [P][rows][cols] (as it lies: the backward's [m, k]), dst_stride floats
// (or, bf16, elements) apart.  P = 2 (big, small), 3 (big, mid, small) or,
// for a bf16 dst, 1 (rounded to nearest even).
struct SplitJob {
  const float* src;
  void* dst;
  int rows, cols, parts;
  size_t src_stride, dst_stride;
};

struct SplitJobs {
  SplitJob job[4];
  int n_jobs, mats, transpose, bf16;
};

// Grid (tiles of 32 x 32, jobs, mats), 256 threads: a tile through shared
// memory, coalesced on both sides.
__device__ __forceinline__ void split_weights(const SplitJobs& js) {
  __shared__ float tile_s[32][33];
  const SplitJob& jb = js.job[blockIdx.y];
  const int tiles_c = (jb.cols + 31) / 32;
  const int tiles = tiles_c * ((jb.rows + 31) / 32);
  const float* src = jb.src + blockIdx.z * jb.src_stride;
  const size_t part = (size_t)jb.rows * jb.cols;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int tid = blockIdx.x; tid < tiles; tid += gridDim.x) {
    const int r0 = (tid / tiles_c) * 32, c0 = (tid % tiles_c) * 32;
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {
      const int r = r0 + i, c = c0 + tx;
      tile_s[i][tx] = r < jb.rows && c < jb.cols
                          ? src[(size_t)r * jb.cols + c]
                          : 0.f;
    }
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {
      // transposed: dst row c0 + i, column r0 + tx; else row r0 + i
      const int orow = js.transpose ? c0 + i : r0 + i;
      const int ocol = js.transpose ? r0 + tx : c0 + tx;
      const int ocols = js.transpose ? jb.rows : jb.cols;
      if (orow >= (js.transpose ? jb.cols : jb.rows) || ocol >= ocols)
        continue;
      const float x = js.transpose ? tile_s[tx][i] : tile_s[i][tx];
      const size_t at = blockIdx.z * jb.dst_stride + (size_t)orow * ocols +
                        ocol;
      if (js.bf16) {
        static_cast<uint16_t*>(jb.dst)[at] =
            static_cast<uint16_t>(tc::round_bf16(x) >> 16);
      } else {
        uint32_t p[3];
        float* d = static_cast<float*>(jb.dst);
        if (jb.parts == 3) {
          tc::split_parts<6>(x, p);
          d[at + 2 * part] = __uint_as_float(p[2]);
        } else {
          tc::split_parts<3>(x, p);
        }
        d[at] = __uint_as_float(p[0]);
        d[at + part] = __uint_as_float(p[1]);
      }
    }
  }
}

// The pre-pass's grid for these jobs.
inline dim3 split_grid(const SplitJobs& js) {
  int most = 1;
  for (int j = 0; j < js.n_jobs; ++j) {
    const int t = ((js.job[j].rows + 31) / 32) * ((js.job[j].cols + 31) / 32);
    most = t > most ? t : most;
  }
  return dim3(most < 1024 ? most : 1024, js.n_jobs, js.mats);
}

}  // namespace wg
