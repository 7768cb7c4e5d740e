// Device helpers shared by the flash-attention kernels. The f32 forward
// (flash_attention.cu) takes cp.async tile copies and warp-level f32
// products in the register layout of an m16n8 mma accumulator; the bf16
// forward and backward (flash_attention_wgmma.cu,
// flash_attention_bwd_wgmma.cu) and the f32 backward
// (flash_attention_bwd_3xtf32.cu) take the constants, the bf16 packing and
// the stores from here and their Hopper machinery from hopper.cuh.
//
// That layout: a warp owns 16 rows; each thread holds, for each 8-column
// tile j, c[j][0..3] = rows g and g + 8 (g = lane / 4), columns 8j + 2t and
// 8j + 2t + 1 (t = lane % 4): (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace akka_flash {

typedef __nv_bfloat16 bf16;

constexpr float kMaskValue = -1e30f;
// the most dynamic shared memory one block may opt into on sm_90
constexpr size_t kMaxSmem = 232448;

// row padding of shared-memory tiles: 16 bytes (bf16) or 4 floats (f32),
// so that the rows of a fragment read hit distinct banks
template <typename T>
struct Pad {
  static constexpr int value = sizeof(T) == 2 ? 8 : 4;
};

// 16 bytes global -> shared without passing through registers; zero-filled
// (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// start copying rows [row0, row0 + ROWS) of one head's (T, D) slice into
// shared memory (row pitch LD elements), 16 bytes a thread per step, every
// copy in flight at once; rows past t_len are zero
template <typename T, int D, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void load_tile_async(T* __restrict__ dst,
                                                const T* __restrict__ src,
                                                int64_t row_stride, int row0,
                                                int t_len) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  static_assert(ROWS * kChunks % THREADS == 0, "whole steps only");
#pragma unroll
  for (int step = 0; step < ROWS * kChunks / THREADS; ++step) {
    const int i = threadIdx.x + step * THREADS;
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    const bool valid = row0 + r < t_len;
    const T* from =
        valid ? src + static_cast<int64_t>(row0 + r) * row_stride + c : src;
    cp_async16(dst + r * LD + c, from, valid);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32_as_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  }
}

// c (16 x 8 NT) += A (16 x K) B (K x 8 NT) for one warp in f32 FMAs (not
// TF32). A is row-major in shared memory (a + m * lda + k). B is "NK",
// stored n-major (b + n * ldb + k, as K is for Q K^T), or "KN", stored
// k-major (b + k * ldb + n, as V is for P V).
template <bool KN, int NT, int K>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4],
                                         const float* __restrict__ a, int lda,
                                         const float* __restrict__ b, int ldb,
                                         int lane) {
  const int g = lane / 4;
  const int t = lane % 4;
  if constexpr (KN) {
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      const float a0 = a[g * lda + k];
      const float a1 = a[(g + 8) * lda + k];
      const float* brow = b + k * ldb + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(brow + 8 * j);
        c[j][0] = fmaf(a0, bb.x, c[j][0]);
        c[j][1] = fmaf(a0, bb.y, c[j][1]);
        c[j][2] = fmaf(a1, bb.x, c[j][2]);
        c[j][3] = fmaf(a1, bb.y, c[j][3]);
      }
    }
  } else {
    static_assert(K % 4 == 0, "float4 steps");
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + g * lda + k);
      const float4 a1 = *reinterpret_cast<const float4*>(a + (g + 8) * lda + k);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(b + (8 * j + 2 * t) * ldb + k);
        const float4 b1 =
            *reinterpret_cast<const float4*>(b + (8 * j + 2 * t + 1) * ldb + k);
        c[j][0] = fmaf(a0.x, b0.x, c[j][0]);
        c[j][0] = fmaf(a0.y, b0.y, c[j][0]);
        c[j][0] = fmaf(a0.z, b0.z, c[j][0]);
        c[j][0] = fmaf(a0.w, b0.w, c[j][0]);
        c[j][1] = fmaf(a0.x, b1.x, c[j][1]);
        c[j][1] = fmaf(a0.y, b1.y, c[j][1]);
        c[j][1] = fmaf(a0.z, b1.z, c[j][1]);
        c[j][1] = fmaf(a0.w, b1.w, c[j][1]);
        c[j][2] = fmaf(a1.x, b0.x, c[j][2]);
        c[j][2] = fmaf(a1.y, b0.y, c[j][2]);
        c[j][2] = fmaf(a1.z, b0.z, c[j][2]);
        c[j][2] = fmaf(a1.w, b0.w, c[j][2]);
        c[j][3] = fmaf(a1.x, b1.x, c[j][3]);
        c[j][3] = fmaf(a1.y, b1.y, c[j][3]);
        c[j][3] = fmaf(a1.z, b1.z, c[j][3]);
        c[j][3] = fmaf(a1.w, b1.w, c[j][3]);
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_f32_as_bf16(a, b);
}

// write a warp's accumulator tile (16 x 8 NT) at rows row_lo and row_lo + 8
// of a row-major array (pitch ld), times mul, rounded to T
template <typename T, int NT>
__device__ __forceinline__ void store_acc(T* __restrict__ dst, int64_t ld,
                                          const float (&c)[NT][4], float mul,
                                          int lane) {
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store2(dst + g * ld + 8 * j + 2 * t, c[j][0] * mul, c[j][1] * mul);
    store2(dst + (g + 8) * ld + 8 * j + 2 * t, c[j][2] * mul, c[j][3] * mul);
  }
}

}  // namespace akka_flash
