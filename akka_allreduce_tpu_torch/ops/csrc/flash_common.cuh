// Device helpers shared by the flash-attention kernels (the bf16 forward
// and backward, flash_attention_wgmma.cu and flash_attention_bwd_wgmma.cu;
// the f32 forward and backward, flash_attention_3xtf32.cu and
// flash_attention_bwd_3xtf32.cu): the constants, the bf16 packing, the
// stores and the forwards' online softmax. Their Hopper machinery is in
// hopper.cuh, the split-TF32 pieces of the f32 kernels in tf32.cuh.
//
// The register layout of a wgmma (or m16n8 mma) accumulator: a warp owns
// 16 rows; each thread holds, for each 8-column tile j, c[4j + 0..3] = rows
// g and g + 8 (g = lane / 4), columns 8j + 2t and 8j + 2t + 1
// (t = lane % 4): (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace akka_flash {

typedef __nv_bfloat16 bf16;

constexpr float kMaskValue = -1e30f;
// the most dynamic shared memory one block may opt into on sm_90
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32_as_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_f32_as_bf16(a, b);
}

// One key block's online softmax on raw scores s (the accumulator layout:
// this thread's rows row_lo and row_lo + 8, keys n0 + 8j + 2t + {0, 1}):
// scale them to base-2 units, mask where a key of the block is past T or
// above the diagonal for some row of the warpgroup (whose first row is
// row0), take the row max, move m_run and l_run, and leave p = 2^(s - m)
// in s and the rescale factor of the rows' earlier sums in corr.
template <int BN>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 2],
                                               float (&m_run)[2],
                                               float (&l_run)[2],
                                               float (&corr)[2],
                                               float scale_log2, int n0,
                                               int row_lo, int t, int t_len,
                                               int causal, int row0) {
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) s[e] *= scale_log2;
  if (n0 + BN > t_len || (causal && n0 + BN - 1 > row0)) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int key = n0 + 8 * (e / 4) + 2 * t + (e & 1);
      const int row = row_lo + 8 * ((e >> 1) & 1);
      if (key >= t_len || (causal && key > row)) s[e] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    corr[r] = akka_sm90::exp2_approx(m_run[r] - m_new);
    m_run[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    const int r = (e >> 1) & 1;
    const float p = akka_sm90::exp2_approx(s[e] - m_run[r]);
    s[e] = p;
    psum[r] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + psum[r];
}

}  // namespace akka_flash
