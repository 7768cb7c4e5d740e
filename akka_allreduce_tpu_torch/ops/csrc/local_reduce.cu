// Single-card threshold-reduce kernels for Hopper (sm_90a).
//
// K1 akka_masked_average   replaces akka_allreduce_tpu/ops/local_reduce.py
//                          _masked_average_impl / _avg_kernel
// K2 akka_elastic_average_step
//                          replaces akka_allreduce_tpu/ops/local_reduce.py
//                          _elastic_step_tiled_impl / _elastic_kernel
//
// X is K stacked worker payloads, row-major (K, data) float32; the JAX
// package's (K, T, 128) tiled form is the same memory with data = T * 128.
// valid is the (K,) 0/1 contribution mask as float32.
//
//   count  = sum_k valid[k]
//   avg[i] = (sum_k valid[k] * x[k][i]) / max(count, 1)          (K1)
//   x[k][i] <- keep * x[k][i] + pull * avg[i]                       (K2)
//   (keep, pull) = (1 - alpha, alpha) if count > 0 else (1, 0)
//
// Bound: HBM bytes. K1 reads X once and writes `data` floats; K2 reads and
// writes every element of X once. Both do 2-5 flops per 4-byte element, far
// under the card's ridge, so the design only has to keep HBM streaming:
//
// - each thread owns VEC contiguous columns (VEC = 4: 16-byte float4 loads
//   when data % 4 == 0 and X is 16-byte aligned; VEC = 1 otherwise), and
//   neighbouring threads own neighbouring columns, so every warp-wide load
//   of one row is a contiguous 512-byte segment;
// - a grid-stride loop over column groups, with the grid sized from the
//   occupancy of the kernel on this card's SMs;
// - for K <= KMAX (templated 8 / 16 / 32) the K values of a column group are
//   loaded into registers once, all K loads in flight together, reduced in k
//   order and, for K2, updated from the same registers: X is read once, the
//   whole point of the TPU kernel (its module docstring). Above 32 replicas a
//   generic loop reads X a second time for the update instead of rejecting K;
// - the count never leaves the device: every thread sums the K mask values
//   itself (broadcast loads that stay in L1), so the count > 0 gate is
//   decided in the kernel and the host never waits on it.
//
// Numerics follow the JAX kernel: the masked total is x_0*v_0 + x_1*v_1 + ...
// in k order, the average divides by max(count, 1) (no reciprocal), and the
// update is keep*x + pull*avg. Every product and sum uses __fmul_rn /
// __fadd_rn / __fdiv_rn, so nvcc contracts nothing into an FMA and the
// results equal the plain PyTorch version (separate mul and add kernels)
// bit for bit on the card.
//
// Each C entry launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else {
    r[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    *p = r[0];
  }
}

// count = sum_k valid[k], in k order
__device__ __forceinline__ float mask_count(const float* __restrict__ valid,
                                            int k) {
  float c = 0.f;
  for (int i = 0; i < k; ++i) c = __fadd_rn(c, valid[i]);
  return c;
}

// total[j] = sum_k valid[k] * x[k][g*VEC + j] / denom, X held in registers
// (KMAX > 0, k <= KMAX) or streamed with a runtime loop (KMAX == 0).
template <int VEC, int KMAX>
__device__ __forceinline__ void column_average(
    const float* __restrict__ col, const float* __restrict__ valid, int k,
    int64_t data, float denom, float (&rows)[KMAX > 0 ? KMAX : 1][VEC],
    float (&avg)[VEC]) {
  if constexpr (KMAX > 0) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < k) load_vec<VEC>(col + i * data, rows[i]);
    }
    const float v0 = valid[0];
#pragma unroll
    for (int j = 0; j < VEC; ++j) avg[j] = __fmul_rn(rows[0][j], v0);
#pragma unroll
    for (int i = 1; i < KMAX; ++i) {
      if (i < k) {
        const float vi = valid[i];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          avg[j] = __fadd_rn(avg[j], __fmul_rn(rows[i][j], vi));
      }
    }
  } else {
    float r[VEC];
    load_vec<VEC>(col, r);
    const float v0 = valid[0];
#pragma unroll
    for (int j = 0; j < VEC; ++j) avg[j] = __fmul_rn(r[j], v0);
    for (int i = 1; i < k; ++i) {
      load_vec<VEC>(col + i * data, r);
      const float vi = valid[i];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        avg[j] = __fadd_rn(avg[j], __fmul_rn(r[j], vi));
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) avg[j] = __fdiv_rn(avg[j], denom);
}

template <int VEC, int KMAX>
__global__ void __launch_bounds__(kThreads)
    masked_average_kernel(const float* __restrict__ x,
                          const float* __restrict__ valid,
                          float* __restrict__ avg_out,
                          float* __restrict__ count_out, int k, int64_t data) {
  const float count = mask_count(valid, k);
  if (blockIdx.x == 0 && threadIdx.x == 0) *count_out = count;
  const float denom = fmaxf(count, 1.f);
  const int64_t groups = data / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    float rows[KMAX > 0 ? KMAX : 1][VEC];
    float avg[VEC];
    column_average<VEC, KMAX>(x + g * VEC, valid, k, data, denom, rows, avg);
    store_vec<VEC>(avg_out + g * VEC, avg);
  }
}

template <int VEC, int KMAX>
__global__ void __launch_bounds__(kThreads)
    elastic_step_kernel(float* __restrict__ x, const float* __restrict__ valid,
                        float alpha, int k, int64_t data) {
  const float count = mask_count(valid, k);
  const float denom = fmaxf(count, 1.f);
  // count == 0: nobody contributed this round; replicas keep their state
  const float keep = count > 0.f ? __fsub_rn(1.f, alpha) : 1.f;
  const float pull = count > 0.f ? alpha : 0.f;
  const int64_t groups = data / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    float* col = x + g * VEC;
    float rows[KMAX > 0 ? KMAX : 1][VEC];
    float avg[VEC];
    column_average<VEC, KMAX>(col, valid, k, data, denom, rows, avg);
    float pulled[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) pulled[j] = __fmul_rn(pull, avg[j]);
    if constexpr (KMAX > 0) {
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < k) {
          float out[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            out[j] = __fadd_rn(__fmul_rn(keep, rows[i][j]), pulled[j]);
          store_vec<VEC>(col + i * data, out);
        }
      }
    } else {
      for (int i = 0; i < k; ++i) {
        float r[VEC];
        load_vec<VEC>(col + i * data, r);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          r[j] = __fadd_rn(__fmul_rn(keep, r[j]), pulled[j]);
        store_vec<VEC>(col + i * data, r);
      }
    }
  }
}

template <typename Kernel>
int grid_for(Kernel kernel, int64_t groups, int device) {
  int sms = 0;
  int per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t needed = (groups + kThreads - 1) / kThreads;
  const int64_t grid = needed < resident ? needed : resident;
  return static_cast<int>(grid > 0 ? grid : 1);
}

template <int VEC, int KMAX>
void launch_masked_average(const float* x, const float* valid, float* avg,
                           float* count, int k, int64_t data, int device,
                           cudaStream_t stream) {
  auto kernel = masked_average_kernel<VEC, KMAX>;
  const int grid = grid_for(kernel, data / VEC, device);
  kernel<<<grid, kThreads, 0, stream>>>(x, valid, avg, count, k, data);
}

template <int VEC, int KMAX>
void launch_elastic_step(float* x, const float* valid, float alpha, int k,
                         int64_t data, int device, cudaStream_t stream) {
  auto kernel = elastic_step_kernel<VEC, KMAX>;
  const int grid = grid_for(kernel, data / VEC, device);
  kernel<<<grid, kThreads, 0, stream>>>(x, valid, alpha, k, data);
}

// The register-resident K bound: 8, 16, 32, or 0 (generic loop, X read twice
// by K2).
template <int VEC>
void masked_average_vec(const float* x, const float* valid, float* avg,
                        float* count, int k, int64_t data, int device,
                        cudaStream_t s) {
  if (k <= 8) {
    launch_masked_average<VEC, 8>(x, valid, avg, count, k, data, device, s);
  } else if (k <= 16) {
    launch_masked_average<VEC, 16>(x, valid, avg, count, k, data, device, s);
  } else if (k <= 32) {
    launch_masked_average<VEC, 32>(x, valid, avg, count, k, data, device, s);
  } else {
    launch_masked_average<VEC, 0>(x, valid, avg, count, k, data, device, s);
  }
}

template <int VEC>
void elastic_step_vec(float* x, const float* valid, float alpha, int k,
                      int64_t data, int device, cudaStream_t s) {
  if (k <= 8) {
    launch_elastic_step<VEC, 8>(x, valid, alpha, k, data, device, s);
  } else if (k <= 16) {
    launch_elastic_step<VEC, 16>(x, valid, alpha, k, data, device, s);
  } else if (k <= 32) {
    launch_elastic_step<VEC, 32>(x, valid, alpha, k, data, device, s);
  } else {
    launch_elastic_step<VEC, 0>(x, valid, alpha, k, data, device, s);
  }
}

bool vec4_ok(const void* p, int64_t data) {
  return data % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

const char* akka_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int akka_masked_average(const float* x, const float* valid, float* avg,
                        float* count, int64_t k, int64_t data, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  if (vec4_ok(x, data) && vec4_ok(avg, data)) {
    masked_average_vec<4>(x, valid, avg, count, kk, data, device, s);
  } else {
    masked_average_vec<1>(x, valid, avg, count, kk, data, device, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int akka_elastic_average_step(float* x, const float* valid, float alpha,
                              int64_t k, int64_t data, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  if (vec4_ok(x, data)) {
    elastic_step_vec<4>(x, valid, alpha, kk, data, device, s);
  } else {
    elastic_step_vec<1>(x, valid, alpha, kk, data, device, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
