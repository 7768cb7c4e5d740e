// Ring allreduce-sum over n virtual ranks on one card, for Hopper (sm_90a).
//
// K3 akka_ring_allreduce   replaces akka_allreduce_tpu/ops/ring.py
//                          pallas_ring_allreduce_sum / _ring_kernel
//
// X is the (n, stride) float32 stack, one row per rank, each row a whole
// number of buckets of n segments of `seg` floats (seg = seg_rows * 128).
// One launch reduces one bucket: every rank ends with the sum over ranks of
// its bucket, after the TPU kernel's 2(n-1)-step schedule. Step s:
//   reduce-scatter (s < n-1): send segment (r-s) % n, accumulate the
//       received one into segment (r-s-1) % n as local + received;
//   all-gather (s >= n-1, s' = s-(n-1)): send segment (r+1-s') % n, copy the
//       received one into segment (r-s') % n.
// With compression every hop's payload is bf16, or int8 with one f32 scale
// per whole segment (max|seg| / 127); at s == n-1 the owner requantizes its
// reduced segment in place, and every all-gather hop requantizes what it
// forwards, exactly as the TPU kernel does (so under int8 the ranks agree
// to about 1 ulp, not bit for bit).
//
// Design. Each rank is a group of C CTAs; CTA c of rank r owns the same
// column slice [c*width, (c+1)*width) of every segment, so it only ever
// exchanges data with CTA c of ranks r-1 and r+1. At step s it pushes its
// send slice into the RIGHT neighbour's receive slot s % 2 (the TPU kernel's
// remote DMA: on one card the slot is a plain device pointer; across cards it
// would be a peer pointer). Flag words replace the semaphores:
//   ready[rank][c][slot]  written by the sender, with release semantics,
//                         after its payload stores; the receiver polls it;
//   free[rank][c][slot]   written by the right neighbour after it consumed
//                         the slot; the sender waits on it before reusing the
//                         slot (s >= 2), the TPU kernel's capacity semaphore.
// Flag values are tags, bucket * 2(n-1) + s + 1, so nothing is reset
// between steps or buckets (the wrapper zeroes the words once per call).
// One thread polls with an acquire load, then __syncthreads. Data another
// CTA wrote is read with ld.global.cg (L2, never a stale L1 line).
//
// The int8 scale covers the whole segment, which C CTAs share: each CTA
// takes the max of |x| over its columns, atomicMax'es the bit pattern into a
// per-(bucket, rank, phase) word (non-negative floats order as unsigned
// integers), bumps a per-(bucket, rank, phase) arrival counter and waits for
// all C arrivals before it quantizes.
//
// Deadlock freedom needs every CTA of every rank resident at once: the grid
// goes out with cudaLaunchCooperativeKernel, which refuses a grid that does
// not fit, and C is chosen from the occupancy API. Every spin is bounded:
// after kSpinTimeoutNs the CTA writes an error word, prints the wait that
// hung and traps, so a protocol bug is a CUDA error and not a hang.
//
// Bound: HBM bytes, X read once and the result written once; a bucket's
// working set (X, result, slots) stays in the 50 MB L2, so the extra passes
// of the schedule mostly hit L2, and the 2(n-1) neighbour hand-shakes per
// bucket (a few microseconds each) are what the first version pays for.
//
// Numerics follow the TPU kernel: RS adds local + received with __fadd_rn;
// bf16 casts are __float2bfloat16_rn (round to nearest even, like XLA and
// torch); int8 is scale = amax > 0 ? amax * f32(1/127) : 1 (__fmul_rn: XLA
// folds the JAX package's amax / 127.0 into that product, so the JAX kernel
// computes it too), q = clamp(rint(x / scale), -127, 127) (a true division,
// __fdiv_rn, ties to even), dequantized as q * scale (__fmul_rn). No FMA
// contraction anywhere, so the kernel equals the plain PyTorch version bit
// for bit.
//
// The C entries launch on the caller's stream, do not synchronise, and
// return cudaGetLastError() (or the launch's error) so the wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kColsPerPass = kThreads * kVec;  // 1024 floats per CTA pass
constexpr int kLane = 128;
constexpr float kInv127 = 1.0f / 127.0f;  // f32(1/127), as XLA folds it
constexpr unsigned long long kSpinTimeoutNs = 20ull * 1000 * 1000 * 1000;

enum Mode { kF32 = 0, kBF16 = 1, kINT8 = 2 };

// Which wait hung, written to the error word before the trap.
enum WaitCode { kWaitFree = 1, kWaitReady = 2, kWaitAmax = 3 };

struct RingArgs {
  const float* x;         // (n, stride) input stack
  float* out;             // (n, stride) result; may equal x (in place)
  void* slots;            // (n, 2, seg) receive slots, wire type
  float* scales;          // (n, ctas, 2) int8 scales beside the slots
  unsigned* flags;        // ready (n, ctas, 2) then free (n, ctas, 2)
  unsigned* amax;         // (buckets, n, 2(n-1)+1) segment maxima, int8
  unsigned* arrive;       // same shape: CTAs that added their maximum
  int* error;             // WaitCode of a spin that timed out
  int64_t seg;            // floats per segment (seg_rows * 128)
  int64_t width;          // columns of each segment one CTA owns
  int64_t stride;         // floats per rank row
  int n;                  // ranks
  int ctas;               // CTAs per rank
  int bucket;             // which bucket this launch reduces
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin (one thread) until *p >= want in tag order; trap after the timeout.
__device__ void wait_at_least(const unsigned* p, unsigned want, int* error,
                              int code, int step) {
  if (static_cast<int>(ld_acquire(p) - want) >= 0) return;
  const unsigned long long t0 = now_ns();
  unsigned polls = 0;
  while (static_cast<int>(ld_acquire(p) - want) < 0) {
    if ((++polls & 1023u) == 0 && now_ns() - t0 > kSpinTimeoutNs) {
      atomicExch(error, code);
      __threadfence_system();
      printf("akka_ring_allreduce: spin timeout, wait %d at step %d, block %d "
             "(flag %u, want %u)\n",
             code, step, static_cast<int>(blockIdx.x), ld_acquire(p), want);
      __trap();
    }
  }
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const unsigned a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const unsigned b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w)));
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __bfloat162float(
      __ushort_as_bfloat16(static_cast<unsigned short>(w >> 16)));
}

__device__ __forceinline__ float int8_scale(float amax) {
  return amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
}

__device__ __forceinline__ signed char quantize(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return static_cast<signed char>(q);
}

__device__ __forceinline__ float dequantize(signed char q, float scale) {
  return __fmul_rn(static_cast<float>(q), scale);
}

__device__ __forceinline__ float abs_max4(float m, float4 v) {
  return fmaxf(fmaxf(fmaxf(m, fabsf(v.x)), fmaxf(fabsf(v.y), fabsf(v.z))),
               fabsf(v.w));
}

// max over the CTA's threads of `local`, then over the rank's CTAs through
// the (word, arrive) pair; every thread gets the rank-wide maximum.
__device__ float rank_max(float local, unsigned* word, unsigned* arrive,
                          int ctas, int* error, int step) {
  __shared__ float warp_max[kThreads / 32];
  __shared__ float result;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(word, __float_as_uint(m));
    __threadfence();
    atomicAdd(arrive, 1u);
    wait_at_least(arrive, static_cast<unsigned>(ctas), error, kWaitAmax, step);
    result = __uint_as_float(atomicOr(word, 0u));
  }
  __syncthreads();
  return result;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) ring_kernel(RingArgs a) {
  const int n = a.n;
  const int r = static_cast<int>(blockIdx.x) / a.ctas;
  const int c = static_cast<int>(blockIdx.x) % a.ctas;
  const int right = (r + 1) % n;
  const int left = (r + n - 1) % n;
  const int steps = 2 * (n - 1);
  const int64_t col0 = c * a.width;
  const int64_t col1 = col0 + a.width < a.seg ? col0 + a.width : a.seg;
  const int64_t first = col0 + static_cast<int64_t>(threadIdx.x) * kVec;
  const int64_t base = static_cast<int64_t>(r) * a.stride +
                       static_cast<int64_t>(a.bucket) * n * a.seg;
  const float* xr = a.x + base;
  float* outr = a.out + base;
  const unsigned tag0 = static_cast<unsigned>(a.bucket) * steps;
  const int pairs = n * a.ctas * 2;
  unsigned* ready_mine = a.flags + (r * a.ctas + c) * 2;
  unsigned* ready_right = a.flags + (right * a.ctas + c) * 2;
  unsigned* free_mine = a.flags + pairs + (r * a.ctas + c) * 2;
  unsigned* free_left = a.flags + pairs + (left * a.ctas + c) * 2;
  const int64_t phase0 = (static_cast<int64_t>(a.bucket) * n + r) * (steps + 1);

  if (xr != outr) {  // out = x, this CTA's columns of every segment
    for (int i = 0; i < n; ++i)
      for (int64_t col = first; col < col1; col += kColsPerPass)
        *reinterpret_cast<float4*>(outr + i * a.seg + col) =
            __ldg(reinterpret_cast<const float4*>(xr + i * a.seg + col));
  }

  for (int s = 0; s < steps; ++s) {
    const bool rs = s < n - 1;
    const int sp = s - (n - 1);
    const int send_idx = ((rs ? r - s : r + 1 - sp) + 2 * n) % n;
    const int recv_idx = ((rs ? r - s - 1 : r - sp) + 2 * n) % n;
    const int slot = s & 1;
    const unsigned tag = tag0 + s + 1;

    if (MODE != kF32 && s == n - 1) {
      // entering the gather: requantize the owned reduced segment in place
      float* own = outr + ((r + 1) % n) * a.seg;
      if (MODE == kBF16) {
        for (int64_t col = first; col < col1; col += kColsPerPass) {
          float4 v = *reinterpret_cast<float4*>(own + col);
          v = make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z),
                          bf16_round(v.w));
          *reinterpret_cast<float4*>(own + col) = v;
        }
      } else {
        float m = 0.f;
        for (int64_t col = first; col < col1; col += kColsPerPass)
          m = abs_max4(m, *reinterpret_cast<const float4*>(own + col));
        const float scale = int8_scale(rank_max(
            m, a.amax + phase0 + steps, a.arrive + phase0 + steps, a.ctas,
            a.error, s));
        for (int64_t col = first; col < col1; col += kColsPerPass) {
          float4 v = *reinterpret_cast<float4*>(own + col);
          v = make_float4(dequantize(quantize(v.x, scale), scale),
                          dequantize(quantize(v.y, scale), scale),
                          dequantize(quantize(v.z, scale), scale),
                          dequantize(quantize(v.w, scale), scale));
          *reinterpret_cast<float4*>(own + col) = v;
        }
      }
    }

    if (s >= 2) {  // the right neighbour consumed what we sent at s-2
      if (threadIdx.x == 0)
        wait_at_least(free_mine + slot, tag - 2, a.error, kWaitFree, s);
      __syncthreads();
    }

    // push this step's send slice into the right neighbour's slot
    const float* src = outr + send_idx * a.seg;
    const int64_t dst_slot = (static_cast<int64_t>(right) * 2 + slot) * a.seg;
    if (MODE == kF32) {
      float* dst = static_cast<float*>(a.slots) + dst_slot;
      for (int64_t col = first; col < col1; col += kColsPerPass)
        *reinterpret_cast<float4*>(dst + col) =
            *reinterpret_cast<const float4*>(src + col);
    } else if (MODE == kBF16) {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.slots) + dst_slot;
      for (int64_t col = first; col < col1; col += kColsPerPass) {
        const float4 v = *reinterpret_cast<const float4*>(src + col);
        *reinterpret_cast<uint2*>(dst + col) =
            make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
      }
    } else {
      float m = 0.f;
      for (int64_t col = first; col < col1; col += kColsPerPass)
        m = abs_max4(m, *reinterpret_cast<const float4*>(src + col));
      const float scale = int8_scale(rank_max(
          m, a.amax + phase0 + s, a.arrive + phase0 + s, a.ctas, a.error, s));
      signed char* dst = static_cast<signed char*>(a.slots) + dst_slot;
      for (int64_t col = first; col < col1; col += kColsPerPass) {
        const float4 v = *reinterpret_cast<const float4*>(src + col);
        *reinterpret_cast<char4*>(dst + col) =
            make_char4(quantize(v.x, scale), quantize(v.y, scale),
                       quantize(v.z, scale), quantize(v.w, scale));
      }
      if (threadIdx.x == 0) a.scales[(right * a.ctas + c) * 2 + slot] = scale;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      st_release(ready_right + slot, tag);
      wait_at_least(ready_mine + slot, tag, a.error, kWaitReady, s);
    }
    __syncthreads();

    // consume our own slot s % 2, filled by the left neighbour
    float* dst = outr + recv_idx * a.seg;
    const int64_t my_slot = (static_cast<int64_t>(r) * 2 + slot) * a.seg;
    for (int64_t col = first; col < col1; col += kColsPerPass) {
      float4 recv;
      if (MODE == kF32) {
        recv = __ldcg(reinterpret_cast<const float4*>(
            static_cast<const float*>(a.slots) + my_slot + col));
      } else if (MODE == kBF16) {
        const uint2 w = __ldcg(reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(a.slots) + my_slot + col));
        recv = make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y),
                              bf16_hi(w.y));
      } else {
        const float scale = __ldcg(a.scales + (r * a.ctas + c) * 2 + slot);
        const char4 q = __ldcg(reinterpret_cast<const char4*>(
            static_cast<const signed char*>(a.slots) + my_slot + col));
        recv = make_float4(dequantize(q.x, scale), dequantize(q.y, scale),
                              dequantize(q.z, scale), dequantize(q.w, scale));
      }
      float4* p = reinterpret_cast<float4*>(dst + col);
      if (rs) {
        const float4 mine = *p;
        *p = make_float4(__fadd_rn(mine.x, recv.x), __fadd_rn(mine.y, recv.y),
                         __fadd_rn(mine.z, recv.z),
                         __fadd_rn(mine.w, recv.w));
      } else {
        *p = recv;
      }
    }
    // slot consumed: the left neighbour may overwrite it at its step s+2
    __syncthreads();
    if (threadIdx.x == 0 && s + 2 < steps) {
      __threadfence();
      st_release(free_left + slot, tag);
    }
  }
}

template <int MODE>
cudaError_t plan_for(int n, int64_t seg, int device, int* ctas,
                     int64_t* width) {
  int sms = 0;
  int per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_kernel<MODE>,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t per_rank = static_cast<int64_t>(sms) * per_sm / n;
  if (per_rank < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t units = seg / kLane;  // seg_rows
  int64_t want = (seg + kColsPerPass - 1) / kColsPerPass;
  if (want > per_rank) want = per_rank;
  const int64_t per_cta = (units + want - 1) / want;
  *width = per_cta * kLane;
  *ctas = static_cast<int>((units + per_cta - 1) / per_cta);
  return cudaSuccess;
}

cudaError_t plan(int mode, int n, int64_t seg, int device, int* ctas,
                 int64_t* width) {
  switch (mode) {
    case kF32: return plan_for<kF32>(n, seg, device, ctas, width);
    case kBF16: return plan_for<kBF16>(n, seg, device, ctas, width);
    case kINT8: return plan_for<kINT8>(n, seg, device, ctas, width);
    default: return cudaErrorInvalidValue;
  }
}

template <int MODE>
cudaError_t launch_buckets(RingArgs a, int buckets, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(a.n * a.ctas));
  const dim3 block(kThreads);
  for (int b = 0; b < buckets; ++b) {
    a.bucket = b;
    void* params[] = {&a};
    cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(ring_kernel<MODE>), grid, block, params,
        0, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* akka_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// How many CTAs each rank gets (and how many columns each owns) for n ranks
// and segments of `seg` floats; the wrapper sizes the flag words from it.
int akka_ring_plan(int mode, int64_t n, int64_t seg, int device, int* ctas,
                   int64_t* width) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      plan(mode, static_cast<int>(n), seg, device, ctas, width));
}

// One cooperative launch per bucket, in bucket order, on `stream`.
int akka_ring_allreduce(int mode, const float* x, float* out, void* slots,
                        float* scales, unsigned* flags, unsigned* amax,
                        unsigned* arrive, int* error, int64_t n,
                        int64_t buckets, int64_t seg, int64_t stride,
                        int ctas, int64_t width, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  RingArgs a{x,   out,  slots, scales, flags, amax, arrive, error,
             seg, width, stride, static_cast<int>(n), ctas, 0};
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32: err = launch_buckets<kF32>(a, static_cast<int>(buckets), s); break;
    case kBF16: err = launch_buckets<kBF16>(a, static_cast<int>(buckets), s); break;
    case kINT8: err = launch_buckets<kINT8>(a, static_cast<int>(buckets), s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
