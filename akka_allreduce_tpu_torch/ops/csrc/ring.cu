// Ring allreduce-sum over n virtual ranks on one card, for Hopper (sm_90a).
//
// K3 akka_ring_allreduce   replaces akka_allreduce_tpu/ops/ring.py
//                          pallas_ring_allreduce_sum / _ring_kernel
//
// X is the (n, data) float32 stack, one row per rank, cut into buckets of n
// segments of `seg` floats (seg = seg_rows * 128); the tail past `data` reads
// as zeros and is never written. Every rank ends with the sum over ranks of
// each bucket, after the TPU kernel's 2(n-1)-step schedule. Step s:
//   reduce-scatter (s < n-1): send segment (r-s) % n, accumulate the
//       received one into segment (r-s-1) % n as local + received;
//   all-gather (s >= n-1, s' = s-(n-1)): send segment (r+1-s') % n, copy the
//       received one into segment (r-s') % n.
// With compression every hop's payload is bf16, or int8 with one f32 scale
// per whole segment (max|seg| / 127); at s == n-1 the owner requantizes its
// reduced segment, and every all-gather hop requantizes what it forwards,
// exactly as the TPU kernel does. An optional per-rank mask multiplies x as
// it is first read (x * valid[r]), as the caller's masking did.
//
// Design: the TPU kernel's shape on a thread-block cluster. The TPU keeps a
// bucket in VMEM, pushes each hop by remote DMA into the neighbour's VMEM
// receive slot and throttles with a capacity semaphore. Here:
// - A cluster is the n ranks of one column slice: CTA c hosts ranks
//   [c*R, (c+1)*R), R = 1 up to 16 ranks (portable clusters up to 8, a
//   non-portable one up to 16), more above; a CTA's hosted ranks take each
//   step in turn, and a hop between them goes through its own shared memory.
// - Each rank has two receive slots in its CTA's shared memory, in the wire
//   type. A hop is st.async of the sender's registers, 16 bytes a thread (4
//   f32, 8 bf16 or 16 int8 columns), into the right neighbour's slot, whose
//   bytes complete that slot's "full" mbarrier (the
//   receive semaphore); the receiver frees the slot by a remote
//   mbarrier.arrive.release.cluster on the sender's "empty" barrier, one per
//   warp (the capacity semaphore). The receiver re-arms "full" with the
//   bytes it expects as soon as it has seen a phase complete.
// - Folded by rank, iteration k of a work item touches segment (r-k) % n:
//   k = 0 sends x; 1 <= k <= n-1 adds x to the received partial and sends
//   the sum (k = n-1 is the turn: the owned segment is final, and written);
//   k >= n writes the received segment and forwards it. So x is read from
//   HBM once, the result written once, and partial sums live only in
//   registers and shared memory: 2 * n * data * 4 bytes, the bound.
// - x is prefetched with cp.async into a ring of a few slices per rank in
//   shared memory, each thread copying (and later reading) its own columns,
//   so the HBM latency stays off the neighbour-to-neighbour chain; the next
//   item's first slices load while this one gathers.
// - One launch per call: persistent clusters walk (bucket, column slice)
//   work items; several clusters share an SM, so one's hand-shake overlaps
//   another's loads. f32 and bf16 need no agreement between clusters.
// - A hop's hand-shake costs much the same whatever its size, so items are
//   wide; item width, x ring and CTAs an SM are set per mode (Wire), chosen
//   by timing variants on an H100 80GB at 700 W: f32 4096 columns (4 CTAs
//   an SM), bf16 8192 (3), int8 16384 with an 8192-column x ring (3).
// - int8 needs max|v| over the whole segment before a hop. Where v holds new
//   sums (the reduce-scatter hops) a pass measures it: inside a CTA a block
//   reduction; a segment wider than one work item spans a team of clusters
//   that walk the same buckets in lockstep and agree through a global word
//   per (bucket, rank, step, pass) (red.max, then a release add on the
//   arrival count that every member waits on), which needs the team
//   co-resident: the grid never exceeds cudaOccupancyMaxActiveClusters.
//   A hop carries its segment's amax beside the bytes; a round trip of a
//   segment quantized with a normal-float scale has max 127 * scale (its
//   largest element maps to +-127), so the owner's requantization and the
//   gather hops need neither a pass nor an agreement.
// Every wait is bounded: after a timeout the thread writes an error word,
// prints which wait hung and traps, so a protocol bug is a CUDA error, not a
// hang.
//
// Numerics follow the TPU kernel: RS adds local + received with __fadd_rn;
// the mask is __fmul_rn(x, valid[r]); bf16 casts are __float2bfloat16_rn
// (round to nearest even, like XLA and torch); int8 is scale = amax > 0 ?
// amax * f32(1/127) : 1 (__fmul_rn: XLA folds the JAX package's amax / 127.0
// into that product), q = clamp(rint(x / scale), -127, 127) (a true division,
// __fdiv_rn, ties to even), dequantized as q * scale (__fmul_rn). No FMA
// contraction anywhere, so the kernel equals the plain PyTorch version bit
// for bit.
//
// The C entries launch on the caller's stream, do not synchronise, and
// return the launch's error (or cudaGetLastError()) so the wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <cstdio>

#include "hopper.cuh"

namespace {

using akka_sm90::smem_addr;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;       // receive slots per rank
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;
constexpr float kInv127 = 1.0f / 127.0f;  // f32(1/127), as XLA folds it
constexpr unsigned long long kSpinTimeoutNs = 20ull * 1000 * 1000 * 1000;

enum Mode { kF32 = 0, kBF16 = 1, kINT8 = 2 };

// Which wait hung, written to the error word before the trap.
enum WaitCode { kWaitFull = 1, kWaitEmpty = 2, kWaitAgree = 3 };

// A thread moves 16 wire bytes a hop: 4 f32, 8 bf16 or 16 int8 columns.
// Per mode: a work item's width (unless the segment is narrower), the x ring
// columns a slice holds (an item's columns past them load from HBM), the x
// slices in flight per rank and the CTAs an SM should hold.
template <int MODE>
struct Wire {
  static constexpr int kBytes = MODE == kF32 ? 4 : MODE == kBF16 ? 2 : 1;
  static constexpr int kCols = 16 / kBytes;
  static constexpr int kF4 = kCols / 4;           // float4s of those columns
  static constexpr int kSub = kThreads * kCols;   // columns a CTA pass covers
  static constexpr int kItemCols =
      MODE == kF32 ? 4096 : MODE == kBF16 ? 8192 : 16384;
  static constexpr int kRingCols = MODE == kF32 ? 4096 : 8192;
  static constexpr int kAhead = 1;
  static constexpr int kMinCtas = MODE == kF32 ? 4 : 3;
  static_assert(kItemCols % kSub == 0 && kRingCols % kSub == 0,
                "an item and an x slice hold whole passes");
};

__host__ __device__ constexpr int64_t align_up(int64_t v, int64_t a) {
  return (v + a - 1) / a * a;
}

template <int MODE>
__host__ __device__ constexpr int64_t ring_cols(int64_t width) {
  return width < Wire<MODE>::kRingCols ? width : Wire<MODE>::kRingCols;
}

// Dynamic shared memory: full[R][S], empty[R][S] (mbarriers), amaxes[R][S],
// the block reduction's kWarps + 1 floats, then (128-byte aligned) the x
// ring, xs[R][kAhead][ring_cols] float32, and the receive
// slots[R][S][width] in the wire type.
__host__ __device__ constexpr int64_t xs_offset(int r) {
  return align_up(static_cast<int64_t>(r) * kStages * (8 + 8 + 4) +
                      (kWarps + 1) * 4,
                  128);
}

template <int MODE>
__host__ __device__ constexpr int64_t slots_offset(int r, int64_t width) {
  return xs_offset(r) +
         static_cast<int64_t>(r) * Wire<MODE>::kAhead * ring_cols<MODE>(width) *
             4;
}

template <int MODE>
__host__ __device__ constexpr int64_t smem_bytes(int r, int64_t width) {
  return slots_offset<MODE>(r, width) +
         static_cast<int64_t>(r) * kStages * width * Wire<MODE>::kBytes;
}

struct RingArgs {
  const float* x;       // (n, data) input stack; never written
  float* out;           // (n, data) result
  const float* valid;   // (n,) per-rank mask, or null
  unsigned* words;      // int8 team agreement: (buckets, n, 2n-1, 2, 2)
  int* error;           // WaitCode of a wait that timed out
  int64_t data;         // floats per rank row
  int64_t seg;          // floats per segment
  int64_t width;        // columns of a segment one work item covers
  int n;                // ranks
  int buckets;          // ceil(data / (n * seg))
  int ranks_per_cta;    // R
  int chunks;           // work items per bucket: ceil(seg / width)
  int team;             // clusters that agree on an int8 scale (1: none)
  int vec;              // rows are 16-byte aligned: float4 loads and stores
};

struct Smem {
  uint64_t* full;
  uint64_t* empty;
  float* amaxes;  // int8: the max|v| each slot's segment was quantized with
  float* red;
  float* xs;
  unsigned char* slots;
  int64_t slot_bytes;
  int64_t xs_cols;  // ring_cols(width)
  uint32_t tx;      // bytes that fill one slot (and its amax)
};

template <int F>
struct Vals {
  float4 f[F];
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_max(unsigned* p, unsigned v) {
  asm volatile("red.relaxed.gpu.global.max.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void red_add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __noinline__ void timeout(int* error, int code, int k, int rank,
                                     unsigned seen, unsigned want) {
  atomicExch(error, code);
  __threadfence_system();
  printf("akka_ring_allreduce: wait %d timed out at iteration %d, rank %d, "
         "block %d (saw %u, want %u)\n",
         code, k, rank, static_cast<int>(blockIdx.x), seen, want);
  __trap();
}

// every thread: until the mbarrier's phase of this parity has completed
__device__ __forceinline__ void wait_bar(uint64_t* bar, uint32_t parity,
                                         int* error, int code, int k,
                                         int rank) {
  const uint32_t addr = smem_addr(bar);
  if (akka_sm90::mbar_try_wait_cluster(addr, parity)) return;
  const unsigned long long t0 = akka_sm90::now_ns();
  unsigned polls = 0;
  while (!akka_sm90::mbar_try_wait_cluster(addr, parity)) {
    if ((++polls & 255u) == 0 && akka_sm90::now_ns() - t0 > kSpinTimeoutNs)
      timeout(error, code, k, rank, parity, parity ^ 1u);
  }
}

// one thread: until *count reaches `want`
__device__ void wait_count(const unsigned* count, unsigned want, int* error,
                           int k, int rank) {
  if (ld_acquire(count) >= want) return;
  const unsigned long long t0 = akka_sm90::now_ns();
  unsigned polls = 0;
  while (ld_acquire(count) < want) {
    if ((++polls & 1023u) == 0 && akka_sm90::now_ns() - t0 > kSpinTimeoutNs)
      timeout(error, kWaitAgree, k, rank, ld_acquire(count), want);
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

__device__ __forceinline__ float bf16_at(unsigned w) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w)));
}

__device__ __forceinline__ float4 bf16_unpack(unsigned lo, unsigned hi) {
  return make_float4(bf16_at(lo), bf16_at(lo >> 16), bf16_at(hi),
                     bf16_at(hi >> 16));
}

__device__ __forceinline__ float int8_scale(float amax) {
  return amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
}

__device__ __forceinline__ unsigned quantize(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

__device__ __forceinline__ float dequantize(unsigned q, float scale) {
  return __fmul_rn(static_cast<float>(static_cast<signed char>(q)), scale);
}

__device__ __forceinline__ unsigned quantize4(float4 v, float s) {
  return quantize(v.x, s) | (quantize(v.y, s) << 8) |
         (quantize(v.z, s) << 16) | (quantize(v.w, s) << 24);
}

__device__ __forceinline__ float4 dequantize4(unsigned q, float s) {
  return make_float4(dequantize(q, s), dequantize(q >> 8, s),
                     dequantize(q >> 16, s), dequantize(q >> 24, s));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 mul4(float4 a, float s) {
  return make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s),
                     __fmul_rn(a.w, s));
}

__device__ __forceinline__ float abs_max4(float m, float4 v) {
  return fmaxf(fmaxf(fmaxf(m, fabsf(v.x)), fmaxf(fabsf(v.y), fabsf(v.z))),
               fabsf(v.w));
}

__device__ __forceinline__ float4 bf16_round4(float4 v) {
  return make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z),
                     bf16_round(v.w));
}

// max|dequantize(q, scale)| over a segment quantized with scale =
// int8_scale(amax): its largest element maps to +-127 (amax / scale is 127
// to within 2^-22 when the scale is a normal float) and rounding is
// monotonic, so it is 127 * scale. -1 where a pass must measure it instead.
__device__ __forceinline__ float requantized_max(float amax, float scale) {
  if (amax == 0.f) return 0.f;
  return scale >= FLT_MIN ? __fmul_rn(127.f, scale) : -1.f;
}

// int8 round trip: what a receiver reconstructs from quantize(v, scale)
__device__ __forceinline__ float4 roundtrip4(float4 v, float s) {
  return dequantize4(quantize4(v, s), s);
}

// x[e .. e+3] of one row, zeros past `data` or outside the segment (!ok)
__device__ __forceinline__ float4 load_x(const float* row, int64_t e,
                                         int64_t data, bool vec, bool ok) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!ok || e >= data) return v;
  if (vec) return __ldg(reinterpret_cast<const float4*>(row + e));
  v.x = __ldg(row + e);
  if (e + 1 < data) v.y = __ldg(row + e + 1);
  if (e + 2 < data) v.z = __ldg(row + e + 2);
  if (e + 3 < data) v.w = __ldg(row + e + 3);
  return v;
}

__device__ __forceinline__ void store_out(float* row, int64_t e, int64_t data,
                                          bool vec, bool ok, float4 v) {
  if (!ok || e >= data) return;
  if (vec) {
    __stcs(reinterpret_cast<float4*>(row + e), v);
    return;
  }
  row[e] = v.x;
  if (e + 1 < data) row[e + 1] = v.y;
  if (e + 2 < data) row[e + 2] = v.z;
  if (e + 3 < data) row[e + 3] = v.w;
}

// a thread's 16 received bytes at column `col` of a slot, as float32
template <int MODE>
__device__ __forceinline__ Vals<Wire<MODE>::kF4> read_slot(
    const unsigned char* slot, int64_t col, float scale) {
  const uint4 w =
      *reinterpret_cast<const uint4*>(slot + col * Wire<MODE>::kBytes);
  Vals<Wire<MODE>::kF4> v;
  if constexpr (MODE == kF32) {
    v.f[0] = make_float4(__uint_as_float(w.x), __uint_as_float(w.y),
                         __uint_as_float(w.z), __uint_as_float(w.w));
  } else if constexpr (MODE == kBF16) {
    v.f[0] = bf16_unpack(w.x, w.y);
    v.f[1] = bf16_unpack(w.z, w.w);
  } else {
    v.f[0] = dequantize4(w.x, scale);
    v.f[1] = dequantize4(w.y, scale);
    v.f[2] = dequantize4(w.z, scale);
    v.f[3] = dequantize4(w.w, scale);
  }
  return v;
}

// those columns as 16 wire bytes
template <int MODE>
__device__ __forceinline__ uint4 encode(const Vals<Wire<MODE>::kF4>& v,
                                        float scale) {
  if constexpr (MODE == kF32) {
    return make_uint4(__float_as_uint(v.f[0].x), __float_as_uint(v.f[0].y),
                      __float_as_uint(v.f[0].z), __float_as_uint(v.f[0].w));
  } else if constexpr (MODE == kBF16) {
    return make_uint4(bf16_pair(v.f[0].x, v.f[0].y),
                      bf16_pair(v.f[0].z, v.f[0].w),
                      bf16_pair(v.f[1].x, v.f[1].y),
                      bf16_pair(v.f[1].z, v.f[1].w));
  } else {
    return make_uint4(quantize4(v.f[0], scale), quantize4(v.f[1], scale),
                      quantize4(v.f[2], scale), quantize4(v.f[3], scale));
  }
}

// max over the CTA of `m`, then over the team's CTAs of this rank through
// the (max, count) word pair when there is one; every thread gets it
__device__ float agree(float m, float* red, unsigned* word, int team,
                       int* error, int k, int rank) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = red[0];
    for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
    if (team > 1) {
      // amax >= 0: its bits order as unsigned integers
      red_max(word, __float_as_uint(r));
      red_add_release(word + 1, 1u);
      wait_count(word + 1, static_cast<unsigned>(team), error, k, rank);
      r = __uint_as_float(ld_acquire(word));
    }
    red[kWarps] = r;
  }
  __syncthreads();
  return red[kWarps];
}

// Where a cluster's t-th work item lies: bucket b (-1 past the last) and
// column slice j. A team of clusters (int8, a segment wider than one item)
// takes the slices of one bucket together; otherwise clusters deal items
// round robin.
struct Walk {
  int cid, clusters, team, buckets, chunks;

  __device__ __forceinline__ void item(int64_t t, int& b, int& j) const {
    if (team > 1) {
      const int64_t bb = cid / team + t * (clusters / team);
      b = bb < buckets ? static_cast<int>(bb) : -1;
      j = cid % team;
    } else {
      const int64_t w = cid + t * clusters;
      b = w < static_cast<int64_t>(buckets) * chunks
              ? static_cast<int>(w / chunks) : -1;
      j = static_cast<int>(w % chunks);
    }
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// this thread's copies of a rank's oldest x slice have landed: each hosted
// rank commits one group a slice, kAhead ahead, so hosted * kAhead - 1
// younger groups may still be in flight
template <int MODE>
__device__ __forceinline__ void wait_x(int hosted) {
  switch (hosted * Wire<MODE>::kAhead - 1) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// Start copying x slice q of rank `rank` (item q / n, iteration q % n) into
// its stage of the ring: the first ring_cols columns, this thread's only (it
// alone reads them); columns past the segment or the data land as zeros.
// One commit group a call, empty past the last item.
template <int MODE>
__device__ void prefetch_x(const RingArgs& a, const Smem& s, const Walk& w,
                           int rank, int i, int64_t q) {
  using W = Wire<MODE>;
  const int n = a.n;
  int b, j;
  w.item(q / n, b, j);
  if (b >= 0) {
    const int k = static_cast<int>(q % n);
    const int seg_idx = (rank - k + n) % n;
    const int64_t col0 = static_cast<int64_t>(j) * a.width;
    const int64_t cols = a.seg - col0 < a.width ? a.seg - col0 : a.width;
    const int64_t e0 = (static_cast<int64_t>(b) * n + seg_idx) * a.seg + col0;
    const float* xr = a.x + static_cast<int64_t>(rank) * a.data;
    constexpr int kAhead = W::kAhead;
    float* dst =
        s.xs + (static_cast<int64_t>(i) * kAhead + q % kAhead) * s.xs_cols;
    for (int64_t cc = static_cast<int64_t>(threadIdx.x) * W::kCols;
         cc < s.xs_cols; cc += W::kSub) {
#pragma unroll
      for (int c = 0; c < W::kCols; c += 4) {
        const int64_t e = e0 + cc + c;
        const bool ok = cc < cols;
        if (a.vec) {
          const bool in = ok && e < a.data;
          cp_async16(dst + cc + c, in ? xr + e : a.x, in ? 16u : 0u);
        } else {
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const bool in = ok && e + d < a.data;
            cp_async4(dst + cc + c + d, in ? xr + e + d : a.x, in ? 4u : 0u);
          }
        }
      }
    }
  }
  cp_async_commit();
}

// Iteration k of the cluster's t-th work item (bucket b, column slice j) for
// rank `rank`, the CTA's hosted rank number i. Slot phases count this rank's
// hops over all items (t * 2(n-1) + k), its x slices t * n + k.
template <int MODE>
__device__ __forceinline__ void hop(const RingArgs& a, const Smem& s,
                                    const Walk& w, int rank, int i, int k,
                                    int64_t t, int b, int j, int hosted) {
  using W = Wire<MODE>;
  using V = Vals<W::kF4>;
  const int n = a.n;
  const int R = a.ranks_per_cta;
  const int seg_idx = (rank - k % n + n) % n;
  const bool has_x = k <= n - 1;
  const bool has_recv = k >= 1;
  const bool sends = k <= 2 * n - 3;
  const bool writes = k >= n - 1;
  const bool turn = k == n - 1;
  const int subs = static_cast<int>(a.width / W::kSub);
  const int64_t col0 = static_cast<int64_t>(j) * a.width;
  const int64_t cols = a.seg - col0 < a.width ? a.seg - col0 : a.width;
  const int64_t e0 = (static_cast<int64_t>(b) * n + seg_idx) * a.seg + col0;
  const float* xr = a.x + static_cast<int64_t>(rank) * a.data;
  float* outr = a.out + static_cast<int64_t>(rank) * a.data;
  const bool masked = a.valid != nullptr;
  const float mask = masked ? __ldg(a.valid + rank) : 1.f;
  const bool vec = a.vec != 0;
  const int64_t tcol = static_cast<int64_t>(threadIdx.x) * W::kCols;
  const int64_t q = t * n + k;  // this rank's x slice (has_x)
  constexpr int kAhead = W::kAhead;
  float* xst =
      s.xs + (static_cast<int64_t>(i) * kAhead + q % kAhead) * s.xs_cols;

  // receive: use k-1 of this rank, from the left neighbour
  const int64_t use0 = t * (2 * (n - 1));
  const int64_t ur = use0 + k - 1;
  const int sr = static_cast<int>(ur % kStages);
  uint64_t* full_r = s.full + i * kStages + sr;
  const unsigned char* slot_r = s.slots + (i * kStages + sr) * s.slot_bytes;
  const int left = (rank + n - 1) % n;
  // send: use k, into the right neighbour's slot
  const int64_t us = use0 + k;
  const int ss = static_cast<int>(us % kStages);
  const int right = (rank + 1) % n;
  const uint32_t rcta = static_cast<uint32_t>(right / R);
  const int ri = right % R;
  const uint32_t dst_slot = akka_sm90::map_cta(
      smem_addr(s.slots + (ri * kStages + ss) * s.slot_bytes), rcta);
  const uint32_t dst_full =
      akka_sm90::map_cta(smem_addr(s.full + ri * kStages + ss), rcta);

  if (has_x) wait_x<MODE>(hosted);
  float amax_r = 0.f;
  if (has_recv) {
    wait_bar(full_r, static_cast<uint32_t>((ur / kStages) & 1), a.error,
             kWaitFull, k, rank);
    // arm the slot's next use; it cannot complete before every warp has
    // released this one
    if (threadIdx.x == 0) akka_sm90::mbar_expect_tx(full_r, s.tx);
    if (MODE == kINT8) amax_r = s.amaxes[i * kStages + sr];
  }
  const float scale_r = int8_scale(amax_r);

  // this thread's columns cc .. cc + kCols - 1 of the item: x * valid (from
  // the ring, or past it from HBM), plus what it received
  bool in_ring = false;  // int8: the ring holds the sums, not x
  auto value = [&](int64_t cc) {
    V v;
    if (in_ring && cc < s.xs_cols) {
#pragma unroll
      for (int f = 0; f < W::kF4; ++f)
        v.f[f] = *reinterpret_cast<const float4*>(xst + cc + 4 * f);
      return v;
    }
#pragma unroll
    for (int f = 0; f < W::kF4; ++f) v.f[f] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (has_x) {
#pragma unroll
      for (int f = 0; f < W::kF4; ++f) {
        v.f[f] = cc < s.xs_cols
                     ? *reinterpret_cast<const float4*>(xst + cc + 4 * f)
                     : load_x(xr, e0 + cc + 4 * f, a.data, vec, cc < cols);
        if (masked) v.f[f] = mul4(v.f[f], mask);
      }
    }
    if (has_recv) {
      const V r = read_slot<MODE>(slot_r, cc, scale_r);
#pragma unroll
      for (int f = 0; f < W::kF4; ++f)
        v.f[f] = has_x ? add4(v.f[f], r.f[f]) : r.f[f];
    }
    return v;
  };

  // int8: max|v| over the whole segment, then its scale. Where v holds new
  // sums (x), a pass and an agreement measure it; a round trip's is known
  // (requantized_max), unless its scale is subnormal
  float amax = 0.f, scale = 0.f, scale_turn = 0.f;
  if (MODE == kINT8 && sends) {
    unsigned* word =
        a.words +
        (((static_cast<int64_t>(b) * n + rank) * (2 * n - 1) + k) * 2) * 2;
    auto measure = [&](bool round_trip, unsigned* at) {
      float m = 0.f;
      for (int u = 0; u < subs; ++u) {
        const int64_t cc = u * W::kSub + tcol;
        V v = value(cc);
        if (has_x && !in_ring && cc < s.xs_cols) {
          // keep the sum where its x was (this thread's own ring columns):
          // the sending pass reads it back instead of recomputing it
#pragma unroll
          for (int f = 0; f < W::kF4; ++f)
            *reinterpret_cast<float4*>(xst + cc + 4 * f) = v.f[f];
        }
#pragma unroll
        for (int f = 0; f < W::kF4; ++f)
          m = abs_max4(m, round_trip ? roundtrip4(v.f[f], scale_turn) : v.f[f]);
      }
      if (has_x) in_ring = true;
      return agree(m, s.red, at, a.team, a.error, k, rank);
    };
    amax = has_x ? measure(false, word) : requantized_max(amax_r, scale_r);
    if (amax < 0.f) amax = measure(false, word);
    if (turn) {
      // the owner requantizes its reduced segment; the hop then quantizes
      // that round trip with its own scale
      scale_turn = int8_scale(amax);
      amax = requantized_max(amax, scale_turn);
      if (amax < 0.f) amax = measure(true, word + 2);
    }
    scale = int8_scale(amax);
  }

  if (sends && us >= kStages) {
    // the right neighbour has released what we sent into this slot before
    wait_bar(s.empty + i * kStages + ss,
             static_cast<uint32_t>((us / kStages - 1) & 1), a.error,
             kWaitEmpty, k, rank);
  }
#pragma unroll 2
  for (int u = 0; u < subs; ++u) {
    const int64_t cc = u * W::kSub + tcol;
    V v = value(cc);
#pragma unroll
    for (int f = 0; f < W::kF4; ++f) {
      if (turn && MODE == kBF16) v.f[f] = bf16_round4(v.f[f]);
      if (turn && MODE == kINT8) v.f[f] = roundtrip4(v.f[f], scale_turn);
      if (writes)
        store_out(outr, e0 + cc + 4 * f, a.data, vec, cc < cols, v.f[f]);
    }
    if (sends)
      akka_sm90::st_async(
          dst_slot + static_cast<uint32_t>(cc * W::kBytes),
          encode<MODE>(v, scale), dst_full);
  }
  if (MODE == kINT8 && sends && threadIdx.x == 0) {
    const uint32_t dst_amax = akka_sm90::map_cta(
        smem_addr(s.amaxes + ri * kStages + ss), rcta);
    akka_sm90::st_async(dst_amax, __float_as_uint(amax), dst_full);
  }
  if (has_recv) {
    // every value read from the slot has been used: release it to the left
    // neighbour, one arrival per warp
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      akka_sm90::mbar_arrive_remote(akka_sm90::map_cta(
          smem_addr(s.empty + (left % R) * kStages + sr),
          static_cast<uint32_t>(left / R)));
    }
  }
  // this stage of the x ring is read: refill it kAhead slices ahead
  if (has_x) prefetch_x<MODE>(a, s, w, rank, i, q + kAhead);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, Wire<MODE>::kMinCtas)
    ring_kernel(const __grid_constant__ RingArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = a.ranks_per_cta;
  Smem s;
  s.full = reinterpret_cast<uint64_t*>(smem);
  s.empty = s.full + R * kStages;
  s.amaxes = reinterpret_cast<float*>(s.empty + R * kStages);
  s.red = s.amaxes + R * kStages;
  s.xs = reinterpret_cast<float*>(smem + xs_offset(R));
  s.slots = smem + slots_offset<MODE>(R, a.width);
  s.slot_bytes = a.width * Wire<MODE>::kBytes;
  s.xs_cols = ring_cols<MODE>(a.width);
  s.tx = static_cast<uint32_t>(s.slot_bytes) + (MODE == kINT8 ? 4u : 0u);

  const int n = a.n;
  const int cta = static_cast<int>(akka_sm90::cluster_ctarank());
  const int hosted = n - cta * R < R ? n - cta * R : R;
  const Walk w{static_cast<int>(akka_sm90::cluster_id()),
               static_cast<int>(akka_sm90::cluster_count()), a.team,
               a.buckets, a.chunks};
  // the first x slices are in flight while the cluster sets up
  for (int q = 0; q < Wire<MODE>::kAhead; ++q)
    for (int i = 0; i < hosted; ++i)
      prefetch_x<MODE>(a, s, w, cta * R + i, i, q);

  if (threadIdx.x == 0) {
    for (int q = 0; q < R * kStages; ++q) {
      akka_sm90::mbar_init(s.full + q, 1);
      akka_sm90::mbar_init(s.empty + q, kWarps);
    }
    for (int q = 0; q < R * kStages; ++q)
      akka_sm90::mbar_expect_tx(s.full + q, s.tx);  // arm the first uses
    akka_sm90::fence_barrier_init();
  }
  akka_sm90::cluster_sync();  // every CTA's barriers exist before any hop

  const int hops = 2 * (n - 1);
  for (int64_t t = 0;; ++t) {
    int b, j;
    w.item(t, b, j);
    if (b < 0) break;
    for (int k = 0; k <= hops; ++k)
      for (int i = 0; i < hosted; ++i)
        hop<MODE>(a, s, w, cta * R + i, i, k, t, b, j, hosted);
  }
  cp_async_wait<0>();
  akka_sm90::cluster_sync();  // no CTA leaves while a neighbour may write it
}

struct Plan {
  int64_t ranks_per_cta;
  int64_t cluster;   // CTAs per cluster
  int64_t clusters;  // clusters in the grid
  int64_t width;
  int64_t chunks;
  int64_t team;
  int64_t smem;
};

// Cluster shape, width and grid for n ranks: the fewest ranks per CTA whose
// cluster (at most 16 CTAs) the card can hold, every resident cluster in the
// grid. int8 with a segment wider than one item widens the item until the
// segment's chunks fit in the resident clusters (a team must be co-resident).
template <int MODE>
cudaError_t plan_for(int n, int64_t seg, int64_t buckets, int device,
                     Plan* p) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const auto kernel = ring_kernel<MODE>;
  for (int r = 1; r <= n; ++r) {
    const int cs = (n + r - 1) / r;
    if (cs > kMaxCluster) continue;
    constexpr int64_t sub = Wire<MODE>::kSub;
    int64_t width = align_up(seg, sub);
    if (width > Wire<MODE>::kItemCols) width = Wire<MODE>::kItemCols;
    for (int tries = 0; tries < 8; ++tries) {
      const int64_t smem = smem_bytes<MODE>(r, width);
      if (smem > optin) break;
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      if (cs > kPortableCluster) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
      }
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(static_cast<unsigned>(cs));
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = static_cast<size_t>(smem);
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int active = 0;
      if (cudaOccupancyMaxActiveClusters(&active, kernel, &cfg) !=
          cudaSuccess) {
        cudaGetLastError();  // this cluster size does not fit: clear it
        active = 0;
      }
      if (active < 1) break;
      const int64_t chunks = (seg + width - 1) / width;
      if (MODE == kINT8 && chunks > 1) {
        if (chunks > active) {
          width = align_up((seg + active - 1) / active, sub);
          continue;
        }
        const int64_t teams =
            buckets < active / chunks ? buckets : active / chunks;
        *p = {r, cs, teams * chunks, width, chunks, chunks, smem};
        return cudaSuccess;
      }
      const int64_t items = buckets * chunks;
      *p = {r, cs, items < active ? items : active, width, chunks, 1, smem};
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;
}

cudaError_t plan(int mode, int n, int64_t seg, int64_t buckets, int device,
                 Plan* p) {
  switch (mode) {
    case kF32: return plan_for<kF32>(n, seg, buckets, device, p);
    case kBF16: return plan_for<kBF16>(n, seg, buckets, device, p);
    case kINT8: return plan_for<kINT8>(n, seg, buckets, device, p);
    default: return cudaErrorInvalidValue;
  }
}

template <int MODE>
cudaError_t launch(const RingArgs& a, const Plan& p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.clusters * p.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ring_kernel<MODE>, a);
}

}  // namespace

extern "C" {

const char* akka_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launch's shape for n ranks, segments of `seg` floats and `buckets`
// buckets: out = {ranks per CTA, CTAs per cluster, clusters, columns per
// work item, work items per bucket, team size, dynamic shared memory bytes}.
int akka_ring_plan(int mode, int64_t n, int64_t seg, int64_t buckets,
                   int device, int64_t* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan p;
  err = plan(mode, static_cast<int>(n), seg, buckets, device, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t v[7] = {p.ranks_per_cta, p.cluster, p.clusters, p.width,
                        p.chunks, p.team, p.smem};
  for (int q = 0; q < 7; ++q) out[q] = v[q];
  return 0;
}

// One cluster launch for the whole stack, on `stream`. `words` (int8: at
// least buckets * n * (2n-1) * 4 zeroed words) and `error` (one zeroed word)
// are the wrapper's; `valid` may be null.
int akka_ring_allreduce(int mode, const float* x, float* out,
                        const float* valid, unsigned* words, int* error,
                        int64_t n, int64_t data, int64_t buckets, int64_t seg,
                        int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan p;
  err = plan(mode, static_cast<int>(n), seg, buckets, device, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  RingArgs a{x,
             out,
             valid,
             words,
             error,
             data,
             seg,
             p.width,
             static_cast<int>(n),
             static_cast<int>(buckets),
             static_cast<int>(p.ranks_per_cta),
             static_cast<int>(p.chunks),
             static_cast<int>(p.team),
             vec};
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32: err = launch<kF32>(a, p, s); break;
    case kBF16: err = launch<kBF16>(a, p, s); break;
    case kINT8: err = launch<kINT8>(a, p, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
