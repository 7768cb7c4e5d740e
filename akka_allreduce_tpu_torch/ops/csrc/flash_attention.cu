// Flash-attention forward for Hopper (sm_90a): K4.
//
// Replaces the flash branch of akka_allreduce_tpu/ops/local_attention.py
// local_attention, which calls the library Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention (forward; the backward
// waits for the training slice).
//
//   o[b, i, h, :] = sum_j p_ij v[b, j, h / G, :] / max(l_i, 1e-30)
//   s_ij = (q[b, i, h, :] . k[b, j, h / G, :]) * scale      (f32)
//   s_ij = -1e30 where masked (causal: j > i)
//   p_ij = exp(s_ij - m_i), exactly 0 where masked;  l_i = sum_j p_ij
//
// with m_i the running row max (starting at -1e30) and G = H / H_kv, the
// grouped-query factor: compact K/V are read in place, never repeated.
// Tensors are (B, T, H, D) with heads and D dense and the batch and row
// strides passed in, so a slice of a longer KV cache needs no copy.
//
// Bound: operations. 4 * B * H * T^2 * D FLOP (halved under causal masking)
// against (3 + 1) * B * T * H * D elements moved: at the flagship shape
// (8, 2048, 16, 128) bf16 that is 1.37e11 FLOP over 268 MB, far above the
// card's ridge, so the products must run on the tensor cores.
//
// Design, a simple flash-attention-2 forward:
// - one CTA per (query block of 64 rows, head, batch), 4 warps, each warp
//   owning 16 query rows; under causal masking the CTAs with the most key
//   blocks (the last query blocks) are launched first;
// - Q, then each K and V tile of kBlockN keys, staged in shared memory by
//   16-byte cp.async copies (rows padded so that fragment reads hit 32
//   distinct banks), the next K tile in flight during this block's softmax
//   and PV product, the next V tile during the next block's QK product;
//   key blocks wholly above the diagonal are skipped, the diagonal block is
//   masked element by element;
// - every thread holds its scores and its output accumulator in the
//   register layout of an m16n8 mma accumulator: rows g and g + 8 of its
//   warp's 16 (g = lane / 4), columns 8j + 2t and 8j + 2t + 1 (t = lane % 4);
//   the row max and sum need only the 4 threads of a group (two shuffles);
//   blocks that every row of a warp sees whole skip the element mask;
// - bf16: both products on the tensor cores, mma.sync.m16n8k16 with f32
//   accumulators, the fragments of Q, K and V (transposed) read from shared
//   memory by ldmatrix; P is rounded to bf16 in registers and fed straight
//   back as the A operand of the PV product;
// - f32: the same layout, both products as f32 FMAs (not TF32); P goes
//   through a per-warp strip of shared memory for the PV product.
// The scale multiplies the f32 scores (as the dense oracle does), the
// exponentials are expf (no fast math), and the output divides by
// max(l, 1e-30). wgmma, TMA and warp specialisation are for later.
//
// The C entry launches on the caller's stream, does not synchronise, and
// returns a CUDA error code (cudaErrorInvalidValue for a shape it does not
// cover) for the Python wrapper to raise on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;  // query rows per CTA
constexpr float kMaskValue = -1e30f;

typedef __nv_bfloat16 bf16;

template <typename T>
struct Tile;

// f32: 32 keys a tile (shared memory: Q + K + V + P strips), rows padded by
// 4 floats; bf16: 64 keys a tile, rows padded by 8 halves (16 bytes)
template <>
struct Tile<float> {
  static constexpr int kBlockN = 32;
  static constexpr int kPad = 4;
};
template <>
struct Tile<bf16> {
  static constexpr int kBlockN = 64;
  static constexpr int kPad = 8;
};

template <typename T, int D>
struct Smem {
  static constexpr int kBlockN = Tile<T>::kBlockN;
  static constexpr int kLd = D + Tile<T>::kPad;  // row pitch, elements
  static constexpr int kLdP = kBlockN + 4;       // f32 P strip row pitch
  static constexpr size_t kQKV =
      static_cast<size_t>(kBlockM + 2 * kBlockN) * kLd * sizeof(T);
  static constexpr size_t kP =
      sizeof(T) == 4 ? static_cast<size_t>(kWarps) * 16 * kLdP * 4 : 0;
  static constexpr size_t kBytes = kQKV + kP;
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
// shared memory, 16 bytes a thread per step, every copy in flight at once;
// rows past t_len are zero
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile_async(T* __restrict__ dst,
                                                const T* __restrict__ src,
                                                int64_t row_stride, int row0,
                                                int t_len) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  constexpr int kLd = Smem<T, D>::kLd;
  static_assert(ROWS * kChunks % kThreads == 0, "whole steps only");
#pragma unroll
  for (int step = 0; step < ROWS * kChunks / kThreads; ++step) {
    const int i = threadIdx.x + step * kThreads;
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    const bool valid = row0 + r < t_len;
    const T* from =
        valid ? src + static_cast<int64_t>(row0 + r) * row_stride + c : src;
    cp_async16(dst + r * kLd + c, from, valid);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32_as_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// four 8x8 b16 matrices from shared memory: lanes 8m..8m+7 give the row
// addresses of matrix m, and each lane receives, from matrix m into r[m],
// the two elements at (row lane / 4, columns 2 (lane % 4), + 1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed: (rows 2 (lane % 4), + 1, column lane / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b: one m16n8k16 tile, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// S (16 x kBlockN) = Q_w K^T for this warp's 16 rows, bf16 tensor cores.
// A (row-major Q): a0 (rows 0-7, columns 2t, 2t + 1), a1 (rows 8-15), a2
// and a3 the same 8 columns on: one ldmatrix.x4 over the matrices
// [rows 0-7 | 8-15] x [columns 16kk.. | 16kk + 8..]. B (K^T, "col"):
// b0 (k = 2t, 2t + 1; n = g) is key row g's D entries 16kk + 2t, + 1, b1
// those 8 on; one ldmatrix.x4 gives b0, b1 of two 8-key tiles.
template <int D, int NB>
__device__ __forceinline__ void scores_bf16(float (&s)[NB][4],
                                            const bf16* __restrict__ sq,
                                            const bf16* __restrict__ sk,
                                            int lane) {
  constexpr int kLd = Smem<bf16, D>::kLd;
  const int m = lane / 8;  // the matrix this lane addresses
  const int r = lane % 8;  // and its row there
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sq + ((m % 2) * 8 + r) * kLd + kk * 16 + (m / 2) * 8);
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, sk + ((j + m / 2) * 8 + r) * kLd + kk * 16 + (m % 2) * 8);
      mma_bf16(s[j], a, b[0], b[1]);
      mma_bf16(s[j + 1], a, b[2], b[3]);
    }
  }
}

// O (16 x D) += P V, bf16 tensor cores. P comes from the score registers:
// for the 16 keys of step kk, a0/a1 are tile 2kk's (c0, c1)/(c2, c3) and
// a2/a3 tile 2kk + 1's. B (V, "col"): b0 (k = keys 2t, 2t + 1; n = g) and
// b1 (keys 8 on) of an 8-wide D tile; one transposed ldmatrix.x4 over
// [keys 16kk.. | 16kk + 8..] x [D tiles jd | jd + 1] gives both tiles'.
template <int D, int NB>
__device__ __forceinline__ void pv_bf16(float (&o)[D / 8][4],
                                        const float (&p)[NB][4],
                                        const bf16* __restrict__ sv,
                                        int lane) {
  constexpr int kLd = Smem<bf16, D>::kLd;
  const int m = lane / 8;
  const int r = lane % 8;
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    uint32_t a[4];
    a[0] = pack_f32_as_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_f32_as_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_f32_as_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_f32_as_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const bf16* vp = sv + (16 * kk + (m % 2) * 8 + r) * kLd + (m / 2) * 8;
#pragma unroll
    for (int jd = 0; jd < D / 8; jd += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vp + 8 * jd);
      mma_bf16(o[jd], a, b[0], b[1]);
      mma_bf16(o[jd + 1], a, b[2], b[3]);
    }
  }
}

// S = Q_w K^T in f32 FMAs, in the same register layout as the mma path
template <int D, int NB>
__device__ __forceinline__ void scores_f32(float (&s)[NB][4],
                                           const float* __restrict__ sq,
                                           const float* __restrict__ sk,
                                           int g, int t) {
  constexpr int kLd = Smem<float, D>::kLd;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 q0 = *reinterpret_cast<const float4*>(sq + g * kLd + d);
    const float4 q1 = *reinterpret_cast<const float4*>(sq + (g + 8) * kLd + d);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float4 k0 =
          *reinterpret_cast<const float4*>(sk + (8 * j + 2 * t) * kLd + d);
      const float4 k1 =
          *reinterpret_cast<const float4*>(sk + (8 * j + 2 * t + 1) * kLd + d);
      s[j][0] = fmaf(q0.x, k0.x, s[j][0]);
      s[j][0] = fmaf(q0.y, k0.y, s[j][0]);
      s[j][0] = fmaf(q0.z, k0.z, s[j][0]);
      s[j][0] = fmaf(q0.w, k0.w, s[j][0]);
      s[j][1] = fmaf(q0.x, k1.x, s[j][1]);
      s[j][1] = fmaf(q0.y, k1.y, s[j][1]);
      s[j][1] = fmaf(q0.z, k1.z, s[j][1]);
      s[j][1] = fmaf(q0.w, k1.w, s[j][1]);
      s[j][2] = fmaf(q1.x, k0.x, s[j][2]);
      s[j][2] = fmaf(q1.y, k0.y, s[j][2]);
      s[j][2] = fmaf(q1.z, k0.z, s[j][2]);
      s[j][2] = fmaf(q1.w, k0.w, s[j][2]);
      s[j][3] = fmaf(q1.x, k1.x, s[j][3]);
      s[j][3] = fmaf(q1.y, k1.y, s[j][3]);
      s[j][3] = fmaf(q1.z, k1.z, s[j][3]);
      s[j][3] = fmaf(q1.w, k1.w, s[j][3]);
    }
  }
}

// O += P V in f32 FMAs; P goes through this warp's strip of shared memory
template <int D, int NB>
__device__ __forceinline__ void pv_f32(float (&o)[D / 8][4],
                                       const float (&p)[NB][4],
                                       float* __restrict__ sp,
                                       const float* __restrict__ sv, int g,
                                       int t) {
  constexpr int kLd = Smem<float, D>::kLd;
  constexpr int kLdP = Smem<float, D>::kLdP;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    sp[g * kLdP + 8 * j + 2 * t] = p[j][0];
    sp[g * kLdP + 8 * j + 2 * t + 1] = p[j][1];
    sp[(g + 8) * kLdP + 8 * j + 2 * t] = p[j][2];
    sp[(g + 8) * kLdP + 8 * j + 2 * t + 1] = p[j][3];
  }
  __syncwarp();
#pragma unroll 2
  for (int key = 0; key < 8 * NB; ++key) {
    const float p0 = sp[g * kLdP + key];
    const float p1 = sp[(g + 8) * kLdP + key];
    const float* vrow = sv + key * kLd + 2 * t;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const float2 vv = *reinterpret_cast<const float2*>(vrow + 8 * jd);
      o[jd][0] = fmaf(p0, vv.x, o[jd][0]);
      o[jd][1] = fmaf(p0, vv.y, o[jd][1]);
      o[jd][2] = fmaf(p1, vv.x, o[jd][2]);
      o[jd][3] = fmaf(p1, vv.y, o[jd][3]);
    }
  }
  __syncwarp();  // the strip is rewritten by the next key block
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_f32_as_bf16(a, b);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int t_len,
                     int group, int64_t q_sb, int64_t k_sb,
                     int64_t v_sb, int64_t o_sb, int64_t q_st, int64_t k_st,
                     int64_t v_st, int64_t o_st, float scale, int causal) {
  using S = Smem<T, D>;
  constexpr int kBlockN = S::kBlockN;
  constexpr int NB = kBlockN / 8;  // 8-key accumulator tiles per key block
  constexpr int kLd = S::kLd;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + kBlockM * kLd;
  T* sv = sk + kBlockN * kLd;
  float* sp = reinterpret_cast<float*>(smem_raw + S::kQKV);

  const int n_mblocks = gridDim.x;
  // causal: the last query blocks have the most key blocks; launch them first
  const int mb = causal ? n_mblocks - 1 - blockIdx.x : blockIdx.x;
  const int m0 = mb * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const T* qg = q + b * q_sb + static_cast<int64_t>(h) * D;
  const T* kg = k + b * k_sb + static_cast<int64_t>(kvh) * D;
  const T* vg = v + b * v_sb + static_cast<int64_t>(kvh) * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row_lo = m0 + warp * 16 + g;  // query rows of this thread
  const int row_hi = row_lo + 8;

  float o_acc[D / 8][4];
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    o_acc[jd][0] = o_acc[jd][1] = o_acc[jd][2] = o_acc[jd][3] = 0.f;
  }
  float m_run[2] = {kMaskValue, kMaskValue};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums

  // K and V tiles each have one buffer; the next K tile loads while this
  // block's softmax and PV run, the next V tile while the next S runs.
  // Copy groups, oldest first: {Q, K_0}, {V_0}, then per block {K_n+1},
  // {V_n+1} (empty past the last block), so "all but the newest group
  // landed" is the wait before each use.
  const int kv_end = causal ? min(t_len, m0 + kBlockM) : t_len;
  load_tile_async<T, D, kBlockM>(sq, qg, q_st, m0, t_len);
  load_tile_async<T, D, kBlockN>(sk, kg, k_st, 0, t_len);
  cp_async_commit();
  load_tile_async<T, D, kBlockN>(sv, vg, v_st, 0, t_len);
  cp_async_commit();
  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    const bool more = n0 + kBlockN < kv_end;
    cp_async_wait<1>();  // Q and K_n landed
    __syncthreads();

    float s[NB][4];
    if constexpr (sizeof(T) == 2) {
      scores_bf16<D, NB>(s, sq + warp * 16 * kLd, sk, lane);
    } else {
      scores_f32<D, NB>(s, sq + warp * 16 * kLd, sk, g, t);
    }
    __syncthreads();  // every warp is done with K_n
    if (more) load_tile_async<T, D, kBlockN>(sk, kg, k_st, n0 + kBlockN, t_len);
    cp_async_commit();

    // every key of the block visible to every row of this warp: no mask
    const bool full = n0 + kBlockN <= t_len &&
                      (!causal || n0 + kBlockN - 1 <= m0 + warp * 16);
    // scale, mask, block row max (rows g and g + 8 of the warp)
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        const bool ok = full || (key < t_len && (!causal || key <= row));
        const float x = ok ? s[j][e] * scale : kMaskValue;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        const bool ok = full || (key < t_len && (!causal || key <= row));
        const float p = ok ? expf(s[j][e] - m_run[e >> 1]) : 0.f;
        s[j][e] = p;
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      o_acc[jd][0] *= corr[0];
      o_acc[jd][1] *= corr[0];
      o_acc[jd][2] *= corr[1];
      o_acc[jd][3] *= corr[1];
    }
    cp_async_wait<1>();  // V_n landed
    __syncthreads();
    if constexpr (sizeof(T) == 2) {
      pv_bf16<D, NB>(o_acc, s, sv, lane);
    } else {
      pv_f32<D, NB>(o_acc, s, sp + warp * 16 * S::kLdP, sv, g, t);
    }
    __syncthreads();  // every warp is done with V_n
    if (more) load_tile_async<T, D, kBlockN>(sv, vg, v_st, n0 + kBlockN, t_len);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // the row sums over the 4 threads of a group, then O / max(l, 1e-30)
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[r] = fmaxf(l, 1e-30f);
  }
  T* og = o + b * o_sb + static_cast<int64_t>(h) * D + 2 * t;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    if (row_lo < t_len) {
      store2(og + static_cast<int64_t>(row_lo) * o_st + 8 * jd,
             o_acc[jd][0] / den[0], o_acc[jd][1] / den[0]);
    }
    if (row_hi < t_len) {
      store2(og + static_cast<int64_t>(row_hi) * o_st + 8 * jd,
             o_acc[jd][2] / den[1], o_acc[jd][3] / den[1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t batch, int64_t t_len, int64_t heads, int64_t group,
                   const int64_t* sb, const int64_t* st, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((t_len + kBlockM - 1) / kBlockM),
                  static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<int>(t_len),
      static_cast<int>(group), sb[0], sb[1], sb[2],
      sb[3], st[0], st[1], st[2], st[3], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int64_t d, const void* q, const void* k, const void* v,
                       void* o, int64_t batch, int64_t t_len, int64_t heads,
                       int64_t group, const int64_t* sb, const int64_t* st,
                       float scale, int causal, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, batch, t_len, heads, group, sb, st,
                           scale, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, t_len, heads, group, sb, st,
                           scale, causal, s);
    case 96:
      return launch<T, 96>(q, k, v, o, batch, t_len, heads, group, sb, st,
                           scale, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, t_len, heads, group, sb, st,
                            scale, causal, s);
    case 160:
      return launch<T, 160>(q, k, v, o, batch, t_len, heads, group, sb, st,
                            scale, causal, s);
    case 192:
      return launch<T, 192>(q, k, v, o, batch, t_len, heads, group, sb, st,
                            scale, causal, s);
    case 224:
      return launch<T, 224>(q, k, v, o, batch, t_len, heads, group, sb, st,
                            scale, causal, s);
    case 256:
      return launch<T, 256>(q, k, v, o, batch, t_len, heads, group, sb, st,
                            scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* akka_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 float32, 1 bfloat16. Strides are in elements: batch strides
// (q, k, v, o) then row strides (q, k, v, o).
int akka_flash_attention_fwd(int dtype, const void* q, const void* k,
                             const void* v, void* o, int64_t batch,
                             int64_t t_len, int64_t heads, int64_t kv_heads,
                             int64_t d, int64_t q_sb, int64_t k_sb,
                             int64_t v_sb, int64_t o_sb, int64_t q_st,
                             int64_t k_st, int64_t v_st, int64_t o_st,
                             float scale, int causal, int device,
                             void* stream) {
  if (batch < 1 || t_len < 1 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || heads > 65535 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t sb[4] = {q_sb, k_sb, v_sb, o_sb};
  const int64_t st[4] = {q_st, k_st, v_st, o_st};
  const int64_t group = heads / kv_heads;
  if (dtype == 0) {
    err = dispatch_d<float>(d, q, k, v, o, batch, t_len, heads, group, sb, st,
                            scale, causal, s);
  } else if (dtype == 1) {
    err = dispatch_d<bf16>(d, q, k, v, o, batch, t_len, heads, group, sb, st,
                           scale, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
