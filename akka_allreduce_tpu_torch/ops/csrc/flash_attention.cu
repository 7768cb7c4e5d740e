// Flash-attention forward for Hopper (sm_90a) in f32: K4's forward when the
// compute dtype is float32 (bf16 runs flash_attention_wgmma.cu), in f32 FMAs.
// wgmma takes f32 only as TF32: one TF32 pass would break the f32 parity
// held at 1e-4, while split TF32 (three passes, as the f32 backward
// flash_attention_bwd_3xtf32.cu runs) keeps it; this kernel is not on the
// tensor cores yet.
//
// Replaces the flash branch of akka_allreduce_tpu/ops/local_attention.py
// local_attention, which calls the library Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention (forward; the backward is
// flash_attention_bwd_3xtf32.cu).
//
//   o[b, i, h, :] = sum_j p_ij v[b, j, h / G, :] / max(l_i, 1e-30)
//   s_ij = (q[b, i, h, :] . k[b, j, h / G, :]) * scale      (f32)
//   s_ij = -1e30 where masked (causal: j > i)
//   p_ij = exp(s_ij - m_i), exactly 0 where masked;  l_i = sum_j p_ij
//
// with m_i the running row max (starting at -1e30) and G = H / H_kv, the
// grouped-query factor: compact K/V are read in place, never repeated. The
// same launch may also write the row statistic lse_i = m_i + log(l_i)
// (B, H, T) f32, which the backward needs to rebuild p.
// Tensors are (B, T, H, D) with heads and D dense and the batch and row
// strides passed in, so a slice of a longer KV cache needs no copy.
//
// Bound: operations. 4 * B * H * T^2 * D FLOP (halved under causal masking)
// against (3 + 1) * B * T * H * D elements moved: at (2, 2048, 16, 128) f32
// that is 3.4e10 FLOP over 134 MB, above the ridge of the card's 67 TFLOP/s
// of f32 FMAs.
//
// Design, a simple flash-attention-2 forward:
// - one CTA per (query block of 64 rows, head, batch), 4 warps, each warp
//   owning 16 query rows; under causal masking the CTAs with the most key
//   blocks (the last query blocks) are launched first;
// - Q, then each K and V tile of kBlockN (32) keys, staged in shared memory
//   by 16-byte cp.async copies (rows padded so that fragment reads hit 32
//   distinct banks), the next K tile in flight during this block's softmax
//   and PV product, the next V tile during the next block's QK product;
//   key blocks wholly above the diagonal are skipped, the diagonal block is
//   masked element by element;
// - every thread holds its scores and its output accumulator in the
//   register layout of an m16n8 mma accumulator: rows g and g + 8 of its
//   warp's 16 (g = lane / 4), columns 8j + 2t and 8j + 2t + 1 (t = lane % 4);
//   the row max and sum need only the 4 threads of a group (two shuffles);
//   blocks that every row of a warp sees whole skip the element mask;
// - both products as f32 FMAs (not TF32) in that layout; P goes through a
//   per-warp strip of shared memory for the PV product.
// The scale multiplies the f32 scores (as the dense oracle does), the
// exponentials are expf (no fast math), and the output divides by
// max(l, 1e-30). The copies and warp products are in flash_common.cuh.
//
// The C entry launches on the caller's stream, does not synchronise, and
// returns a CUDA error code (cudaErrorInvalidValue for a shape it does not
// cover) for the Python wrapper to raise on.

#include "flash_common.cuh"

namespace {

using namespace akka_flash;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;  // query rows per CTA

template <int D>
struct Smem {
  static constexpr int kBlockN = 32;  // keys a tile: Q + K + V + P strips fit
  static constexpr int kLd = D + Pad<float>::value;  // row pitch, elements
  static constexpr int kLdP = kBlockN + 4;       // f32 P strip row pitch
  static constexpr size_t kQKV =
      static_cast<size_t>(kBlockM + 2 * kBlockN) * kLd * sizeof(float);
  static constexpr size_t kP =
      static_cast<size_t>(kWarps) * 16 * kLdP * sizeof(float);
  static constexpr size_t kBytes = kQKV + kP;
};

// O += P V in f32 FMAs; P goes through this warp's strip of shared memory
template <int D, int NB>
__device__ __forceinline__ void pv_f32(float (&o)[D / 8][4],
                                       const float (&p)[NB][4],
                                       float* __restrict__ sp,
                                       const float* __restrict__ sv,
                                       int lane) {
  constexpr int kLdP = Smem<D>::kLdP;
  store_acc<float, NB>(sp, kLdP, p, 1.f, lane);
  __syncwarp();
  warp_mma<true, D / 8, 8 * NB>(o, sp, kLdP, sv, Smem<D>::kLd, lane);
  __syncwarp();  // the strip is rewritten by the next key block
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int t_len, int group,
                     int64_t q_sb, int64_t k_sb,
                     int64_t v_sb, int64_t o_sb, int64_t q_st, int64_t k_st,
                     int64_t v_st, int64_t o_st, float scale, int causal) {
  using S = Smem<D>;
  constexpr int kBlockN = S::kBlockN;
  constexpr int NB = kBlockN / 8;  // 8-key accumulator tiles per key block
  constexpr int kLd = S::kLd;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sk = sq + kBlockM * kLd;
  float* sv = sk + kBlockN * kLd;
  float* sp = reinterpret_cast<float*>(smem_raw + S::kQKV);

  const int n_mblocks = gridDim.x;
  // causal: the last query blocks have the most key blocks; launch them first
  const int mb = causal ? n_mblocks - 1 - blockIdx.x : blockIdx.x;
  const int m0 = mb * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const float* qg = q + b * q_sb + static_cast<int64_t>(h) * D;
  const float* kg = k + b * k_sb + static_cast<int64_t>(kvh) * D;
  const float* vg = v + b * v_sb + static_cast<int64_t>(kvh) * D;

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
  load_tile_async<float, D, kBlockM, kLd, kThreads>(sq, qg, q_st, m0, t_len);
  load_tile_async<float, D, kBlockN, kLd, kThreads>(sk, kg, k_st, 0, t_len);
  cp_async_commit();
  load_tile_async<float, D, kBlockN, kLd, kThreads>(sv, vg, v_st, 0, t_len);
  cp_async_commit();
  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    const bool more = n0 + kBlockN < kv_end;
    cp_async_wait<1>();  // Q and K_n landed
    __syncthreads();

    float s[NB][4];
    zero_acc(s);
    warp_mma<false, NB, D>(s, sq + warp * 16 * kLd, kLd, sk, kLd, lane);
    __syncthreads();  // every warp is done with K_n
    if (more) {
      load_tile_async<float, D, kBlockN, kLd, kThreads>(sk, kg, k_st,
                                                    n0 + kBlockN, t_len);
    }
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
    pv_f32<D, NB>(o_acc, s, sp + warp * 16 * S::kLdP, sv, lane);
    __syncthreads();  // every warp is done with V_n
    if (more) {
      load_tile_async<float, D, kBlockN, kLd, kThreads>(sv, vg, v_st,
                                                    n0 + kBlockN, t_len);
    }
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
    // the row statistic for the backward: lse = m + log(l), in the units of
    // the scaled scores (-inf for a row that sees no key)
    const int row = r == 0 ? row_lo : row_hi;
    if (lse != nullptr && t == 0 && row < t_len) {
      lse[(static_cast<int64_t>(b) * gridDim.y + h) * t_len + row] =
          m_run[r] + logf(l);
    }
  }
  float* og = o + b * o_sb + static_cast<int64_t>(h) * D + 2 * t;
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

// one forward call: pointers, shape, (q, k, v, o) batch and row strides
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int64_t batch, t_len, heads, group;
  int64_t sb[4], st[4];
  float scale;
  int causal;
};

template <int D>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::kBytes;
  static_assert(smem <= kMaxSmem, "tile set exceeds shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((a.t_len + kBlockM - 1) / kBlockM),
                  static_cast<unsigned>(a.heads),
                  static_cast<unsigned>(a.batch));
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse,
      static_cast<int>(a.t_len), static_cast<int>(a.group), a.sb[0], a.sb[1],
      a.sb[2], a.sb[3], a.st[0], a.st[1], a.st[2], a.st[3], a.scale,
      a.causal);
  return cudaGetLastError();
}

cudaError_t dispatch_d(int64_t d, const FwdArgs& a, cudaStream_t s) {
  switch (d) {
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    case 96: return launch<96>(a, s);
    case 128: return launch<128>(a, s);
    case 160: return launch<160>(a, s);
    case 192: return launch<192>(a, s);
    case 224: return launch<224>(a, s);
    case 256: return launch<256>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* akka_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// float32 only (bf16 has its own entry, with the same arguments, in
// flash_attention_wgmma.cu). Strides are in elements: batch strides
// (q, k, v, o) then row strides (q, k, v, o). lse, when not null, receives
// the (B, H, T) f32 row statistics m + log(l).
int akka_flash_attention_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse,
                             int64_t batch, int64_t t_len, int64_t heads,
                             int64_t kv_heads, int64_t d, int64_t q_sb,
                             int64_t k_sb, int64_t v_sb, int64_t o_sb,
                             int64_t q_st, int64_t k_st, int64_t v_st,
                             int64_t o_st, float scale, int causal, int device,
                             void* stream) {
  if (batch < 1 || t_len < 1 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || heads > 65535 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FwdArgs a{q, k, v, o, lse, batch, t_len, heads, heads / kv_heads,
                  {q_sb, k_sb, v_sb, o_sb}, {q_st, k_st, v_st, o_st}, scale,
                  causal};
  return static_cast<int>(
      dispatch_d(d, a, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
