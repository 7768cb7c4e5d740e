// Flash-attention backward for Hopper (sm_90a) in f32: K4's VJP when the
// compute dtype is float32 (bf16 runs flash_attention_bwd_wgmma.cu: wgmma
// takes f32 only as TF32, which would break the f32 parity held at 1e-4).
//
// Replaces the custom VJP of the library Pallas TPU kernel that the flash
// branch of akka_allreduce_tpu/ops/local_attention.py local_attention
// calls (jax.experimental.pallas.ops.tpu.flash_attention): its two kernels
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq, with
// di = sum(o * do, -1) taken between them outside any kernel (here too: the
// wrapper computes di with one PyTorch reduction before the launch).
//
// From Q, K, V, dO, the forward's row statistic lse (B, H, T) f32 and di,
// per (batch, head), with G = H / H_kv and kv head h / G:
//   s_ij  = (q_i . k_j) * scale          (f32; masked where causal and j > i)
//   p_ij  = exp(s_ij - lse_i), exactly 0 where masked
//   dv_j  = sum_i p_ij do_i              dp_ij = do_i . v_j
//   ds_ij = p_ij (dp_ij - di_i)
//   dq_i  = scale * sum_j ds_ij k_j      dk_j  = scale * sum_i ds_ij q_i
// dK and dV are summed over the G query heads of each kv head and written in
// the compact (B, T, H_kv, D) shape; dQ is (B, T, H, D). All f32.
//
// Bound: operations. Five products of 2 * T^2 * D FLOP per (b, h) (halved
// under causal masking): at (2, 2048, 16, 128) that is 8.6e10 FLOP against
// 6 x 34 MB of Q, K, V, O, dO and dQ/dK/dV moved, above the ridge of the
// card's 67 TFLOP/s of f32 FMAs. This design recomputes S and dP in the dQ
// kernel: seven products run.
//
// Design, two deterministic kernels (no atomics: each output element is
// written once by one thread, so two runs give bit-identical gradients):
// - dK/dV: one CTA per (block of 64 keys, kv head [x D half], batch), four
//   warps of 16 keys. K and V tiles stay in shared memory; the CTA loops
//   over every query head of its GQA group and, for each, over the blocks
//   of 32 query rows that can see its keys (from the diagonal down under
//   causal masking). Each warp computes S^T = K_w Q^T and dP^T = V_w dO^T
//   (16 keys x 32 queries) in registers, forms P^T and dS^T, writes them to
//   a per-warp strip of shared memory, and adds P^T dO and dS^T Q to its
//   accumulators. At D above 128 the accumulators (2 x 16 x D floats a
//   warp) do not fit in registers: two CTAs share a key block, each
//   accumulating one half of D and both recomputing S^T and dP^T.
// - dQ: one CTA per (block of 64 query rows, head, batch), four warps of 16
//   rows, looping over the blocks of 32 keys up to the diagonal: S = Q_w K^T
//   and dP = dO_w V^T, dS into the strip, dQ += dS K.
// - Tiles come in by 16-byte cp.async copies into rows padded so that
//   fragment reads hit 32 distinct banks; the streamed tiles (Q and dO, or K
//   and V) are double-buffered, the next in flight during this one's
//   products, where two sets fit in shared memory (else single).
// - The products are f32 FMAs (not TF32) in the register layout of an
//   m16n8 mma accumulator. The scale multiplies the f32 scores, masked p is
//   exactly 0, the exponentials are expf (no fast math).
//
// The C entry launches both kernels on the caller's stream, does not
// synchronise, and returns a CUDA error code (cudaErrorInvalidValue for a
// shape it does not cover) for the Python wrapper to raise on.

#include "flash_common.cuh"

namespace {

using namespace akka_flash;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// the dK/dV kernel's tiles: 64 keys a CTA, 32 query rows a step
template <int D>
struct DkvTile {
  static constexpr int kBlockN = kWarps * 16;
  static constexpr int kBlockM = 32;
  static constexpr int kSplit = D > 128 ? 2 : 1;  // CTAs sharing a key block
  static constexpr int kDC = D / kSplit;  // dK/dV columns of one CTA
  static constexpr int kLd = D + Pad<float>::value;
  static constexpr int kLdS = kBlockM + Pad<float>::value;  // strip pitch
  static constexpr size_t kKV = 2 * kBlockN * kLd * sizeof(float);
  // one stage: Q and dO tiles, then lse and di
  static constexpr size_t kStage =
      2 * kBlockM * kLd * sizeof(float) + 2 * kBlockM * sizeof(float);
  static constexpr size_t kStrips = kWarps * 2 * 16 * kLdS * sizeof(float);
  static constexpr int kStages = kKV + 2 * kStage + kStrips <= kMaxSmem ? 2 : 1;
  static constexpr size_t kBytes = kKV + kStages * kStage + kStrips;
};

// the dQ kernel's tiles: 64 query rows a CTA, 32 keys a step
template <int D>
struct DqTile {
  static constexpr int kBlockM = kWarps * 16;
  static constexpr int kBlockN = 32;
  static constexpr int kLd = D + Pad<float>::value;
  static constexpr int kLdS = kBlockN + Pad<float>::value;
  static constexpr size_t kQ = 2 * kBlockM * kLd * sizeof(float);  // Q and dO
  static constexpr size_t kStage = 2 * kBlockN * kLd * sizeof(float);  // K and V
  static constexpr size_t kStrips = kWarps * 16 * kLdS * sizeof(float);
  static constexpr int kStages = kQ + 2 * kStage + kStrips <= kMaxSmem ? 2 : 1;
  static constexpr size_t kBytes = kQ + kStages * kStage + kStrips;
};

// one backward call: pointers, shape, strides (elements) of the inputs
// q, k, v, dO (batch, then row); the outputs are dense
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // (B, H, T)
  const float* di;   // (B, H, T)
  void* dq;          // (B, T, H, D)
  void* dk;          // (B, T, H_kv, D)
  void* dv;          // (B, T, H_kv, D)
  int64_t batch, t_len, heads, kv_heads;
  int64_t sb[4], st[4];
  float scale;
  int causal;
};

// 32 floats of a (B, H, T) row statistic into shared memory: 8 threads, 16
// bytes each
__device__ __forceinline__ void load_stat_async(float* dst, const float* src,
                                                int thread0) {
  const int i = threadIdx.x - thread0;
  if (i >= 0 && i < 8) cp_async16(dst + 4 * i, src + 4 * i, true);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(BwdArgs a) {
  using C = DkvTile<D>;
  constexpr int kBlockN = C::kBlockN;
  constexpr int kBlockM = C::kBlockM;
  constexpr int kLd = C::kLd;
  constexpr int kLdS = C::kLdS;
  constexpr int kDC = C::kDC;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);
  float* sv = sk + kBlockN * kLd;
  unsigned char* stages = smem_raw + C::kKV;
  float* strips = reinterpret_cast<float*>(stages + C::kStages * C::kStage);

  const int t_len = static_cast<int>(a.t_len);
  const int group = static_cast<int>(a.heads / a.kv_heads);
  const int n0 = blockIdx.x * kBlockN;  // causal: the first blocks do most
  const int kvh = blockIdx.y / C::kSplit;
  const int dc0 = (blockIdx.y % C::kSplit) * kDC;
  const int b = blockIdx.z;
  const float* q = static_cast<const float*>(a.q) + b * a.sb[0];
  const float* kg = static_cast<const float*>(a.k) + b * a.sb[1] +
                static_cast<int64_t>(kvh) * D;
  const float* vg = static_cast<const float*>(a.v) + b * a.sb[2] +
                static_cast<int64_t>(kvh) * D;
  const float* dout = static_cast<const float*>(a.dout) + b * a.sb[3];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int key_lo = n0 + warp * 16 + g;  // this thread's keys: key_lo, + 8
  float* strip_p = strips + warp * 2 * 16 * kLdS;
  float* strip_ds = strip_p + 16 * kLdS;

  // the query blocks that see some key of the block, for each head of the
  // group: one flat loop of n_it steps over (head, block)
  const int m_begin = a.causal ? (n0 / kBlockM) * kBlockM : 0;
  const int n_m = (t_len - m_begin + kBlockM - 1) / kBlockM;
  const int n_it = group * n_m;

  auto stage_q = [&](int s) {
    return reinterpret_cast<float*>(stages + s * C::kStage);
  };
  auto load_stage = [&](int it, int s) {
    const int h = kvh * group + it / n_m;
    const int m0 = m_begin + (it % n_m) * kBlockM;
    float* sq = stage_q(s);
    float* sdo = sq + kBlockM * kLd;
    float* slse = reinterpret_cast<float*>(sdo + kBlockM * kLd);
    load_tile_async<float, D, kBlockM, kLd, kThreads>(
        sq, q + static_cast<int64_t>(h) * D, a.st[0], m0, t_len);
    load_tile_async<float, D, kBlockM, kLd, kThreads>(
        sdo, dout + static_cast<int64_t>(h) * D, a.st[3], m0, t_len);
    const int64_t row = (static_cast<int64_t>(b) * a.heads + h) * t_len + m0;
    load_stat_async(slse, a.lse + row, 0);
    load_stat_async(slse + kBlockM, a.di + row, 32);
  };

  load_tile_async<float, D, kBlockN, kLd, kThreads>(sk, kg, a.st[1], n0, t_len);
  load_tile_async<float, D, kBlockN, kLd, kThreads>(sv, vg, a.st[2], n0, t_len);
  cp_async_commit();
  load_stage(0, 0);
  cp_async_commit();

  float dk[kDC / 8][4];
  float dv[kDC / 8][4];
  zero_acc(dk);
  zero_acc(dv);
  for (int it = 0; it < n_it; ++it) {
    const int s = C::kStages == 2 ? it % 2 : 0;
    if constexpr (C::kStages == 2) {
      if (it + 1 < n_it) load_stage(it + 1, (it + 1) % 2);
      cp_async_commit();
      cp_async_wait<1>();  // K, V and this step's tiles landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int m0 = m_begin + (it % n_m) * kBlockM;
    const float* sq = stage_q(s);
    const float* sdo = sq + kBlockM * kLd;
    const float* slse = reinterpret_cast<const float*>(sdo + kBlockM * kLd);
    const float* sdi = slse + kBlockM;

    // S^T = K_w Q^T and dP^T = V_w dO^T: 16 keys x 32 query rows
    float st[kBlockM / 8][4];
    float dpt[kBlockM / 8][4];
    zero_acc(st);
    zero_acc(dpt);
    warp_mma<false, kBlockM / 8, D>(st, sk + warp * 16 * kLd, kLd, sq, kLd,
                                    lane);
    warp_mma<false, kBlockM / 8, D>(dpt, sv + warp * 16 * kLd, kLd, sdo, kLd,
                                    lane);
    // P^T and dS^T: row = key, column = query row
#pragma unroll
    for (int j = 0; j < kBlockM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const int key = key_lo + (e < 2 ? 0 : 8);
        const int row = m0 + col;
        const bool ok = row < t_len && (!a.causal || key <= row);
        const float p = ok ? expf(st[j][e] * a.scale - slse[col]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sdi[col]);
      }
    }
    store_acc<float, kBlockM / 8>(strip_p, kLdS, st, 1.f, lane);
    store_acc<float, kBlockM / 8>(strip_ds, kLdS, dpt, 1.f, lane);
    __syncwarp();
    // dV += P^T dO, dK += dS^T Q over this CTA's D columns
    warp_mma<true, kDC / 8, kBlockM>(dv, strip_p, kLdS, sdo + dc0, kLd, lane);
    warp_mma<true, kDC / 8, kBlockM>(dk, strip_ds, kLdS, sq + dc0, kLd, lane);
    __syncthreads();  // every warp is done with this stage and its strips
    if constexpr (C::kStages == 1) {
      if (it + 1 < n_it) load_stage(it + 1, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  const int64_t ld = a.kv_heads * D;
  const int64_t out0 = (static_cast<int64_t>(b) * t_len + n0 + warp * 16) * ld +
                       static_cast<int64_t>(kvh) * D + dc0;
  store_acc<float, kDC / 8>(static_cast<float*>(a.dk) + out0, ld, dk, a.scale, lane);
  store_acc<float, kDC / 8>(static_cast<float*>(a.dv) + out0, ld, dv, 1.f, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(BwdArgs a) {
  using C = DqTile<D>;
  constexpr int kBlockM = C::kBlockM;
  constexpr int kBlockN = C::kBlockN;
  constexpr int kLd = C::kLd;
  constexpr int kLdS = C::kLdS;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sdo = sq + kBlockM * kLd;
  unsigned char* stages = smem_raw + C::kQ;
  float* strips = reinterpret_cast<float*>(stages + C::kStages * C::kStage);

  const int t_len = static_cast<int>(a.t_len);
  const int group = static_cast<int>(a.heads / a.kv_heads);
  // causal: the last query blocks have the most key blocks; launch them first
  const int mb = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int m0 = mb * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const float* qg = static_cast<const float*>(a.q) + b * a.sb[0] +
                static_cast<int64_t>(h) * D;
  const float* kg = static_cast<const float*>(a.k) + b * a.sb[1] +
                static_cast<int64_t>(kvh) * D;
  const float* vg = static_cast<const float*>(a.v) + b * a.sb[2] +
                static_cast<int64_t>(kvh) * D;
  const float* dog = static_cast<const float*>(a.dout) + b * a.sb[3] +
                 static_cast<int64_t>(h) * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row_lo = m0 + warp * 16 + g;  // this thread's rows: row_lo, + 8
  float* strip = strips + warp * 16 * kLdS;

  const int64_t stat0 = (static_cast<int64_t>(b) * a.heads + h) * t_len;
  float lse[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(row_lo + 8 * r, t_len - 1);
    lse[r] = a.lse[stat0 + row];
    di[r] = a.di[stat0 + row];
  }

  const int kv_end = a.causal ? min(t_len, m0 + kBlockM) : t_len;
  const int n_it = (kv_end + kBlockN - 1) / kBlockN;
  auto stage_k = [&](int s) {
    return reinterpret_cast<float*>(stages + s * C::kStage);
  };
  auto load_stage = [&](int it, int s) {
    float* sk = stage_k(s);
    load_tile_async<float, D, kBlockN, kLd, kThreads>(sk, kg, a.st[1],
                                                  it * kBlockN, t_len);
    load_tile_async<float, D, kBlockN, kLd, kThreads>(sk + kBlockN * kLd, vg,
                                                  a.st[2], it * kBlockN, t_len);
  };

  load_tile_async<float, D, kBlockM, kLd, kThreads>(sq, qg, a.st[0], m0, t_len);
  load_tile_async<float, D, kBlockM, kLd, kThreads>(sdo, dog, a.st[3], m0, t_len);
  cp_async_commit();
  load_stage(0, 0);
  cp_async_commit();

  float dq[D / 8][4];
  zero_acc(dq);
  for (int it = 0; it < n_it; ++it) {
    const int s = C::kStages == 2 ? it % 2 : 0;
    if constexpr (C::kStages == 2) {
      if (it + 1 < n_it) load_stage(it + 1, (it + 1) % 2);
      cp_async_commit();
      cp_async_wait<1>();  // Q, dO and this step's K, V landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n0 = it * kBlockN;
    const float* sk = stage_k(s);
    const float* sv = sk + kBlockN * kLd;

    // S = Q_w K^T and dP = dO_w V^T: 16 rows x 32 keys
    float sc[kBlockN / 8][4];
    float dp[kBlockN / 8][4];
    zero_acc(sc);
    zero_acc(dp);
    warp_mma<false, kBlockN / 8, D>(sc, sq + warp * 16 * kLd, kLd, sk, kLd,
                                    lane);
    warp_mma<false, kBlockN / 8, D>(dp, sdo + warp * 16 * kLd, kLd, sv, kLd,
                                    lane);
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + 8 * j + 2 * t + (e & 1);
        const int row = row_lo + (e < 2 ? 0 : 8);
        const bool ok = key < t_len && (!a.causal || key <= row);
        const float p = ok ? expf(sc[j][e] * a.scale - lse[e >> 1]) : 0.f;
        dp[j][e] = p * (dp[j][e] - di[e >> 1]);
      }
    }
    store_acc<float, kBlockN / 8>(strip, kLdS, dp, 1.f, lane);
    __syncwarp();
    // dQ += dS K
    warp_mma<true, D / 8, kBlockN>(dq, strip, kLdS, sk, kLd, lane);
    __syncthreads();  // every warp is done with this stage and its strip
    if constexpr (C::kStages == 1) {
      if (it + 1 < n_it) load_stage(it + 1, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  const int64_t ld = a.heads * D;
  const int64_t out0 = (static_cast<int64_t>(b) * t_len + m0 + warp * 16) * ld +
                       static_cast<int64_t>(h) * D;
  store_acc<float, D / 8>(static_cast<float*>(a.dq) + out0, ld, dq, a.scale, lane);
}

template <int D>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  using Kv = DkvTile<D>;
  using Q = DqTile<D>;
  static_assert(Kv::kBytes <= kMaxSmem && Q::kBytes <= kMaxSmem,
                "tile set exceeds shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Kv::kBytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Q::kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(static_cast<unsigned>(a.t_len / Kv::kBlockN),
                     static_cast<unsigned>(a.kv_heads * Kv::kSplit),
                     static_cast<unsigned>(a.batch));
  flash_bwd_dkv_kernel<D><<<grid_kv, kThreads, Kv::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(static_cast<unsigned>(a.t_len / Q::kBlockM),
                    static_cast<unsigned>(a.heads),
                    static_cast<unsigned>(a.batch));
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, Q::kBytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_d(int64_t d, const BwdArgs& a, cudaStream_t s) {
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

// float32 only (bf16 runs flash_attention_bwd_wgmma.cu). Strides are in
// elements: batch strides (q, k, v, do) then row strides (q, k, v, do);
// heads and D dense. lse and di are dense (B, H, T) f32; dq (B, T, H, D)
// and dk, dv (B, T, H_kv, D) are dense f32 outputs. T must be a multiple
// of 64.
int akka_flash_attention_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* di, void* dq, void* dk, void* dv,
                             int64_t batch, int64_t t_len, int64_t heads,
                             int64_t kv_heads, int64_t d, int64_t q_sb,
                             int64_t k_sb, int64_t v_sb, int64_t do_sb,
                             int64_t q_st, int64_t k_st, int64_t v_st,
                             int64_t do_st, float scale, int causal,
                             int device, void* stream) {
  if (batch < 1 || t_len < 64 || t_len % 64 != 0 || heads < 1 ||
      kv_heads < 1 || heads % kv_heads != 0 || heads > 32767 ||
      batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs a{q, k, v, dout, lse, di, dq, dk, dv,
                  batch, t_len, heads, kv_heads,
                  {q_sb, k_sb, v_sb, do_sb}, {q_st, k_st, v_st, do_st},
                  scale, causal};
  return static_cast<int>(
      dispatch_d(d, a, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
