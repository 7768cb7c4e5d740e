// Flash-attention forward for Hopper (sm_90a) in bf16: K4's forward on the
// tensor-core path, designed for the card (TMA, mbarrier pipelines, wgmma,
// warp specialisation).
//
// Replaces the flash branch of akka_allreduce_tpu/ops/local_attention.py
// local_attention, which calls the library Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention. It computes what the f32
// forward flash_attention_3xtf32.cu computes:
//
//   o[b, i, h, :] = sum_j p_ij v[b, j, h / G, :] / max(l_i, 1e-30)
//   s_ij = (q[b, i, h, :] . k[b, j, h / G, :]) * scale      (f32)
//   p_ij = exp(s_ij - m_i), exactly 0 where masked (causal: j > i);
//   l_i = sum_j p_ij;  lse_i = m_i + log(l_i)  (B, H, T) f32
//
// with (B, T, H, D) tensors read in place through their batch and row
// strides (a slice of a longer KV cache needs no copy) and compact GQA K/V
// (G = H / H_kv), never repeated. Every D the flash gate admits (32 to 256,
// step 32) is covered.
//
// Bound: operations. 4 * B * H * T^2 * D FLOP, halved under causal masking:
// 1.37e11 FLOP at the flagship (B 8, T 2048, H 16, D 128, causal) against
// 268 MB moved, far above the card's ridge.
//
// Design (the FlashAttention-3 shape, simplified), against what held the
// mma.sync kernel back:
// - Products on wgmma, the only route to the full tensor-core rate:
//   S = Q K^T is wgmma.m64n{BN}k16 with Q and K read from shared memory by
//   descriptors; O += P V is wgmma.m64n{D}k16 with P, rounded to bf16 in
//   registers, as the register A operand and V as the MN-major
//   (transposed) B operand. fence / commit_group / wait_group order them.
// - A producer/consumer split: one CTA per (128 query rows, head, batch),
//   three warpgroups. Warpgroup 0 is the producer: one thread issues every
//   TMA load and the group hands its registers over (setmaxnreg 24).
//   Warpgroups 1 and 2 are consumers (setmaxnreg 240), each owning 64 query
//   rows. No __syncthreads after the split: K and V go through a ring of
//   two stages with an mbarrier pair per stage (full, filled by the TMA
//   transaction count; empty, one arrival per consumer warp), and K and V
//   have separate full barriers, so S waits only for K and the PV product
//   only for V.
// - Larger tiles: 128 query rows per CTA share each K/V tile; Q is loaded
//   once by TMA and read by the descriptors in place, never re-fetched into
//   registers. Key tiles are 128 wide for D <= 128; above that 64, so that
//   the O accumulator (D / 2 floats a thread) and S (BN / 2) fit in 240
//   registers.
// - Tiles arrive by TMA in the swizzled layout wgmma reads (hopper.cuh):
//   4-D maps (D, H, T, B) over the tensors in place, 64-column boxes with a
//   128-byte swizzle and a 64-byte one for a 32-column remainder; rows past
//   T are zero-filled, so a ragged last block needs no special load.
// - Softmax in the accumulator layout (online_softmax, flash_common.cuh):
//   the scores are scaled by scale * log2(e) (one FMUL; any sign of
//   scale), the row max is taken on them, and p = 2^(s - m) is one FADD and
//   one ex2; m is kept in base-2 units and lse converted back to natural log
//   (the backward reads it). The element mask is built only on the diagonal
//   block and the ragged edge; masked scores become -inf, whose exponential
//   is exactly 0.
// - Causal: key blocks above the diagonal are skipped, and the CTAs with
//   the most key blocks are launched first (reversed query-block index).
// Each consumer runs Q K^T, softmax, P V in turn on a block; the two
// consumers drift apart, so one's softmax overlaps the other's products.
// Tried on the card and left out: issuing block i's Q K^T before block
// i - 1's P V to overlap the softmax inside a consumer (S, P and O then
// live at once; ptxas spilled P and serialised the wgmmas: slower), the
// pingpong schedule between the consumers (slower), a third stage and a
// TMA store of O through shared memory (no faster than two stages and the
// direct stores below).
//
// No atomics: a repeat is bit-identical. The C entry launches on the
// caller's stream, does not synchronise, and returns a CUDA error code
// (cudaErrorInvalidValue for a shape it does not cover).

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace akka_flash;
using namespace akka_sm90;

constexpr int kBlockM = 128;  // query rows per CTA
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kStages = 2;  // a third stage measured no faster
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kConsumerWarps = 8;
constexpr float kLn2 = 0.693147180559945309f;

template <int D>
struct Cfg {
  static constexpr int kBlockN = D <= 128 ? 128 : 64;  // keys per tile
  static constexpr int kWide = D / 64;  // 64-column blocks, 128-byte swizzle
  static constexpr bool kTail = D % 64 != 0;  // one 32-column block, 64-byte
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kTileBytes = kBlockN * D * 2;  // one K or V tile
  static constexpr int kKOff = kQBytes;  // stage s: K at kKOff + s * 2 tiles
  static constexpr int kBarOff = kQBytes + kStages * 2 * kTileBytes;
  // barriers: q_full, full_k[S], full_v[S], empty[S]; 1024 bytes of slack
  // to align the dynamic shared memory to the 128-byte swizzle's period
  static constexpr size_t kSmem = kBarOff + 8 * (1 + 3 * kStages) + 1024;
  static_assert(D % 32 == 0 && D >= 32 && D <= 256, "D in 32..256 step 32");
  static_assert(kSmem <= kMaxSmem, "tile set exceeds shared memory");
};

struct Maps {
  CUtensorMap q_wide, q_tail, k_wide, k_tail, v_wide, v_tail;
};

// the TMA loads of one tile (R rows from `row`) into its column blocks
template <int D, int R>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* wide,
                                          const CUtensorMap* tail,
                                          uint64_t* bar, int head, int row,
                                          int b) {
  using C = Cfg<D>;
#pragma unroll
  for (int j = 0; j < C::kWide; ++j) {
    tma_load(dst + j * R * 128, wide, bar, 64 * j, head, row, b);
  }
  if constexpr (C::kTail) {
    tma_load(dst + C::kWide * R * 128, tail, bar, 64 * C::kWide, head, row, b);
  }
}

// S (64 x BN) = Q_c K^T over D: Q_c is this consumer's 64 rows of the Q
// tile (from q_wide in the 64-column blocks, which lie kBlockM * 128 bytes
// apart, and from q_tail in the 32-column block), K the stage's tile; both
// K-major, 4 k steps per 64-column block and 2 in the 32-column one
template <int D>
__device__ __forceinline__ void qk_product(float* s, uint32_t q_wide,
                                           uint32_t q_tail, uint32_t k) {
  using C = Cfg<D>;
  constexpr int BN = C::kBlockN;
#pragma unroll
  for (int j = 0; j < C::kWide; ++j) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      wgmma_ss<BN>(s,
                   make_desc(q_wide + j * kBlockM * 128 + 32 * u, 16, 1024, 1),
                   make_desc(k + j * BN * 128 + 32 * u, 16, 1024, 1),
                   j + u > 0);
    }
  }
  if constexpr (C::kTail) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      wgmma_ss<BN>(s, make_desc(q_tail + 32 * u, 16, 512, 2),
                   make_desc(k + C::kWide * BN * 128 + 32 * u, 16, 512, 2),
                   C::kWide + u > 0);
    }
  }
}

// O (64 x D) += P V: P from registers (16 keys a step), V the stage's tile,
// MN-major: the 64-column blocks in one product (lbo steps a block), the
// 32-column block in another
template <int D>
__device__ __forceinline__ void pv_product(float* o,
                                           const uint32_t (*p)[4],
                                           uint32_t v) {
  using C = Cfg<D>;
  constexpr int BN = C::kBlockN;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    if constexpr (C::kWide > 0) {
      wgmma_rs<64 * C::kWide>(
          o, p[kk], make_desc(v + kk * 16 * 128, BN * 128, 1024, 1), 1);
    }
    if constexpr (C::kTail) {
      wgmma_rs<32>(o + 32 * C::kWide, p[kk],
                   make_desc(v + C::kWide * BN * 128 + kk * 16 * 64, BN * 64,
                             512, 2),
                   1);
    }
  }
}

// shared-memory address of stage s's K tile (its V tile follows)
template <int D>
__device__ __forceinline__ uint32_t stage_addr(const unsigned char* smem,
                                               int s) {
  return smem_addr(smem) + Cfg<D>::kKOff + s * 2 * Cfg<D>::kTileBytes;
}

// P (f32, the accumulator layout) rounded to bf16 as the A operand of the
// P V product: 16 keys, two 8-key accumulator tiles, a step
template <int BN>
__device__ __forceinline__ void to_operand(uint32_t (&pa)[BN / 16][4],
                                           const float (&p)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = pack_f32_as_bf16(p[8 * kk], p[8 * kk + 1]);
    pa[kk][1] = pack_f32_as_bf16(p[8 * kk + 2], p[8 * kk + 3]);
    pa[kk][2] = pack_f32_as_bf16(p[8 * kk + 4], p[8 * kk + 5]);
    pa[kk][3] = pack_f32_as_bf16(p[8 * kk + 6], p[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ Maps maps,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           int t_len, int group, int64_t o_sb, int64_t o_st,
                           float scale_log2, int causal) {
  using C = Cfg<D>;
  constexpr int BN = C::kBlockN;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full_k = q_full + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  // causal: the last query blocks have the most key blocks; launch them first
  const int mb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int m0 = mb * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_end = causal ? min(t_len, m0 + kBlockM) : t_len;
  const int n_blocks = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load --------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int kvh = h / group;
      mbar_expect_tx(q_full, C::kQBytes);
      load_tile<D, kBlockM>(smem, &maps.q_wide, &maps.q_tail, q_full, h, m0,
                            b);
      int s = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_blocks; ++i) {
        mbar_wait(&empty[s], phase ^ 1);
        unsigned char* tile = smem + C::kKOff + s * 2 * C::kTileBytes;  // K, V
        mbar_expect_tx(&full_k[s], C::kTileBytes);
        load_tile<D, BN>(tile, &maps.k_wide, &maps.k_tail, &full_k[s], kvh,
                         i * BN, b);
        mbar_expect_tx(&full_v[s], C::kTileBytes);
        load_tile<D, BN>(tile + C::kTileBytes, &maps.v_wide, &maps.v_tail,
                         &full_v[s], kvh, i * BN, b);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each -------------------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int t = lane % 4;
    const int row_lo = m0 + 64 * c + 16 * (tid / 32) + lane / 4;  // and + 8
    // this consumer's rows of Q: 64 rows of 128 bytes into each 64-column
    // block, 64 rows of 64 bytes into the 32-column one
    const uint32_t q_wide = smem_addr(smem) + c * 64 * 128;
    const uint32_t q_tail =
        smem_addr(smem) + C::kWide * kBlockM * 128 + c * 64 * 64;

    float acc_o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
    float m_run[2] = {kMaskValue, kMaskValue};  // base-2 units
    float l_run[2] = {0.f, 0.f};  // this thread's partial row sums

    mbar_wait(q_full, 0);
    __syncwarp();  // converged for the .aligned wgmma instructions
    int s = 0;
    uint32_t phase = 0;
    for (int i = 0; i < n_blocks; ++i) {
      const uint32_t k_addr = stage_addr<D>(smem, s);
      float acc_s[BN / 2];
      mbar_wait(&full_k[s], phase);
      __syncwarp();
      wgmma_fence();
      qk_product<D>(acc_s, q_wide, q_tail, k_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_s);

      float corr[2];
      online_softmax<BN>(acc_s, m_run, l_run, corr, scale_log2, i * BN,
                         row_lo, t, t_len, causal, m0 + 64 * c);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc_o[e] *= corr[(e >> 1) & 1];
      uint32_t pa[BN / 16][4];
      to_operand<BN>(pa, acc_s);

      mbar_wait(&full_v[s], phase);
      __syncwarp();
      fence_regs(acc_o);
      wgmma_fence();
      pv_product<D>(acc_o, pa, k_addr + C::kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }

    // the row sums over the 4 threads of a group, then O / max(l, 1e-30)
    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      den[r] = fmaxf(l, 1e-30f);
      // lse = m + log(l) in natural-log units of the scaled scores (-inf
      // for a row that sees no key)
      const int row = row_lo + 8 * r;
      if (lse != nullptr && t == 0 && row < t_len) {
        lse[(static_cast<int64_t>(b) * gridDim.y + h) * t_len + row] =
            m_run[r] * kLn2 + logf(l);
      }
    }
    bf16* og = o + b * o_sb + static_cast<int64_t>(h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (row_lo < t_len) {
        store2(og + static_cast<int64_t>(row_lo) * o_st + 8 * j,
               acc_o[4 * j] / den[0], acc_o[4 * j + 1] / den[0]);
      }
      if (row_lo + 8 < t_len) {
        store2(og + static_cast<int64_t>(row_lo + 8) * o_st + 8 * j,
               acc_o[4 * j + 2] / den[1], acc_o[4 * j + 3] / den[1]);
      }
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
  int64_t batch, t_len, heads, kv_heads;
  int64_t sb[4], st[4];
  float scale;
  int causal;
};

template <int D>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  using C = Cfg<D>;
  Maps maps;
  const void* base[3] = {a.q, a.k, a.v};
  CUtensorMap* wide[3] = {&maps.q_wide, &maps.k_wide, &maps.v_wide};
  CUtensorMap* tail[3] = {&maps.q_tail, &maps.k_tail, &maps.v_tail};
  for (int x = 0; x < 3; ++x) {
    const int64_t heads = x == 0 ? a.heads : a.kv_heads;
    const int rows = x == 0 ? kBlockM : C::kBlockN;  // a CTA's Q, a K/V tile
    cudaError_t err = cudaSuccess;
    if (C::kWide > 0) {
      err = make_map(wide[x], base[x], D, heads, a.t_len, a.batch, a.st[x],
                     a.sb[x], 64, rows);
      if (err != cudaSuccess) return err;
    }
    if (C::kTail) {
      err = make_map(tail[x], base[x], D, heads, a.t_len, a.batch, a.st[x],
                     a.sb[x], 32, rows);
      if (err != cudaSuccess) return err;
    }
    if (C::kWide == 0) *wide[x] = *tail[x];
    if (!C::kTail) *tail[x] = *wide[x];
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((a.t_len + kBlockM - 1) / kBlockM),
                  static_cast<unsigned>(a.heads),
                  static_cast<unsigned>(a.batch));
  const float scale_log2 =
      static_cast<float>(static_cast<double>(a.scale) * 1.4426950408889634);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      maps, static_cast<bf16*>(a.o), a.lse, static_cast<int>(a.t_len),
      static_cast<int>(a.heads / a.kv_heads), a.sb[3], a.st[3], scale_log2,
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

// bf16 only. Strides are in elements: batch strides (q, k, v, o)
// then row strides (q, k, v, o), each a multiple of 8 (16-byte rows, as TMA
// needs), with 16-byte-aligned bases. lse, when not null, receives the
// (B, H, T) f32 row statistics m + log(l).
int akka_flash_attention_fwd_wgmma(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int64_t batch, int64_t t_len,
                                   int64_t heads, int64_t kv_heads, int64_t d,
                                   int64_t q_sb, int64_t k_sb, int64_t v_sb,
                                   int64_t o_sb, int64_t q_st, int64_t k_st,
                                   int64_t v_st, int64_t o_st, float scale,
                                   int causal, int device, void* stream) {
  if (batch < 1 || t_len < 1 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || heads > 65535 || batch > 65535 ||
      t_len > (int64_t{1} << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FwdArgs a{q, k, v, o, lse, batch, t_len, heads, kv_heads,
                  {q_sb, k_sb, v_sb, o_sb}, {q_st, k_st, v_st, o_st}, scale,
                  causal};
  return static_cast<int>(dispatch_d(d, a, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
