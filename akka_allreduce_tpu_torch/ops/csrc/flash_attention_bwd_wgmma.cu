// Flash-attention backward for Hopper (sm_90a) in bf16: K4's VJP on the
// tensor-core path, designed for the card (TMA, mbarrier pipelines, wgmma
// with register operands). The f32 backward is flash_attention_bwd_3xtf32.cu,
// on the same plan in split TF32.
//
// Replaces the custom VJP of the library Pallas TPU kernel that the flash
// branch of akka_allreduce_tpu/ops/local_attention.py local_attention
// calls (jax.experimental.pallas.ops.tpu.flash_attention): its two kernels
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq, and the
// di = sum(o * do, -1) taken between them outside any kernel, which here is
// folded into the dQ kernel.
//
// From Q, K, V, O, dO and the forward's row statistic lse (B, H, T) f32,
// per (batch, head), with G = H / H_kv and kv head h / G:
//   di_i  = sum_d o_id do_id              (f32, written to a (B, H, T) buffer)
//   s_ij  = (q_i . k_j) * scale           (f32; masked where causal and j > i)
//   p_ij  = exp(s_ij - lse_i), exactly 0 where masked
//   dv_j  = sum_i p_ij do_i               dp_ij = do_i . v_j
//   ds_ij = p_ij (dp_ij - di_i)
//   dq_i  = scale * sum_j ds_ij k_j       dk_j  = scale * sum_i ds_ij q_i
// dK and dV are summed over the G query heads of each kv head and written in
// the compact (B, T, H_kv, D) shape; dQ is (B, T, H, D). All bf16 in and
// out, accumulated in f32; P and dS are rounded to bf16 before their
// products, as the forward rounds P.
//
// Bound: operations. Five products of 2 * T^2 * D FLOP per (b, h), halved
// under causal masking: 3.44e11 FLOP at the flagship (B 8, T 2048, H 16,
// D 128, causal) against 6 x 67 MB moved, far above the card's ridge. This
// design runs seven: the dQ kernel recomputes S and dP.
//
// Design (the FlashAttention-3 backward, made deterministic: no atomics,
// each output element written once, so a repeat is bit-identical):
// - Two kernels on the caller's stream, dQ first. Each CTA is two consumer
//   warpgroups of 64 rows each, and thread 0 also issues every TMA load.
//   Streamed tiles go through a ring of three stages (two where three do
//   not fit in shared memory) with full (TMA transaction count) and empty
//   (one arrival per warp) mbarriers; a stage is refilled as soon as both
//   consumers have released it, one tile behind, so that one consumer may
//   run a tile ahead of the other. A dedicated producer warp was measured
//   and left out: ptxas then holds every thread to 168 registers, and the
//   dK/dV kernel spills.
// - dQ: one CTA per (128 query rows, head, batch). Q and dO are loaded once;
//   K and V stream in tiles of 128 keys (32 above D 128), with separate full
//   barriers, so S waits only for K. The consumers first take di for their
//   rows from O and dO in global memory (one read each) and write it out;
//   then per key tile S = Q K^T and dP = dO V^T (wgmma from shared memory),
//   P = 2^(S scale log2e - lse log2e) and dS = P (dP - di) in the
//   accumulator registers, and dQ += dS K with dS as the register A operand
//   and K as the MN-major B (no shared-memory round trip); P is formed
//   while the dP product runs. Causal key tiles above the diagonal are
//   skipped, and the query blocks with the most key tiles launch first.
// - dK/dV: one CTA per (128 keys, kv head, batch), reading the di the dQ
//   kernel wrote. K and V are loaded once; thread 0 streams Q, dO (64
//   query rows a tile, 32 above D 128) and their lse and di rows (bulk
//   copies onto the same barrier) for every query head of the GQA group in
//   turn, from the diagonal down under causal masking. Per tile each
//   consumer forms S^T = K Q^T and dP^T = V dO^T for its 64 keys, P^T and
//   dS^T in registers, and dV += P^T dO, dK += dS^T Q (register A), each
//   product issued as soon as its operand is formed, so dP^T's product runs
//   while P^T is formed and dV's while dS^T is. Above D 128 the dK and dV
//   accumulators (D floats a thread) do not fit: two CTAs share a key
//   block, one accumulating columns 0-127 and the other the rest, both
//   forming S^T and dP^T.
// - Tiles arrive by TMA in the swizzled layout wgmma reads (hopper.cuh):
//   4-D maps (D, H, T, B) over the tensors in place, 64-column boxes with a
//   128-byte swizzle and a 64-byte one for a 32-column remainder; rows past
//   T are zero-filled. T is a multiple of 64, so every query tile of the
//   dK/dV kernel is whole; rows and keys past T in a ragged 128-block are
//   zeros that only feed outputs that are not stored, or (the dQ kernel's
//   keys) are masked.
//
// The C entry launches both kernels on the caller's stream, does not
// synchronise, and returns a CUDA error code (cudaErrorInvalidValue for a
// shape it does not cover).

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace akka_flash;
using namespace akka_sm90;

// Two consumer warpgroups and nothing else: ptxas holds a kernel of more
// than 256 threads to 168 registers a thread whatever setmaxnreg asks at
// run time (with a producer warp or warpgroup the dK/dV kernel at D 128
// spilled), and the dK and dV accumulators need about 240. Thread 0
// issues every TMA load.
constexpr int kThreads = 256;
constexpr int kWarps = 8;
constexpr int kBlock = 128;  // query rows of a dQ CTA, keys of a dK/dV CTA
constexpr float kLog2e = 1.4426950408889634f;

// the column blocks of a tile of R rows x D in shared memory: D / 64 blocks
// of R x 128 bytes (128-byte swizzle), then one of R x 64 bytes (64-byte
// swizzle) when D % 64 == 32
template <int D>
struct Cols {
  static constexpr int kWide = D / 64;
  static constexpr bool kTail = D % 64 != 0;
  static_assert(D % 32 == 0 && D >= 32 && D <= 256, "D in 32..256 step 32");
};

// three stages of streamed tiles where they fit, else two; plus the
// barriers (8 bytes each) and 1024 bytes of slack to align the dynamic
// shared memory to the swizzle's period
constexpr int stages(int fixed, int stage, int barriers_a_stage) {
  return fixed + 3 * stage + 8 * (1 + 3 * barriers_a_stage) + 1024 <=
                 static_cast<int>(kMaxSmem)
             ? 3
             : 2;
}

template <int D>
struct DqCfg {
  static constexpr int kBlockN = D <= 128 ? 128 : 32;  // keys per tile
  static constexpr int kRowBytes = kBlock * D * 2;  // Q or dO
  static constexpr int kTileBytes = kBlockN * D * 2;  // one K or V tile
  static constexpr int kKOff = 2 * kRowBytes;  // stage s: K, then V
  static constexpr int kStages = stages(kKOff, 2 * kTileBytes, 3);
  static constexpr int kBarOff = kKOff + kStages * 2 * kTileBytes;
  // barriers: qdo_full, full_k[S], full_v[S], empty[S]
  static constexpr size_t kSmem = kBarOff + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kSmem <= kMaxSmem, "tile set exceeds shared memory");
};

template <int D>
struct DkvCfg {
  static constexpr int kBlockM = D <= 128 ? 64 : 32;  // query rows per tile
  static constexpr int kSplit = D <= 128 ? 1 : 2;  // CTAs sharing a key block
  static constexpr int kKVBytes = kBlock * D * 2;  // K or V
  static constexpr int kTileBytes = kBlockM * D * 2;  // one Q or dO tile
  static constexpr int kStatBytes = kBlockM * 4;  // one lse or di tile
  // a stage: Q, dO, lse, di; whole 1024-byte periods
  static constexpr int kStageBytes =
      (2 * kTileBytes + 2 * kStatBytes + 1023) / 1024 * 1024;
  static constexpr int kStageOff = 2 * kKVBytes;
  static constexpr int kStages = stages(kStageOff, kStageBytes, 2);
  static constexpr int kBarOff = kStageOff + kStages * kStageBytes;
  // barriers: kv_full, full[S], empty[S]
  static constexpr size_t kSmem = kBarOff + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kSmem <= kMaxSmem, "tile set exceeds shared memory");
};

// TMA maps of one kernel: q, k, v, do, each as 64-column and 32-column boxes
struct Maps {
  CUtensorMap wide[4], tail[4];
};
enum { kQ = 0, kK = 1, kV = 2, kDo = 3 };

struct Args {
  const bf16* o;
  const bf16* dout;
  const float* lse;
  float* di;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int t_len, heads, kv_heads;
  int64_t o_sb, o_st, do_sb, do_st;
  float scale, scale_log2;
  int causal;
};

__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// the TMA loads of one tile (R rows from `row`) into its column blocks
template <int D, int R>
__device__ __forceinline__ void load_tile(unsigned char* dst, const Maps& maps,
                                          int x, uint64_t* bar, int head,
                                          int row, int b) {
  using C = Cols<D>;
#pragma unroll
  for (int j = 0; j < C::kWide; ++j) {
    tma_load(dst + j * R * 128, &maps.wide[x], bar, 64 * j, head, row, b);
  }
  if constexpr (C::kTail) {
    tma_load(dst + C::kWide * R * 128, &maps.tail[x], bar, 64 * C::kWide,
             head, row, b);
  }
}

// acc (64 x N) = A B^T over D, both K-major: A is 64 rows of a tile of RA
// rows (a_wide: its first row in the first 64-column block, whose blocks
// lie RA * 128 bytes apart; a_tail: its first row in the 32-column block),
// B a whole tile of N rows at b. 4 k steps a 64-column block, 2 in the
// 32-column one.
template <int D, int RA, int N>
__device__ __forceinline__ void ss_product(float* acc, uint32_t a_wide,
                                           uint32_t a_tail, uint32_t b) {
  using C = Cols<D>;
#pragma unroll
  for (int j = 0; j < C::kWide; ++j) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      wgmma_ss<N>(acc, make_desc(a_wide + j * RA * 128 + 32 * u, 16, 1024, 1),
                  make_desc(b + j * N * 128 + 32 * u, 16, 1024, 1), j + u > 0);
    }
  }
  if constexpr (C::kTail) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      wgmma_ss<N>(acc, make_desc(a_tail + 32 * u, 16, 512, 2),
                  make_desc(b + C::kWide * N * 128 + 32 * u, 16, 512, 2),
                  C::kWide + u > 0);
    }
  }
}

// acc (64 x DC) += A B: A from registers (R / 16 k steps), B columns
// [C0, C0 + DC) of a tile of R rows at `tile`, read MN-major (D contiguous):
// the 64-column blocks in one product, the 32-column block in another. C0
// is 0 or 128, so the columns are whole blocks.
template <int D, int R, int C0, int DC>
__device__ __forceinline__ void rs_product(float* acc,
                                           const uint32_t (*a)[4],
                                           uint32_t tile) {
  constexpr bool kTail = C0 + DC == D && Cols<D>::kTail;
  constexpr int kNw = (DC - (kTail ? 32 : 0)) / 64;
  static_assert(C0 % 64 == 0 && DC > 0 && C0 + DC <= D, "whole blocks");
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
    if constexpr (kNw > 0) {
      wgmma_rs<64 * kNw>(acc, a[kk],
                         make_desc(tile + (C0 / 64) * R * 128 + kk * 16 * 128,
                                   R * 128, 1024, 1),
                         1);
    }
    if constexpr (kTail) {
      wgmma_rs<32>(acc + 32 * kNw, a[kk],
                   make_desc(tile + Cols<D>::kWide * R * 128 + kk * 16 * 64,
                             R * 64, 512, 2),
                   1);
    }
  }
}

// N columns of f32 accumulators rounded to bf16 as the A operand of a
// product over them: 16 columns, two 8-column accumulator tiles, a step
template <int N>
__device__ __forceinline__ void to_operand(uint32_t (&x)[N / 16][4],
                                           const float (&f)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    x[kk][0] = pack_f32_as_bf16(f[8 * kk], f[8 * kk + 1]);
    x[kk][1] = pack_f32_as_bf16(f[8 * kk + 2], f[8 * kk + 3]);
    x[kk][2] = pack_f32_as_bf16(f[8 * kk + 4], f[8 * kk + 5]);
    x[kk][3] = pack_f32_as_bf16(f[8 * kk + 6], f[8 * kk + 7]);
  }
}

// sum over 8 bf16 pairs (x_i * y_i) in f32
__device__ __forceinline__ float dot8(uint4 x, uint4 y) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s += __uint_as_float(xs[i] << 16) * __uint_as_float(ys[i] << 16);
    s += __uint_as_float(xs[i] & 0xffff0000u) *
         __uint_as_float(ys[i] & 0xffff0000u);
  }
  return s;
}

// The refill of a ring of S stages: once tile i is done, the stage of tile
// i + 2 - S (this one when S is 2, the one before when S is 3, so that a
// consumer may run a tile ahead of the other) takes tile i + 2, when both
// consumers have released it. Returns that tile, or -1.
__device__ __forceinline__ int refill(int i, int stages, int n,
                                      uint64_t* empty) {
  const int r = i + 2 - stages;
  if (r < 0 || r + stages >= n) return -1;
  mbar_wait(&empty[r % stages], (r / stages) & 1);
  return r + stages;
}

// ---- dQ (and di) ------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ Maps maps, const Args a) {
  using C = DqCfg<D>;
  constexpr int BN = C::kBlockN;
  constexpr int S = C::kStages;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full_k = qdo_full + 1;
  uint64_t* full_v = full_k + S;
  uint64_t* empty = full_v + S;

  const int t_len = a.t_len;
  // causal: the last query blocks have the most key tiles; launch them first
  const int mb = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int m0 = mb * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.heads / a.kv_heads);
  const int kv_end = a.causal ? min(t_len, m0 + kBlock) : t_len;
  const int n_blocks = (kv_end + BN - 1) / BN;

  // K and V of key tile i into its stage (thread 0)
  auto load_kv = [&](int i) {
    const int st = i % S;
    unsigned char* tile = smem + C::kKOff + st * 2 * C::kTileBytes;
    mbar_expect_tx(&full_k[st], C::kTileBytes);
    load_tile<D, BN>(tile, maps, kK, &full_k[st], kvh, i * BN, b);
    mbar_expect_tx(&full_v[st], C::kTileBytes);
    load_tile<D, BN>(tile + C::kTileBytes, maps, kV, &full_v[st], kvh, i * BN,
                     b);
  };
  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    fence_barrier_init();
    mbar_expect_tx(qdo_full, 2 * C::kRowBytes);
    load_tile<D, kBlock>(smem, maps, kQ, qdo_full, h, m0, b);
    load_tile<D, kBlock>(smem + C::kRowBytes, maps, kDo, qdo_full, h, m0, b);
    for (int i = 0; i < min(S, n_blocks); ++i) load_kv(i);
  }
  __syncthreads();

  // consumer c owns query rows m0 + 64c .. + 63
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int row0 = m0 + 64 * c;
  const int row_lo = row0 + 16 * (tid / 32) + lane / 4;  // and row_lo + 8

  // di for this thread's two rows: the 4 threads of a quad each take every
  // fourth 16-byte chunk of O and dO, then sum over the quad
  float di[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    float sum = 0.f;
    if (row < t_len) {
      const uint4* o4 = reinterpret_cast<const uint4*>(
          a.o + b * a.o_sb + row * a.o_st + static_cast<int64_t>(h) * D);
      const uint4* do4 = reinterpret_cast<const uint4*>(
          a.dout + b * a.do_sb + row * a.do_st + static_cast<int64_t>(h) * D);
#pragma unroll
      for (int j = 0; j < D / 32; ++j) sum += dot8(o4[4 * j + t], do4[4 * j + t]);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    di[r] = sum;
    const int64_t stat = (static_cast<int64_t>(b) * a.heads + h) * t_len + row;
    if (row < t_len && t == 0) a.di[stat] = sum;
    lse2[r] = row < t_len ? a.lse[stat] * kLog2e : 0.f;
  }

  const uint32_t base = smem_addr(smem);
  const uint32_t q_wide = base + c * 64 * 128;
  const uint32_t q_tail = base + Cols<D>::kWide * kBlock * 128 + c * 64 * 64;
  float acc_dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dq[i] = 0.f;

  mbar_wait(qdo_full, 0);
  __syncwarp();  // converged for the .aligned wgmma instructions
  for (int i = 0; i < n_blocks; ++i) {
    const int s = i % S;
    const uint32_t phase = (i / S) & 1;
    const int n0 = i * BN;
    const uint32_t k_addr = base + C::kKOff + s * 2 * C::kTileBytes;
    float acc_s[BN / 2];
    float acc_dp[BN / 2];
    mbar_wait(&full_k[s], phase);
    __syncwarp();
    wgmma_fence();
    ss_product<D, kBlock, BN>(acc_s, q_wide, q_tail, k_addr);
    wgmma_commit();
    mbar_wait(&full_v[s], phase);
    __syncwarp();
    wgmma_fence();
    ss_product<D, kBlock, BN>(acc_dp, q_wide + C::kRowBytes,
                              q_tail + C::kRowBytes, k_addr + C::kTileBytes);
    wgmma_commit();
    wgmma_wait<1>();  // S has landed; dP may still run
    fence_regs(acc_s);

    // P, then dS, in the accumulator layout: rows row_lo + 8 ((e >> 1) & 1),
    // keys n0 + 8 (e / 4) + 2t + (e & 1). The keys past T of a last tile are
    // masked in a loop of their own: folded into this loop's test, they made
    // the kernel about a fifth slower on an H100.
    const bool diag = a.causal && n0 + BN - 1 > row0;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int r = (e >> 1) & 1;
      float p = exp2_approx(fmaf(acc_s[e], a.scale_log2, -lse2[r]));
      if (diag && n0 + 8 * (e / 4) + 2 * t + (e & 1) > row_lo + 8 * r) {
        p = 0.f;
      }
      acc_s[e] = p;
    }
    if (n0 + BN > t_len) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        if (n0 + 8 * (e / 4) + 2 * t + (e & 1) >= t_len) acc_s[e] = 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc_dp);
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      acc_dp[e] = acc_s[e] * (acc_dp[e] - di[(e >> 1) & 1]);
    }
    uint32_t ds[BN / 16][4];
    to_operand<BN>(ds, acc_dp);

    fence_regs(acc_dq);
    wgmma_fence();
    rs_product<D, BN, 0, D>(acc_dq, ds, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 0) {
      const int next = refill(i, S, n_blocks, empty);
      if (next >= 0) load_kv(next);
    }
  }

  // dQ (B, T, H, D), dense, times the scale
  const int64_t ld = static_cast<int64_t>(a.heads) * D;
  bf16* dq = a.dq + (static_cast<int64_t>(b) * t_len) * ld +
             static_cast<int64_t>(h) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row_lo < t_len) {
      store2(dq + row_lo * ld + 8 * j, acc_dq[4 * j] * a.scale,
             acc_dq[4 * j + 1] * a.scale);
    }
    if (row_lo + 8 < t_len) {
      store2(dq + (row_lo + 8) * ld + 8 * j, acc_dq[4 * j + 2] * a.scale,
             acc_dq[4 * j + 3] * a.scale);
    }
  }
}

// ---- dK and dV --------------------------------------------------------------

// where a dK/dV CTA streams from: its keys, kv head, batch and the flat loop
// of n_it = G * n_m steps over (query head of the group, query tile)
struct DkvWalk {
  int n0, kvh, b, group, m_begin, n_m, n_it;
};

// Q, dO, lse and di of step `it` into its stage (thread 0)
template <int D>
__device__ __forceinline__ void dkv_load(unsigned char* smem, const Maps& maps,
                                         const Args& a, const DkvWalk& w,
                                         int it) {
  using C = DkvCfg<D>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff) + 1;
  const int st = it % C::kStages;
  const int h = w.kvh * w.group + it / w.n_m;
  const int m0 = w.m_begin + (it % w.n_m) * C::kBlockM;
  unsigned char* stage = smem + C::kStageOff + st * C::kStageBytes;
  mbar_expect_tx(&full[st], 2 * C::kTileBytes + 2 * C::kStatBytes);
  load_tile<D, C::kBlockM>(stage, maps, kQ, &full[st], h, m0, w.b);
  load_tile<D, C::kBlockM>(stage + C::kTileBytes, maps, kDo, &full[st], h, m0,
                           w.b);
  const int64_t stat = (static_cast<int64_t>(w.b) * a.heads + h) * a.t_len + m0;
  bulk_load(stage + 2 * C::kTileBytes, a.lse + stat, C::kStatBytes, &full[st]);
  bulk_load(stage + 2 * C::kTileBytes + C::kStatBytes, a.di + stat,
            C::kStatBytes, &full[st]);
}

// One consumer's part of the dK/dV kernel: its 64 keys and the columns
// [C0, C0 + DC) of dK and dV, over every streamed query tile.
template <int D, int C0, int DC>
__device__ __forceinline__ void dkv_consumer(unsigned char* smem,
                                             const Maps& maps, const Args& a,
                                             const DkvWalk& w) {
  using C = DkvCfg<D>;
  constexpr int BM = C::kBlockM;
  constexpr int S = C::kStages;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int t_len = a.t_len;
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int kc0 = w.n0 + 64 * c;
  const int key_lo = kc0 + 16 * (tid / 32) + lane / 4;  // and key_lo + 8
  const uint32_t base = smem_addr(smem);
  const uint32_t k_wide = base + c * 64 * 128;
  const uint32_t k_tail = base + Cols<D>::kWide * kBlock * 128 + c * 64 * 64;

  float acc_dv[DC / 2];
  float acc_dk[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) acc_dv[i] = acc_dk[i] = 0.f;

  mbar_wait(kv_full, 0);
  __syncwarp();
  for (int it = 0; it < w.n_it; ++it) {
    const int s = it % S;
    const int m0 = w.m_begin + (it % w.n_m) * BM;
    const uint32_t q_addr = base + C::kStageOff + s * C::kStageBytes;
    const uint32_t do_addr = q_addr + C::kTileBytes;
    const float* s_lse = reinterpret_cast<const float*>(
        smem + C::kStageOff + s * C::kStageBytes + 2 * C::kTileBytes);
    const float* s_di = s_lse + BM;
    mbar_wait(&full[s], (it / S) & 1);
    __syncwarp();
    // under causal masking a tile whose rows all precede the keys adds 0
    if (!(a.causal && kc0 > m0 + BM - 1)) {
      float acc_s[BM / 2];
      float acc_dp[BM / 2];
      wgmma_fence();
      ss_product<D, kBlock, BM>(acc_s, k_wide, k_tail, q_addr);
      wgmma_commit();
      ss_product<D, kBlock, BM>(acc_dp, k_wide + C::kKVBytes,
                                k_tail + C::kKVBytes, do_addr);
      wgmma_commit();
      wgmma_wait<1>();  // S^T has landed; dP^T may still run
      fence_regs(acc_s);

      // P^T, then dS^T, in the accumulator layout: keys key_lo + 8 (e >> 1),
      // query rows m0 + 8j + 2t + (e & 1); dV's product runs while dS^T is
      // formed
      const bool diag = a.causal && kc0 + 63 > m0;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(s_lse + 8 * j + 2 * t);
        const float lse2[2] = {l2.x * kLog2e, l2.y * kLog2e};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          float p = exp2_approx(fmaf(acc_s[x], a.scale_log2, -lse2[e & 1]));
          if (diag && key_lo + 8 * (e >> 1) > m0 + 8 * j + 2 * t + (e & 1)) {
            p = 0.f;
          }
          acc_s[x] = p;
        }
      }
      uint32_t pt[BM / 16][4];
      to_operand<BM>(pt, acc_s);
      fence_regs(acc_dv);
      wgmma_fence();
      rs_product<D, BM, C0, DC>(acc_dv, pt, do_addr);
      wgmma_commit();

      wgmma_wait<1>();  // dP^T has landed; dV's product may still run
      fence_regs(acc_dp);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(s_di + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          acc_dp[x] = acc_s[x] * (acc_dp[x] - ((e & 1) ? d2.y : d2.x));
        }
      }
      uint32_t dst[BM / 16][4];
      to_operand<BM>(dst, acc_dp);
      fence_regs(acc_dk);
      wgmma_fence();
      rs_product<D, BM, C0, DC>(acc_dk, dst, q_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 0) {
      const int next = refill(it, S, w.n_it, empty);
      if (next >= 0) dkv_load<D>(smem, maps, a, w, next);
    }
  }

  // dK (times the scale) and dV, (B, T, H_kv, D) dense, columns C0 on
  const int64_t ld = static_cast<int64_t>(a.kv_heads) * D;
  const int64_t off = (static_cast<int64_t>(w.b) * t_len) * ld +
                      static_cast<int64_t>(w.kvh) * D + C0 + 2 * t;
  bf16* dk = a.dk + off;
  bf16* dv = a.dv + off;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_lo + 8 * r;
      if (key < t_len) {
        store2(dk + key * ld + 8 * j, acc_dk[4 * j + 2 * r] * a.scale,
               acc_dk[4 * j + 2 * r + 1] * a.scale);
        store2(dv + key * ld + 8 * j, acc_dv[4 * j + 2 * r],
               acc_dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ Maps maps, const Args a) {
  using C = DkvCfg<D>;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::kStages;

  // the query tiles that see some key of the block (from the diagonal down
  // under causal masking), for each query head of the group
  const int n0 = blockIdx.x * kBlock;  // causal: the first blocks do most
  const int m_begin = a.causal ? n0 : 0;
  const int n_m = (a.t_len - m_begin) / C::kBlockM;
  const int group = a.heads / a.kv_heads;
  const DkvWalk w{n0, static_cast<int>(blockIdx.y) / C::kSplit,
                  static_cast<int>(blockIdx.z), group, m_begin, n_m,
                  group * n_m};

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    fence_barrier_init();
    mbar_expect_tx(kv_full, 2 * C::kKVBytes);
    load_tile<D, kBlock>(smem, maps, kK, kv_full, w.kvh, n0, w.b);
    load_tile<D, kBlock>(smem + C::kKVBytes, maps, kV, kv_full, w.kvh, n0, w.b);
    for (int it = 0; it < min(C::kStages, w.n_it); ++it) {
      dkv_load<D>(smem, maps, a, w, it);
    }
  }
  __syncthreads();

  if constexpr (C::kSplit == 1) {
    dkv_consumer<D, 0, D>(smem, maps, a, w);
  } else if (blockIdx.y % C::kSplit == 0) {
    dkv_consumer<D, 0, 128>(smem, maps, a, w);
  } else {
    dkv_consumer<D, 128, D - 128>(smem, maps, a, w);
  }
}

// ---- host ------------------------------------------------------------------

// one backward call: pointers, shape, batch and row strides (elements) of
// q, k, v, o, do; lse and di are dense (B, H, T), dq, dk and dv dense
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* di;
  void* dq;
  void* dk;
  void* dv;
  int64_t batch, t_len, heads, kv_heads;
  int64_t sb[5], st[5];
  float scale;
  int causal;
};

// the 64- and 32-column maps of q, k, v and do, each box `rows[x]` rows
template <int D>
cudaError_t make_maps(Maps* maps, const BwdArgs& a, const int (&rows)[4]) {
  using C = Cols<D>;
  const void* base[4] = {a.q, a.k, a.v, a.dout};
  const int src[4] = {0, 1, 2, 4};  // index into sb, st
  for (int x = 0; x < 4; ++x) {
    const int64_t heads = x == kK || x == kV ? a.kv_heads : a.heads;
    cudaError_t err = cudaSuccess;
    if (C::kWide > 0) {
      err = make_map(&maps->wide[x], base[x], D, heads, a.t_len, a.batch,
                     a.st[src[x]], a.sb[src[x]], 64, rows[x]);
      if (err != cudaSuccess) return err;
    }
    if (C::kTail) {
      err = make_map(&maps->tail[x], base[x], D, heads, a.t_len, a.batch,
                     a.st[src[x]], a.sb[src[x]], 32, rows[x]);
      if (err != cudaSuccess) return err;
    }
    if (C::kWide == 0) maps->wide[x] = maps->tail[x];
    if (!C::kTail) maps->tail[x] = maps->wide[x];
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  using Q = DqCfg<D>;
  using Kv = DkvCfg<D>;
  Maps dq_maps, dkv_maps;
  cudaError_t err = make_maps<D>(
      &dq_maps, a, {kBlock, Q::kBlockN, Q::kBlockN, kBlock});
  if (err != cudaSuccess) return err;
  err = make_maps<D>(&dkv_maps, a, {Kv::kBlockM, kBlock, kBlock, Kv::kBlockM});
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Q::kSmem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Kv::kSmem));
  if (err != cudaSuccess) return err;

  const Args args{
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout), a.lse,
      a.di, static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), static_cast<int>(a.t_len),
      static_cast<int>(a.heads), static_cast<int>(a.kv_heads), a.sb[3],
      a.st[3], a.sb[4], a.st[4], a.scale,
      static_cast<float>(static_cast<double>(a.scale) * 1.4426950408889634),
      a.causal};
  const unsigned blocks = static_cast<unsigned>((a.t_len + kBlock - 1) / kBlock);
  const dim3 grid_q(blocks, static_cast<unsigned>(a.heads),
                    static_cast<unsigned>(a.batch));
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, Q::kSmem, stream>>>(dq_maps, args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(blocks, static_cast<unsigned>(a.kv_heads * Kv::kSplit),
                     static_cast<unsigned>(a.batch));
  flash_bwd_dkv_kernel<D><<<grid_kv, kThreads, Kv::kSmem, stream>>>(dkv_maps,
                                                                   args);
  return cudaGetLastError();
}

// dynamic shared memory of the dQ (kernel 0) or dK/dV (kernel 1) CTA
template <int D>
int smem_bytes(int kernel) {
  return static_cast<int>(kernel == 0 ? DqCfg<D>::kSmem : DkvCfg<D>::kSmem);
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

// bf16 only. Strides are in elements: batch strides (q, k, v, o, do) then
// row strides (q, k, v, o, do), each a multiple of 8 (16-byte rows, as TMA
// needs), with 16-byte-aligned bases; heads and D dense. lse is the
// forward's dense (B, H, T) f32 statistic and di a dense (B, H, T) f32
// scratch that receives sum(o * do, -1), both 16-byte aligned; dq
// (B, T, H, D) and dk, dv (B, T, H_kv, D) are dense bf16 outputs. T must be
// a multiple of 64.
int akka_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* di, void* dq, void* dk,
    void* dv, int64_t batch, int64_t t_len, int64_t heads, int64_t kv_heads,
    int64_t d, int64_t q_sb, int64_t k_sb, int64_t v_sb, int64_t o_sb,
    int64_t do_sb, int64_t q_st, int64_t k_st, int64_t v_st, int64_t o_st,
    int64_t do_st, float scale, int causal, int device, void* stream) {
  if (batch < 1 || t_len < 64 || t_len % 64 != 0 || heads < 1 ||
      kv_heads < 1 || heads % kv_heads != 0 || heads > 65535 ||
      batch > 65535 || t_len > (int64_t{1} << 30) ||
      reinterpret_cast<uintptr_t>(lse) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(di) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs a{q, k, v, o, dout, lse, di, dq, dk, dv,
                  batch, t_len, heads, kv_heads,
                  {q_sb, k_sb, v_sb, o_sb, do_sb},
                  {q_st, k_st, v_st, o_st, do_st}, scale, causal};
  return static_cast<int>(dispatch_d(d, a, static_cast<cudaStream_t>(stream)));
}

// the dynamic shared memory (bytes) one CTA of the dQ (kernel 0) or dK/dV
// (kernel 1) kernel takes at head dimension d; -1 for a d not covered
int akka_flash_attention_bwd_wgmma_smem(int64_t d, int kernel) {
  switch (d) {
    case 32: return smem_bytes<32>(kernel);
    case 64: return smem_bytes<64>(kernel);
    case 96: return smem_bytes<96>(kernel);
    case 128: return smem_bytes<128>(kernel);
    case 160: return smem_bytes<160>(kernel);
    case 192: return smem_bytes<192>(kernel);
    case 224: return smem_bytes<224>(kernel);
    case 256: return smem_bytes<256>(kernel);
    default: return -1;
  }
}

}  // extern "C"
