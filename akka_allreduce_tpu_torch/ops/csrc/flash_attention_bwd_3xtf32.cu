// Flash-attention backward for Hopper (sm_90a) in f32: K4's VJP when the
// compute dtype is float32, on the tensor cores through wgmma in split TF32
// (3xTF32), as PyTorch's own f32 attention kernels multiply f32 (CUTLASS's
// OpMultiplyAddFastF32). The bf16 backward is flash_attention_bwd_wgmma.cu.
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
//   di_i  = sum_d o_id do_id              (written to a (B, H, T) buffer)
//   s_ij  = (q_i . k_j) * scale           (masked where causal and j > i)
//   p_ij  = exp(s_ij - lse_i), exactly 0 where masked
//   dv_j  = sum_i p_ij do_i               dp_ij = do_i . v_j
//   ds_ij = p_ij (dp_ij - di_i)
//   dq_i  = scale * sum_j ds_ij k_j       dk_j  = scale * sum_i ds_ij q_i
// dK and dV are summed over the G query heads of each kv head and written in
// the compact (B, T, H_kv, D) shape; dQ is (B, T, H, D). All f32.
//
// Numerics: every product is split TF32. Each f32 operand x becomes
// big = tf32(x) and small = tf32(x - big) (cvt.rna, both explicit), and
// a b ~ small_a big_b + big_a small_b + big_a big_b, three TF32 wgmma
// products into one f32 accumulator, small terms first: an error of about
// 2^-21 |a||b| a term, far inside the 1e-4 the f32 backward is held to.
//
// Bound: operations. Five products of 2 T^2 D FLOP per (b, h), halved under
// causal masking: 8.59e10 FLOP at (B 2, T 2048, H 16, D 128), at the card's
// TF32 rate over three (494.7 / 3 = 164.9 TFLOP/s) 0.521 ms, against 6 x 34
// MB of Q, K, V, O, dO and gradients moved (0.06 ms). This design runs
// seven products: the dQ kernel recomputes S and dP.
//
// What the card imposes, and the design:
// - TF32 wgmma (m64nNk8) reads a shared-memory operand K-major only: no
//   transposed operand. S = Q K^T and dP = dO V^T (and S^T = K Q^T,
//   dP^T = V dO^T) contract over D, along the rows as stored: their B is a
//   streamed tile. dQ += dS K, dV += P^T dO and dK += dS^T Q contract over
//   the rows of the stored tile: they are computed transposed,
//   dQ^T += K^T dS^T, dV^T += dO^T P, dK^T += Q^T dS, with the A operand
//   (K^T, dO^T, Q^T) gathered by the threads from the tile in shared memory
//   into registers, and the B operand the dS (or P^T, dS^T) tile the
//   warpgroup has just formed, written to a shared-memory strip as its
//   accumulator holds it, which is K-major. The transposed accumulators
//   are 64-row tiles of D: a D that is not a multiple of 64 leaves half of
//   its last tile zero.
// - B operands must be TF32 big and small in shared memory. A streamed tile
//   arrives raw by TMA into its big buffer; the consumers then split it in
//   place (big) and into a small buffer, permuting the columns of each
//   group of 8 so that even ones come first. The A operand of the products
//   over D is then a float2 (columns 2t, 2t + 1) of the raw tile per row
//   and k step, split in registers. The resident tiles (Q and dO in dQ, K
//   and V in dK/dV) stay raw, in registers up to D 128: they are only ever
//   an A operand.
// - A register operand must stay untouched until its product is done, so
//   the fragments go in commit groups of two, two groups in flight; and
//   consecutive products feed different accumulators where there are two
//   or more, since a chain into one accumulator waits on each product.
//   A TF32 wgmma with a register A issues far more slowly per FLOP at N 32
//   than at N 64, and one warpgroup alone leaves the tensor cores idle, so
//   each kernel runs two warpgroups and, up to D 128, N 64 products.
// - dQ: one CTA per (64 query rows, head, batch), reading K and V in
//   streamed tiles; two consumer warpgroups over the same rows with a role
//   each: warpgroup 0 forms S = Q K^T and P = 2^(S scale log2e - lse
//   log2e) (to a P buffer), warpgroup 1 dP = dO V^T and dS = P (dP - di)
//   (its strip), and each then accumulates half of dQ^T's 64-row tiles of D
//   (dQ^T += K^T dS^T). Warpgroup 1 first takes di for the rows from O and
//   dO in global memory (one read each) and writes it out. Up to D 128
//   each warpgroup keeps its raw Q or dO fragments in registers and the key
//   tiles are 64 keys (S and dP m64n64 products) in one stage; above, Q and
//   dO stay in shared memory and the tiles are 16 keys. The next tile is
//   split while dQ^T's products run. Causal key tiles above the diagonal
//   are skipped, and the query blocks with the most key tiles launch first.
// - dK/dV: one CTA per (64 keys, kv head, batch), reading the di the dQ
//   kernel wrote; two consumer warpgroups over the same keys with a role
//   each: warpgroup 0 forms S^T = K Q^T, P^T (its strip) and dV^T += dO^T P,
//   warpgroup 1 dP^T = V dO^T, dS^T = P^T (dP^T - di) (reading P^T back
//   from the strip; its own strip) and dK^T += Q^T dS, so that each holds
//   one set of accumulators and the two keep the tensor cores busy between
//   them. Up to D 128 each warpgroup keeps its raw K or V fragments in
//   registers (D / 2 a thread, loaded once through the stage buffer), and
//   the shared memory this frees takes 64-row query tiles in one stage, so
//   S^T and dP^T are m64n64 products; above D 128 K and V stay in shared
//   memory with 16-row tiles. Thread 0 streams Q, dO and their lse and di
//   rows (bulk copies onto the same barrier) for every query head of the
//   GQA group in turn, from the diagonal down under causal masking. Every
//   1,024 query rows each thread adds its dK^T or dV^T accumulators into
//   its own elements of dK or dV in f32 and starts them again from zero: a
//   longer run inside the tensor cores' accumulators drifts from the f32
//   sum (over a GQA group of 16 at T 1024, 16,384 rows, chip_smoke.py's
//   check found dK 1.2e-4 of max|grad| off, past its 1e-4).
// - Thread 0 issues every TMA load; full barriers count the transaction
//   bytes, empty barriers one arrival per warp. T is a multiple of 64, so
//   every streamed tile is whole.
// - Deterministic: no atomics, each output element written by one thread
//   only, in a fixed order, so a repeat is bit-identical.
//
// The C entry launches both kernels on the caller's stream, does not
// synchronise, and returns a CUDA error code (cudaErrorInvalidValue for a
// shape it does not cover).

#include "flash_common.cuh"
#include "tf32.cuh"

namespace {

using namespace akka_flash;
using namespace akka_sm90;
using namespace akka_tf32;

constexpr int kRows = 64;  // query rows (dQ) or keys (dK/dV) a warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// two stages of streamed tiles where they fit, else one; plus the barriers
// (8 bytes each) and 1024 bytes of slack to align the dynamic shared memory
// to the swizzle's period
constexpr int stages(int fixed, int stage) {
  return fixed + 2 * stage + 8 * 5 + 1024 <= static_cast<int>(kMaxSmem) ? 2
                                                                       : 1;
}

template <int D>
struct DqCfg {
  static_assert(D % 32 == 0 && D >= 32 && D <= 256, "D in 32..256 step 32");
  // two warpgroups over the CTA's 64 query rows: S and P (warpgroup 0), dP
  // and dS (warpgroup 1), each then accumulating half of dQ^T's tiles
  static constexpr int kThreads = 256;
  // up to D 128 each warpgroup holds its Q or dO fragments in registers
  // (D / 2 a thread), which leaves room for 64-key tiles; above, Q and dO
  // stay in shared memory and the tiles are 16 keys
  static constexpr bool kQdoInRegs = D <= 128;
  static constexpr int kBlockN = kQdoInRegs ? 64 : 16;  // keys a tile
  static constexpr int kTiles = (D + 63) / 64;  // 64-row tiles of dQ^T
  static constexpr int kTiles0 = (kTiles + 1) / 2;  // warpgroup 0's
  static constexpr int kRowBytes = kRows * D * 4;  // Q or dO
  static constexpr int kQdoBytes = kQdoInRegs ? 0 : kRowBytes;  // resident
  static constexpr int kTileBytes = kBlockN * D * 4;  // K or V, big or small
  static constexpr int kPBytes = kRows * kBlockN * 4;  // P, dS big, dS small
  static constexpr int kPOff = 2 * kQdoBytes;
  static constexpr int kStageOff = kPOff + 3 * kPBytes;
  // a stage: K big, K small, V big, V small
  static constexpr int kStages = stages(kStageOff, 4 * kTileBytes);
  static constexpr int kBarOff = kStageOff + kStages * 4 * kTileBytes;
  // barriers: qdo_full, full[S], empty[S]
  static constexpr size_t kSmem = kBarOff + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kSmem <= kMaxSmem, "tile set exceeds shared memory");
};

template <int D>
struct DkvCfg {
  // two warpgroups over the CTA's 64 keys: S^T, P^T and dV (warpgroup 0),
  // dP^T, dS^T and dK (warpgroup 1)
  static constexpr int kThreads = 256;
  // up to D 128 each warpgroup holds its K or V fragments in registers
  // (D / 2 a thread), which leaves room for 64-row query tiles; above, K
  // and V stay in shared memory and the tiles are 16 rows
  static constexpr bool kKVInRegs = D <= 128;
  static constexpr int kBlockM = kKVInRegs ? 64 : 16;  // query rows a tile
  static constexpr int kTiles = (D + 63) / 64;  // 64-row tiles of dK^T, dV^T
  static constexpr int kKVTile = kRows * D * 4;  // K or V
  static constexpr int kKVBytes = kKVInRegs ? 0 : kKVTile;  // resident
  static constexpr int kTileBytes = kBlockM * D * 4;  // Q or dO, big or small
  static constexpr int kStripBytes = kRows * kBlockM * 4;  // P^T or dS^T, b/s
  static constexpr int kStatBytes = kBlockM * 4;  // lse or di of one tile
  // the query rows one run of the dK^T, dV^T accumulators takes before it is
  // added into dK, dV in f32 (a longer run inside the tensor cores'
  // accumulators drifts from the f32 sum)
  static constexpr int kFlushIts = 1024 / kBlockM;
  static constexpr int kStripOff = 2 * kKVBytes;  // P^T b/s, then dS^T b/s
  static constexpr int kStageOff = kStripOff + 4 * kStripBytes;
  // a stage: Q big, Q small, dO big, dO small; then lse and di of each stage
  static constexpr int kStages =
      stages(kStageOff + 2 * 2 * kStatBytes, 4 * kTileBytes);
  static constexpr int kStatOff = kStageOff + kStages * 4 * kTileBytes;
  static constexpr int kBarOff = kStatOff + kStages * 2 * kStatBytes;
  // barriers: kv_full, full[S], empty[S]
  static constexpr size_t kSmem = kBarOff + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kSmem <= kMaxSmem, "tile set exceeds shared memory");
};

// TMA maps of one kernel: q, k, v, do, 32-column f32 boxes
struct Maps {
  CUtensorMap m[4];
};
enum { kQ = 0, kK = 1, kV = 2, kDo = 3 };

struct Args {
  const float* o;
  const float* dout;
  const float* lse;
  float* di;
  float* dq;
  float* dk;
  float* dv;
  int t_len, heads, kv_heads;
  int64_t o_sb, o_st, do_sb, do_st;
  float scale, scale_log2;
  int causal;
};

// The refill after tile i: once every warp has released its stage, thread
// 0 loads tile i + S into it.
__device__ __forceinline__ bool refill(int i, int stages, int n,
                                       uint64_t* empty) {
  if (threadIdx.x != 0 || i + stages >= n) return false;
  mbar_wait(&empty[i % stages], (i / stages) & 1);
  return true;
}

// ---- dQ (and di) ------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ Maps maps, const Args a) {
  using C = DqCfg<D>;
  constexpr int BN = C::kBlockN;
  constexpr int S = C::kStages;
  constexpr int NT = C::kThreads;
  constexpr int kTiles0 = C::kTiles0;  // dQ^T tiles of warpgroup 0
  constexpr int kTiles1 = C::kTiles - kTiles0;  // and of warpgroup 1

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + S;

  const int t_len = a.t_len;
  // causal: the last query blocks have the most key tiles; launch them first
  const int mb = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int m0 = mb * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.heads / a.kv_heads);
  const int n_tiles = (a.causal ? m0 + kRows : t_len) / BN;

  auto stage = [&](int i) {
    return smem + C::kStageOff + (i % S) * 4 * C::kTileBytes;
  };
  // K and V of key tile i, raw, into the big buffers of its stage
  auto load_kv = [&](int i) {
    unsigned char* st = stage(i);
    mbar_expect_tx(&full[i % S], 2 * C::kTileBytes);
    load_tile<D, BN>(st, &maps.m[kK], &full[i % S], kvh, i * BN, b);
    load_tile<D, BN>(st + 2 * C::kTileBytes, &maps.m[kV], &full[i % S], kvh,
                     i * BN, b);
  };
  // split tile i once it has landed (every thread)
  auto split_kv = [&](int i) {
    mbar_wait(&full[i % S], (i / S) & 1);
    unsigned char* st = stage(i);
    split_tile<D, BN, NT>(st, st + C::kTileBytes);
    split_tile<D, BN, NT>(st + 2 * C::kTileBytes, st + 3 * C::kTileBytes);
    fence_proxy_async();
  };
  // Q and dO land in their resident buffers, or in stage 0 on their way to
  // registers
  unsigned char* qdo = smem + (C::kQdoInRegs ? C::kStageOff : 0);
  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT / 32);
    }
    fence_barrier_init();
    mbar_expect_tx(qdo_full, 2 * C::kRowBytes);
    load_tile<D, kRows>(qdo, &maps.m[kQ], qdo_full, h, m0, b);
    load_tile<D, kRows>(qdo + C::kRowBytes, &maps.m[kDo], qdo_full, h, m0, b);
    if constexpr (!C::kQdoInRegs) {
      for (int i = 0; i < min(S, n_tiles); ++i) load_kv(i);
    }
  }
  __syncthreads();

  const int role = threadIdx.x / 128;  // 0: S, P; 1: dP, dS
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rl = 16 * warp + g;  // this thread's rows: m0 + rl and + 8
  const int row_lo = m0 + rl;

  // warpgroup 1: di for this thread's two rows (the 4 threads of a quad
  // each take every fourth 16-byte chunk of O and dO, then sum over the
  // quad), written out; warpgroup 0: their lse
  float stat[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const int64_t at_row = (static_cast<int64_t>(b) * a.heads + h) * t_len + row;
    if (role == 1) {
      const float4* o4 = reinterpret_cast<const float4*>(
          a.o + b * a.o_sb + row * a.o_st + static_cast<int64_t>(h) * D);
      const float4* do4 = reinterpret_cast<const float4*>(
          a.dout + b * a.do_sb + row * a.do_st + static_cast<int64_t>(h) * D);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const float4 x = o4[4 * j + t];
        const float4 y = do4[4 * j + t];
        sum += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      stat[r] = sum;
      if (t == 0) a.di[at_row] = sum;
    } else {
      stat[r] = a.lse[at_row] * kLog2e;
    }
  }

  // this warp's rows of Q (warpgroup 0) or dO (warpgroup 1), columns
  // 8k + 2t and + 1 of rows rl (.x, .y) and rl + 8 (.z, .w)
  float4 qdo_frag[C::kQdoInRegs ? D / 8 : 1];
  const unsigned char* qdo_tile = qdo + role * C::kRowBytes;
  mbar_wait(qdo_full, 0);
  if constexpr (C::kQdoInRegs) {
#pragma unroll
    for (int k = 0; k < D / 8; ++k) {
      const float2 x = *reinterpret_cast<const float2*>(
          qdo_tile + at<kRows>(rl, 8 * k + 2 * t));
      const float2 y = *reinterpret_cast<const float2*>(
          qdo_tile + at<kRows>(rl + 8, 8 * k + 2 * t));
      qdo_frag[k] = make_float4(x.x, x.y, y.x, y.y);
    }
    fence_proxy_async();
    __syncthreads();  // stage 0 is free for the first key tile
    if (threadIdx.x == 0) {
      for (int i = 0; i < min(S, n_tiles); ++i) load_kv(i);
    }
  }

  unsigned char* p_buf = smem + C::kPOff;  // P, raw
  unsigned char* ds = p_buf + C::kPBytes;  // dS big, then small
  const uint32_t ds_addr = smem_addr(ds);
  float acc_dq[kTiles0][32];  // this warpgroup's dQ^T tiles, from `first`
  const int first = role == 0 ? 0 : kTiles0;
#pragma unroll
  for (int m = 0; m < kTiles0; ++m) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_dq[m][i] = 0.f;
  }

  split_kv(0);
  __syncthreads();
  for (int i = 0; i < n_tiles; ++i) {
    const int n0 = i * BN;
    unsigned char* st = stage(i);
    const uint32_t k_addr = smem_addr(st);

    // S = Q K^T (warpgroup 0) or dP = dO V^T (warpgroup 1)
    float x[BN / 2];
    {
      float* const out[1] = {x};
      const uint32_t bb[1] = {k_addr + 2 * role * C::kTileBytes};
      const uint32_t bs[1] = {k_addr + (2 * role + 1) * C::kTileBytes};
      auto load = [&](int, int k, float2& lo, float2& hi) {
        if constexpr (C::kQdoInRegs) {
          lo = make_float2(qdo_frag[k].x, qdo_frag[k].y);
          hi = make_float2(qdo_frag[k].z, qdo_frag[k].w);
        } else {
          lo = *reinterpret_cast<const float2*>(
              qdo_tile + at<kRows>(rl, 8 * k + 2 * t));
          hi = *reinterpret_cast<const float2*>(
              qdo_tile + at<kRows>(rl + 8, 8 * k + 2 * t));
        }
      };
      products_over_d<D, BN, 1>(out, load, bb, bs);
    }
    wgmma_wait<0>();
    fence_regs(x);

    // in the accumulator layout: rows row_lo + 8 ((e >> 1) & 1), keys
    // n0 + 8 (e / 4) + 2t + (e & 1)
    if (role == 0) {  // P, exactly 0 where masked, to the P buffer
      const bool diag = a.causal && n0 + BN - 1 > row_lo - g;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[e] = exp2_approx(
                fmaf(x[4 * j + 2 * hh + e], a.scale_log2, -stat[hh]));
            if (diag && n0 + 8 * j + 2 * t + e > row_lo + 8 * hh) p[e] = 0.f;
          }
          *reinterpret_cast<float2*>(
              p_buf + strip_at<BN>(rl + 8 * hh, 8 * j + 2 * t)) =
              make_float2(p[0], p[1]);
        }
      }
    }
    bar_sync(1, NT);  // P is whole
    if (role == 1) {  // dS = P (dP - di), to the dS strip
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 p = *reinterpret_cast<const float2*>(
              p_buf + strip_at<BN>(rl + 8 * hh, 8 * j + 2 * t));
          x[4 * j + 2 * hh] = p.x * (x[4 * j + 2 * hh] - stat[hh]);
          x[4 * j + 2 * hh + 1] = p.y * (x[4 * j + 2 * hh + 1] - stat[hh]);
        }
      }
      write_strip<BN>(ds, ds + C::kPBytes, x, rl, t);
      fence_proxy_async();
    }
    bar_sync(1, NT);  // the dS strip is whole

    // dQ^T += K^T dS^T, this warpgroup's 64-row tiles of D (one call site:
    // warpgroup 1 may have a tile fewer, left zero past D)
    if (kTiles1 > 0 || role == 0) {
      products_transposed<D, BN, kTiles0>(acc_dq, st, st + C::kTileBytes,
                                          ds_addr, ds_addr + C::kPBytes,
                                          first, warp, g, t);
    }
    // this warp is done reading the stage: its product over D has landed
    // and its K^T fragments are in registers
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % S]);
    if (refill(i, S, n_tiles, empty)) load_kv(i + S);
    if (i + 1 < n_tiles) split_kv(i + 1);  // while dQ^T's products run
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < kTiles0; ++m) fence_regs(acc_dq[m]);
    __syncthreads();  // the next tile is split, P and the dS strip free
  }

  // dQ (B, T, H, D), dense, times the scale: acc_dq[m][4j + e] is
  // d = 64 (m0 + m) + rl + 8 (e / 2) for this warpgroup's first tile m0,
  // row m0 + 8j + 2t + (e % 2)
  const int64_t ld = static_cast<int64_t>(a.heads) * D;
  float* dq = a.dq + (static_cast<int64_t>(b) * t_len + m0) * ld +
              static_cast<int64_t>(h) * D;
  const int count = role == 0 ? kTiles0 : kTiles1;
#pragma unroll
  for (int m = 0; m < kTiles0; ++m) {
    if (m >= count || 64 * (first + m) + 16 * warp >= D) continue;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int d = 64 * (first + m) + rl + 8 * ((e >> 1) & 1);
      const int row = 8 * (e / 4) + 2 * t + (e & 1);
      dq[row * ld + d] = acc_dq[m][e] * a.scale;
    }
  }
}

// ---- dK and dV --------------------------------------------------------------

// where a dK/dV CTA streams from: its keys, kv head, batch and the flat loop
// of n_it = G * n_m steps over (query head of the group, query tile)
struct DkvWalk {
  int n0, kvh, b, group, m_begin, n_m, n_it;
};

// Q, dO, lse and di of step `it`, raw, into its stage (thread 0)
template <int D>
__device__ __forceinline__ void dkv_load(unsigned char* smem, const Maps& maps,
                                         const Args& a, const DkvWalk& w,
                                         int it) {
  using C = DkvCfg<D>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff) + 1;
  const int s = it % C::kStages;
  const int h = w.kvh * w.group + it / w.n_m;
  const int m0 = w.m_begin + (it % w.n_m) * C::kBlockM;
  unsigned char* st = smem + C::kStageOff + s * 4 * C::kTileBytes;
  unsigned char* stat = smem + C::kStatOff + s * 2 * C::kStatBytes;
  mbar_expect_tx(&full[s], 2 * C::kTileBytes + 2 * C::kStatBytes);
  load_tile<D, C::kBlockM>(st, &maps.m[kQ], &full[s], h, m0, w.b);
  load_tile<D, C::kBlockM>(st + 2 * C::kTileBytes, &maps.m[kDo], &full[s], h,
                           m0, w.b);
  const int64_t row = (static_cast<int64_t>(w.b) * a.heads + h) * a.t_len + m0;
  bulk_load(stat, a.lse + row, C::kStatBytes, &full[s]);
  bulk_load(stat + C::kStatBytes, a.di + row, C::kStatBytes, &full[s]);
}

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ Maps maps, const Args a) {
  using C = DkvCfg<D>;
  constexpr int BM = C::kBlockM;
  constexpr int S = C::kStages;
  constexpr int NT = C::kThreads;
  constexpr int kTiles = C::kTiles;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  // the query tiles that see some key of the block (from the diagonal down
  // under causal masking), for each query head of the group
  const int t_len = a.t_len;
  const int n0 = blockIdx.x * kRows;  // causal: the first blocks do most
  const int m_begin = a.causal ? n0 : 0;
  const int n_m = (t_len - m_begin) / BM;
  const int group = a.heads / a.kv_heads;
  const DkvWalk w{n0, static_cast<int>(blockIdx.y),
                  static_cast<int>(blockIdx.z), group, m_begin, n_m,
                  group * n_m};

  // K and V land in their resident buffers, or in stage 0 on their way to
  // registers
  unsigned char* kv = smem + (C::kKVInRegs ? C::kStageOff : 0);
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT / 32);
    }
    fence_barrier_init();
    mbar_expect_tx(kv_full, 2 * C::kKVTile);
    load_tile<D, kRows>(kv, &maps.m[kK], kv_full, w.kvh, n0, w.b);
    load_tile<D, kRows>(kv + C::kKVTile, &maps.m[kV], kv_full, w.kvh, n0, w.b);
    if constexpr (!C::kKVInRegs) {
      for (int it = 0; it < min(S, w.n_it); ++it) {
        dkv_load<D>(smem, maps, a, w, it);
      }
    }
  }
  __syncthreads();

  const int role = threadIdx.x / 128;  // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int kl = 16 * warp + g;  // this thread's keys: n0 + kl and + 8
  const int key_lo = n0 + kl;
  unsigned char* strips = smem + C::kStripOff;  // P^T b/s, dS^T b/s
  const uint32_t sp = smem_addr(strips);

  auto stage = [&](int it) {
    return smem + C::kStageOff + (it % S) * 4 * C::kTileBytes;
  };
  auto split_qdo = [&](int it) {
    mbar_wait(&full[it % S], (it / S) & 1);
    unsigned char* st = stage(it);
    split_tile<D, BM, NT>(st, st + C::kTileBytes);
    split_tile<D, BM, NT>(st + 2 * C::kTileBytes, st + 3 * C::kTileBytes);
    fence_proxy_async();
  };

  float acc[kTiles][32];  // dV^T (warpgroup 0) or dK^T (warpgroup 1)
#pragma unroll
  for (int m = 0; m < kTiles; ++m) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
  }
  // dV, or dK times the scale, (B, T, H_kv, D) dense: acc[m][4j + e] is
  // d = 64m + kl + 8 (e / 2), key n0 + 8j + 2t + (e % 2). Each element is
  // this thread's alone: the first flush writes it, later ones add to it in
  // f32, and the accumulators start again from zero.
  auto flush = [&](bool first) {
    const int64_t ld = static_cast<int64_t>(a.kv_heads) * D;
    float* out = (role == 0 ? a.dv : a.dk) +
                 (static_cast<int64_t>(w.b) * t_len + n0) * ld +
                 static_cast<int64_t>(w.kvh) * D;
    const float mul = role == 0 ? 1.f : a.scale;
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (64 * m + 16 * warp < D) {
          const int d = 64 * m + kl + 8 * ((e >> 1) & 1);
          float* o = out + (8 * (e / 4) + 2 * t + (e & 1)) * ld + d;
          *o = first ? acc[m][e] * mul : *o + acc[m][e] * mul;
        }
        acc[m][e] = 0.f;
      }
    }
  };

  // this warp's rows of K (warpgroup 0) or V (warpgroup 1), columns 8k + 2t
  // and + 1 of rows kl (.x, .y) and kl + 8 (.z, .w)
  float4 kv_frag[C::kKVInRegs ? D / 8 : 1];
  const unsigned char* kv_tile = kv + role * C::kKVTile;
  mbar_wait(kv_full, 0);
  if constexpr (C::kKVInRegs) {
#pragma unroll
    for (int k = 0; k < D / 8; ++k) {
      const float2 x = *reinterpret_cast<const float2*>(
          kv_tile + at<kRows>(kl, 8 * k + 2 * t));
      const float2 y = *reinterpret_cast<const float2*>(
          kv_tile + at<kRows>(kl + 8, 8 * k + 2 * t));
      kv_frag[k] = make_float4(x.x, x.y, y.x, y.y);
    }
    fence_proxy_async();
    __syncthreads();  // stage 0 is free for the first query tile
    if (threadIdx.x == 0) {
      for (int it = 0; it < min(S, w.n_it); ++it) {
        dkv_load<D>(smem, maps, a, w, it);
      }
    }
  }
  split_qdo(0);
  __syncthreads();
  for (int it = 0; it < w.n_it; ++it) {
    const int m0 = w.m_begin + (it % w.n_m) * BM;
    unsigned char* st = stage(it);
    const uint32_t q_addr = smem_addr(st);
    const float* s_lse = reinterpret_cast<const float*>(
        smem + C::kStatOff + (it % S) * 2 * C::kStatBytes);
    const float* s_di = s_lse + BM;

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
    float x[BM / 2];
    {
      float* const out[1] = {x};
      const uint32_t bb[1] = {q_addr + 2 * role * C::kTileBytes};
      const uint32_t bs[1] = {q_addr + (2 * role + 1) * C::kTileBytes};
      auto load = [&](int, int k, float2& lo, float2& hi) {
        if constexpr (C::kKVInRegs) {
          lo = make_float2(kv_frag[k].x, kv_frag[k].y);
          hi = make_float2(kv_frag[k].z, kv_frag[k].w);
        } else {
          lo = *reinterpret_cast<const float2*>(
              kv_tile + at<kRows>(kl, 8 * k + 2 * t));
          hi = *reinterpret_cast<const float2*>(
              kv_tile + at<kRows>(kl + 8, 8 * k + 2 * t));
        }
      };
      products_over_d<D, BM, 1>(out, load, bb, bs);
    }
    wgmma_wait<0>();
    fence_regs(x);

    // in the accumulator layout: keys key_lo + 8 ((e >> 1) & 1), query rows
    // m0 + 8 (e / 4) + 2t + (e & 1)
    if (role == 0) {  // P^T, exactly 0 where masked
      const bool diag = a.causal && key_lo - g + 15 > m0;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(s_lse + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_approx(fmaf(x[4 * j + e], a.scale_log2,
                                     -((e & 1) ? l2.y : l2.x) * kLog2e));
          if (diag && key_lo + 8 * (e >> 1) > m0 + 8 * j + 2 * t + (e & 1)) {
            p = 0.f;
          }
          x[4 * j + e] = p;
        }
      }
      write_strip<BM>(strips, strips + C::kStripBytes, x, kl, t);
      fence_proxy_async();
    }
    bar_sync(1, NT);  // the P^T strip is whole
    if (role == 1) {  // dS^T = P^T (dP^T - di), P^T read back as big + small
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(s_di + 8 * j + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t off = strip_at<BM>(kl + 8 * h, 8 * j + 2 * t);
          const float2 pb = *reinterpret_cast<const float2*>(strips + off);
          const float2 ps =
              *reinterpret_cast<const float2*>(strips + C::kStripBytes + off);
          x[4 * j + 2 * h] = (pb.x + ps.x) * (x[4 * j + 2 * h] - d2.x);
          x[4 * j + 2 * h + 1] = (pb.y + ps.y) * (x[4 * j + 2 * h + 1] - d2.y);
        }
      }
      write_strip<BM>(strips + 2 * C::kStripBytes,
                      strips + 3 * C::kStripBytes, x, kl, t);
      fence_proxy_async();
      bar_sync(2, 128);  // the dS^T strip is whole
    }

    // dV^T += dO^T P (warpgroup 0), dK^T += Q^T dS (warpgroup 1)
    const int tile = 2 * (1 - role);  // dO, or Q
    const uint32_t sb = sp + 2 * role * C::kStripBytes;
    products_transposed<D, BM, kTiles>(
        acc, st + tile * C::kTileBytes, st + (tile + 1) * C::kTileBytes, sb,
        sb + C::kStripBytes, 0, warp, g, t);
    // this warp is done reading the stage: its product over D has landed
    // and its transposed product's fragments are in registers
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % S]);
    if (refill(it, S, w.n_it, empty)) dkv_load<D>(smem, maps, a, w, it + S);
    if (it + 1 < w.n_it) split_qdo(it + 1);  // while the products run
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < kTiles; ++m) fence_regs(acc[m]);
    if ((it + 1) % C::kFlushIts == 0 && it + 1 < w.n_it) {
      flush(it + 1 == C::kFlushIts);
    }
    __syncthreads();  // the next tile is split and the strips free
  }
  flush(w.n_it <= C::kFlushIts);
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

// the 32-column f32 maps of q, k, v and do, each box `rows[x]` rows
template <int D>
cudaError_t make_maps(Maps* maps, const BwdArgs& a, const int (&rows)[4]) {
  const void* base[4] = {a.q, a.k, a.v, a.dout};
  const int src[4] = {0, 1, 2, 4};  // index into sb, st
  for (int x = 0; x < 4; ++x) {
    const int64_t heads = x == kK || x == kV ? a.kv_heads : a.heads;
    const cudaError_t err =
        make_map(&maps->m[x], base[x], D, heads, a.t_len, a.batch,
                 a.st[src[x]], a.sb[src[x]], 32, rows[x], 4);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  using Q = DqCfg<D>;
  using Kv = DkvCfg<D>;
  Maps dq_maps, dkv_maps;
  cudaError_t err = make_maps<D>(
      &dq_maps, a, {kRows, Q::kBlockN, Q::kBlockN, kRows});
  if (err != cudaSuccess) return err;
  err = make_maps<D>(&dkv_maps, a, {Kv::kBlockM, kRows, kRows, Kv::kBlockM});
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
      static_cast<const float*>(a.o), static_cast<const float*>(a.dout),
      a.lse, a.di, static_cast<float*>(a.dq), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), static_cast<int>(a.t_len),
      static_cast<int>(a.heads), static_cast<int>(a.kv_heads), a.sb[3],
      a.st[3], a.sb[4], a.st[4], a.scale,
      static_cast<float>(static_cast<double>(a.scale) * 1.4426950408889634),
      a.causal};
  const dim3 grid_q(static_cast<unsigned>(a.t_len / kRows),
                    static_cast<unsigned>(a.heads),
                    static_cast<unsigned>(a.batch));
  flash_bwd_dq_kernel<D><<<grid_q, Q::kThreads, Q::kSmem, stream>>>(dq_maps,
                                                                    args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(static_cast<unsigned>(a.t_len / kRows),
                     static_cast<unsigned>(a.kv_heads),
                     static_cast<unsigned>(a.batch));
  flash_bwd_dkv_kernel<D><<<grid_kv, Kv::kThreads, Kv::kSmem, stream>>>(
      dkv_maps, args);
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

// f32 only. Strides are in elements: batch strides (q, k, v, o, do) then
// row strides (q, k, v, o, do), each a multiple of 4 (16-byte rows, as TMA
// needs), with 16-byte-aligned bases; heads and D dense. lse is the
// forward's dense (B, H, T) f32 statistic and di a dense (B, H, T) f32
// scratch that receives sum(o * do, -1), both 16-byte aligned; dq
// (B, T, H, D) and dk, dv (B, T, H_kv, D) are dense f32 outputs. T must be
// a multiple of 64.
int akka_flash_attention_bwd_3xtf32(
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
int akka_flash_attention_bwd_3xtf32_smem(int64_t d, int kernel) {
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
