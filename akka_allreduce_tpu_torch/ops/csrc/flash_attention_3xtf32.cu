// Flash-attention forward for Hopper (sm_90a) in f32: K4's forward when the
// compute dtype is float32, on the tensor cores through wgmma in split TF32
// (3xTF32), as PyTorch's own f32 attention kernels multiply f32 (CUTLASS's
// OpMultiplyAddFastF32). The bf16 forward is flash_attention_wgmma.cu, the
// f32 backward flash_attention_bwd_3xtf32.cu.
//
// Replaces the flash branch of akka_allreduce_tpu/ops/local_attention.py
// local_attention, which calls the library Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention (forward).
//
//   o[b, i, h, :] = sum_j p_ij v[b, j, h / G, :] / max(l_i, 1e-30)
//   s_ij = (q[b, i, h, :] . k[b, j, h / G, :]) * scale      (f32)
//   p_ij = exp(s_ij - m_i), exactly 0 where masked (causal: j > i);
//   l_i = sum_j p_ij;  lse_i = m_i + log(l_i)  (B, H, T) f32
//
// with m_i the running row max and G = H / H_kv, the grouped-query factor:
// compact K/V are read in place, never repeated. lse (-inf for a row that
// sees no key) is written by the same launch; the f32 backward reads it.
// (B, T, H, D) tensors are read through their batch and row strides, so a
// slice of a longer KV cache needs no copy. Every D the flash gate admits
// (32 to 256, step 32) is covered; T is a multiple of 64.
//
// Numerics: every product is split TF32 (tf32.cuh): each f32 operand x
// becomes big = tf32(x) and small = tf32(x - big), both cvt.rna, and three
// TF32 wgmma products accumulate into one f32 accumulator, small terms
// first, an error of about 2^-21 |a||b| a term. One TF32 pass (about
// 2^-11) would break the 1e-4 parity the f32 forward is held to.
//
// Bound: operations. Two products of 2 T^2 D FLOP per (b, h), halved under
// causal masking: 3.44e10 FLOP at (B 2, T 2048, H 16, D 128), at the card's
// TF32 rate over three (494.7 / 3 = 164.9 TFLOP/s) 0.2084 ms, against 4 x
// 33.6 MB of Q, K, V and O moved (0.04 ms).
//
// What the card imposes, and the design:
// - TF32 wgmma (m64nNk8) reads a shared-memory operand K-major only: no
//   transposed operand. S = Q K^T contracts over D along the rows of K as
//   stored: its B is the K tile, split element by element into big and
//   small where TMA landed it, and its A the raw Q columns t and t + 4 of a
//   row a k step, read from the resident Q tile and split in registers.
//   O = P V contracts over the keys, the rows of V as stored, so it cannot
//   read V in place. P is the register A operand, in the accumulator layout
//   S left it: columns 2t and 2t + 1 of a k step are taken as k positions t
//   and t + 4, and the consumers write V's split transposed (V^T: D rows of
//   keys, K-major) with its keys in that order. The transpose costs one
//   pass over the V tile a CTA (conflict-free reads of a row by a warp,
//   conflict-free 16-byte writes of 8 keys a lane); in return P never goes
//   through shared memory and the online softmax, with its per-row rescale
//   of O, stays in registers.
// - Each tile's P V goes into a fresh accumulator, 64 of O's columns (an
//   N 64 product) at a time, and is added into O in f32 FMAs, O = O corr +
//   P V. Accumulated across the tiles inside the tensor cores' accumulators
//   (768 accumulations at T 2048), O drifted from the f32 sum, and the
//   backward's di = sum(o do) carried the drift into dS: chip_smoke.py
//   found the whole model's f32 gradient 1.15e-4 of max|grad| off (a query
//   projection's), past its 1e-4.
// - One CTA per (128 query rows, head, batch): two consumer warpgroups of
//   64 rows each share every K and V tile, so each tile is split once for
//   128 rows. 256 threads, no producer warpgroup (a kernel of more than 256
//   threads is held to 168 registers by ptxas); thread 0 issues every TMA
//   load. A split f32 tile takes 8 bytes an element, so shared memory
//   binds: it holds Q (raw, the whole kernel), K (big, small), V^T (big,
//   small) and V's raw landing buffer, 225 KB at D 128 with 64-key tiles
//   (S is m64n64k8); above D 128 the tiles are 16 keys. Keeping Q in
//   shared memory rather than in registers (D / 2 a thread) leaves room
//   for the splits' loads in flight.
// - Per tile, two CTA barriers: S's products, with V's transposed split
//   beside them (an item every few k steps); a barrier, after which thread
//   0 loads K's and V's next tiles (K over its split copy, V into its raw
//   buffer); softmax and P V's products, with K's next tile split while
//   the first 64 columns' run; a barrier. A register operand stays
//   untouched until its product is done: S's Q fragments go in commit
//   groups of two, two groups in flight; P is split whole (64 registers at
//   64 keys), and each 64 columns' P V products go in one group.
// - Softmax as in the bf16 forward (flash_common.cuh online_softmax): the
//   scores scaled by scale * log2(e) (any sign of scale), p = 2^(s - m)
//   with m in base-2 units, lse converted back to natural log; the element
//   mask only on the diagonal tile.
// - Causal: key tiles above the diagonal are skipped (a warpgroup whose 64
//   rows see none of a tile's keys skips its products too), and the query
//   blocks with the most key tiles launch first.
// - Deterministic: no atomics, each output element written once by one
//   thread, so a repeat is bit-identical.
//
// The C entry launches on the caller's stream, does not synchronise, and
// returns a CUDA error code (cudaErrorInvalidValue for a shape it does not
// cover) for the Python wrapper to raise on.

#include "flash_common.cuh"
#include "tf32.cuh"

namespace {

using namespace akka_flash;
using namespace akka_sm90;
using namespace akka_tf32;

constexpr int kRows = 64;  // query rows a warpgroup
constexpr int kBlockM = 2 * kRows;  // query rows a CTA
constexpr int kThreads = 256;  // two consumer warpgroups
constexpr float kLn2 = 0.693147180559945309f;

template <int D>
struct Cfg {
  static_assert(D % 32 == 0 && D >= 32 && D <= 256, "D in 32..256 step 32");
  // Q resident (raw), K split where it lands, V landing raw beside its
  // split transpose; 64-key tiles up to D 128, 16-key tiles above
  static constexpr int kBlockN = D <= 128 ? 64 : 16;  // keys a tile
  static constexpr int kQBytes = kBlockM * D * 4;
  static constexpr int kTileBytes = kBlockN * D * 4;  // K or V, raw or split
  static constexpr int kKOff = kQBytes;  // K big, K small
  static constexpr int kVtOff = kKOff + 2 * kTileBytes;  // V^T big, small
  static constexpr int kVOff = kVtOff + 2 * kTileBytes;  // V raw
  static constexpr int kBarOff = kVOff + kTileBytes;
  // barriers: q_full, k_full, v_full; 1024 bytes of slack to align the
  // dynamic shared memory to the swizzle's period
  static constexpr size_t kSmem = kBarOff + 8 * 3 + 1024;
  static_assert(kSmem <= kMaxSmem, "tile set exceeds shared memory");
};

// TMA maps of q, k and v: 32-column f32 boxes of a CTA's Q, a K/V tile
struct Maps {
  CUtensorMap q, k, v;
};

struct Args {
  float* o;
  float* lse;
  int t_len, group;
  int64_t o_sb, o_st;
  float scale_log2;
  int causal;
};

// V^T of a tile of R keys: D rows x R keys, K-major as the B operand of
// O += P V: for R 64, 32-key column blocks of D rows x 128 bytes; for R 16,
// rows of 64 bytes (64-byte swizzle). vt_at is element (d, key position),
// vt_b the B operand of rows 64m on and k step kk (8 key positions).
template <int D, int R>
__device__ __forceinline__ uint32_t vt_at(int d, int c) {
  return R == 16 ? swz<64>(d * 64 + c * 4) : at<D>(d, c);
}

template <int D, int R>
__device__ __forceinline__ uint32_t vt_b(int m, int kk) {
  return R == 16 ? m * 64 * 64 + 32 * kk
                 : (kk / 4) * D * 128 + m * 64 * 128 + 32 * (kk % 4);
}

// Split a K tile (R keys x D) where TMA landed it, element by element,
// into its TF32 big part (in place) and its small part at `small`, in the
// tile's own layout: S's A fragments take Q's columns t and t + 4 of a k
// step, as the tile stores them. The NT threads take 16 bytes each in turn.
template <int D, int R, int NT>
__device__ __forceinline__ void split_k(unsigned char* big,
                                        unsigned char* small) {
#pragma unroll 4
  for (int i = static_cast<int>(threadIdx.x); i < R * D / 4; i += NT) {
    const float4 x = *reinterpret_cast<const float4*>(big + 16 * i);
    const float v[4] = {x.x, x.y, x.z, x.w};
    uint32_t bg[4], sm[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bg[e] = to_tf32(v[e]);
      sm[e] = to_tf32(v[e] - __uint_as_float(bg[e]));
    }
    *reinterpret_cast<uint4*>(big + 16 * i) = make_uint4(bg[0], bg[1], bg[2], bg[3]);
    *reinterpret_cast<uint4*>(small + 16 * i) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
}

// One item of the split of a raw V tile (R keys x D, at `raw`) into the
// TF32 big and small parts of its transpose, keys permuted as split_col
// says (position t of a k step holds key 2t, position t + 4 key 2t + 1, as
// P's A fragment takes them): item j of this thread is (column d, 8 keys)
// number threadIdx.x + j NT. A warp's lanes read 32 neighbouring columns of
// one row (one 128-byte line) and write 32 rows of V^T, 16 bytes each, free
// of bank conflicts.
template <int D, int R, int NT>
__device__ __forceinline__ void split_v_item(const unsigned char* raw,
                                             unsigned char* big,
                                             unsigned char* small, int j) {
  constexpr int kItems = D * R / 8;
  const int i = static_cast<int>(threadIdx.x) + j * NT;
  if (kItems % NT != 0 && i >= kItems) return;
  const int d = i % D;
  const int n = (i / D) * 8;
  uint32_t bg[8], sm[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float v = *reinterpret_cast<const float*>(raw + at<R>(n + e, d));
    bg[e] = to_tf32(v);
    sm[e] = to_tf32(v - __uint_as_float(bg[e]));
  }
  const uint32_t lo = vt_at<D, R>(d, n);
  const uint32_t hi = vt_at<D, R>(d, n + 4);
  *reinterpret_cast<uint4*>(big + lo) = make_uint4(bg[0], bg[2], bg[4], bg[6]);
  *reinterpret_cast<uint4*>(big + hi) = make_uint4(bg[1], bg[3], bg[5], bg[7]);
  *reinterpret_cast<uint4*>(small + lo) = make_uint4(sm[0], sm[2], sm[4], sm[6]);
  *reinterpret_cast<uint4*>(small + hi) = make_uint4(sm[1], sm[3], sm[5], sm[7]);
}

// Columns [C0, C0 + W) of P V over the R keys of a tile (W 32 or 64),
// into a fresh accumulator o (W / 2 a thread): P the split fragments of
// this warp's 16 rows (one a k step), V^T at vb (big) and vs (small)
template <int D, int R, int C0, int W>
__device__ __forceinline__ void pv_products(float* o, const Frag (&p)[R / 8],
                                            uint32_t vb, uint32_t vs) {
  constexpr int kRB = R == 16 ? 64 : 128;  // V^T row bytes
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    const uint32_t off = vt_b<D, R>(C0 / 64, kk);
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      mma3_term<W, kRB>(o, p[kk], vb + off, vs + off, term, kk > 0);
    }
  }
}

// O = O corr + (this tile's P V), from O's columns 64 C on: the products
// into a fresh accumulator, 64 columns (N 64) at a time, each added into O
// in f32 FMAs; `beside` runs while the first columns' products are in
// flight
template <int D, int R, int C, class Beside>
__device__ __forceinline__ void pv_into_o(float* o, const Frag (&p)[R / 8],
                                          const float (&corr)[2], uint32_t vb,
                                          uint32_t vs, const Beside& beside) {
  constexpr int W = D - 64 * C < 64 ? D - 64 * C : 64;
  float pv[W / 2];
  wgmma_fence();
  pv_products<D, R, 64 * C, W>(pv, p, vb, vs);
  wgmma_commit();
  if constexpr (C == 0) beside();
  wgmma_wait<0>();
  fence_regs(pv);
#pragma unroll
  for (int e = 0; e < W / 2; ++e) {
    o[32 * C + e] = fmaf(o[32 * C + e], corr[(e >> 1) & 1], pv[e]);
  }
  if constexpr (64 * (C + 1) < D) {
    pv_into_o<D, R, C + 1>(o, p, corr, vb, vs, beside);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_3xtf32_kernel(const __grid_constant__ Maps maps, const Args a) {
  using C = Cfg<D>;
  constexpr int BN = C::kBlockN;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = q_full + 2;
  unsigned char* kb = smem + C::kKOff;  // K big (K lands here), K small
  unsigned char* vtb = smem + C::kVtOff;  // V^T big, then V^T small
  unsigned char* v_raw = smem + C::kVOff;
  const unsigned char* q_tile = smem;

  const int t_len = a.t_len;
  // causal: the last query blocks have the most key tiles; launch them first
  const int mb = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int m0 = mb * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.group;
  const int n_tiles = (a.causal ? min(t_len, m0 + kBlockM) : t_len) / BN;

  auto load_k = [&](int i) {
    mbar_expect_tx(k_full, C::kTileBytes);
    load_tile<D, BN>(kb, &maps.k, k_full, kvh, i * BN, b);
  };
  auto load_v = [&](int i) {
    mbar_expect_tx(v_full, C::kTileBytes);
    load_tile<D, BN>(v_raw, &maps.v, v_full, kvh, i * BN, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    fence_barrier_init();
    mbar_expect_tx(q_full, C::kQBytes);
    load_tile<D, kBlockM>(smem, &maps.q, q_full, h, m0, b);
    load_k(0);
    load_v(0);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rl = kRows * wg + 16 * warp + g;  // this thread's rows: rl, + 8
  const int row_lo = m0 + rl;
  const int row0 = m0 + kRows * wg;  // the warpgroup's first row

  auto q_at = [&](int r, int c) {
    return *reinterpret_cast<const float*>(q_tile + at<kBlockM>(r, c));
  };
  auto q_cols = [&](int k, float2& lo, float2& hi) {
    lo = make_float2(q_at(rl, 8 * k + t), q_at(rl, 8 * k + t + 4));
    hi = make_float2(q_at(rl + 8, 8 * k + t), q_at(rl + 8, 8 * k + t + 4));
  };
  mbar_wait(k_full, 0);
  split_k<D, BN, kThreads>(kb, kb + C::kTileBytes);
  fence_proxy_async();
  __syncthreads();
  // V's split is kVItems items a thread, one every kVEvery of S's k steps
  constexpr int kVItems = (D * BN / 8 + kThreads - 1) / kThreads;
  constexpr int kVEvery = D / 8 / kVItems;
  static_assert(kVEvery * kVItems == D / 8, "V items spread over S's k steps");

  const uint32_t k_addr = smem_addr(kb);
  const uint32_t vt_addr = smem_addr(vtb);
  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  float m_run[2] = {kMaskValue, kMaskValue};  // base-2 units
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums
  mbar_wait(q_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int n0 = i * BN;
    // causal: a warpgroup whose rows see none of the tile's keys has p = 0
    // there and skips its products
    const bool live = !a.causal || n0 <= row0 + kRows - 1;

    // S = Q K^T, V's transposed split beside its products
    mbar_wait(v_full, i & 1);
    float x[BN / 2];
    if (live) {
      float* const out[1] = {x};
      const uint32_t bb[1] = {k_addr};
      const uint32_t bs[1] = {k_addr + C::kTileBytes};
      auto load = [&](int, int k, float2& lo, float2& hi) {
        q_cols(k, lo, hi);
        if (k % kVEvery == kVEvery - 1) {
          split_v_item<D, BN, kThreads>(v_raw, vtb, vtb + C::kTileBytes,
                                        k / kVEvery);
        }
      };
      products_over_d<D, BN, 1>(out, load, bb, bs);
      wgmma_wait<0>();
      fence_regs(x);
    } else {
#pragma unroll 1
      for (int j = 0; j < kVItems; ++j) {
        split_v_item<D, BN, kThreads>(v_raw, vtb, vtb + C::kTileBytes, j);
      }
    }
    fence_proxy_async();
    bar_sync(1, kThreads);  // K's split read; V^T split; V's raw read
    if (threadIdx.x == 0 && i + 1 < n_tiles) {
      load_k(i + 1);
      load_v(i + 1);
    }

    // P = 2^(S scale log2e - m), then O = O corr + P V
    auto split_next_k = [&] {  // K's next tile, while the products run
      if (i + 1 < n_tiles) {
        mbar_wait(k_full, (i + 1) & 1);
        split_k<D, BN, kThreads>(kb, kb + C::kTileBytes);
      }
    };
    if (live) {
      float corr[2];
      online_softmax<BN>(x, m_run, l_run, corr, a.scale_log2, n0, row_lo, t,
                         t_len, a.causal, row0);
      // k positions t and t + 4 of k step kk: keys 8kk + 2t and + 1
      Frag p[BN / 8];
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        split_frag(p[kk], x[4 * kk], x[4 * kk + 2], x[4 * kk + 1],
                   x[4 * kk + 3]);
      }
      pv_into_o<D, BN, 0>(acc_o, p, corr, vt_addr, vt_addr + C::kTileBytes,
                          split_next_k);
    } else {
      split_next_k();
    }
    if (i + 1 == n_tiles) break;
    fence_proxy_async();
    __syncthreads();  // every warpgroup is done with V^T; K's next split
  }

  // the row sums over the 4 threads of a group, then O / max(l, 1e-30)
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[r] = fmaxf(l, 1e-30f);
    // lse = m + log(l) in natural-log units of the scaled scores (-inf for
    // a row that sees no key)
    const int row = row_lo + 8 * r;
    if (a.lse != nullptr && t == 0 && row < t_len) {
      a.lse[(static_cast<int64_t>(b) * gridDim.y + h) * t_len + row] =
          m_run[r] * kLn2 + logf(l);
    }
  }
  float* og = a.o + b * a.o_sb + static_cast<int64_t>(h) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row_lo < t_len) {
      store2(og + static_cast<int64_t>(row_lo) * a.o_st + 8 * j,
             acc_o[4 * j] / den[0], acc_o[4 * j + 1] / den[0]);
    }
    if (row_lo + 8 < t_len) {
      store2(og + static_cast<int64_t>(row_lo + 8) * a.o_st + 8 * j,
             acc_o[4 * j + 2] / den[1], acc_o[4 * j + 3] / den[1]);
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
  const int rows[3] = {kBlockM, C::kBlockN, C::kBlockN};
  CUtensorMap* map[3] = {&maps.q, &maps.k, &maps.v};
  const void* base[3] = {a.q, a.k, a.v};
  for (int x = 0; x < 3; ++x) {
    const cudaError_t err =
        make_map(map[x], base[x], D, x == 0 ? a.heads : a.kv_heads, a.t_len,
                 a.batch, a.st[x], a.sb[x], 32, rows[x], 4);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_3xtf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const Args args{
      static_cast<float*>(a.o), a.lse, static_cast<int>(a.t_len),
      static_cast<int>(a.heads / a.kv_heads), a.sb[3], a.st[3],
      static_cast<float>(static_cast<double>(a.scale) * 1.4426950408889634),
      a.causal};
  const dim3 grid(static_cast<unsigned>((a.t_len + kBlockM - 1) / kBlockM),
                  static_cast<unsigned>(a.heads),
                  static_cast<unsigned>(a.batch));
  flash_fwd_3xtf32_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(maps, args);
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

// f32 only (bf16 has its own entry, with the same arguments, in
// flash_attention_wgmma.cu). Strides are in elements: batch strides
// (q, k, v, o) then row strides (q, k, v, o), each a multiple of 4
// (16-byte rows, as TMA needs), with 16-byte-aligned bases; heads and D
// dense. T must be a multiple of 64. lse, when not null, receives the
// (B, H, T) f32 row statistics m + log(l).
int akka_flash_attention_fwd_3xtf32(const void* q, const void* k,
                                    const void* v, void* o, float* lse,
                                    int64_t batch, int64_t t_len,
                                    int64_t heads, int64_t kv_heads,
                                    int64_t d, int64_t q_sb, int64_t k_sb,
                                    int64_t v_sb, int64_t o_sb, int64_t q_st,
                                    int64_t k_st, int64_t v_st, int64_t o_st,
                                    float scale, int causal, int device,
                                    void* stream) {
  if (batch < 1 || t_len < 64 || t_len % 64 != 0 || heads < 1 ||
      kv_heads < 1 || heads % kv_heads != 0 || heads > 65535 ||
      batch > 65535 || t_len > (int64_t{1} << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FwdArgs a{q, k, v, o, lse, batch, t_len, heads, kv_heads,
                  {q_sb, k_sb, v_sb, o_sb}, {q_st, k_st, v_st, o_st}, scale,
                  causal};
  return static_cast<int>(dispatch_d(d, a, static_cast<cudaStream_t>(stream)));
}

// the dynamic shared memory (bytes) one CTA takes at head dimension d; -1
// for a d not covered
int akka_flash_attention_3xtf32_smem(int64_t d) {
  switch (d) {
    case 32: return static_cast<int>(Cfg<32>::kSmem);
    case 64: return static_cast<int>(Cfg<64>::kSmem);
    case 96: return static_cast<int>(Cfg<96>::kSmem);
    case 128: return static_cast<int>(Cfg<128>::kSmem);
    case 160: return static_cast<int>(Cfg<160>::kSmem);
    case 192: return static_cast<int>(Cfg<192>::kSmem);
    case 224: return static_cast<int>(Cfg<224>::kSmem);
    case 256: return static_cast<int>(Cfg<256>::kSmem);
    default: return -1;
  }
}

}  // extern "C"
