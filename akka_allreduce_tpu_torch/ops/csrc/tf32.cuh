// Split-TF32 (3xTF32) building blocks for f32 products on TF32 wgmma, shared
// by the f32 flash-attention forward (flash_attention_3xtf32.cu) and
// backward (flash_attention_bwd_3xtf32.cu).
//
// Each f32 operand x becomes big = tf32(x) and small = tf32(x - big)
// (cvt.rna, both explicit), and a b ~ small_a big_b + big_a small_b +
// big_a big_b, three TF32 wgmma products into one f32 accumulator, small
// terms first: an error of about 2^-21 |a||b| a term.
//
// Layouts (hopper.cuh): an f32 tile of R rows x D lies in D / 32 column
// blocks of R rows x 128 bytes (128-byte swizzle), as TMA writes it. TF32
// wgmma reads a shared-memory operand K-major only, so every B operand is
// stored with its k dimension along the rows: a streamed tile whose
// products contract over D, split in place into big and small; a strip
// (64 rows x N, k along a row) for products that contract over the stored
// rows. The register A fragment of a k step holds k positions t and t + 4
// of a row (hopper.cuh); split_tile stores the 8 k values of each group
// even ones first (split_col), so that those positions are columns 2t and
// 2t + 1 of the raw operand, one float2.

#pragma once

#include "hopper.cuh"

namespace akka_tf32 {

using namespace akka_sm90;

constexpr int kGroup = 2;  // fragments a commit group

// the dynamic shared memory, aligned up to the swizzle's 1024-byte period
__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// a byte offset inside a tile of 1024-byte-aligned rows of RB bytes (128:
// 128-byte swizzle, 64: 64-byte swizzle), swizzled as TMA and wgmma see it
template <int RB>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ ((off >> 3) & (RB == 128 ? 0x70u : 0x30u));
}

// element (r, c) of an f32 tile of R rows: D / 32 column blocks of R rows
// x 128 bytes
template <int R>
__device__ __forceinline__ uint32_t at(int r, int c) {
  return (c >> 5) * R * 128 + swz<128>(r * 128 + (c & 31) * 4);
}

// the column where a split tile keeps column c: in each group of 8, the
// even columns first, then the odd ones
__device__ __forceinline__ int split_col(int c) {
  return (c & ~7) | ((c & 1) << 2) | ((c & 7) >> 1);
}

// A strip: 64 rows x N f32 (N 16, 32 or 64), K-major as a B operand whose
// k runs along a row. Element (r, c) lies at strip_at<N>(r, c): rows of 64
// bytes (64-byte swizzle) for N 16, else 32-column blocks of 64 rows x 128
// bytes, as a tile; the B operand of k step k (8 columns) starts at
// strip_k<N>(k).
template <int N>
__device__ __forceinline__ uint32_t strip_at(int r, int c) {
  return N == 16 ? swz<64>(r * 64 + c * 4) : at<64>(r, c);
}

template <int N>
__device__ __forceinline__ uint32_t strip_k(int k) {
  return N == 16 ? 32 * k : (k / 4) * 64 * 128 + 32 * (k % 4);
}

// the TMA loads of one tile (R rows from `row`) into its column blocks,
// through a map of 32-column f32 boxes
template <int D, int R>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int head, int row,
                                          int b) {
#pragma unroll
  for (int j = 0; j < D / 32; ++j) {
    tma_load(dst + j * R * 128, map, bar, 32 * j, head, row, b);
  }
}

// Split a raw tile of R rows x D in place into its TF32 big part and, at
// `small`, its small part, columns permuted as split_col says; the NT
// threads of the CTA take a group of 8 columns each in turn, one group at
// a time (it runs beside the accumulators of the products in flight; more
// in flight spill the f32 backward's dK/dV kernel's registers).
template <int D, int R, int NT>
__device__ __forceinline__ void split_tile(unsigned char* big,
                                           unsigned char* small) {
  constexpr int kGroups = R * D / 8;
#pragma unroll 1
  for (int k = 0; k < (kGroups + NT - 1) / NT; ++k) {
    const int i = static_cast<int>(threadIdx.x) + k * NT;
    if (kGroups % NT == 0 || i < kGroups) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      const uint32_t lo = at<R>(r, c);
      const uint32_t hi = at<R>(r, c + 4);
      const float4 x = *reinterpret_cast<const float4*>(big + lo);
      const float4 y = *reinterpret_cast<const float4*>(big + hi);
      const float v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
      uint32_t bg[8], sm[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        bg[e] = to_tf32(v[e]);
        sm[e] = to_tf32(v[e] - __uint_as_float(bg[e]));
      }
      *reinterpret_cast<uint4*>(big + lo) = make_uint4(bg[0], bg[2], bg[4], bg[6]);
      *reinterpret_cast<uint4*>(big + hi) = make_uint4(bg[1], bg[3], bg[5], bg[7]);
      *reinterpret_cast<uint4*>(small + lo) = make_uint4(sm[0], sm[2], sm[4], sm[6]);
      *reinterpret_cast<uint4*>(small + hi) = make_uint4(sm[1], sm[3], sm[5], sm[7]);
    }
  }
}

// a TF32 A fragment, big and small
struct Frag {
  uint32_t b[4], s[4];
};

__device__ __forceinline__ void split_frag(Frag& f, float x0, float x1,
                                           float x2, float x3) {
  const float x[4] = {x0, x1, x2, x3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.b[i] = to_tf32(x[i]);
    f.s[i] = to_tf32(x[i] - __uint_as_float(f.b[i]));
  }
}

// one of the three TF32 products of a k step (term 0: small A x big B,
// 1: big A x small B, 2: big A x big B; small terms first), B K-major at
// bb (big) or bs (small), rows of RB bytes; term 0 overwrites the
// accumulator unless `accumulate`
template <int N, int RB = 128>
__device__ __forceinline__ void mma3_term(float* acc, const Frag& f,
                                          uint32_t bb, uint32_t bs, int term,
                                          int accumulate) {
  const uint64_t b = make_desc(term == 1 ? bs : bb, 16, 8 * RB,
                               RB == 128 ? 1 : 2);
  wgmma_tf32<N>(acc, term == 0 ? f.s : f.b, b, term > 0 || accumulate);
}

// acc[i] = A_i B_i^T (64 x N) over D for the NA products i of one call: A_i
// is this warp's 16 rows of raw f32, load(i, k, x, y) giving k positions t
// and t + 4 of step k (columns 8k + 2t, 8k + 2t + 1 of a split_tile tile)
// of its rows g (x) and g + 8 (y), split in registers; B_i the big and
// small of a split tile of N rows at bb[i], bs[i]. Fragment f is product f % NA's at k step f / NA, so that
// consecutive products feed different accumulators (a chain into one
// accumulator waits on each product). Commit groups of kGroup fragments,
// two in flight, so a group's A registers stay untouched until its
// products are done.
template <int D, int N, int NA, class Load>
__device__ __forceinline__ void products_over_d(
    float* const (&acc)[NA], const Load& load, const uint32_t (&bb)[NA],
    const uint32_t (&bs)[NA]) {
  constexpr int kSteps = D / 8;
  constexpr int kChunks = NA * kSteps / kGroup;
  Frag f[2][kGroup];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c >= 2) wgmma_wait<1>();
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int fi = c * kGroup + u;
      float2 x, y;
      load(fi % NA, fi / NA, x, y);
      split_frag(f[c & 1][u], x.x, y.x, x.y, y.y);
    }
    wgmma_fence();
#pragma unroll
    for (int term = 0; term < 3; ++term) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int fi = c * kGroup + u;
        const int i = fi % NA;
        const int k = fi / NA;
        const uint32_t off = (k / 4) * N * 128 + 32 * (k % 4);
        mma3_term<N>(acc[i], f[c & 1][u], bb[i] + off, bs[i] + off, term,
                     k > 0);
      }
    }
    wgmma_commit();
  }
}

// acc[m] (64 x 64) += A_m B over K rows, for the NM 64-row tiles m0 + m of
// D: A_m^T is those 64 columns of a split tile (K rows x D at tb, ts:
// big, small), this warp's 16 columns gathered into registers, zero past
// D; B a strip (64 rows x K at sb, ss: big, small).
// Fragments and commit groups as above, fragment f for tile f % NM.
template <int D, int K, int NM>
__device__ __forceinline__ void products_transposed(
    float (*acc)[32], const unsigned char* tb, const unsigned char* ts,
    uint32_t sb, uint32_t ss, int m0, int warp, int g, int t) {
  constexpr int kSteps = K / 8;
  constexpr int kChunks = NM * kSteps / kGroup;
  constexpr int kRB = K == 16 ? 64 : 128;  // strip swizzle row bytes
  Frag f[2][kGroup];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c >= 2) wgmma_wait<1>();
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int fi = c * kGroup + u;
      const int m = m0 + fi % NM;
      const int r = 8 * (fi / NM) + t;
      Frag& fr = f[c & 1][u];
      if (64 * m + 16 * warp < D) {  // the warp's 16 rows
        const int col = split_col(64 * m + 16 * warp + g);
        const uint32_t o[4] = {at<K>(r, col), at<K>(r, col + 8),
                               at<K>(r + 4, col), at<K>(r + 4, col + 8)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fr.b[i] = *reinterpret_cast<const uint32_t*>(tb + o[i]);
          fr.s[i] = *reinterpret_cast<const uint32_t*>(ts + o[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) fr.b[i] = fr.s[i] = 0u;
      }
    }
    wgmma_fence();
#pragma unroll
    for (int term = 0; term < 3; ++term) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int fi = c * kGroup + u;
        const int k = fi / NM;
        mma3_term<64, kRB>(acc[fi % NM], f[c & 1][u], sb + strip_k<K>(k),
                           ss + strip_k<K>(k), term, 1);
      }
    }
    wgmma_commit();
  }
}

// write accumulator values x[4j + e] (rows r0 + 8 (e / 2), columns
// 8j + 2t + (e % 2)) as TF32 big and small into a strip of 64 rows x N
template <int N>
__device__ __forceinline__ void write_strip(unsigned char* big,
                                            unsigned char* small,
                                            const float (&x)[N / 2], int r0,
                                            int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = x[4 * j + 2 * h];
      const float v1 = x[4 * j + 2 * h + 1];
      const uint32_t b0 = to_tf32(v0);
      const uint32_t b1 = to_tf32(v1);
      const uint32_t off = strip_at<N>(r0 + 8 * h, 8 * j + 2 * t);
      *reinterpret_cast<uint2*>(big + off) = make_uint2(b0, b1);
      *reinterpret_cast<uint2*>(small + off) =
          make_uint2(to_tf32(v0 - __uint_as_float(b0)),
                     to_tf32(v1 - __uint_as_float(b1)));
    }
  }
}

}  // namespace akka_tf32
