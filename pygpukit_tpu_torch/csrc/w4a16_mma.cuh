// The w4a16 GEMV body on bf16 tensor cores, for rows <= 8 of bf16
// activations against split-half packed int4 weights (a byte holds K row r
// in its low nibble and K row K/2 + r in its high one), each weight rounded
// to bf16 after its scale multiply: y[r, n] = bf16(sum_k x[r, k] *
// bf16(nibble(k, n) * s(k, n))), f32 sums.
//
// Used by block_w4a16_gemv.cu (int4_block: a K-major [K/2, N] weight, bf16
// block scales [K/B, N]), whose body this is, and by w4a16_gemv.cu (the
// plain int4 [N, K/2] weight with per-column scales), which takes the
// nibble pairs, the product and the weight loads from here.
//
// The design, for a memory-bound stream of 2-12 MB a call:
// - The dequantization in pairs: a byte's two nibbles are one bf16x2
//   register. One PRMT puts the byte's low nibble in the low half and its
//   high nibble in the high half, one LOP3 keeps the nibbles, flips their
//   sign bit and ORs in the exponent of 128 (u | 0x4300 with u = nibble ^
//   8 is the bf16 of 128 + u), one HSUB2 takes 136 away (the signed nibble,
//   exact) and one HMUL2 by the two K rows' scales rounds each exact product
//   once: bit for bit bf16(f32(nibble) * f32(s)), the reference's weight.
// - The products on tensor cores: mma.sync m16n8k16 bf16 -> f32 with the
//   weight as A (16 output columns) and x as B (the activation rows as n 8,
//   zero past `rows`). The pair of a byte is A's two k values of one
//   register, so the mma's k runs over (r, K/2 + r) pairs and x is paired
//   alike (one PRMT a B register). Lane (g, t) of a warp owns the kV = 8
//   columns 8g .. 8g + 7 of its 64-column tile (one 8-byte load of a K row)
//   and the 8 packed rows 8t .. 8t + 7 of a 32-row round; the columns 2m
//   and 2m + 1 of its 8 are rows g and g + 8 of product m, its rows 2j and
//   2j + 1 the k pairs t and t + 4 of k-step j. So every byte a lane loads
//   is a fragment of its own: no shuffle, no shared memory.
// - The card full: 64-column tiles x K split over a thread-block cluster of
//   up to 8 blocks, the fewest that bring the grid to two blocks an SM, a
//   warp a round of its split (at most 8 a block). (128-column tiles with
//   16-byte loads measured no faster at rows 1 and slower at rows 8; a
//   warp's next round loaded before its math, or more warps a block, slower
//   at gate|up and down: PERF.md.)
// - Loads: a round's scales first, then its 8 weight rows (past L1; 4
//   lanes t x 8 g a load: 4 rows of 64 contiguous bytes), then x (L1,
//   shared by every block). The kernel is its predecessor's programmatic
//   dependent: the first round's scales and weights are on their way
//   before it waits for the grid that wrote x (griddepcontrol.wait; a
//   no-op after an ordinary launch, so graphs keep the edge).
// - The sums in a fixed order: a warp's rounds ascending in the tensor
//   cores' accumulators, the warps of a block ascending through shared
//   memory, then the K splits of a tile (the cluster) ascending after every
//   block stored its sums into block 0's shared memory. No global scratch,
//   no counter, no atomics: a launch and a graph replay give the same bits.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace {
namespace w4a16 {

constexpr int kRound = 32;          // packed K rows a warp takes a round
constexpr int kMaxRows = 8;         // activation rows: the products' n
constexpr int kV = 8;               // columns (bytes of a K row) a lane
constexpr int kTileN = 8 * kV;      // columns a block
constexpr int kMaxSplits = 8;       // a cluster's blocks at most (portable)
constexpr int kMaxWarps = 8;
constexpr int kTargetBlocks = 264;  // two on each of the H100's 132 SMs

// The launch plan, a function of (N, K/2) alone so a captured graph stays
// valid: 64-column tiles; K split into the fewest power-of-2 cluster of
// blocks that brings the grid to kTargetBlocks (at most kMaxSplits, each
// split a round at least); a block's warps one per round of its split, at
// most kMaxWarps.
struct Plan {
  int tile_n, tiles, splits, warps, rounds;
};

__host__ __device__ inline Plan make_plan(int n, int k_half) {
  Plan p;
  p.rounds = (k_half + kRound - 1) / kRound;
  p.tile_n = kTileN;
  p.tiles = (n + kTileN - 1) / kTileN;
  p.splits = 1;
  while (p.splits < kMaxSplits && p.tiles * p.splits < kTargetBlocks &&
         2 * p.splits <= p.rounds)
    p.splits *= 2;
  const int per = (p.rounds + p.splits - 1) / p.splits;
  p.warps = per < kMaxWarps ? per : kMaxWarps;
  return p;
}

// Dynamic shared memory of a launch: each warp's sums, then each split's.
__host__ __device__ inline size_t smem_bytes(const Plan& p, int rows) {
  return (size_t)(p.warps + p.splits) * rows * p.tile_n * sizeof(float);
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte e of word `wd` (its high nibbles shifted down in `wd4 = wd >> 4`)
// as the bf16x2 of its two signed nibbles (lo, hi), exact. w4a16_gemv.cu
// takes them as they are (its scale is a column's, applied to the f32 sum).
template <int E>
__device__ __forceinline__ __nv_bfloat162 nibble_pair(uint32_t wd, uint32_t wd4) {
  constexpr uint32_t kSel = E | (E << 4) | ((4 + E) << 8) | ((4 + E) << 12);
  const uint32_t b = __byte_perm(wd, wd4, kSel);
  const uint32_t u = (b & 0x000F000Fu) ^ 0x43084308u;          // 128 + (nibble ^ 8)
  return __hsub2(as_bf2(u), as_bf2(0x43084308u));               // the nibble
}

// The same byte as (bf16(lo * sp.lo), bf16(hi * sp.hi)).
template <int E>
__device__ __forceinline__ uint32_t dq_pair(uint32_t wd, uint32_t wd4, uint32_t sp) {
  return as_u32(__hmul2(nibble_pair<E>(wd, wd4), as_bf2(sp)));
}

// d += A (16 x 16 bf16) . B (16 x 8 bf16), f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Weight bytes, read once: past L1.
__device__ __forceinline__ uint4 ld_w16(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ld_w8(const uint8_t* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ld_w4(const uint8_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// NB bytes (NB / 4 words) at p: one load where `wide` and all `valid`
// columns are inside N, else word by word, the words at or past `valid`
// zero (N % 4 == 0).
template <int NB>
__device__ __forceinline__ void load_bytes(const uint8_t* p, bool wide, int valid,
                                           uint32_t (&wd)[NB / 4]) {
  if (wide && valid >= NB) {
    if constexpr (NB == 16) {
      const uint4 v = ld_w16(p);
      wd[0] = v.x; wd[1] = v.y; wd[2] = v.z; wd[3] = v.w;
    } else {
      const uint2 v = ld_w8(p);
      wd[0] = v.x; wd[1] = v.y;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < NB / 4; ++q) wd[q] = 4 * q < valid ? ld_w4(p + 4 * q) : 0u;
}

// The V bf16 scales of a K block row at columns c0 .. (V / 2 words), through
// L1 (the four lanes t of a column group read the same ones).
template <int V>
__device__ __forceinline__ void load_scales(const __nv_bfloat16* p, bool wide, int valid,
                                            uint32_t (&sw)[V / 2]) {
  if (wide && valid >= V) {
#pragma unroll
    for (int i = 0; i < V / 8; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      sw[4 * i] = v.x; sw[4 * i + 1] = v.y; sw[4 * i + 2] = v.z; sw[4 * i + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {          // groups of 4 columns: 8 bytes
    uint2 v = make_uint2(0u, 0u);
    if (4 * q < valid) v = __ldg(reinterpret_cast<const uint2*>(p + 4 * q));
    sw[2 * q] = v.x;
    sw[2 * q + 1] = v.y;
  }
}

// (s_lo[c], s_hi[c]) of each of the V columns as a bf16x2
template <int V>
__device__ __forceinline__ void scale_pairs(const uint32_t (&lo)[V / 2], const uint32_t (&hi)[V / 2],
                                            uint32_t (&sp)[V]) {
#pragma unroll
  for (int q = 0; q < V / 2; ++q) {
    sp[2 * q] = __byte_perm(lo[q], hi[q], 0x5410);
    sp[2 * q + 1] = __byte_perm(lo[q], hi[q], 0x7632);
  }
}

// 8 bf16 of an activation row at p (16 bytes, or two 8-byte halves where
// p is only 8-byte aligned), the halves at or past `valid` values zero.
template <bool kAligned>
__device__ __forceinline__ void load_x8(const __nv_bfloat16* p, int valid, uint32_t (&xv)[4]) {
  if (kAligned && valid >= 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    xv[0] = v.x; xv[1] = v.y; xv[2] = v.z; xv[3] = v.w;
    return;
  }
  const uint2 a = valid > 0 ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
  const uint2 b = valid > 4 ? __ldg(reinterpret_cast<const uint2*>(p + 4)) : make_uint2(0u, 0u);
  xv[0] = a.x; xv[1] = a.y; xv[2] = b.x; xv[3] = b.y;
}

// One launch: block (tile blockIdx.x / splits, split blockIdx.x % splits),
// its warps the split's warps; a tile's splits are one cluster. Warp gw of
// the tile (split-major) takes the rounds [gw R / GW, (gw + 1) R / GW).
// kSplitHi: K/2 % 8 == 4, so a lane's 8 high-half rows may straddle a
// scale block at its row 4 (and its high x is only 8-byte aligned).
template <bool kSplitHi>
__global__ void __launch_bounds__(32 * kMaxWarps)
block_kernel(const uint8_t* __restrict__ w, const __nv_bfloat16* __restrict__ s,
             const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out, int rows,
             int n, int k_half, int blk, int splits, int wide) {
  constexpr int V = kV, TN = kTileN;
  constexpr int NM = V / 2;                    // products a k-step
  constexpr int NW = V / 4;                    // words of a lane's row chunk
  extern __shared__ float sm[];
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x / splits, rank = blockIdx.x % splits;
  const int c0 = tile * TN + g * V;            // the lane's first column
  const int valid = n - c0;                    // its columns inside N
  const int rounds = (k_half + kRound - 1) / kRound;
  const int gwarps = splits * nwarps, gw = rank * nwarps + warp;
  const int i0 = (int)((long long)gw * rounds / gwarps);
  const int i1 = (int)((long long)(gw + 1) * rounds / gwarps);
  const bool xrow = g < rows;
  const __nv_bfloat16* xr = x + (size_t)g * 2 * k_half;

  // the cluster's blocks have started before any stores into block 0's
  // shared memory (the wait stands before the fold)
  if (splits > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  float d[NM][4];
#pragma unroll
  for (int m = 0; m < NM; ++m) d[m][0] = d[m][1] = d[m][2] = d[m][3] = 0.f;

  for (int i = i0; i < i1; ++i) {
    const int r0 = i * kRound + 8 * t;         // the lane's first packed row
    const int live = min(max(k_half - r0, 0), 8);   // 0, 4 or 8 (K/2 % 4 == 0)
    // 1. the scales: the low half's block, the high half's (two where a
    // block boundary falls at row 4)
    uint32_t sw_lo[V / 2], sw_h0[V / 2], sw_h1[V / 2];   // sw_h1: kSplitHi only
    if (live > 0) {
      load_scales<V>(s + (size_t)(r0 / blk) * n + c0, wide, valid, sw_lo);
      load_scales<V>(s + (size_t)((k_half + r0) / blk) * n + c0, wide, valid, sw_h0);
      if constexpr (kSplitHi) {
        if (live > 4) {
          load_scales<V>(s + (size_t)((k_half + r0 + 4) / blk) * n + c0, wide, valid, sw_h1);
        } else {
#pragma unroll
          for (int q = 0; q < V / 2; ++q) sw_h1[q] = 0u;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < V / 2; ++q) sw_lo[q] = sw_h0[q] = sw_h1[q] = 0u;
    }
    // 2. the weights: 8 K rows of V bytes
    uint32_t wv[8][NW];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < live && valid > 0) {
        load_bytes<V>(w + (size_t)(r0 + j) * n + c0, wide, valid, wv[j]);
      } else {
#pragma unroll
        for (int q = 0; q < NW; ++q) wv[j][q] = 0u;
      }
    }
    // 3. x's two halves of the 8 rows, once the grid that wrote x is done
    if (i == i0) asm volatile("griddepcontrol.wait;" ::: "memory");
    uint32_t xl[4] = {0u, 0u, 0u, 0u}, xh[4] = {0u, 0u, 0u, 0u};
    if (xrow && live > 0) {
      load_x8<true>(xr + r0, live, xl);
      load_x8<!kSplitHi>(xr + k_half + r0, live, xh);
    }
    // 4. the products: k-step j takes rows 2j (k pair t) and 2j + 1 (t + 4)
    uint32_t sp[V];
    scale_pairs<V>(sw_lo, sw_h0, sp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (kSplitHi) {
        if (j == 2) scale_pairs<V>(sw_lo, sw_h1, sp);    // rows 4-7
      }
      const uint32_t b0 = __byte_perm(xl[j], xh[j], 0x5410);
      const uint32_t b1 = __byte_perm(xl[j], xh[j], 0x7632);
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        const uint32_t wa = wv[2 * j][q], wb = wv[2 * j + 1][q];
        const uint32_t wa4 = wa >> 4, wb4 = wb >> 4;
        // columns 4q, 4q + 1 (product 2q) and 4q + 2, 4q + 3 (2q + 1)
        mma_bf16(d[2 * q], dq_pair<0>(wa, wa4, sp[4 * q]), dq_pair<1>(wa, wa4, sp[4 * q + 1]),
                 dq_pair<0>(wb, wb4, sp[4 * q]), dq_pair<1>(wb, wb4, sp[4 * q + 1]), b0, b1);
        mma_bf16(d[2 * q + 1], dq_pair<2>(wa, wa4, sp[4 * q + 2]),
                 dq_pair<3>(wa, wa4, sp[4 * q + 3]), dq_pair<2>(wb, wb4, sp[4 * q + 2]),
                 dq_pair<3>(wb, wb4, sp[4 * q + 3]), b0, b1);
      }
    }
  }

  // 5. the warps' sums (rows 2t, 2t + 1 of columns g V + 2m, + 1), then
  // the warps in ascending order, then the splits in ascending order in
  // block 0's shared memory
  asm volatile("griddepcontrol.wait;" ::: "memory");   // before any store (warps without rounds)
  const int cells = rows * TN;
  float* red = sm;                             // [warps][rows][TN]
  float* part = sm + nwarps * cells;           // [splits][rows][TN]
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int col = g * V + 2 * m;
    if (2 * t < rows) {
      red[warp * cells + 2 * t * TN + col] = d[m][0];
      red[warp * cells + 2 * t * TN + col + 1] = d[m][2];
    }
    if (2 * t + 1 < rows) {
      red[warp * cells + (2 * t + 1) * TN + col] = d[m][1];
      red[warp * cells + (2 * t + 1) * TN + col + 1] = d[m][3];
    }
  }
  __syncthreads();
  if (splits > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    float v = red[idx];
    for (int u = 1; u < nwarps; ++u) v += red[u * cells + idx];
    if (splits > 1) {
      const uint32_t local = (uint32_t)__cvta_generic_to_shared(part + rank * cells + idx);
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(0));
      asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(v) : "memory");
    } else {
      part[idx] = v;
    }
  }
  if (splits > 1) {
    asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;" ::: "memory");
  } else {
    __syncthreads();
  }
  if (rank != 0) return;
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    const int col = tile * TN + idx % TN;
    float v = part[idx];
    for (int q = 1; q < splits; ++q) v += part[q * cells + idx];
    if (col < n) out[(size_t)(idx / TN) * n + col] = __float2bfloat16_rn(v);
  }
}

}  // namespace w4a16
}  // namespace
