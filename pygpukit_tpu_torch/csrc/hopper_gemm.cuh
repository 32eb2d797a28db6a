// The bf16 GEMM mainloop of gemm.cu and gmm.cu on Hopper: TMA loads into a
// multi-stage shared-memory ring, a producer warpgroup, two consumer
// warpgroups that run wgmma, and the epilogue's stores.
//
// One output tile is BM (128) rows x BN (256 or 128) columns of
// A[rows, K] . B[K, cols], f32 sums:
// - A is bf16 K-major (row-major [rows, K]); a stage holds one TMA box of
//   64 K columns x 128 rows, 128-byte swizzled: the K-major descriptor, SBO
//   1024, a 16-wide k-step adds 32 bytes (hopper.cuh).
// - B is bf16 [K, N] row-major, so MN-major; a stage holds BN / 64 boxes of
//   64 columns x 64 K rows of a 3-D map (N, K, matrix): the MN-major
//   descriptor with the transpose bit, SBO 1024, LBO the 8 KB between the
//   64-column sub-tiles, a k-step adds 2048 bytes. gemm's B is matrix 0 of
//   one; gmm's rhs [G, K, N] is G matrices, so a K tile past K reads zeros
//   rather than the next group's rows.
// - TMA fills zeros past every edge, so a ragged M, N or K edge needs no
//   padding: operands need only 16-byte rows and a 16-byte aligned base.
// - Warp roles (one big branch, as setmaxnreg needs): warpgroup 0 is the
//   producer (setmaxnreg_dec; one thread issues every load, waiting on the
//   stage's empty barrier), warpgroups 1 and 2 the consumers of rows 0-63
//   and 64-127 (setmaxnreg_inc), each m64nBNk16 products straight from
//   shared memory, one k tile's four products in flight while the next
//   stage is awaited; a stage frees once every consumer warp's products
//   read it.
// - Optionally (gemm) a cluster of CM x CN CTAs on CM row tiles and CN
//   column tiles: each loads 1 / CN of its A stage and 1 / CM of its B
//   stage and multicasts them to the CTAs that share them (HgCluster): on
//   the H100 the L2 -> SM rate, about 8 TB/s, not the tensor cores, bounds
//   a card full of unclustered 128 x 128 tiles.
// - The grid is persistent: as many blocks (clusters) as fit walk the
//   tiles (units of tiles) in a fixed order (hg_raster), and one ring
//   counter runs across a block's tiles, so the producer loads the next
//   tile while the consumers store this one.
// Deterministic: one block owns each output element, K is walked in
// ascending order into one f32 accumulator, no split-K and no atomics.
//
// The launch order (hg_raster) is mirrored in Python by kernels/gemm.py
// (raster), which the CPU tests hold.
#pragma once

#include "hopper.cuh"

namespace {

constexpr int kHgBM = 128;            // rows a tile: two consumer warpgroups of 64
constexpr int kHgBK = 64;             // K a stage: one 128-byte swizzled box row
constexpr int kHgThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kHgConsumers = 256;
constexpr int kHgRasterRows = 16;     // row tiles a raster group
constexpr int kHgProducerRegs = 40, kHgConsumerRegs = 232;

template <int BN>
struct HgLayout {
  static_assert(BN == 128 || BN == 256, "BN is 128 or 256");
  static constexpr int kStages = BN == 256 ? 4 : 6;         // 192 KB of ring either way
  static constexpr int kABytes = kHgBM * kHgBK * 2;         // 16 KB
  static constexpr int kBBytes = kHgBK * BN * 2;            // 32 or 16 KB
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kBarOff = kStages * kStageBytes;
  static constexpr int kBytes = kBarOff + 16 * kStages + 1024;   // + alignment slack
};

struct HgRing {
  __nv_bfloat16* a;       // [stage][128 rows][64]
  __nv_bfloat16* b;       // [stage][BN / 64][64 K rows][64]
  uint64_t* full;         // [stage]: the stage's bytes have landed
  uint64_t* empty;        // [stage]: both consumers are done reading it
};

__host__ __device__ __forceinline__ int hg_cdiv(int a, int b) { return (a + b - 1) / b; }

// Tile t of tiles_m x tiles_n in launch order: groups of kHgRasterRows row
// tiles, each swept column tile by column tile with its row tiles fastest,
// so the blocks in flight share a few B column tiles and A row tiles in L2.
__device__ __forceinline__ void hg_raster(int t, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int per = kHgRasterRows * tiles_n;
  const int first = t / per * kHgRasterRows;
  const int h = min(kHgRasterRows, tiles_m - first);
  const int r = t % per;
  tm = first + r % h;
  tn = r / h;
}

template <int BN>
__device__ __forceinline__ HgRing hg_ring(unsigned char* raw) {
  using L = HgLayout<BN>;
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  HgRing r;
  r.a = reinterpret_cast<__nv_bfloat16*>(base);
  r.b = reinterpret_cast<__nv_bfloat16*>(base + L::kStages * L::kABytes);
  r.full = reinterpret_cast<uint64_t*>(base + L::kBarOff);
  r.empty = r.full + L::kStages;
  return r;
}

// A cluster of CM x CN CTAs (rank rm + CM rn) computes CM x CN tiles: row
// tiles shared along rn, column tiles along rm. Each CTA loads 1 / CN of its
// A stage (its row band of 128 / CN rows) and 1 / CM of its B stage (every
// CM-th 64-column sub-tile), each multicast to the CTAs that share it, so
// it reads 1 / CN of A and 1 / CM of B from L2. The CTAs that write into a
// CTA's stage, and so must hear that its consumers are done with it, are
// itself, its CN - 1 row partners and its CM - 1 column partners.
template <int CM, int CN>
struct HgCluster {
  static constexpr int kSize = CM * CN;
  static constexpr int kWriters = CM + CN - 1;
  static __device__ __forceinline__ uint16_t a_mask(int rm) {   // CTAs of row tile rm
    uint16_t m = 0;
    for (int j = 0; j < CN; ++j) m |= 1u << (rm + CM * j);
    return m;
  }
  static __device__ __forceinline__ uint16_t b_mask(int rn) {   // CTAs of column tile rn
    return ((1u << CM) - 1) << (CM * rn);
  }
};

// Thread 0 initialises the barriers; the block (the cluster) syncs after.
// A stage's empty barrier takes one arrival from each consumer warp of each
// CTA that this CTA's loads fill.
template <int BN, int CM, int CN>
__device__ __forceinline__ void hg_init(const HgRing& r) {
  for (int st = 0; st < HgLayout<BN>::kStages; ++st) {
    mbar_init(&r.full[st], 1);
    mbar_init(&r.empty[st], HgCluster<CM, CN>::kWriters * kHgConsumers / 32);
  }
  mbar_fence_init();
}

// Producer (one thread): the n_k stages of one tile, A rows [m0, m0 + 128)
// of ta and B columns [n0, n0 + BN) of matrix g of tb, this CTA's share of
// each in a cluster (HgCluster). `it` counts the block's stages across its
// tiles. A stage's bytes are all of A and B either way.
template <int BN, int CM, int CN>
__device__ __forceinline__ void hg_produce(const CUtensorMap* ta, const CUtensorMap* tb,
                                           const HgRing& r, int m0, int n0, int g, int n_k,
                                           uint32_t rank, uint32_t& it) {
  using L = HgLayout<BN>;
  using C = HgCluster<CM, CN>;
  constexpr int kBand = kHgBM / CN;                  // A rows a CTA loads
  const int rm = rank % CM, rn = rank / CM;
  for (int kt = 0; kt < n_k; ++kt, ++it) {
    const int st = it % L::kStages;
    mbar_wait(&r.empty[st], ((it / L::kStages) & 1) ^ 1);
    mbar_arrive_expect_tx(&r.full[st], L::kStageBytes);
    __nv_bfloat16* a_dst = r.a + st * (kHgBM * kHgBK);
    if constexpr (CN == 1)
      tma_load_2d(a_dst, ta, &r.full[st], kt * kHgBK, m0);
    else
      tma_load_2d_multicast(a_dst + rn * kBand * kHgBK, ta, &r.full[st], kt * kHgBK,
                            m0 + rn * kBand, C::a_mask(rm));
#pragma unroll
    for (int sub = 0; sub < BN / 64; ++sub) {
      __nv_bfloat16* dst = r.b + st * (kHgBK * BN) + sub * (kHgBK * 64);
      if constexpr (CM == 1)
        tma_load_3d(dst, tb, &r.full[st], n0 + sub * 64, kt * kHgBK, g);
      else if (sub % CM == rm)
        tma_load_3d_multicast(dst, tb, &r.full[st], n0 + sub * 64, kt * kHgBK, g,
                              C::b_mask(rn));
    }
  }
}

// Producer, after its last stage: wait until every consumer, in this CTA and
// its peers, has released the last stages, so no peer arrives on this CTA's
// barriers after it exits.
template <int BN>
__device__ __forceinline__ void hg_produce_tail(const HgRing& r, uint32_t it) {
  using L = HgLayout<BN>;
  for (uint32_t j = it > (uint32_t)L::kStages ? it - L::kStages : 0; j < it; ++j)
    mbar_wait(&r.empty[j % L::kStages], (j / L::kStages) & 1);
}

template <int BN>
__device__ __forceinline__ void hg_mma(float (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void hg_mma<256>(float (&d)[128], uint64_t da, uint64_t db,
                                            int scale_d) {
  wgmma_ss_m64n256_tb(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void hg_mma<128>(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  wgmma_ss_m64n128_tb(d, da, db, scale_d);
}

// A consumer warp is done reading stage st: lane 0 tells the stage's empty
// barrier in every CTA that writes into this CTA's stage.
template <int CM, int CN>
__device__ __forceinline__ void hg_release(const HgRing& r, int st, uint32_t rank) {
  if ((threadIdx.x & 31) != 0) return;
  if constexpr (CM * CN == 1) {
    mbar_arrive(&r.empty[st]);
  } else {
    const int rm = rank % CM, rn = rank / CM;
    mbar_arrive_cluster(&r.empty[st], rank);
#pragma unroll
    for (int j = 0; j < CN; ++j)
      if (j != rn) mbar_arrive_cluster(&r.empty[st], rm + CM * j);
#pragma unroll
    for (int i = 0; i < CM; ++i)
      if (i != rm) mbar_arrive_cluster(&r.empty[st], i + CM * rn);
  }
}

// Consumer warpgroup cwg (0 or 1): acc = rows [64 cwg, 64 cwg + 64) of the
// tile, summed over the n_k stages in ascending K (n_k >= 1). Thread (warp w
// of the warpgroup, lane 4 g + t) holds rows 16 w + g (acc[4 j], acc[4 j +
// 1]) and 16 w + g + 8 (acc[4 j + 2], acc[4 j + 3]) at columns 8 j + 2 t, + 1.
template <int BN, int CM, int CN>
__device__ __forceinline__ void hg_consume(float (&acc)[BN / 2], const HgRing& r, int cwg,
                                           int n_k, uint32_t rank, uint32_t& it) {
  using L = HgLayout<BN>;
  for (int kt = 0; kt < n_k; ++kt, ++it) {
    const int st = it % L::kStages;
    mbar_wait(&r.full[st], (it / L::kStages) & 1);
    const __nv_bfloat16* at = r.a + st * (kHgBM * kHgBK) + cwg * (64 * kHgBK);
    const __nv_bfloat16* bt = r.b + st * (kHgBK * BN);
    wgmma_fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHgBK / 16; ++kk)
      hg_mma<BN>(acc, wgmma_desc_sw128(at + kk * 16, 16, 1024),
                 wgmma_desc_sw128(bt + kk * 16 * 64, kHgBK * 128, 1024), kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();                   // the previous stage's products are done
    wgmma_fence_regs(acc);
    if (kt > 0) hg_release<CM, CN>(r, (it - 1) % L::kStages, rank);
  }
  wgmma_wait<0>();
  wgmma_fence_regs(acc);
  hg_release<CM, CN>(r, (it - 1) % L::kStages, rank);
}

template <typename T>
__device__ __forceinline__ T hg_cast(float x);
template <>
__device__ __forceinline__ float hg_cast<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 hg_cast<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float hg_sel4(float x0, float x1, float x2, float x3, int i) {
  return i == 0 ? x0 : i == 1 ? x1 : i == 2 ? x2 : x3;
}

// Store a consumer's 64 x BN accumulator (first row row0, first column
// col0) into out (row stride ldc), rounding once, or zeros where `zeros`:
// rows outside [lo, hi) and columns at or past n are not written. The
// accumulator is only read, never written (a write outside wgmma would
// serialize the products, ptxas C7515).
// The four threads of a quad hold one row's columns 8 j + 2 t, + 1; for
// each four j they trade pairs (a 4 x 4 transpose by shuffles) so that
// thread t holds the 8 columns of j = 4 q + t and stores them as 16-byte
// words: a warp's store then fills whole 32-byte sectors (stored straight
// from the accumulator layout, 4- or 8-byte pieces, the epilogue took
// about 9 us of a 33 us 2048^3 product on the H100).
template <int BN, typename OutT>
__device__ __forceinline__ void hg_store(const float (&acc)[BN / 2], OutT* __restrict__ out,
                                         int ldc, int row0, int col0, int lo, int hi, int n,
                                         bool zeros = false) {
  constexpr int kVec = 16 / sizeof(OutT);            // elements of a 16-byte word
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = ldc % kVec == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + warp * 16 + g + half * 8;
    const bool live = row >= lo && row < hi;
    OutT* orow = out + (size_t)row * ldc;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      const int e = 16 * q + 2 * half;               // acc index of (j = 4 q, this half)
      float w[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // receive from quad thread s = t + r its pair of j = 4 q + t, send it
        // this thread's pair of j = 4 q + (t - r)
        const int s = (t + r) & 3, jj = (t - r) & 3;
        const float x0 = hg_sel4(acc[e], acc[e + 4], acc[e + 8], acc[e + 12], jj);
        const float x1 = hg_sel4(acc[e + 1], acc[e + 5], acc[e + 9], acc[e + 13], jj);
        const float y0 = __shfl_sync(0xffffffffu, x0, (lane & ~3) | s);
        const float y1 = __shfl_sync(0xffffffffu, x1, (lane & ~3) | s);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (s == i) {
            w[2 * i] = zeros ? 0.f : y0;
            w[2 * i + 1] = zeros ? 0.f : y1;
          }
      }
      const int col = col0 + 8 * (4 * q + t);
      if (!live || col >= n) continue;
      if (vec && col + 8 <= n) {
        if constexpr (sizeof(OutT) == 4) {
          reinterpret_cast<float4*>(orow + col)[0] = make_float4(w[0], w[1], w[2], w[3]);
          reinterpret_cast<float4*>(orow + col)[1] = make_float4(w[4], w[5], w[6], w[7]);
        } else {
          *reinterpret_cast<uint4*>(orow + col) =
              make_uint4(pack_bf16(w[0], w[1]), pack_bf16(w[2], w[3]), pack_bf16(w[4], w[5]),
                         pack_bf16(w[6], w[7]));
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (col + i < n) orow[col + i] = hg_cast<OutT>(w[i]);
      }
    }
  }
}

}  // namespace
