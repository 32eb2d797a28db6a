// Tensor-core and async-copy helpers: 16-byte cp.async into shared memory
// (decode_attention.cuh's ring, the tile below), ldmatrix fragments, the
// bf16 m16n8k16 product with f32 sums and bf16 packing (hopper.cuh builds
// on these), and the 128 x 128 mma.sync block tile of gemm.cu and gmm.cu.
#pragma once

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (nothing is read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// One 128 x 128 block tile of A . B in f32 on the tensor cores (gemm.cu,
// gmm.cu): 8 warps (2 x 4, each warp 64 x 32), K in steps of 32. A and B
// tiles stream into padded shared memory by 16-byte cp.async,
// double-buffered; a vector of A outside rows [row_lo, row_hi), or past n or
// k, is zero-filled (source size 0), so ragged edges need no padding beyond
// 16-byte rows (k % 8 == 0, n % 8 == 0, lda and ldb multiples of 8). A
// fragments come from ldmatrix, B fragments ([K, N] row-major) from
// ldmatrix.trans, and the products run on mma.sync m16n8k16. Every output
// element is one thread's sum in ascending K order (per 16-wide mma step).
//
// acc[mi][ni][e] holds row wm + mi*16 + lane/4 + (e/2)*8 and column
// wn + ni*8 + 2*(lane%4) + e%2 of the tile, with wm = (warp/4)*64 and
// wn = (warp%4)*32.
// ---------------------------------------------------------------------------

constexpr int kTileM = 128, kTileN = 128, kTileK = 32;
constexpr int kTileThreads = 256;
constexpr int kTileAS = kTileK + 8;   // padded shared rows: ldmatrix rows hit distinct banks
constexpr int kTileBS = kTileN + 8;

struct TileSmem {
  __nv_bfloat16 a[2][kTileM * kTileAS];
  __nv_bfloat16 b[2][kTileK * kTileBS];
};

__device__ __forceinline__ void mma_tile_bf16(const __nv_bfloat16* __restrict__ a, int lda,
                                              int m0, int row_lo, int row_hi,
                                              const __nv_bfloat16* __restrict__ b, int ldb,
                                              int n0, int n, int k, TileSmem& sm,
                                              float (&acc)[4][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;   // this warp's 64 x 32

  auto load_tile = [&](int kt, int buf) {
    const int k0 = kt * kTileK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = threadIdx.x + j * kTileThreads;
      {  // A: 128 rows x 4 vectors
        const int r = i >> 2, col = (i & 3) * 8;
        const int row = m0 + r;
        const bool ok = row >= row_lo && row < row_hi && k0 + col < k;
        const __nv_bfloat16* src = a + (ok ? (size_t)row * lda + k0 + col : 0);
        cp_async16(&sm.a[buf][r * kTileAS + col], src, ok);
      }
      {  // B: 32 rows x 16 vectors
        const int r = i >> 4, col = (i & 15) * 8;
        const bool ok = k0 + r < k && n0 + col < n;
        const __nv_bfloat16* src = b + (ok ? (size_t)(k0 + r) * ldb + n0 + col : 0);
        cp_async16(&sm.b[buf][r * kTileBS + col], src, ok);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int n_k = (k + kTileK - 1) / kTileK;
  load_tile(0, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {
      load_tile(kt + 1, (kt + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* at = sm.a[kt & 1];
    const __nv_bfloat16* bt = sm.b[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)   // matrices: rows 0-7 / 8-15 x k lo, then x k hi
        ldmatrix_x4(af[mi], at + (wm + mi * 16 + (lane & 15)) * kTileAS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: k (16kk.., 16kk+8..) x n tile 2nj, then x n tile 2nj+1
        uint32_t r[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(r, bt + key * kTileBS + wn + nj * 16 + (lane >> 4) * 8);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    __syncthreads();                   // this buffer is refilled two tiles on
  }
}

}  // namespace
