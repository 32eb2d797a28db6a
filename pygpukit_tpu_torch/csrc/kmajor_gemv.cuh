// Shared layout of the K-major GEMVs (block_w4a8_gemv, block_w4a16_gemv,
// conv_gemv): weights stored [K (or K/2 packed), N] with N contiguous, as the
// model keeps them.
//
// A block owns 32 output columns. Its 512 threads are 8 column groups of 4
// columns (one 32-bit word of a one-byte row, so a warp reads whole 32-byte
// sectors of 8 rows) times 64 K-slices. Each thread walks groups of 4
// consecutive K rows: it loads the 4 rows' words and transposes them in
// registers (pgk_transpose4), so each column's 4 K values sit in one word.
#pragma once

#include "common.cuh"

namespace {

constexpr int kKmTN = 32;                       // output columns per block
constexpr int kKmGroups = 8;                    // column groups of 4
constexpr int kKmThreads = 512;
constexpr int kKmSlices = kKmThreads / kKmGroups;   // 64 K-slices
constexpr int kKmWarps = kKmThreads / 32;
constexpr int kKmMaxRows = 8;

// w_j holds row j's bytes of 4 columns (column c in byte c). On return col[c]
// holds column c's bytes of the 4 rows (row j in byte j).
__device__ __forceinline__ void pgk_transpose4(unsigned w0, unsigned w1, unsigned w2,
                                               unsigned w3, unsigned (&col)[4]) {
  const unsigned a = __byte_perm(w0, w1, 0x5140);   // w0c0 w1c0 w0c1 w1c1
  const unsigned b = __byte_perm(w0, w1, 0x7362);   // w0c2 w1c2 w0c3 w1c3
  const unsigned c = __byte_perm(w2, w3, 0x5140);
  const unsigned d = __byte_perm(w2, w3, 0x7362);
  col[0] = __byte_perm(a, c, 0x5410);
  col[1] = __byte_perm(a, c, 0x7632);
  col[2] = __byte_perm(b, d, 0x5410);
  col[3] = __byte_perm(b, d, 0x7632);
}

// Signed nibble j of a word's low (hi == 0) or high nibbles, as an int.
__device__ __forceinline__ int pgk_nibble(unsigned w, int j, int hi) {
  return ((int)(w << (28 - 8 * j - 4 * hi))) >> 28;
}

// Sum each thread's acc[r][c] over the 64 K-slices in a fixed order (two
// shuffle steps inside the warp, then the 16 warps in ascending order through
// `red`, kKmWarps * kKmMaxRows * kKmTN floats of shared memory) and store
// out[r, n] = bf16(sum * scale[n]); scale == nullptr multiplies by nothing.
__device__ __forceinline__ void pgk_km_reduce_store(
    float (&acc)[kKmMaxRows][4], int rows, int n, const float* __restrict__ scale,
    __nv_bfloat16* __restrict__ out, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = threadIdx.x % kKmGroups;
#pragma unroll
  for (int r = 0; r < kKmMaxRows; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = acc[r][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < kKmGroups && r < rows) red[(warp * kKmMaxRows + r) * kKmTN + grp * 4 + c] = v;
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < rows * kKmTN) {
    const int r = t / kKmTN, col = t % kKmTN;
    const int gn = blockIdx.x * kKmTN + col;
    if (gn < n) {
      float s = 0.f;
      for (int w = 0; w < kKmWarps; ++w) s += red[(w * kKmMaxRows + r) * kKmTN + col];
      if (scale != nullptr) s *= scale[gn];
      out[(size_t)r * n + gn] = __float2bfloat16_rn(s);
    }
  }
}

}  // namespace
