// int4_block w4a16 GEMV for rows <= 8: y[r, n] = bf16(sum_k x[r, k] * w[k, n])
// with w[k, n] = bf16(nibble(k, n) * s[k / B, n]) and x in bf16, f32 sums.
//
// Replaces pygpukit_tpu/kernels/gemv_quant.py _gemv_block_stacked_pallas and
// _gemv_block_pallas (the same _block_tile_dots math on a stacked [L, K/2, N]
// or a 2-D [K/2, N] weight; here a layer of a stack is a free view).
//
// Storage: K-major split-half packed [K/2, N] uint8 (packed row r holds
// W[r] in the low nibble and W[K/2 + r] in the high one) and bf16 block
// scales [K/B, N]. Each k takes the block k / B, so a block that straddles
// K/2 (B not dividing K/2) is read right, where the reference's lo/hi scale
// split needs B | K/2.
//
// Bound: bytes. Per step each packed byte is read once (plus one bf16 scale
// per B/2 bytes) for at most 8 rows. Design: kmajor_gemv.cuh's layout; the
// weight is rounded to bf16 after the scale multiply, as the reference's
// bf16 tile multiply does, so x * w is exact in f32 and only the order of
// the f32 sums differs from the reference (and from the plain version).
#include "kmajor_gemv.cuh"

namespace {

__global__ void __launch_bounds__(kKmThreads)
block_w4a16_gemv_kernel(const uint8_t* __restrict__ w, const __nv_bfloat16* __restrict__ s,
                        const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                        int rows, int n, int k_half, int blk) {
  __shared__ float red[kKmWarps * kKmMaxRows * kKmTN];
  const int grp = threadIdx.x % kKmGroups;
  const int slice = threadIdx.x / kKmGroups;
  const int n0 = blockIdx.x * kKmTN + grp * 4;
  const int k = 2 * k_half;
  float acc[kKmMaxRows][4];
#pragma unroll
  for (int r = 0; r < kKmMaxRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  if (n0 < n) {
    for (int r0 = 4 * slice; r0 < k_half; r0 += 4 * kKmSlices) {
      const unsigned* wp = reinterpret_cast<const unsigned*>(w + (size_t)r0 * n + n0);
      const size_t st = n / 4;
      unsigned col[4];
      pgk_transpose4(__ldg(wp), __ldg(wp + st), __ldg(wp + 2 * st), __ldg(wp + 3 * st), col);
      // the 4 rows share their lo block and their hi block (B % 8 == 0)
      const uint2 slo = __ldg(reinterpret_cast<const uint2*>(s + (size_t)(r0 / blk) * n + n0));
      const uint2 shi = __ldg(reinterpret_cast<const uint2*>(
          s + (size_t)((k_half + r0) / blk) * n + n0));
      const __nv_bfloat16* sl = reinterpret_cast<const __nv_bfloat16*>(&slo);
      const __nv_bfloat16* sh = reinterpret_cast<const __nv_bfloat16*>(&shi);
      float wl[4][4], wh[4][4];                        // [column][row j]
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float fl = __bfloat162float(sl[c]), fh = __bfloat162float(sh[c]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wl[c][j] = __bfloat162float(__float2bfloat16_rn((float)pgk_nibble(col[c], j, 0) * fl));
          wh[c][j] = __bfloat162float(__float2bfloat16_rn((float)pgk_nibble(col[c], j, 1) * fh));
        }
      }
#pragma unroll
      for (int r = 0; r < kKmMaxRows; ++r) {
        if (r < rows) {
          const uint2 xl = __ldg(reinterpret_cast<const uint2*>(x + (size_t)r * k + r0));
          const uint2 xh = __ldg(reinterpret_cast<const uint2*>(x + (size_t)r * k + k_half + r0));
          const __nv_bfloat16* xlb = reinterpret_cast<const __nv_bfloat16*>(&xl);
          const __nv_bfloat16* xhb = reinterpret_cast<const __nv_bfloat16*>(&xh);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float a = __bfloat162float(xlb[j]), b = __bfloat162float(xhb[j]);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] += a * wl[c][j] + b * wh[c][j];
          }
        }
      }
    }
  }
  pgk_km_reduce_store(acc, rows, n, nullptr, out, red);
}

}  // namespace

// x [rows, 2*k_half] bf16; w [k_half, n] uint8; s [2*k_half/blk, n] bf16;
// out [rows, n] bf16. Requires rows <= 8, n % 4 == 0, blk % 8 == 0 and
// (2*k_half) % blk == 0.
PGK_API int pgk_block_w4a16_gemv(const void* x, const void* w, const void* s, void* out,
                                 int rows, int n, int k_half, int blk, void* stream) {
  if (rows < 1 || rows > kKmMaxRows || n < 4 || n % 4 || blk < 8 || blk % 8 ||
      k_half < 1 || (2 * k_half) % blk)
    return (int)cudaErrorInvalidValue;
  const int grid = (n + kKmTN - 1) / kKmTN;
  block_w4a16_gemv_kernel<<<grid, kKmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(w), static_cast<const __nv_bfloat16*>(s),
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), rows, n,
      k_half, blk);
  return (int)cudaGetLastError();
}
