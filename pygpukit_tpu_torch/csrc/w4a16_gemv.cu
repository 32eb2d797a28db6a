// int4 w4a16 GEMV for rows <= 8: y[r, n] = bf16(acc[r, n] * scale[n]) with
// acc[r, n] = sum_k x[r, k] * nibble(n, k) in f32 and x rounded to bf16.
//
// Replaces pygpukit_tpu/kernels/gemv_quant.py _gemv_packed_pallas and
// _gemv_packed_stacked_pallas (the same _packed_tile_dots math on a 2-D
// [N, K/2] or a stacked [L, N, K/2] weight; here a layer is a free view).
// The reference multiplies x_hi / 16 by the high nibble * 16; both factors
// are exact powers of two apart, so x_hi * nibble is the same product.
//
// Bound: bytes, laid out as w4a8_gemv.cu: one warp per output column, each
// lane streams 16-byte chunks of the column's contiguous K/2 bytes. x stays
// in bf16 and is read through the L1 cache; every bf16 x times a nibble is
// exact in f32, so only the f32 summation order (lane strides, then a fixed
// xor tree) differs from the reference.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;       // output columns per block
constexpr int kMaxRows = 8;

__device__ __forceinline__ void pgk_bf16x8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(b[i]);
}

__global__ void __launch_bounds__(kWarps * 32)
w4a16_gemv_kernel(const uint8_t* __restrict__ w, const float* __restrict__ scale,
                  const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                  int rows, int n, int k_half) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kWarps + warp;
  if (col >= n) return;
  const int k = 2 * k_half;
  const uint4* wc = reinterpret_cast<const uint4*>(w + (size_t)col * k_half);
  const int nchunks = k_half / 16;

  float acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;

  for (int c = lane; c < nchunks; c += 32) {
    const uint4 wv = __ldg(wc + c);
    const unsigned ww[4] = {wv.x, wv.y, wv.z, wv.w};
    float lo[16], hi[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      lo[i] = (float)(((int)(ww[i / 4] << (28 - 8 * (i % 4)))) >> 28);
      hi[i] = (float)(((int)(ww[i / 4] << (24 - 8 * (i % 4)))) >> 28);
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < rows) {
        const __nv_bfloat16* xl = x + (size_t)r * k + c * 16;
        const __nv_bfloat16* xh = xl + k_half;
        float a[8];
        float s = acc[r];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          pgk_bf16x8(xl + 8 * h, a);
#pragma unroll
          for (int i = 0; i < 8; ++i) s += a[i] * lo[8 * h + i];
          pgk_bf16x8(xh + 8 * h, a);
#pragma unroll
          for (int i = 0; i < 8; ++i) s += a[i] * hi[8 * h + i];
        }
        acc[r] = s;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = pgk_warp_sum(acc[r]);
  if (lane == 0) {
    const float sc = scale[col];
    for (int r = 0; r < rows; ++r)
      out[(size_t)r * n + col] = __float2bfloat16_rn(acc[r] * sc);
  }
}

}  // namespace

// x [rows, 2*k_half] bf16, row-major; w [n, k_half] uint8; scale [n] f32;
// out [rows, n] bf16. Requires rows <= 8 and k_half % 16 == 0.
PGK_API int pgk_w4a16_gemv(const void* x, const void* w, const void* scale, void* out,
                           int rows, int n, int k_half, void* stream) {
  if (rows < 1 || rows > kMaxRows || k_half < 16 || k_half % 16 != 0 || n < 1)
    return (int)cudaErrorInvalidValue;
  const int grid = (n + kWarps - 1) / kWarps;
  w4a16_gemv_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), rows, n,
      k_half);
  return (int)cudaGetLastError();
}
