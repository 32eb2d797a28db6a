// Converting GEMV for rows <= 8: y[r, n] = bf16(acc[r, n] * scale[n]) with
// acc[r, n] = sum_k x[r, k] * bf16(w[k, n]) in f32, x rounded to bf16, and w
// a K-major [K, N] weight in fp8 e4m3fn, fp8 e5m2, int8 or bf16.
//
// Replaces pygpukit_tpu/kernels/gemv_quant.py _gemv_conv_stacked_pallas (the
// stacked [L, K, N] form; here a layer is a free view). Every one of the four
// storage types converts exactly to bf16 (and so to f32): fp8 has 2-3
// mantissa bits and a range inside bf16's, int8 needs 7 bits.
//
// Bound: bytes. Decode streams each weight byte once per step for at most 8
// rows. Design: kmajor_gemv.cuh's layout (4 columns a thread, one 32-bit word
// of a one-byte row or 8 bytes of a bf16 row; 64 K-slices of 4-row groups);
// bf16 x times the converted weight is exact in f32, so only the order of
// the f32 sums differs from the reference and the plain version.
#include <cuda_fp8.h>

#include "kmajor_gemv.cuh"

namespace {

enum Kind { kE4M3 = 0, kE5M2 = 1, kInt8 = 2, kBf16 = 3 };

template <int KIND>
__device__ __forceinline__ float pgk_byte_to_f32(unsigned byte) {
  if constexpr (KIND == kE4M3) {
    __nv_fp8_e4m3 v;
    v.__x = (__nv_fp8_storage_t)byte;
    return float(v);
  } else if constexpr (KIND == kE5M2) {
    __nv_fp8_e5m2 v;
    v.__x = (__nv_fp8_storage_t)byte;
    return float(v);
  } else {
    return (float)(int8_t)byte;
  }
}

// Row j's 4 columns of a K-major weight, as f32 into w[c][j].
template <int KIND>
__device__ __forceinline__ void pgk_load_row(const void* base, size_t off, int j,
                                             float (&w)[4][4]) {
  if constexpr (KIND == kBf16) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(base) + off));
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c][j] = __bfloat162float(b[c]);
  } else {
    const unsigned u = __ldg(reinterpret_cast<const unsigned*>(
        static_cast<const uint8_t*>(base) + off));
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c][j] = pgk_byte_to_f32<KIND>((u >> (8 * c)) & 0xFFu);
  }
}

template <int KIND>
__global__ void __launch_bounds__(kKmThreads)
conv_gemv_kernel(const void* __restrict__ w, const float* __restrict__ scale,
                 const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                 int rows, int n, int k) {
  __shared__ float red[kKmWarps * kKmMaxRows * kKmTN];
  const int grp = threadIdx.x % kKmGroups;
  const int slice = threadIdx.x / kKmGroups;
  const int n0 = blockIdx.x * kKmTN + grp * 4;
  float acc[kKmMaxRows][4];
#pragma unroll
  for (int r = 0; r < kKmMaxRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  if (n0 < n) {
    for (int k0 = 4 * slice; k0 < k; k0 += 4 * kKmSlices) {
      float wv[4][4];                                  // [column][row j]
#pragma unroll
      for (int j = 0; j < 4; ++j) pgk_load_row<KIND>(w, (size_t)(k0 + j) * n + n0, j, wv);
#pragma unroll
      for (int r = 0; r < kKmMaxRows; ++r) {
        if (r < rows) {
          const uint2 xu = __ldg(reinterpret_cast<const uint2*>(x + (size_t)r * k + k0));
          const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(&xu);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float a = __bfloat162float(xb[j]);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] += a * wv[c][j];
          }
        }
      }
    }
  }
  pgk_km_reduce_store(acc, rows, n, scale, out, red);
}

}  // namespace

// x [rows, k] bf16; w [k, n] of `kind` (0 fp8 e4m3fn, 1 fp8 e5m2, 2 int8,
// 3 bf16); scale [n] f32; out [rows, n] bf16. Requires rows <= 8,
// n % 4 == 0 and k % 4 == 0.
PGK_API int pgk_conv_gemv(const void* x, const void* w, int kind, const void* scale,
                          void* out, int rows, int n, int k, void* stream) {
  if (rows < 1 || rows > kKmMaxRows || n < 4 || n % 4 || k < 4 || k % 4)
    return (int)cudaErrorInvalidValue;
  const int grid = (n + kKmTN - 1) / kKmTN;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  switch (kind) {
    case kE4M3: conv_gemv_kernel<kE4M3><<<grid, kKmThreads, 0, st>>>(w, sc, xb, o, rows, n, k); break;
    case kE5M2: conv_gemv_kernel<kE5M2><<<grid, kKmThreads, 0, st>>>(w, sc, xb, o, rows, n, k); break;
    case kInt8: conv_gemv_kernel<kInt8><<<grid, kKmThreads, 0, st>>>(w, sc, xb, o, rows, n, k); break;
    case kBf16: conv_gemv_kernel<kBf16><<<grid, kKmThreads, 0, st>>>(w, sc, xb, o, rows, n, k); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
