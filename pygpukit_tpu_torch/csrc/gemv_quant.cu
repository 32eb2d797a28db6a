// Quantized-storage GEMV: y[n] = bf16((sum_k bf16(W[n, k]) * bf16(x[k])) *
// scale[n]), sums in f32, W an N-major [N, K] weight (K contiguous per output)
// in fp8 e4m3fn, fp8 e5m2, int8 or bf16.
//
// Replaces pygpukit_tpu/kernels/gemv_quant.py _gemv_pallas (gemv_quant, the
// library GEMV over quantized storage). Its bn/bk tiles and the 7 padding
// rows of x are TPU tiling and have no counterpart here.
//
// Bound: bytes. Every weight byte is read once (N K elt bytes; x, scale and y
// are small), two flops per weight element. Design: one warp per output row,
// eight rows per block. x is converted to bf16 once per block into shared
// memory. Each lane reads 16-byte vectors along its warp's row (16 fp8 or
// int8 values, 8 bf16), converts them to f32 (exact for all four types: fp8
// and int8 fit bf16, which fits f32) and sums its products in f32 in
// ascending K order; the warp's 32 partial sums fold by xor shuffles in a
// fixed order, so a replay gives the same bits. A row whose start is not 16
// bytes aligned (K * elt % 16 != 0) runs a scalar head up to the first
// aligned element and a scalar tail after the last whole vector.
#include <cuda_fp8.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Kind { kE4M3 = 0, kE5M2 = 1, kInt8 = 2, kBf16 = 3 };
constexpr int kWarps = 8;

template <int KIND>
struct Storage {
  using T = uint8_t;
};
template <>
struct Storage<kBf16> {
  using T = bf16;
};

template <int KIND>
__device__ __forceinline__ float to_f32(typename Storage<KIND>::T v) {
  if constexpr (KIND == kE4M3) {
    __nv_fp8_e4m3 f;
    f.__x = (__nv_fp8_storage_t)v;
    return float(f);
  } else if constexpr (KIND == kE5M2) {
    __nv_fp8_e5m2 f;
    f.__x = (__nv_fp8_storage_t)v;
    return float(f);
  } else if constexpr (KIND == kInt8) {
    return (float)(int8_t)v;
  } else {
    return __bfloat162float(v);
  }
}

template <int KIND>
__global__ void __launch_bounds__(kWarps * 32)
gemv_quant_kernel(const void* __restrict__ w, const void* __restrict__ x, int x_f32,
                  const float* __restrict__ scale, bf16* __restrict__ out, int n, int k) {
  using T = typename Storage<KIND>::T;
  constexpr int kVec = 16 / (int)sizeof(T);          // elements per 16-byte load
  extern __shared__ __align__(16) bf16 xs[];          // [k]
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    xs[i] = x_f32 ? __float2bfloat16_rn(static_cast<const float*>(x)[i])
                  : static_cast<const bf16*>(x)[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n) return;
  const T* wr = static_cast<const T*>(w) + (size_t)row * k;
  // scalar head up to the first 16-byte aligned element, whole vectors, tail
  const int head = min(k, (int)(((16 - ((uintptr_t)wr & 15)) & 15) / sizeof(T)));
  const int n_vec = (k - head) / kVec;
  const int tail = head + n_vec * kVec;
  float acc = 0.f;
  if (lane < head) acc = to_f32<KIND>(wr[lane]) * __bfloat162float(xs[lane]);
  const uint4* wv = reinterpret_cast<const uint4*>(wr + head);
#pragma unroll 4
  for (int v = lane; v < n_vec; v += 32) {
    const uint4 u = __ldg(wv + v);
    const T* e = reinterpret_cast<const T*>(&u);
    const bf16* xv = xs + head + v * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc = fmaf(to_f32<KIND>(e[i]), __bfloat162float(xv[i]), acc);
  }
  for (int i = tail + lane; i < k; i += 32)
    acc = fmaf(to_f32<KIND>(wr[i]), __bfloat162float(xs[i]), acc);
  acc = pgk_warp_sum(acc);
  if (lane == 0) out[row] = __float2bfloat16_rn(scale != nullptr ? acc * scale[row] : acc);
}

template <int KIND>
cudaError_t launch_gemv(const void* w, const void* x, int x_f32, const float* scale, bf16* out,
                        int n, int k, cudaStream_t st) {
  const size_t smem = (size_t)k * sizeof(bf16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gemv_quant_kernel<KIND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int grid = (n + kWarps - 1) / kWarps;
  gemv_quant_kernel<KIND><<<grid, kWarps * 32, smem, st>>>(w, x, x_f32, scale, out, n, k);
  return cudaGetLastError();
}

}  // namespace

// w [n, k] of `kind` (0 fp8 e4m3fn, 1 fp8 e5m2, 2 int8, 3 bf16), rows
// contiguous; x [k] f32 (x_f32 != 0) or bf16; scale [n] f32 or null (1.0);
// out [n] bf16. Requires n, k >= 1 and k bf16 values in shared memory
// (k <= 116224).
PGK_API int pgk_gemv_quant(const void* w, int kind, const void* x, int x_f32,
                           const void* scale, void* out, int n, int k, void* stream) {
  if (n < 1 || k < 1 || (size_t)k * sizeof(bf16) > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  bf16* o = static_cast<bf16*>(out);
  switch (kind) {
    case kE4M3: return (int)launch_gemv<kE4M3>(w, x, x_f32, sc, o, n, k, st);
    case kE5M2: return (int)launch_gemv<kE5M2>(w, x, x_f32, sc, o, n, k, st);
    case kInt8: return (int)launch_gemv<kInt8>(w, x, x_f32, sc, o, n, k, st);
    case kBf16: return (int)launch_gemv<kBf16>(w, x, x_f32, sc, o, n, k, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
