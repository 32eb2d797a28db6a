// A new KV row in pool storage: what kv_row_write.cu's kernel and the row
// write fused into batch_decode_attention.cu's pass one both store, bitwise
// as the plain version (ops/embedding.to_kv_dtype and kv_quant_rows):
// - bf16 and f32: a copy, or one round-to-nearest-even conversion;
// - fp8 e4m3 and e5m2: clamp to the format's finite range, then convert
//   with round-to-nearest-even;
// - int8 {"q", "s"}: scale = max(amax / 127, 1e-8) over the whole row by an
//   IEEE division (not a reciprocal: a one-ulp scale flips the rounding of
//   a value), rounded to bf16 and written to "s"; each value divided by the
//   rounded scale (IEEE again), rounded half to even, clamped to +-127.
#pragma once

#include <cuda_fp8.h>

#include <type_traits>

#include "common.cuh"

namespace {

template <class P>
__device__ __forceinline__ P kv_row_convert(float x) {
  if constexpr (std::is_same<P, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(x);
  } else if constexpr (std::is_same<P, float>::value) {
    return x;
  } else if constexpr (std::is_same<P, __nv_fp8_e4m3>::value) {
    return __nv_fp8_e4m3(fminf(fmaxf(x, -448.f), 448.f));
  } else {
    return __nv_fp8_e5m2(fminf(fmaxf(x, -57344.f), 57344.f));
  }
}

// The int8 row scale of a row whose largest |value| is amax.
__device__ __forceinline__ __nv_bfloat16 kv_row_int8_scale(float amax) {
  return __float2bfloat16_rn(fmaxf(__fdiv_rn(amax, 127.f), 1e-8f));
}

// A value under the row scale sf (the bf16 scale as f32).
__device__ __forceinline__ int8_t kv_row_int8(float x, float sf) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(x, sf)), -127.f), 127.f);
}

// max |src[i]| over i < n, taken by a whole block (n_warps = blockDim.x /
// 32 <= 32) through `red` in shared memory; every thread gets it. The
// maximum is exact in any order.
template <class N>
__device__ __forceinline__ float kv_row_amax(const N* __restrict__ src, int n, float* red) {
  float amax = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) amax = fmaxf(amax, fabsf(pgk_to_f32(src[i])));
  amax = pgk_warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) amax = fmaxf(amax, red[w]);
  return amax;
}

}  // namespace
