// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel here is exported through a plain C entry point (no PyTorch
// headers) and loaded with ctypes from pygpukit_tpu_torch/kernels/_build.py.
// An entry point launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() as an int; the Python wrapper raises on non-zero.
//
// Determinism: every reduction runs in a fixed order and no sum is taken by
// atomics (flash_decode's atomic ticket only elects the block that folds),
// so a replay of the same inputs gives the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PGK_API extern "C" __attribute__((visibility("default")))

static __device__ __forceinline__ float pgk_to_f32(float v) { return v; }
static __device__ __forceinline__ float pgk_to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

static __device__ __forceinline__ float pgk_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static __device__ __forceinline__ float pgk_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static __device__ __forceinline__ int pgk_warp_sum_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Split-half packed int4: each byte holds two signed nibbles. These turn the
// four low (or high) nibbles of a 32-bit word into four signed int8 lanes for
// __dp4a: (nibble ^ 8) is the offset-binary value u in [0, 15], and a
// per-byte u - 8 (no borrow across bytes) is the two's-complement int8.
static __device__ __forceinline__ int pgk_lo_nibbles(unsigned w) {
  return (int)__vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
static __device__ __forceinline__ int pgk_hi_nibbles(unsigned w) {
  return (int)__vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
