// Per-row int8 activation quantization, the prologue of the w4a8 kernels.
//
// Op for op the reference's _quantize_acts_w4a8 (pygpukit_tpu/kernels/
// gemv_quant.py): sx = max(amax / 127, 1e-12) with an IEEE f32 divide, then
// xq = clip(rint(x / sx), -127, 127). rintf rounds half to even like
// jnp.round; a multiply by 1/sx or roundf would change bits.
#pragma once

#include "common.cuh"

namespace {

template <typename T>
__global__ void pgk_act_quant_kernel(const T* __restrict__ x, int k,
                                     int8_t* __restrict__ xq,
                                     float* __restrict__ sx) {
  // a kernel launched after this one with programmatic stream serialization
  // (the w4a8 GEMV, on rows too long for its own quantization kernel) may
  // start now; its griddepcontrol.wait still waits for this grid's xq and
  // sx. Before an ordinary launch it does nothing.
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ float red[32];
  const int r = blockIdx.x;
  const T* xr = x + (size_t)r * k;
  float m = 0.f;
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    m = fmaxf(m, fabsf(pgk_to_f32(xr[i])));
  m = pgk_warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0.f;
    v = pgk_warp_max(v);
    if (threadIdx.x == 0) red[0] = v;
  }
  __syncthreads();
  const float s = fmaxf(red[0] / 127.0f, 1e-12f);
  if (threadIdx.x == 0) sx[r] = s;
  int8_t* q = xq + (size_t)r * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    float v = rintf(pgk_to_f32(xr[i]) / s);
    v = fminf(fmaxf(v, -127.f), 127.f);
    q[i] = (int8_t)v;
  }
}

// Launch the prologue for `rows` rows of x (bf16 when x_f32 == 0, else f32).
cudaError_t pgk_act_quant(const void* x, int x_f32, int rows, int k,
                          int8_t* xq, float* sx, cudaStream_t st) {
  if (x_f32)
    pgk_act_quant_kernel<float><<<rows, 256, 0, st>>>(
        static_cast<const float*>(x), k, xq, sx);
  else
    pgk_act_quant_kernel<__nv_bfloat16><<<rows, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), k, xq, sx);
  return cudaGetLastError();
}

}  // namespace
