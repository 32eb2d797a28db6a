// w4a8 int4 GEMV for rows <= 8: y[r, n] = bf16((acc[r, n] * scale[n]) * sx[r])
// with acc[r, n] = sum_k xq[r, k] * w[n, k] in exact int32.
//
// Replaces pygpukit_tpu/kernels/gemv_quant.py
//   _gemv_w4a8_stacked_fusedq_pallas (and _gemv_w4a8_stacked_pallas,
//   _gemv_w4a8_pallas: the same math with the quant outside the kernel or on
//   a 2-D weight; here a layer of a stacked [L, N, K/2] weight is a free view).
//
// Bound: bytes. Decode streams every packed weight byte once per step
// (K/2 bytes per output column) for at most 8 activation rows, so the
// arithmetic per byte is ~16 int8 MACs, far below the card's ridge point.
// Design: one warp per output column; each lane streams 16-byte chunks of
// the column's contiguous K/2 bytes (K/2 = 1024 or 2816 on the 1.1B shape:
// 2 or 5.5 chunks a lane, the ragged last round masked by the loop bound),
// so a warp issues 512 contiguous bytes per round. The quantized
// activations (rows * K bytes, <= 45 KB) sit in shared memory for the
// block's 8 warps. Nibbles unpack to signed int8 lanes in registers and go
// through __dp4a; the int32 warp reduction is exact, so the f32 epilogue sees
// the same integer the reference's f32 tile sums hold (|acc| <= 127*8*K < 2^24)
// and the bf16 output is bitwise the reference's.
#include "act_quant.cuh"

namespace {

constexpr int kWarps = 8;       // output columns per block
constexpr int kMaxRows = 8;

__global__ void __launch_bounds__(kWarps * 32)
w4a8_gemv_kernel(const uint8_t* __restrict__ w, const float* __restrict__ scale,
                 const int8_t* __restrict__ xq, const float* __restrict__ sx,
                 __nv_bfloat16* __restrict__ out, int rows, int n, int k_half) {
  extern __shared__ int4 pgk_xq_smem[];
  const int k = 2 * k_half;
  const int nvec = rows * k / 16;
  const int4* src = reinterpret_cast<const int4*>(xq);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) pgk_xq_smem[i] = src[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kWarps + warp;
  if (col >= n) return;
  const int8_t* xs = reinterpret_cast<const int8_t*>(pgk_xq_smem);
  const uint4* wc = reinterpret_cast<const uint4*>(w + (size_t)col * k_half);
  const int nchunks = k_half / 16;

  int acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0;

  for (int c = lane; c < nchunks; c += 32) {
    const uint4 wv = __ldg(wc + c);
    const unsigned ww[4] = {wv.x, wv.y, wv.z, wv.w};
    int lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[j] = pgk_lo_nibbles(ww[j]);
      hi[j] = pgk_hi_nibbles(ww[j]);
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < rows) {
        const int4 xl = *reinterpret_cast<const int4*>(xs + (size_t)r * k + c * 16);
        const int4 xh = *reinterpret_cast<const int4*>(xs + (size_t)r * k + k_half + c * 16);
        int a = acc[r];
        a = __dp4a(lo[0], xl.x, a);
        a = __dp4a(lo[1], xl.y, a);
        a = __dp4a(lo[2], xl.z, a);
        a = __dp4a(lo[3], xl.w, a);
        a = __dp4a(hi[0], xh.x, a);
        a = __dp4a(hi[1], xh.y, a);
        a = __dp4a(hi[2], xh.z, a);
        a = __dp4a(hi[3], xh.w, a);
        acc[r] = a;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = pgk_warp_sum_i(acc[r]);
  if (lane == 0) {
    const float sc = scale[col];
    for (int r = 0; r < rows; ++r)
      out[(size_t)r * n + col] = __float2bfloat16_rn(((float)acc[r] * sc) * sx[r]);
  }
}

}  // namespace

// x [rows, 2*k_half] bf16 (x_f32 == 0) or f32, row-major; w [n, k_half] uint8;
// scale [n] f32; xq [rows, 2*k_half] int8 and sx [rows] f32 are scratch;
// out [rows, n] bf16. Requires rows <= 8 and k_half % 16 == 0.
PGK_API int pgk_w4a8_gemv(const void* x, int x_f32, const void* w,
                          const void* scale, void* xq, void* sx, void* out,
                          int rows, int n, int k_half, void* stream) {
  if (rows < 1 || rows > kMaxRows || k_half % 16 != 0 || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k = 2 * k_half;
  cudaError_t e = pgk_act_quant(x, x_f32, rows, k, static_cast<int8_t*>(xq),
                                static_cast<float*>(sx), st);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)rows * k;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(w4a8_gemv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (n + kWarps - 1) / kWarps;
  w4a8_gemv_kernel<<<grid, kWarps * 32, smem, st>>>(
      static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<__nv_bfloat16*>(out), rows, n, k_half);
  return (int)cudaGetLastError();
}
