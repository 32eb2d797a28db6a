// w4a8 int4 GEMM for M > 8 rows (prefill): the w4a8 GEMV's math,
// y[m, n] = bf16((acc[m, n] * scale[n]) * sx[m]), acc exact in int32.
//
// Replaces pygpukit_tpu/kernels/gemv_quant.py _gemm_w4a8_pallas.
//
// Bound: operations. At prefill M (the bucket: 32 to 1024 rows) every packed
// weight byte feeds M * 2 int8 MACs, so the kernel is compute-bound well
// before M = 256. Design: a classic shared-memory tiled GEMM on __dp4a
// (4 int8 MACs per instruction): 64x64 output tiles, 256 threads with a 4x4
// int32 micro-tile each, 64 K values (32 packed bytes) staged per step. The
// weight tile is unpacked to signed int8 lanes once, on its way into shared
// memory, so the inner loop is loads and dp4a only. Tiles are stored K-major
// with 4 words of padding, so the micro-tile reads are conflict-free 16-byte
// vectors. Tensor-core int8 (mma / wgmma) is a later step; this kernel keeps
// the same exact-integer accumulation, so its output is bitwise the GEMV's
// and the reference's.
#include "act_quant.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBKW = 8;              // 32-bit words of packed K per step
constexpr int kPad = 4;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
w4a8_gemm_kernel(const uint8_t* __restrict__ w, const float* __restrict__ scale,
                 const int8_t* __restrict__ xq, const float* __restrict__ sx,
                 __nv_bfloat16* __restrict__ out, int m, int n, int k_half) {
  __shared__ __align__(16) int a_lo[kBKW][kBM + kPad];
  __shared__ __align__(16) int a_hi[kBKW][kBM + kPad];
  __shared__ __align__(16) int b_lo[kBKW][kBN + kPad];
  __shared__ __align__(16) int b_hi[kBKW][kBN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid & 15;             // 4 output columns each
  const int ty = tid >> 4;             // 4 output rows each
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int khw = k_half / 4;          // packed words per weight row
  const int* xw = reinterpret_cast<const int*>(xq);        // rows of 2*khw words
  const unsigned* ww = reinterpret_cast<const unsigned*>(w);

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int kw0 = 0; kw0 < khw; kw0 += kBKW) {
    for (int i = tid; i < kBM * kBKW; i += kThreads) {
      const int r = i / kBKW, kw = i % kBKW;
      const int gm = m0 + r, gk = kw0 + kw;
      int vlo = 0, vhi = 0;
      if (gm < m && gk < khw) {
        vlo = xw[(size_t)gm * 2 * khw + gk];
        vhi = xw[(size_t)gm * 2 * khw + khw + gk];
      }
      a_lo[kw][r] = vlo;
      a_hi[kw][r] = vhi;
    }
    for (int i = tid; i < kBN * kBKW; i += kThreads) {
      const int c = i / kBKW, kw = i % kBKW;
      const int gn = n0 + c, gk = kw0 + kw;
      const unsigned p = (gn < n && gk < khw) ? __ldg(ww + (size_t)gn * khw + gk) : 0u;
      b_lo[kw][c] = pgk_lo_nibbles(p);
      b_hi[kw][c] = pgk_hi_nibbles(p);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kBKW; ++kw) {
      const int4 al = *reinterpret_cast<const int4*>(&a_lo[kw][ty * 4]);
      const int4 ah = *reinterpret_cast<const int4*>(&a_hi[kw][ty * 4]);
      const int4 bl = *reinterpret_cast<const int4*>(&b_lo[kw][tx * 4]);
      const int4 bh = *reinterpret_cast<const int4*>(&b_hi[kw][tx * 4]);
      const int av_lo[4] = {al.x, al.y, al.z, al.w};
      const int av_hi[4] = {ah.x, ah.y, ah.z, ah.w};
      const int bv_lo[4] = {bl.x, bl.y, bl.z, bl.w};
      const int bv_hi[4] = {bh.x, bh.y, bh.z, bh.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = __dp4a(av_lo[i], bv_lo[j], acc[i][j]);
          acc[i][j] = __dp4a(av_hi[i], bv_hi[j], acc[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= m) continue;
    const float s_row = sx[gm];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < n)
        out[(size_t)gm * n + gn] =
            __float2bfloat16_rn(((float)acc[i][j] * scale[gn]) * s_row);
    }
  }
}

}  // namespace

// x [m, 2*k_half] bf16 (x_f32 == 0) or f32; w [n, k_half] uint8; scale [n]
// f32; xq [m, 2*k_half] int8 and sx [m] f32 are scratch; out [m, n] bf16.
// Requires k_half % 16 == 0 (whole 32-bit words in both halves).
PGK_API int pgk_w4a8_gemm(const void* x, int x_f32, const void* w,
                          const void* scale, void* xq, void* sx, void* out,
                          int m, int n, int k_half, void* stream) {
  if (m < 1 || n < 1 || k_half % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = pgk_act_quant(x, x_f32, m, 2 * k_half, static_cast<int8_t*>(xq),
                                static_cast<float*>(sx), st);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  w4a8_gemm_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<__nv_bfloat16*>(out), m, n, k_half);
  return (int)cudaGetLastError();
}
