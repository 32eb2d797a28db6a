// Dense GEMM: C[M, N] = A[M, K] . B[K, N], f32 sums, one rounding to C's type.
//
// Replaces pygpukit_tpu/kernels/gemm.py _gemm_pallas (the PYGPUKIT_GEMM=pallas
// route of ops.matmul for 2-D operands).
//
// Bound: operations at the sizes the route takes (M >= 64, N, K >= 128 and
// up): 2 M N K flops over (M K + K N) input and M N output elements. The
// forward's projections at M 2048 have 60 to 256 flops per byte, the bench
// cell's 8192^3 about 2700, so the tensor cores (989 TFLOP/s bf16) bound
// both, and the f32 route the CUDA cores (67 TFLOP/s FFMA).
//
// bf16 design: the 128 x 128 block tile of mma.cuh (8 warps, K in steps of
// 32, double-buffered 16-byte cp.async, mma.sync m16n8k16 into f32); a
// vector past the M, N or K edge is zero-filled, so ragged edges need no
// padding of the operands beyond 16-byte rows (K % 8 == 0 and N % 8 == 0;
// the wrapper pads otherwise). The epilogue rounds once and stores with
// predicates.
//
// f32 design: no TF32 (the reference asks for HIGHEST precision): a 128 x 128
// tile per block of 256 threads, each thread an 8 x 8 register tile of FFMA
// sums over K in steps of 8, A staged transposed in shared memory so both
// operands read as float4. Loads are scalar and predicated, so any shape
// runs unpadded.
//
// Every output element is one thread's sum in ascending K order (bf16: per
// 16-wide mma step): a replay gives the same bits.
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T store_cast(float x);
template <>
__device__ __forceinline__ float store_cast<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 store_cast<bf16>(float x) { return __float2bfloat16_rn(x); }

// ---------------------------------------------------------------------------
// bf16: tensor cores (the block tile of mma.cuh)
// ---------------------------------------------------------------------------

constexpr int kBM = kTileM, kBN = kTileN;
constexpr int kThreads = kTileThreads;

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b, OutT* __restrict__ c,
                 int m, int n, int k, int lda, int ldb, int ldc) {
  __shared__ __align__(16) TileSmem sm;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4][4];
  mma_tile_bf16(a, lda, m0, 0, m, b, ldb, n0, n, k, sm, acc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + g + half * 8;
      if (row >= m) continue;
      OutT* crow = c + (size_t)row * ldc;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * t;
        if (col < n) crow[col] = store_cast<OutT>(acc[mi][ni][2 * half]);
        if (col + 1 < n) crow[col + 1] = store_cast<OutT>(acc[mi][ni][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFK = 8;
constexpr int kFPad = kBM + 4;    // float4-aligned rows

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b, OutT* __restrict__ c,
                int m, int n, int k, int lda, int ldb, int ldc) {
  __shared__ __align__(16) float as[kFK][kFPad];   // A transposed: [k][m]
  __shared__ __align__(16) float bs[kFK][kFPad];   // [k][n]
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise with tx
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kFK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = threadIdx.x + j * kThreads;
      {  // A: 128 rows x 8 k
        const int r = i >> 3, kc = i & 7;
        const bool ok = m0 + r < m && k0 + kc < k;
        as[kc][r] = ok ? a[(size_t)(m0 + r) * lda + k0 + kc] : 0.f;
      }
      {  // B: 8 k x 128 columns
        const int r = i >> 7, col = i & 127;
        const bool ok = k0 + r < k && n0 + col < n;
        bs[r][col] = ok ? b[(size_t)(k0 + r) * ldb + n0 + col] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float av[8], bv[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < n) c[(size_t)row * ldc + col] = store_cast<OutT>(acc[i][j]);
    }
  }
}

template <typename InT, typename OutT>
cudaError_t launch_gemm(const void* a, const void* b, void* c, int m, int n, int k, int lda,
                        int ldb, int ldc, cudaStream_t st) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if constexpr (sizeof(InT) == 2) {
    gemm_bf16_kernel<OutT><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<OutT*>(c), m, n,
        k, lda, ldb, ldc);
  } else {
    gemm_f32_kernel<OutT><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<OutT*>(c), m,
        n, k, lda, ldb, ldc);
  }
  return cudaGetLastError();
}

}  // namespace

// a [m, k] (row stride lda), b [k, n] (row stride ldb), c [m, n] (row stride
// ldc); in_f32 picks f32 operands (else bf16), out_f32 an f32 C (else bf16).
// bf16 operands need 16-byte rows and pointers: lda, ldb and k multiples of
// 8, and B's rows readable up to n rounded up to 8 (ldb >= that). Requires
// m, n, k >= 1 and m / 128 < 65536.
PGK_API int pgk_gemm(const void* a, const void* b, void* c, int m, int n, int k, int lda,
                     int ldb, int ldc, int in_f32, int out_f32, void* stream) {
  if (m < 1 || n < 1 || k < 1 || (m + kBM - 1) / kBM > 65535 || lda < k || ldb < n || ldc < n)
    return (int)cudaErrorInvalidValue;
  if (!in_f32 && (lda % 8 || ldb % 8 || k % 8 || ldb < (n + 7) / 8 * 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_f32)
    return out_f32 ? (int)launch_gemm<float, float>(a, b, c, m, n, k, lda, ldb, ldc, st)
                   : (int)launch_gemm<float, bf16>(a, b, c, m, n, k, lda, ldb, ldc, st);
  return out_f32 ? (int)launch_gemm<bf16, float>(a, b, c, m, n, k, lda, ldb, ldc, st)
                 : (int)launch_gemm<bf16, bf16>(a, b, c, m, n, k, lda, ldb, ldc, st);
}
