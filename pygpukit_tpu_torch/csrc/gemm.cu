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
// bf16 design: a 128 x 128 output tile per block of 8 warps (2 x 4, each warp
// 64 x 32), K in steps of 32. A and B tiles stream into padded shared memory
// by 16-byte cp.async, double-buffered; a vector past the M, N or K edge is
// zero-filled (source size 0), so ragged edges need no padding of the
// operands beyond 16-byte rows (K % 8 == 0 and N % 8 == 0; the wrapper pads
// otherwise). A fragments come from ldmatrix, B fragments ([K, N] row-major,
// the layout of V in flash_attention.cu) from ldmatrix.trans, and the
// products run on mma.sync m16n8k16 into f32 accumulators. The epilogue
// rounds once and stores with predicates.
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
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;
constexpr int kAS = kBK + 8;      // padded shared rows: ldmatrix rows hit distinct banks
constexpr int kBS = kBN + 8;

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b, OutT* __restrict__ c,
                 int m, int n, int k, int lda, int ldb, int ldc) {
  __shared__ __align__(16) bf16 as[2][kBM * kAS];
  __shared__ __align__(16) bf16 bs[2][kBK * kBS];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;   // this warp's 64 x 32

  auto load_tile = [&](int kt, int buf) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = threadIdx.x + j * kThreads;
      {  // A: 128 rows x 4 vectors
        const int r = i >> 2, col = (i & 3) * 8;
        const bool ok = m0 + r < m && k0 + col < k;
        const bf16* src = a + (ok ? (size_t)(m0 + r) * lda + k0 + col : 0);
        cp_async16(&as[buf][r * kAS + col], src, ok);
      }
      {  // B: 32 rows x 16 vectors
        const int r = i >> 4, col = (i & 15) * 8;
        const bool ok = k0 + r < k && n0 + col < n;
        const bf16* src = b + (ok ? (size_t)(k0 + r) * ldb + n0 + col : 0);
        cp_async16(&bs[buf][r * kBS + col], src, ok);
      }
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int n_k = (k + kBK - 1) / kBK;
  load_tile(0, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {
      load_tile(kt + 1, (kt + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* at = as[kt & 1];
    const bf16* bt = bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)   // matrices: rows 0-7 / 8-15 x k lo, then x k hi
        ldmatrix_x4(af[mi], at + (wm + mi * 16 + (lane & 15)) * kAS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: k (16kk.., 16kk+8..) x n tile 2nj, then x n tile 2nj+1
        uint32_t r[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(r, bt + key * kBS + wn + nj * 16 + (lane >> 4) * 8);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    __syncthreads();                   // this buffer is refilled two tiles on
  }

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
