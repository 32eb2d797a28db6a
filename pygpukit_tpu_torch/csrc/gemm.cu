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
// bf16 design: the TMA + wgmma mainloop of hopper_gemm.cuh (a producer
// warpgroup, two consumer warpgroups, a 4- or 6-stage ring), 128 x BN
// tiles in clusters that share their operand loads by TMA multicast:
// 128 x 256 tiles in pairs along M (sharing B), 128 x 128 tiles in 2 x 2
// (sharing A and B). BN is picked per launch by the fewest wasted slots
// (plan_gemm), and a persistent grid of as many clusters as fit on the card
// walks the units of tiles in raster groups of 16 row units. TMA zero-fills
// past the M, N and K edges, so ragged shapes need no padding of the
// operands beyond 16-byte rows (K % 8 == 0 and N % 8 == 0; the wrapper pads
// otherwise). The epilogue rounds once and stores 16-byte words with
// predicates.
//
// f32 design: no TF32 (the reference asks for HIGHEST precision): a 128 x 128
// tile per block of 256 threads, each thread an 8 x 8 register tile of FFMA
// sums over K in steps of 8, A staged transposed in shared memory so both
// operands read as float4. Loads are scalar and predicated, so any shape
// runs unpadded.
//
// Every output element is one thread's sum in ascending K order (bf16: per
// 16-wide wgmma step): a replay gives the same bits.
#include "hopper_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: tensor cores (the mainloop of hopper_gemm.cuh)
// ---------------------------------------------------------------------------

// The cluster of a tile width: CM row tiles x CN column tiles (HgCluster).
// A 128 x 128 tile moves twice the bytes a flop of a 128 x 256 one, and a
// card full of them waits on L2, so they share A and B in clusters of 2 x 2;
// the 128 x 256 tile is bound by the tensor cores and shares B in pairs.
template <int BN>
struct GemmCl;
template <>
struct GemmCl<256> {
  static constexpr int kCM = 2, kCN = 1;
};
template <>
struct GemmCl<128> {
  static constexpr int kCM = 2, kCN = 2;
};

template <int BN, typename OutT>
__global__ void __launch_bounds__(kHgThreads, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 OutT* __restrict__ c, int m, int n, int k, int ldc) {
  constexpr int kCM = GemmCl<BN>::kCM, kCN = GemmCl<BN>::kCN;
  extern __shared__ __align__(1024) unsigned char gemm_raw[];
  const HgRing ring = hg_ring<BN>(gemm_raw);
  if (threadIdx.x == 0) hg_init<BN, kCM, kCN>(ring);
  cluster_sync();
  // the cluster walks units of kCM x kCN tiles; this CTA computes tile
  // (kCM um + rm, kCN un + rn) of unit (um, un)
  const uint32_t rank = cluster_ctarank();
  const int rm = rank % kCM, rn = rank / kCM;
  const int units_m = hg_cdiv(hg_cdiv(m, kHgBM), kCM);
  const int units_n = hg_cdiv(hg_cdiv(n, BN), kCN);
  const int n_units = units_m * units_n, n_k = hg_cdiv(k, kHgBK);
  const int first = cluster_id_x(), step = cluster_count_x();
  uint32_t it = 0;
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kHgProducerRegs>();
    if (threadIdx.x == 0) {
      for (int u = first; u < n_units; u += step) {
        int um, un;
        hg_raster(u, units_m, units_n, um, un);
        hg_produce<BN, kCM, kCN>(&ta, &tb, ring, (um * kCM + rm) * kHgBM,
                                 (un * kCN + rn) * BN, 0, n_k, rank, it);
      }
      hg_produce_tail<BN>(ring, it);
    }
  } else {
    setmaxnreg_inc<kHgConsumerRegs>();
    const int cwg = (threadIdx.x - 128) >> 7;
    float acc[BN / 2];
    for (int u = first; u < n_units; u += step) {
      int um, un;
      hg_raster(u, units_m, units_n, um, un);
      hg_consume<BN, kCM, kCN>(acc, ring, cwg, n_k, rank, it);
      hg_store<BN, OutT>(acc, c, ldc, (um * kCM + rm) * kHgBM + cwg * 64, (un * kCN + rn) * BN,
                         0, m, n);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128;
constexpr int kThreads = 256;
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
      if (col < n) c[(size_t)row * ldc + col] = hg_cast<OutT>(acc[i][j]);
    }
  }
}

template <typename OutT>
cudaError_t launch_gemm_f32(const void* a, const void* b, void* c, int m, int n, int k, int lda,
                            int ldb, int ldc, cudaStream_t st) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_f32_kernel<OutT><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<OutT*>(c), m, n, k,
      lda, ldb, ldc);
  return cudaGetLastError();
}

// The CTAs of a cluster of tile width BN, and its units (CM x CN tiles) for
// an [m, n] output.
template <int BN>
constexpr int cluster_size() {
  return GemmCl<BN>::kCM * GemmCl<BN>::kCN;
}
template <int BN>
int gemm_units(int m, int n) {
  return hg_cdiv(hg_cdiv(m, kHgBM), GemmCl<BN>::kCM) * hg_cdiv(hg_cdiv(n, BN), GemmCl<BN>::kCN);
}

template <int BN>
cudaLaunchAttribute cluster_attr() {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster_size<BN>();
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// Clusters of this kernel that fit on the card at once: the persistent
// grid's size (queried once; it depends on the card and the kernel alone).
template <int BN>
cudaError_t max_clusters(int* clusters) {
  static int cached = 0;
  if (cached == 0) {
    constexpr int smem = HgLayout<BN>::kBytes;
    cudaError_t e = cudaFuncSetAttribute(gemm_bf16_kernel<BN, bf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr = cluster_attr<BN>();
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster_size<BN>() * 128);
    cfg.blockDim = dim3(kHgThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&cached, gemm_bf16_kernel<BN, bf16>, &cfg);
    if (e != cudaSuccess) return e;
    if (cached < 1) return cudaErrorInvalidConfiguration;
  }
  *clusters = cached;
  return cudaSuccess;
}

template <int BN, typename OutT>
cudaError_t launch_gemm_bf16(const void* a, const void* b, void* c, int m, int n, int k, int lda,
                             int ldb, int ldc, int clusters, cudaStream_t st) {
  CUtensorMap ta, tb;
  cudaError_t e = pgk_tensor_map_bf16(&ta, a, k, m, (uint64_t)lda * 2, kHgBK,
                                      kHgBM / GemmCl<BN>::kCN);
  if (e == cudaSuccess)
    e = pgk_tensor_map_bf16_3d(&tb, b, n, k, 1, (uint64_t)ldb * 2, (uint64_t)ldb * 2 * k, 64,
                               kHgBK);
  if (e != cudaSuccess) return e;
  constexpr int smem = HgLayout<BN>::kBytes;
  e = cudaFuncSetAttribute(gemm_bf16_kernel<BN, OutT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr = cluster_attr<BN>();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster_size<BN>() * min(gemm_units<BN>(m, n), clusters));
  cfg.blockDim = dim3(kHgThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gemm_bf16_kernel<BN, OutT>, ta, tb, static_cast<OutT*>(c), m, n,
                         k, ldc);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The launch plan of an [m, k] x [k, n] product (kernels/gemm.py gemm_plan
// is the same rule): the tile width whose waves of units cost least (waves
// x BN, 256 on a tie), and the clusters of its persistent grid.
cudaError_t plan_gemm(int m, int n, int* bn, int* clusters) {
  int c256 = 0, c128 = 0;
  cudaError_t e = max_clusters<256>(&c256);
  if (e == cudaSuccess) e = max_clusters<128>(&c128);
  if (e != cudaSuccess) return e;
  const int cost256 = hg_cdiv(gemm_units<256>(m, n), c256) * 256;
  const int cost128 = hg_cdiv(gemm_units<128>(m, n), c128) * 128;
  *bn = cost128 < cost256 ? 128 : 256;
  *clusters = *bn == 256 ? c256 : c128;
  return cudaSuccess;
}

template <typename OutT>
cudaError_t launch_gemm_bf16(const void* a, const void* b, void* c, int m, int n, int k, int lda,
                             int ldb, int ldc, cudaStream_t st) {
  int bn = 0, clusters = 0;
  cudaError_t e = plan_gemm(m, n, &bn, &clusters);
  if (e != cudaSuccess) return e;
  if (bn == 256)
    return launch_gemm_bf16<256, OutT>(a, b, c, m, n, k, lda, ldb, ldc, clusters, st);
  return launch_gemm_bf16<128, OutT>(a, b, c, m, n, k, lda, ldb, ldc, clusters, st);
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
    return out_f32 ? (int)launch_gemm_f32<float>(a, b, c, m, n, k, lda, ldb, ldc, st)
                   : (int)launch_gemm_f32<bf16>(a, b, c, m, n, k, lda, ldb, ldc, st);
  return out_f32 ? (int)launch_gemm_bf16<float>(a, b, c, m, n, k, lda, ldb, ldc, st)
                 : (int)launch_gemm_bf16<bf16>(a, b, c, m, n, k, lda, ldb, ldc, st);
}

// The bf16 launch plan on this card, for the tests that hold its Python
// mirror (kernels/gemm.py gemm_plan): plan[0] the tile width BN, plan[1] the
// CTAs of the persistent grid, plan[2] and plan[3] the clusters of the
// 256- and 128-wide tiles that fit at once.
PGK_API int pgk_gemm_plan(int m, int n, int* plan) {
  int bn = 0, clusters = 0;
  cudaError_t e = plan_gemm(m, n, &bn, &clusters);
  if (e == cudaSuccess) e = max_clusters<256>(&plan[2]);
  if (e == cudaSuccess) e = max_clusters<128>(&plan[3]);
  if (e != cudaSuccess) return (int)e;
  plan[0] = bn;
  plan[1] = bn == 256 ? cluster_size<256>() * min(gemm_units<256>(m, n), clusters)
                      : cluster_size<128>() * min(gemm_units<128>(m, n), clusters);
  return 0;
}
