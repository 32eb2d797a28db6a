// Grouped matmul: out[M, N] f32 where rows offs[g]..offs[g+1] of out equal
// lhs[those rows] . rhs[g], with offs the exclusive prefix sum of
// group_sizes. Rows past the sum of the sizes (up to M) are written as zeros.
//
// Replaces megablox gmm (jax.experimental.pallas.ops.tpu.megablox, shipped
// with jax and called from pygpukit_tpu/ops/moe.py:60 in moe_gmm_fn): the
// MoE prefill's gate, up and down products over expert-sorted token rows,
// bf16 operands, preferred_element_type f32.
//
// Bound: Mixtral's gate/up at M 4096 (a 2048-token forward at top-2) does
// 481 GFLOP over 1.21 GB (operations, 0.49 ms at 989 TFLOP/s); at M 1024 (a
// 512-token prefill) 120 GFLOP over 1.01 GB, most of it the eight experts'
// weights (bytes, 0.30 ms at 3.35 TB/s).
//
// Design: the TMA + wgmma mainloop of hopper_gemm.cuh (gemm.cu's), rhs
// through a 3-D tensor map (N, K, group), so a K tile past K reads zeros
// and never the next group's rows. Row tiles start at each group's first
// row (lo + j * 128): TMA starts a box at any row, so no tile straddles two
// groups and none is computed twice (megablox aligns tiles to 128 rows). A
// tile may read the next group's lhs rows, or rows past M (zeros): each
// output row depends only on its own lhs row, so those rows are computed
// and not stored. The rows past the sum form one more segment, stored as
// zeros without a product. Nothing is read on the host: the grid is
// persistent, min(upper bound of tiles, SMs) blocks, the upper bound
// (ceil(M/128) + G row tiles) x column tiles depending on shapes alone;
// every warp that needs a tile's (group, rows) scans group_sizes from
// device memory, 32 groups a step (gmm_locate), and the blocks walk the
// actual tiles in hg_raster's order (row tiles fastest within groups of
// 16), so the blocks that share one column tile of an expert's weights run
// together and read it from L2. A group with no rows has no tile and reads
// no weights.
//
// Deterministic: exactly one block owns each output element, K is walked in
// ascending 16-wide wgmma steps into one f32 accumulator, no split-K, no
// atomics. Needs no host sync, so it captures into a CUDA graph. The tile
// enumeration is mirrored in Python by kernels/gmm.py (gmm_row_tiles),
// which the CPU tests hold.
//
// The other operands (f32, as an f32 model passes them, or bf16 with K or N
// off a multiple of 8, or a row stride off 8) take gmm_simt_kernel: the
// same row tiles, one 128 x 128 output tile a block on the CUDA cores (f32
// FMAs, no TF32: the reference's f32 product), operands converted to f32
// as they are staged in shared memory 8 K rows at a time, every load
// predicated, so any K, N and stride. The grid is the tiles' upper bound
// (ceil(M/128) + G row tiles x column tiles); a block past the actual
// tiles exits after its scan.
#include "hopper_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// One row tile: segment g (a group, or n_groups for the rows past the sum),
// whose rows [lo, hi) it stores; its first row m0 = lo + 128 j.
struct GmmTile {
  int g, lo, hi, m0;
};

// Row tile r of the segments in order (every lane of the warp gets it;
// g = -1 past the last), and the count of row tiles in `total`. Segment g
// holds rows [min(offs[g], m), min(offs[g + 1], m)), ceil(rows / 128) tiles.
__device__ __forceinline__ GmmTile gmm_locate(const int* __restrict__ group_sizes,
                                              int n_groups, int m, int r, int lane,
                                              int& total) {
  GmmTile tile{-1, 0, 0, 0};
  int rows_before = 0, tiles_before = 0;
  for (int base = 0; base < n_groups; base += 32) {
    const int g = base + lane;
    const int size = g < n_groups ? max(group_sizes[g], 0) : 0;
    const int end = rows_before + warp_inclusive_sum(size, lane);
    const int lo = min(end - size, m), hi = min(end, m);
    const int nt = hg_cdiv(hi - lo, kHgBM);
    const int t_end = tiles_before + warp_inclusive_sum(nt, lane);
    const unsigned mine = __ballot_sync(0xffffffffu, r >= t_end - nt && r < t_end);
    if (mine) {
      const int src = __ffs(mine) - 1;
      tile.g = __shfl_sync(0xffffffffu, g, src);
      tile.lo = __shfl_sync(0xffffffffu, lo, src);
      tile.hi = __shfl_sync(0xffffffffu, hi, src);
      tile.m0 = tile.lo + (r - __shfl_sync(0xffffffffu, t_end - nt, src)) * kHgBM;
    }
    rows_before = __shfl_sync(0xffffffffu, end, 31);
    tiles_before = __shfl_sync(0xffffffffu, t_end, 31);
  }
  // the rows past the sum of the sizes: segment n_groups, written as zeros
  const int lo = min(rows_before, m);
  const int nt = hg_cdiv(m - lo, kHgBM);
  if (r >= tiles_before && r < tiles_before + nt)
    tile = GmmTile{n_groups, lo, m, lo + (r - tiles_before) * kHgBM};
  total = tiles_before + nt;
  return tile;
}

template <int BN>
__global__ void __launch_bounds__(kHgThreads, 1)
gmm_kernel(const __grid_constant__ CUtensorMap tl, const __grid_constant__ CUtensorMap tr,
           const int* __restrict__ group_sizes, float* __restrict__ out, int m, int n, int k,
           int n_groups) {
  extern __shared__ __align__(1024) unsigned char gmm_raw[];
  const HgRing ring = hg_ring<BN>(gmm_raw);
  if (threadIdx.x == 0) hg_init<BN, 1, 1>(ring);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int tiles_n = hg_cdiv(n, BN), n_k = hg_cdiv(k, kHgBK);
  uint32_t it = 0;
  int rows;
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kHgProducerRegs>();
    if (threadIdx.x < 32) {            // warp 0 scans, its lane 0 issues the loads
      gmm_locate(group_sizes, n_groups, m, -1, lane, rows);
      for (int t = blockIdx.x; t < rows * tiles_n; t += gridDim.x) {
        int tm, tn;
        hg_raster(t, rows, tiles_n, tm, tn);
        const GmmTile tile = gmm_locate(group_sizes, n_groups, m, tm, lane, rows);
        if (lane == 0 && tile.g < n_groups)
          hg_produce<BN, 1, 1>(&tl, &tr, ring, tile.m0, tn * BN, tile.g, n_k, 0, it);
        __syncwarp();
      }
    }
  } else {
    setmaxnreg_inc<kHgConsumerRegs>();
    const int cwg = (threadIdx.x - 128) >> 7;
    float acc[BN / 2];
    gmm_locate(group_sizes, n_groups, m, -1, lane, rows);
    for (int t = blockIdx.x; t < rows * tiles_n; t += gridDim.x) {
      int tm, tn;
      hg_raster(t, rows, tiles_n, tm, tn);
      const GmmTile tile = gmm_locate(group_sizes, n_groups, m, tm, lane, rows);
      const bool zeros = tile.g == n_groups;          // the rows past the sum
      if (!zeros) hg_consume<BN, 1, 1>(acc, ring, cwg, n_k, 0, it);
      hg_store<BN, float>(acc, out, n, tile.m0 + cwg * 64, tn * BN, tile.lo, tile.hi, n, zeros);
    }
  }
}

__device__ __forceinline__ float gmm_f32(float x) { return x; }
__device__ __forceinline__ float gmm_f32(bf16 x) { return __bfloat162float(x); }

constexpr int kSimtBM = 128, kSimtBN = 128, kSimtK = 8, kSimtThreads = 256;
constexpr int kSimtPad = kSimtBM + 4;    // float4-aligned rows
static_assert(kSimtBM == kHgBM, "the simt route walks gmm_locate's row tiles");

// One 128 x 128 tile of out: row tile blockIdx.y of gmm_locate, column tile
// blockIdx.x. Thread (ty, tx) owns rows ty*4 + {0..3}, 64 + ty*4 + {0..3}
// and the same columns with tx; K in ascending order, one FMA chain each.
template <typename T>
__global__ void __launch_bounds__(kSimtThreads)
gmm_simt_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                const int* __restrict__ group_sizes, float* __restrict__ out, int m, int n,
                int k, int n_groups, int lda) {
  __shared__ __align__(16) float as[kSimtK][kSimtPad];   // lhs transposed: [k][row]
  __shared__ __align__(16) float bs[kSimtK][kSimtPad];   // [k][column]
  __shared__ GmmTile shared_tile;
  if (threadIdx.x < 32) {
    int total;
    const GmmTile t = gmm_locate(group_sizes, n_groups, m, blockIdx.y, threadIdx.x, total);
    if (threadIdx.x == 0) shared_tile = t;
  }
  __syncthreads();
  const GmmTile tile = shared_tile;
  if (tile.g < 0) return;                      // past the actual row tiles
  const int n0 = blockIdx.x * kSimtBN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (tile.g < n_groups) {                     // else the rows past the sum: zeros
    const T* b = rhs + (size_t)tile.g * k * n;
    for (int k0 = 0; k0 < k; k0 += kSimtK) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = threadIdx.x + j * kSimtThreads;
        {  // lhs: 128 rows x 8 k, rows of this tile's segment only
          const int r = i >> 3, kc = i & 7;
          const bool ok = tile.m0 + r < tile.hi && k0 + kc < k;
          as[kc][r] = ok ? gmm_f32(lhs[(size_t)(tile.m0 + r) * lda + k0 + kc]) : 0.f;
        }
        {  // rhs[g]: 8 k x 128 columns
          const int r = i >> 7, col = i & 127;
          const bool ok = k0 + r < k && n0 + col < n;
          bs[r][col] = ok ? gmm_f32(b[(size_t)(k0 + r) * n + n0 + col]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSimtK; ++kk) {
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
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = tile.m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row < tile.lo || row >= tile.hi) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < n) out[(size_t)row * n + col] = acc[i][j];
    }
  }
}

template <typename T>
cudaError_t launch_gmm_simt(const void* lhs, const void* rhs, const void* group_sizes,
                            void* out, int m, int n, int k, int n_groups, int lda,
                            cudaStream_t st) {
  const dim3 grid(hg_cdiv(n, kSimtBN), hg_cdiv(m, kSimtBM) + n_groups);
  gmm_simt_kernel<T><<<grid, kSimtThreads, 0, st>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs),
      static_cast<const int*>(group_sizes), static_cast<float*>(out), m, n, k, n_groups, lda);
  return cudaGetLastError();
}

// The tile width for row_tiles 128-row tiles over n columns on sms SMs: the
// width whose waves cost least (waves x BN), 256 on a tie (kernels/gemm.py
// pick_bn is the same rule).
int pick_bn(int row_tiles, int n, int sms) {
  const int w256 = hg_cdiv(row_tiles * hg_cdiv(n, 256), sms);
  const int w128 = hg_cdiv(row_tiles * hg_cdiv(n, 128), sms);
  return w128 * 128 < w256 * 256 ? 128 : 256;
}

template <int BN>
cudaError_t launch_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                       int m, int n, int k, int n_groups, int lda, int sms, cudaStream_t st) {
  CUtensorMap tl, tr;
  cudaError_t e = pgk_tensor_map_bf16(&tl, lhs, k, m, (uint64_t)lda * 2, kHgBK, kHgBM);
  if (e == cudaSuccess)
    e = pgk_tensor_map_bf16_3d(&tr, rhs, n, k, n_groups, (uint64_t)n * 2, (uint64_t)n * 2 * k,
                               64, kHgBK);
  if (e != cudaSuccess) return e;
  constexpr int smem = HgLayout<BN>::kBytes;
  e = cudaFuncSetAttribute(gmm_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)(hg_cdiv(m, kHgBM) + n_groups) * hg_cdiv(n, BN);
  gmm_kernel<BN><<<tiles < sms ? (int)tiles : sms, kHgThreads, smem, st>>>(
      tl, tr, static_cast<const int*>(group_sizes), static_cast<float*>(out), m, n, k,
      n_groups);
  return cudaGetLastError();
}

}  // namespace

// lhs [m, k] bf16 (row stride lda), rhs [n_groups, k, n] bf16 contiguous,
// group_sizes [n_groups] int32 in device memory, out [m, n] f32 contiguous.
// Needs k, n and lda multiples of 8 (16-byte rows) and 16-byte aligned
// pointers; m, n, k, n_groups >= 1.
PGK_API int pgk_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                    int m, int n, int k, int n_groups, int lda, void* stream) {
  if (m < 1 || n < 1 || k < 1 || n_groups < 1 || lda < k || k % 8 || n % 8 || lda % 8)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pick_bn(hg_cdiv(m, kHgBM) + n_groups, n, sms) == 256)
    return (int)launch_gmm<256>(lhs, rhs, group_sizes, out, m, n, k, n_groups, lda, sms, st);
  return (int)launch_gmm<128>(lhs, rhs, group_sizes, out, m, n, k, n_groups, lda, sms, st);
}

// The CUDA-core route: lhs [m, k] (row stride lda) and rhs [n_groups, k, n]
// contiguous, both f32 (in_f32) or both bf16, any k, n and lda >= k;
// group_sizes [n_groups] int32 in device memory, out [m, n] f32 contiguous.
PGK_API int pgk_gmm_simt(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                         int m, int n, int k, int n_groups, int lda, int in_f32,
                         void* stream) {
  if (m < 1 || n < 1 || k < 1 || n_groups < 1 || lda < k ||
      hg_cdiv(m, kSimtBM) + n_groups > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_f32)
    return (int)launch_gmm_simt<float>(lhs, rhs, group_sizes, out, m, n, k, n_groups, lda, st);
  return (int)launch_gmm_simt<bf16>(lhs, rhs, group_sizes, out, m, n, k, n_groups, lda, st);
}
