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
// Design: the 128 x 128 tensor-core block tile of gemm.cu (mma.cuh
// mma_tile_bf16), one tile of one group per block. Nothing is read on the
// host: the grid is the upper bound of (group, row tile) pairs,
// ceil(M/128) + G (G - 1 for the boundaries between groups, one more for
// the rows past the sum), on x, times the column tiles on y. Warp 0 of
// every block scans group_sizes from device memory, 32 groups a step, into
// row and tile offsets and picks the block's (group, row tile); a block
// past the count returns. Row tiles are aligned to multiples of 128 rows as
// in megablox's make_group_metadata, so a tile that straddles two groups is
// computed once for each, and each computation zero-fills the other
// group's rows on load and stores only its own. A group with no rows has no
// tile and reads no weights. Row tiles vary fastest, so the blocks that
// share one column tile of an expert's weights run together and read it
// from L2 rather than from device memory.
//
// Deterministic: exactly one block owns each output element, K is walked in
// ascending 16-wide mma steps into one f32 accumulator, no split-K, no
// atomics. Needs no host sync, so it captures into a CUDA graph.
#include "mma.cuh"

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

// Row tiles [lo/128, ceil(hi/128)) of the rows [lo, hi); none when empty.
__device__ __forceinline__ int tiles_of(int lo, int hi) {
  return hi > lo ? (hi + kTileM - 1) / kTileM - lo / kTileM : 0;
}

__global__ void __launch_bounds__(kTileThreads)
gmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
           const int* __restrict__ group_sizes, float* __restrict__ out, int m, int n, int k,
           int n_groups, int lda) {
  __shared__ __align__(16) TileSmem sm;
  __shared__ int s_group, s_lo, s_hi, s_tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int want = blockIdx.x;
  if (threadIdx.x == 0) s_group = -1;
  __syncthreads();
  if (warp == 0) {
    int rows_before = 0, tiles_before = 0;
    for (int base = 0; base < n_groups; base += 32) {
      const int g = base + lane;
      const int size = g < n_groups ? max(group_sizes[g], 0) : 0;
      const int end = rows_before + warp_inclusive_sum(size, lane);
      const int lo = min(end - size, m), hi = min(end, m);
      const int nt = tiles_of(lo, hi);
      const int t_end = tiles_before + warp_inclusive_sum(nt, lane);
      if (want >= t_end - nt && want < t_end) {
        s_group = g;
        s_lo = lo;
        s_hi = hi;
        s_tile = lo / kTileM + want - (t_end - nt);
      }
      rows_before = __shfl_sync(0xffffffffu, end, 31);
      tiles_before = __shfl_sync(0xffffffffu, t_end, 31);
    }
    // the rows past the sum of the sizes: group n_groups, written as zeros
    const int lo = min(rows_before, m);
    if (lane == 0 && want >= tiles_before && want < tiles_before + tiles_of(lo, m)) {
      s_group = n_groups;
      s_lo = lo;
      s_hi = m;
      s_tile = lo / kTileM + want - tiles_before;
    }
  }
  __syncthreads();
  const int grp = s_group;
  if (grp < 0) return;
  const int m0 = s_tile * kTileM, lo = s_lo, hi = s_hi;
  const int n0 = blockIdx.y * kTileN;

  float acc[4][4][4];
  if (grp < n_groups) {
    mma_tile_bf16(lhs, lda, m0, lo, hi, rhs + (size_t)grp * k * n, n, n0, n, k, sm, acc);
  } else {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  }

  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + g + half * 8;
      if (row < lo || row >= hi) continue;      // another group's row, or past M
      float* orow = out + (size_t)row * n;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * t;  // even, and n % 8 == 0
        if (col < n)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
  }
}

}  // namespace

// lhs [m, k] bf16 (row stride lda), rhs [n_groups, k, n] bf16 contiguous,
// group_sizes [n_groups] int32 in device memory, out [m, n] f32 contiguous.
// Needs k, n and lda multiples of 8 (16-byte rows) and 16-byte aligned
// pointers; m, n, k, n_groups >= 1.
PGK_API int pgk_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                    int m, int n, int k, int n_groups, int lda, void* stream) {
  if (m < 1 || n < 1 || k < 1 || n_groups < 1 || lda < k || k % 8 || n % 8 || lda % 8 ||
      (n + kTileN - 1) / kTileN > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kTileM - 1) / kTileM + n_groups, (n + kTileN - 1) / kTileN);
  gmm_kernel<<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs),
      static_cast<const int*>(group_sizes), static_cast<float*>(out), m, n, k, n_groups, lda);
  return (int)cudaGetLastError();
}
