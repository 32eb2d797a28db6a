// Converting GEMV for rows <= 8: y[r, n] = bf16(acc[r, n] * scale[n]) with
// acc[r, n] = sum_k x[r, k] * float(w[k, n]) in f32, x rounded to bf16, and w
// a K-major [K, N] weight in fp8 e4m3fn, fp8 e5m2, int8 or bf16.
//
// Replaces pygpukit_tpu/kernels/gemv_quant.py _gemv_conv_stacked_pallas
// (:714, pallas_call :720; the stacked [L, K, N] form, here a layer is a free
// view). Every storage type converts exactly to f32 (fp8 has 2-3 mantissa
// bits and a range inside f32's, int8 needs 8 bits), and a bf16 x times it
// is exact in f32, so only the order of the f32 sums differs from the plain
// version; that order is fixed, so two launches and a graph replay give
// the same bits.
//
// Bound: bytes. Decode streams each weight byte once per step for at most 8
// rows: the four 1.1B projections are 44 MB in fp8 (13.2 us at 3.35 TB/s).
// Design:
// - Coalesced 16-byte loads along N: a thread owns C columns (16 up to 2
//   rows, 8 up to 4, 4 up to 8, so its C x rows f32 sums fit its registers)
//   and loads them from each of 4 consecutive K rows (a quad) at once; the
//   threads of a K row cover a 64-column tile (4 threads of 16 fp8 columns:
//   64 contiguous bytes, two whole sectors), the rest of the block's 256
//   threads take other quads (64 of them at 16 columns), a quad at a time:
//   its 4 rows' loads, then its math (more quads in flight a thread measured
//   slower, at 8 rows much slower: PERF.md); x's 4 values of a quad
//   come in one 8-byte load (L1, shared by the tile's threads).
// - Paired converts, as csrc/gemv_quant.cu: fp8x2 -> f16x2 by one cvt, then
//   f32 (exact); int8 by the 2^23 magic (exact, no int-to-float convert);
//   bf16 by a shift or a mask.
// - The card full at every projection: the grid is column tiles x K splits,
//   a tile's splits one thread-block cluster of 1, 2, 4 or 8 blocks, the
//   fewest that bring the blocks to kTargetBlocks (two a SM) while each
//   thread keeps a quad, so N 2048 runs 256 blocks and N 11264 352
//   (conv_plan; kernels/gemv_quant.py conv_gemv_plan mirrors it). A function
//   of (rows, N, K) alone, so a captured graph stays valid.
// - Fixed-order sums: a thread adds its quads in ascending K; the threads of
//   a column meet by xor shuffles, then the warps in ascending order through
//   shared memory; then the splits in ascending order: every block of the
//   cluster stores its sums into block 0's shared memory (distributed
//   shared memory), and after one cluster barrier block 0 folds them and
//   stores the tile. No global scratch, counter or second launch. (Tried
//   first: 128-column tiles, the partials in a global scratch folded by the
//   last block to arrive after an atomic ticket, two quads in flight a
//   thread; then the fold read across the cluster between two barriers.
//   Both measured slower: PERF.md.)
// Rows whose 16-byte loads would leave their alignment (N * elt not a
// multiple of the load, or a base off it) load 4 columns at a time; the
// ragged last tile masks whole groups of 4 columns (N % 4 == 0).
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Kind { kE4M3 = 0, kE5M2 = 1, kInt8 = 2, kBf16 = 3 };
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 64;                    // output columns a block
constexpr int kTargetBlocks = 264;           // two blocks on each of 132 SMs
constexpr int kMaxSplits = 8;                 // a cluster's blocks at most (portable)
constexpr int kMaxRows = 8;

__host__ __device__ constexpr int row_bound(int rows) {
  return rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : 8;
}
// columns a thread at row bound R
__host__ __device__ constexpr int conv_cols(int r) { return r <= 2 ? 16 : r == 4 ? 8 : 4; }

struct ConvPlan {
  int tiles, splits, cols, klanes;
};

// The grid: ceil(N / 64) column tiles x splits of K's quads, a tile's
// splits one cluster; the fewest splits, a power of 2, that give
// kTargetBlocks blocks, at most kMaxSplits and as many as leave every K
// lane a quad.
inline ConvPlan conv_plan(int rows, int n, int k) {
  ConvPlan p;
  p.cols = conv_cols(row_bound(rows));
  p.klanes = kThreads * p.cols / kTileN;
  p.tiles = (n + kTileN - 1) / kTileN;
  p.splits = 1;
  while (p.splits < kMaxSplits && p.tiles * p.splits < kTargetBlocks &&
         (k / 4) / (2 * p.splits) >= p.klanes)
    p.splits *= 2;
  return p;
}

// v into the shared memory of block `rank` of the cluster, at the offset
// `p` has in this block's.
__device__ __forceinline__ void st_cluster(float* p, uint32_t rank, float v) {
  const uint32_t local = (uint32_t)__cvta_generic_to_shared(p);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(v) : "memory");
}

// Every thread of every block of the cluster: the shared-memory writes
// before are visible to the cluster after (release, acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;" ::: "memory");
}

template <int KIND>
struct Elt {
  static constexpr int kBytes = KIND == kBf16 ? 2 : 1;
};

// Four columns of a 32-bit word (one byte each) as f32.
template <int KIND>
__device__ __forceinline__ void bytes_f32(uint32_t wd, float* f) {
  if constexpr (KIND == kInt8) {
    const uint32_t u = wd ^ 0x80808080u;           // offset binary: v + 128
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5440u + b)) - 8388736.f;
  } else {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          (__nv_fp8x2_storage_t)((wd >> (16 * p)) & 0xffffu), KIND == kE4M3 ? __NV_E4M3 : __NV_E5M2);
      const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&h));
      f[2 * p] = v.x;
      f[2 * p + 1] = v.y;
    }
  }
}

// A thread's NW words of one K row (C columns) as C floats.
template <int KIND, int NW>
__device__ __forceinline__ void row_f32(const uint32_t (&wd)[NW], float* f) {
  if constexpr (KIND == kBf16) {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      f[2 * i] = __uint_as_float(wd[i] << 16);
      f[2 * i + 1] = __uint_as_float(wd[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) bytes_f32<KIND>(wd[i], f + 4 * i);
  }
}

// Weight loads, streamed past L1 (read once) so they do not evict x.
__device__ __forceinline__ uint4 ld_w16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ld_w8(const void* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ld_w4(const void* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// NW 32-bit words at p: in 16-, 8- or 4-byte loads where `wide`, else in
// groups of 4 columns (4 E bytes), those at or past `valid` columns zero.
template <int NW, int E>
__device__ __forceinline__ void load_row(const uint8_t* p, bool wide, int valid,
                                         uint32_t (&wd)[NW]) {
  constexpr int C = NW * 4 / E;
  if (wide && valid >= C) {
    if constexpr (NW >= 4) {
#pragma unroll
      for (int i = 0; i < NW / 4; ++i) {
        const uint4 v = ld_w16(p + 16 * i);
        wd[4 * i] = v.x;
        wd[4 * i + 1] = v.y;
        wd[4 * i + 2] = v.z;
        wd[4 * i + 3] = v.w;
      }
    } else if constexpr (NW == 2) {
      const uint2 v = ld_w8(p);
      wd[0] = v.x;
      wd[1] = v.y;
    } else {
      wd[0] = ld_w4(p);
    }
    return;
  }
  constexpr int kGroupWords = E;                 // words of 4 columns
#pragma unroll
  for (int gi = 0; gi < C / 4; ++gi) {
    const bool in = 4 * gi < valid;
    if constexpr (kGroupWords == 2) {
      const uint2 v = in ? ld_w8(p + 8 * gi) : make_uint2(0u, 0u);
      wd[2 * gi] = v.x;
      wd[2 * gi + 1] = v.y;
    } else {
      wd[gi] = in ? ld_w4(p + 4 * gi) : 0u;
    }
  }
}

// Block (tile blockIdx.x / splits, split blockIdx.x % splits). Thread t:
// columns (t % CL) C .. of the tile, K lane t / CL, which takes the quads
// q0 + lane, q0 + lane + KL, ... of its split [q0, q1).
template <int KIND, int R>
__global__ void __launch_bounds__(kThreads)
conv_gemv_kernel(const uint8_t* __restrict__ w, const float* __restrict__ scale,
                 const bf16* __restrict__ x, bf16* __restrict__ out, int rows, int n, int k,
                 int splits, int wide) {
  constexpr int E = Elt<KIND>::kBytes;
  constexpr int C = conv_cols(R);
  constexpr int CL = kTileN / C;                 // threads across the tile's columns
  constexpr int KL = kThreads / CL;              // K lanes
  constexpr int NW = C * E / 4;                  // words of a thread's columns in a K row
  __shared__ float red[kWarps][R][kTileN];
  __shared__ float part[kMaxSplits][R][kTileN];   // rank 0's: every split's sums
  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const int cl = threadIdx.x % CL, kl = threadIdx.x / CL;
  const int n0 = tile * kTileN + cl * C;
  const int valid = n - n0;                      // columns of mine inside N (<= 0: none)
  const int quads = k / 4;
  const int q0 = (int)((long long)split * quads / splits);
  const int q1 = (int)((long long)(split + 1) * quads / splits);
  const int mine = q1 - q0 > kl ? (q1 - q0 - kl + KL - 1) / KL : 0;    // my quads
  const uint8_t* wp = w + (size_t)n0 * E;
  // the scales of the outputs this thread stores (rank 0 stores), loaded
  // now, off the tail
  const uint32_t rank = blockIdx.x % splits;
  constexpr int kOuts = R * kTileN > kThreads ? R * kTileN / kThreads : 1;   // outputs a thread at most
  float sc[kOuts];
#pragma unroll
  for (int i = 0; i < kOuts; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int gn = tile * kTileN + idx % kTileN;
    sc[i] = rank == 0 && idx < rows * kTileN && gn < n ? __ldg(scale + gn) : 0.f;
  }

  float acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;

  for (int i = 0; i < mine; ++i) {               // my quads, one at a time
    const int k0 = 4 * (q0 + kl + i * KL);
    uint32_t wv[4][NW];                          // [K row][word]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (valid > 0) {
        load_row<NW, E>(wp + (size_t)(k0 + j) * n * E, wide, valid, wv[j]);
      } else {
#pragma unroll
        for (int v = 0; v < NW; ++v) wv[j][v] = 0u;
      }
    }
    float xf[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint2 xu = r < rows ? __ldg(reinterpret_cast<const uint2*>(x + (size_t)r * k + k0))
                                : make_uint2(0u, 0u);
      xf[r][0] = __uint_as_float(xu.x << 16);
      xf[r][1] = __uint_as_float(xu.x & 0xffff0000u);
      xf[r][2] = __uint_as_float(xu.y << 16);
      xf[r][3] = __uint_as_float(xu.y & 0xffff0000u);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float wf[C];
      row_f32<KIND, NW>(wv[j], wf);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows)
#pragma unroll
          for (int c = 0; c < C; ++c) acc[r][c] = fmaf(xf[r][j], wf[c], acc[r][c]);
    }
  }

  // the K lanes of a column: xor shuffles inside the warp, then the warps in
  // ascending order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float v = acc[r][c];
#pragma unroll
      for (int o = CL; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < CL) red[warp][r][cl * C + c] = v;
    }
  __syncthreads();
  // the warps in ascending order: this split's sums, into rank 0's shared
  // memory (a store across the cluster)
  for (int idx = threadIdx.x; idx < rows * kTileN; idx += kThreads) {
    const int r = idx / kTileN, col = idx % kTileN;
    float s = red[0][r][col];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) s += red[v][r][col];
    if (splits > 1) st_cluster(&part[rank][r][col], 0, s);
    else part[0][r][col] = s;
  }
  // one barrier: the cluster's sums have arrived; rank 0 folds the splits
  // in ascending order and stores, the others are done (nothing reads
  // their shared memory)
  if (splits > 1) cluster_sync();
  else __syncthreads();
  if (rank != 0) return;
#pragma unroll
  for (int i = 0; i < kOuts; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx >= rows * kTileN) break;
    const int r = idx / kTileN, col = idx % kTileN;
    const int gn = tile * kTileN + col;
    float p[kMaxSplits];
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) p[q] = q < splits ? part[q][r][col] : 0.f;
    float s = -0.f;                              // -0 + p0 is p0, its sign included
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < splits) s += p[q];
    if (gn < n) out[(size_t)r * n + gn] = __float2bfloat16_rn(__fmul_rn(s, sc[i]));
  }
}

template <int KIND, int R>
cudaError_t launch_conv(const void* w, const float* scale, const bf16* x, bf16* out, int rows,
                        int n, int k, cudaStream_t st) {
  constexpr int E = Elt<KIND>::kBytes;
  constexpr int VB = conv_cols(R) * E;           // bytes of a thread's columns in a K row
  constexpr int kAlign = VB < 16 ? VB : 16;
  const ConvPlan p = conv_plan(rows, n, k);
  const int wide = (size_t)n * E % kAlign == 0 && reinterpret_cast<uintptr_t>(w) % kAlign == 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles * p.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, conv_gemv_kernel<KIND, R>, static_cast<const uint8_t*>(w),
                            scale, x, out, rows, n, k, p.splits, wide);
}

template <int KIND>
cudaError_t launch_rows(const void* w, const float* scale, const bf16* x, bf16* out, int rows,
                        int n, int k, cudaStream_t st) {
  switch (row_bound(rows)) {
    case 1: return launch_conv<KIND, 1>(w, scale, x, out, rows, n, k, st);
    case 2: return launch_conv<KIND, 2>(w, scale, x, out, rows, n, k, st);
    case 4: return launch_conv<KIND, 4>(w, scale, x, out, rows, n, k, st);
    default: return launch_conv<KIND, 8>(w, scale, x, out, rows, n, k, st);
  }
}

}  // namespace

// x [rows, k] bf16, 8-byte aligned; w [k, n] of `kind` (0 fp8 e4m3fn, 1 fp8
// e5m2, 2 int8, 3 bf16), aligned to 4 columns; scale [n] f32; out [rows, n]
// bf16. Requires rows <= 8, n % 4 == 0 and k % 4 == 0.
PGK_API int pgk_conv_gemv(const void* x, const void* w, int kind, const void* scale, void* out,
                          int rows, int n, int k, void* stream) {
  if (rows < 1 || rows > kMaxRows || n < 4 || n % 4 || k < 4 || k % 4 ||
      reinterpret_cast<uintptr_t>(x) % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* o = static_cast<bf16*>(out);
  cudaError_t e;
  switch (kind) {
    case kE4M3: e = launch_rows<kE4M3>(w, sc, xb, o, rows, n, k, st); break;
    case kE5M2: e = launch_rows<kE5M2>(w, sc, xb, o, rows, n, k, st); break;
    case kInt8: e = launch_rows<kInt8>(w, sc, xb, o, rows, n, k, st); break;
    case kBf16: e = launch_rows<kBf16>(w, sc, xb, o, rows, n, k, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The launch plan (kernels/gemv_quant.py conv_gemv_plan is the same rule):
// plan[0..4] = columns a block, column tiles, K splits, columns a thread,
// K lanes a block.
PGK_API int pgk_conv_gemv_plan(int rows, int n, int k, int* plan) {
  if (rows < 1 || rows > kMaxRows || n < 1 || k < 4) return (int)cudaErrorInvalidValue;
  const ConvPlan p = conv_plan(rows, n, k);
  plan[0] = kTileN;
  plan[1] = p.tiles;
  plan[2] = p.splits;
  plan[3] = p.cols;
  plan[4] = p.klanes;
  return 0;
}
