// int4_block w4a16 GEMV for rows <= 8: y[r, n] = bf16(sum_k x[r, k] * w[k, n])
// with w[k, n] = bf16(nibble(k, n) * s[k / B, n]) and x in bf16, f32 sums.
//
// Replaces pygpukit_tpu/kernels/gemv_quant.py _gemv_block_stacked_pallas
// (:1260, pallas_call :1269) and _gemv_block_pallas (:1366, :1373): the
// same _block_tile_dots math on a stacked [L, K/2, N] or a 2-D [K/2, N]
// weight (here a layer of a stack is a free view).
//
// Storage: K-major split-half packed [K/2, N] uint8 (packed row r holds
// W[r] in the low nibble and W[K/2 + r] in the high one) and bf16 block
// scales [K/B, N]. Each k takes the block k / B, so a block that straddles
// K/2 (B not dividing K/2) is read right, where the reference's lo/hi scale
// split needs B | K/2.
//
// Bound: bytes. Per step each packed byte is read once, with one bf16
// scale per B/2 bytes, for at most 8 rows: the four 1.1B projections are
// 24.8 MB (7.4 us at 3.35 TB/s). Design: w4a16_mma.cuh, bf16 tensor cores
// over a card-filling grid (64-column tiles x K splits in a cluster),
// launched as its predecessor's programmatic dependent, each weight
// dequantized in pairs and rounded once to bf16 as the reference's bf16
// tile multiply does, so only the order of the f32 sums differs from the
// reference (and from the plain version); that order is fixed.
#include "w4a16_mma.cuh"

namespace {

template <bool kSplitHi>
cudaError_t launch_block(const void* x, const void* w, const void* s, void* out, int rows, int n,
                         int k_half, int blk, int wide, cudaStream_t st) {
  const w4a16::Plan p = w4a16::make_plan(n, k_half);
  auto kernel = w4a16::block_kernel<kSplitHi>;
  const size_t smem = w4a16::smem_bytes(p, rows);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  // the cluster of a tile's splits; the programmatic launch: the kernel may
  // start once the grid before it on the stream has, and waits for it
  // before it reads x (griddepcontrol.wait)
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = p.splits;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles * p.splits);
  cfg.blockDim = dim3(32 * p.warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = p.splits > 1 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint8_t*>(w),
                            static_cast<const __nv_bfloat16*>(s),
                            static_cast<const __nv_bfloat16*>(x),
                            static_cast<__nv_bfloat16*>(out), rows, n, k_half, blk, p.splits,
                            wide);
}

}  // namespace

// x [rows, 2*k_half] bf16, 16-byte aligned; w [k_half, n] uint8; s
// [2*k_half/blk, n] bf16; out [rows, n] bf16. Requires rows <= 8, n % 4 ==
// 0, blk % 8 == 0 and (2*k_half) % blk == 0 (so k_half % 4 == 0).
PGK_API int pgk_block_w4a16_gemv(const void* x, const void* w, const void* s, void* out,
                                 int rows, int n, int k_half, int blk, void* stream) {
  if (rows < 1 || rows > w4a16::kMaxRows || n < 4 || n % 4 || blk < 8 || blk % 8 ||
      k_half < 1 || (2 * k_half) % blk || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 4 || reinterpret_cast<uintptr_t>(s) % 8)
    return (int)cudaErrorInvalidValue;
  // 8-byte weight loads and 16-byte scale loads where N keeps the rows on
  // them, else 4 columns at a time
  const int wide = n % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(s) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      k_half % 8 != 0 ? launch_block<true>(x, w, s, out, rows, n, k_half, blk, wide, st)
                      : launch_block<false>(x, w, s, out, rows, n, k_half, blk, wide, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The launch plan (kernels/gemv_quant.py block_w4a16_plan is the same
// rule): plan[0..5] = columns a block, column tiles, K splits (a cluster's
// blocks), warps a block, 32-row rounds of K/2, dynamic shared bytes.
PGK_API int pgk_block_w4a16_plan(int rows, int n, int k_half, int* plan) {
  if (rows < 1 || rows > w4a16::kMaxRows || n < 1 || k_half < 1)
    return (int)cudaErrorInvalidValue;
  const w4a16::Plan p = w4a16::make_plan(n, k_half);
  plan[0] = p.tile_n;
  plan[1] = p.tiles;
  plan[2] = p.splits;
  plan[3] = p.warps;
  plan[4] = p.rounds;
  plan[5] = (int)w4a16::smem_bytes(p, rows);
  return 0;
}
