// int4_block w4a8 GEMV for rows <= 8:
//   y[r, n] = bf16((Y_lo + Y_hi) * sx[r]),  Y_h = sum_b Z_h[b] * s[b, n]
// over the K-blocks b of half h in ascending order, in f32 with one rounding
// per multiply and per add, where Z_h[b] is the exact int32 dot of the
// block's rows of half h (signed nibbles) with the int8 activations
// xq = rint(x / sx), sx = max(amax / 127, 1e-12).
//
// Replaces pygpukit_tpu/kernels/gemv_quant.py
//   _gemv_block_w4a8_stacked_fusedq_pallas (and _gemv_block_w4a8_stacked_pallas,
//   the same _block_w4a8_tile_dots math with the activation quant outside
//   the kernel). The reference adds 8 to the low nibble (correcting by
//   -8 * sum(xq)) and carries the high nibble times 16 (undone after the
//   block sum); the integers are exact either way and the factor 16 is exact
//   in f32, so signed nibbles give the same values.
//
// Storage: K-major split-half packed [K/2, N] (packed row r holds W[r] low
// and W[K/2 + r] high) and bf16 scales [K/B, N]. Each k takes block k / B:
// where B does not divide K/2, one block straddles the halves and its two
// parts are summed into Y_lo and Y_hi separately, as the plain version does.
//
// Bound: bytes at one row (decode), int32 dot products at 8. Design: the
// packed rows are cut into segments, each inside one lo block and one hi
// block (the blocks themselves when B | K/2, else halves of them). A block
// owns 32 columns; its 512 threads are 8 groups of 4 columns times 64
// segment slots. For a chunk of 64 segments, every thread takes one
// segment: it loads 4 packed rows at a time, transposes them so each
// column's 4 K values share one word, and runs __dp4a against 4 int8
// activations; the exact Z of each (segment, row, column) and the scales of
// the segment's two blocks go to shared memory (a scale load inside the
// ordered pass would put its latency on the serial chain, once per block).
// Then one thread per (row, column) walks the chunk's segments in
// ascending order, adds the integers of a block and, when the block ends,
// folds it into Y_h with __fmul_rn / __fadd_rn (no FMA contraction). That
// fixed order is the plain version's, so the two are bitwise equal.
#include "act_quant.cuh"
#include "kmajor_gemv.cuh"

namespace {

constexpr int kSegs = kKmSlices;     // segments per chunk, one per thread slot

// Packed-row segments [start(i), start(i + 1)) inside one lo block and one
// hi block. Lo blocks end at multiples of B; hi blocks where (K/2 + r) % B
// == 0, i.e. at off + j*B. K % B == 0, so off is 0 or B/2.
struct Segments {
  int k_half, blk, off, count;
  __device__ Segments(int k_half_, int blk_) : k_half(k_half_), blk(blk_) {
    off = (blk - k_half % blk) % blk;
    const int nlo = (k_half + blk - 1) / blk;
    count = off == 0 ? nlo : nlo + (k_half > off ? (k_half - off + blk - 1) / blk : 0);
  }
  __device__ int start(int i) const {
    return off == 0 ? i * blk : (i / 2) * blk + (i % 2) * off;
  }
  __device__ int end(int i) const { return i + 1 < count ? start(i + 1) : k_half; }
};

__global__ void __launch_bounds__(kKmThreads)
block_w4a8_gemv_kernel(const uint8_t* __restrict__ w, const __nv_bfloat16* __restrict__ s,
                       const int8_t* __restrict__ xq, const float* __restrict__ sx,
                       __nv_bfloat16* __restrict__ out, int rows, int n, int k_half,
                       int blk) {
  // [2][kSegs][rows][kKmTN] int32 block sums, then [2][kSegs][kKmTN] f32
  // scales of each segment's lo and hi block
  extern __shared__ int pgk_z_smem[];
  float* scales = reinterpret_cast<float*>(pgk_z_smem + 2 * kSegs * rows * kKmTN);
  const int grp = threadIdx.x % kKmGroups;
  const int slot = threadIdx.x / kKmGroups;
  const int n0 = blockIdx.x * kKmTN + grp * 4;
  const int k = 2 * k_half;
  const Segments seg(k_half, blk);
  const size_t st = n / 4;
  auto zat = [&](int h, int sg, int r, int col) -> int& {
    return pgk_z_smem[((h * kSegs + sg) * rows + r) * kKmTN + col];
  };

  // the (row, column) this thread folds in the ordered pass
  const int fr = threadIdx.x / kKmTN, fc = threadIdx.x % kKmTN;
  const int fn = blockIdx.x * kKmTN + fc;
  const bool folds = fr < rows && fn < n;
  float y_lo = 0.f, y_hi = 0.f;
  int z_lo = 0, z_hi = 0;

  for (int base = 0; base < seg.count; base += kSegs) {
    const int i = base + slot;
    if (i < seg.count && n0 < n) {
      int zl[kKmMaxRows][4], zh[kKmMaxRows][4];
#pragma unroll
      for (int r = 0; r < kKmMaxRows; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) zl[r][c] = zh[r][c] = 0;
      const int re = seg.end(i);
      for (int r0 = seg.start(i); r0 < re; r0 += 4) {
        const unsigned* wp = reinterpret_cast<const unsigned*>(w + (size_t)r0 * n + n0);
        unsigned col[4];
        pgk_transpose4(__ldg(wp), __ldg(wp + st), __ldg(wp + 2 * st), __ldg(wp + 3 * st),
                       col);
        int lo[4], hi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[c] = pgk_lo_nibbles(col[c]);
          hi[c] = pgk_hi_nibbles(col[c]);
        }
#pragma unroll
        for (int r = 0; r < kKmMaxRows; ++r) {
          if (r < rows) {
            const int xl = __ldg(reinterpret_cast<const int*>(xq + (size_t)r * k + r0));
            const int xh = __ldg(reinterpret_cast<const int*>(xq + (size_t)r * k + k_half + r0));
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              zl[r][c] = __dp4a(lo[c], xl, zl[r][c]);
              zh[r][c] = __dp4a(hi[c], xh, zh[r][c]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kKmMaxRows; ++r)
        if (r < rows)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            zat(0, slot, r, grp * 4 + c) = zl[r][c];
            zat(1, slot, r, grp * 4 + c) = zh[r][c];
          }
      // the fold below reads these from shared memory, off its serial chain
      const int a = seg.start(i);
      const uint2 sl = __ldg(reinterpret_cast<const uint2*>(s + (size_t)(a / blk) * n + n0));
      const uint2 sh = __ldg(reinterpret_cast<const uint2*>(
          s + (size_t)((k_half + a) / blk) * n + n0));
      const __nv_bfloat16* slb = reinterpret_cast<const __nv_bfloat16*>(&sl);
      const __nv_bfloat16* shb = reinterpret_cast<const __nv_bfloat16*>(&sh);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        scales[slot * kKmTN + grp * 4 + c] = __bfloat162float(slb[c]);
        scales[(kSegs + slot) * kKmTN + grp * 4 + c] = __bfloat162float(shb[c]);
      }
    }
    __syncthreads();
    if (folds) {
      const int last = min(kSegs, seg.count - base);
      for (int j = 0; j < last; ++j) {
        const int e = seg.end(base + j);
        z_lo += zat(0, j, fr, fc);
        z_hi += zat(1, j, fr, fc);
        if (e % blk == 0 || e == k_half) {           // a lo block ends
          y_lo = __fadd_rn(y_lo, __fmul_rn((float)z_lo, scales[j * kKmTN + fc]));
          z_lo = 0;
        }
        if ((k_half + e) % blk == 0) {               // a hi block ends
          y_hi = __fadd_rn(y_hi, __fmul_rn((float)z_hi, scales[(kSegs + j) * kKmTN + fc]));
          z_hi = 0;
        }
      }
    }
    __syncthreads();
  }
  if (folds)
    out[(size_t)fr * n + fn] = __float2bfloat16_rn(__fmul_rn(__fadd_rn(y_lo, y_hi), sx[fr]));
}

}  // namespace

// x [rows, 2*k_half] bf16 (x_f32 == 0) or f32, row-major; w [k_half, n]
// uint8; s [2*k_half/blk, n] bf16; xq [rows, 2*k_half] int8 and sx [rows]
// f32 are scratch; out [rows, n] bf16. Requires rows <= 8, n % 4 == 0,
// blk % 8 == 0 and (2*k_half) % blk == 0.
PGK_API int pgk_block_w4a8_gemv(const void* x, int x_f32, const void* w, const void* s,
                                void* xq, void* sx, void* out, int rows, int n,
                                int k_half, int blk, void* stream) {
  if (rows < 1 || rows > kKmMaxRows || n < 4 || n % 4 || blk < 8 || blk % 8 ||
      k_half < 1 || (2 * k_half) % blk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = pgk_act_quant(x, x_f32, rows, 2 * k_half, static_cast<int8_t*>(xq),
                                static_cast<float*>(sx), st);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)2 * kSegs * (rows + 1) * kKmTN * sizeof(int);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(block_w4a8_gemv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (n + kKmTN - 1) / kKmTN;
  block_w4a8_gemv_kernel<<<grid, kKmThreads, smem, st>>>(
      static_cast<const uint8_t*>(w), static_cast<const __nv_bfloat16*>(s),
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<__nv_bfloat16*>(out), rows, n, k_half, blk);
  return (int)cudaGetLastError();
}
