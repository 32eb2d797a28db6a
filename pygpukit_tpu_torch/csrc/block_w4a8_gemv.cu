// int4_block w4a8 GEMV for rows <= 8:
//   y[r, n] = bf16((Y_lo + Y_hi) * sx[r]),  Y_h = sum_b Z_h[b] * s[b, n]
// over the K-blocks b of half h in ascending order, in f32 with one rounding
// per multiply and per add, where Z_h[b] is the exact int32 dot of the
// block's rows of half h (signed nibbles) with the int8 activations
// xq = rint(x / sx), sx = max(amax / 127, 1e-12).
//
// Replaces pygpukit_tpu/kernels/gemv_quant.py
//   _gemv_block_w4a8_stacked_fusedq_pallas (:1137, pallas_call :1148), which
//   quantizes the activations inside the kernel as this one does, and
//   _gemv_block_w4a8_stacked_pallas (:1051), the same _block_w4a8_tile_dots
//   math with the quantization outside. The reference adds 8 to the low
//   nibble (correcting by -8 * sum(xq)) and carries the high nibble times 16
//   (undone after the block sum); the integers are exact either way and the
//   factor 16 is exact in f32, so signed nibbles give the same values.
//
// Storage: K-major split-half packed [K/2, N] (packed row r holds W[r] low
// and W[K/2 + r] high) and bf16 scales [K/B, N]. Each k takes block k / B:
// where B does not divide K/2, one block straddles the halves and its two
// parts are summed into Y_lo and Y_hi separately, as the plain version does.
//
// Bound: bytes at one row (decode): the packed weight and its scales, read
// once. At that size (2-12 MB a projection, 0.6-3.4 us at 3.35 TB/s) a call
// is a chain of round trips to memory, so the design fills the card in one
// launch and keeps that chain short:
// - The packed rows are cut into segments, each inside one lo block and one
//   hi block (the blocks themselves when B | K/2, else halves of them). A
//   block (CTA) owns a column tile over all of K: 32 columns (one 32-byte
//   sector of a packed row) where N / 32 tiles fill the card's 132 SMs, else
//   16, else 8 (block_groups; kernels/gemv_quant.py block_w4a8_plan mirrors
//   it), so N 2048 runs 256 blocks and no sum crosses blocks.
// - Its 256 threads are slots of 8: each slot takes one segment of a chunk of
//   32, its 8 threads 8 / W groups of 4 packed rows each of a row's W
//   threads, a thread V words (4 V columns) of a packed row at once (two at
//   one row, where N allows; one above, for the per-row sums' registers). A
//   thread's weight words and block scales are loaded before the math, the
//   first chunk's before the activations are quantized (with one row, the
//   activations themselves go first), so they stream in meanwhile. Each
//   group of 4 packed rows is transposed so a column's 4 K values share a
//   word, then __dp4a against the int8 activations; the segment's exact sums
//   meet by shuffles.
// - The activation quantization is fused: every block takes each row's amax
//   from x and quantizes the row into shared memory, op for op as
//   act_quant.cuh (an IEEE divide, rintf, a clamp), so the result is bitwise
//   the separate launch's (the second read of x hits L1). Above 2 rows the
//   separate form (xq and sx from act_quant.cuh's launch first, copied in)
//   is faster, as chip_smoke.py phase 3 times both; the wrapper picks by
//   rows (kernels/gemv_quant.py BLOCK_FUSED_MAX_ROWS).
// - One thread per (half, row, column) folds each chunk's segments in
//   ascending order from shared memory: it sums a block's integers and, when
//   the block ends, adds __fmul_rn(float(Z), s) with __fadd_rn (no FMA).
//   That fixed order is the plain version's, so the two are bitwise equal.
//   Each segment's block and whether it ends there come from a table the
//   block builds first: an integer division a segment on the fold's chain
//   cost more than the rest of the kernel.
#include "act_quant.cuh"
#include "kmajor_gemv.cuh"

namespace {

constexpr int kBThreads = 256;
constexpr int kBSlots = 32;          // segments a chunk: one a slot of 8 threads
constexpr int kBWave = 132;          // blocks of one wave: the H100's SMs
constexpr int kBQuads = 8;           // groups of 4 packed rows a thread loads before their math

// Packed-row segments [start(i), start(i + 1)) inside one lo block and one
// hi block. Lo blocks end at multiples of B; hi blocks where (K/2 + r) % B
// == 0, i.e. at off + j*B. K % B == 0, so off is 0 or B/2.
struct Segments {
  int k_half, blk, off, count;
  __host__ __device__ Segments(int k_half_, int blk_) : k_half(k_half_), blk(blk_) {
    off = (blk - k_half % blk) % blk;
    const int nlo = (k_half + blk - 1) / blk;
    count = off == 0 ? nlo : nlo + (k_half > off ? (k_half - off + blk - 1) / blk : 0);
  }
  __host__ __device__ int start(int i) const {
    return off == 0 ? i * blk : (i / 2) * blk + (i % 2) * off;
  }
  __host__ __device__ int end(int i) const { return i + 1 < count ? start(i + 1) : k_half; }
  // segment i's block in half h, times 2, plus 1 where that block ends
  // with the segment
  __device__ int fold_code(int h, int i) const {
    const int e = end(i);
    const bool ends = h == 0 ? e % blk == 0 || e == k_half : (k_half + e) % blk == 0;
    return (h * k_half + start(i)) / blk * 2 + ends;
  }
};

// The column tile: the widest of 32, 16 and 8 columns (8, 4 or 2 groups of
// 4) whose tiles fill the card's kBWave SMs; the blocks never split K.
__host__ __device__ inline int block_groups(int n) {
  if ((n + 31) / 32 >= kBWave) return 8;
  return (n + 15) / 16 >= kBWave ? 4 : 2;
}

// The words a thread loads from a packed row: V (1 or 2) consecutive 32-bit
// words (4 V columns) in one load. Volatile, so the compiler keeps it where
// it stands, ahead of the quantization's barriers.
template <int V>
__device__ __forceinline__ void load_words(const unsigned* p, unsigned (&u)[V]) {
  static_assert(V == 1 || V == 2, "one or two words");
  if constexpr (V == 2) {
    asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n" : "=r"(u[0]), "=r"(u[1]) : "l"(p));
  } else {
    asm volatile("ld.global.nc.u32 %0, [%1];\n" : "=r"(u[0]) : "l"(p));
  }
}

// 16 bytes of activations as floats (8 bf16 or 4 f32)
template <typename T>
struct XVec {
  static constexpr int kN = 16 / sizeof(T);
  uint4 raw;
  // volatile: issued where it stands, ahead of the weight loads that follow
  __device__ __forceinline__ void load(const T* p) {
    asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(raw.x), "=r"(raw.y), "=r"(raw.z), "=r"(raw.w)
                 : "l"(p));
  }
  __device__ __forceinline__ float at(int i) const {
    if constexpr (sizeof(T) == 4) {
      return reinterpret_cast<const float*>(&raw)[i];
    } else {
      return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&raw)[i]);
    }
  }
};

// One row's activations a thread holds: kXRegs 16-byte words, loaded
// before anything else so they are not queued behind the weights (K up to
// kXRegs * 256 * 8 bf16 or * 4 f32 values).
constexpr int kXRegs = 3;

// xq of every row of x [rows, k] into shared memory as int8 words, op for op
// act_quant.cuh: each row's amax over 16-byte loads, the block's max in a
// fixed order, sx = max(amax / 127, 1e-12) with an IEEE divide, then
// xq = clamp(rintf(x / sx), -127, 127). With one row (`cached`) the values
// are the ones the block loaded first, in `keep`; else both passes load them
// (the second from L1: the same thread, the same addresses).
template <typename T, int R>
__device__ void block_quantize(const T* __restrict__ x, int rows, int k, float* sxs,
                               float (*red)[R], int* xqs, bool cached,
                               const XVec<T> (&keep)[kXRegs]) {
  constexpr int kPer = XVec<T>::kN;
  const int kw = k / 4;
  float mx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = 0.f;
  if (cached) {
#pragma unroll
    for (int j = 0; j < kXRegs; ++j) {
      const int i = (threadIdx.x + j * kBThreads) * kPer;
      if (i < k)
#pragma unroll
        for (int e = 0; e < kPer; ++e) mx[0] = fmaxf(mx[0], fabsf(keep[j].at(e)));
    }
  } else {
    for (int i = threadIdx.x * kPer; i < k; i += kBThreads * kPer)
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows) {
          XVec<T> v;
          v.load(x + (size_t)r * k + i);
#pragma unroll
          for (int e = 0; e < kPer; ++e) mx[r] = fmaxf(mx[r], fabsf(v.at(e)));
        }
  }
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float m = pgk_warp_max(mx[r]);
    if ((threadIdx.x & 31) == 0 && r < rows) red[warp][r] = m;
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    float m = 0.f;
    for (int w = 0; w < kBThreads / 32; ++w) m = fmaxf(m, red[w][threadIdx.x]);
    sxs[threadIdx.x] = fmaxf(m / 127.0f, 1e-12f);
  }
  __syncthreads();
  auto quantize = [&](const XVec<T>& v, float sc, int* dst) {
#pragma unroll
    for (int w4 = 0; w4 < kPer / 4; ++w4) {
      uint32_t q = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float t = fminf(fmaxf(rintf(v.at(4 * w4 + e) / sc), -127.f), 127.f);
        q |= (uint32_t)(uint8_t)(int8_t)t << (8 * e);
      }
      dst[w4] = (int)q;
    }
  };
  if (cached) {
#pragma unroll
    for (int j = 0; j < kXRegs; ++j) {
      const int i = (threadIdx.x + j * kBThreads) * kPer;
      if (i < k) quantize(keep[j], sxs[0], xqs + i / 4);
    }
  } else {
    for (int r = 0; r < rows; ++r)
      for (int i = threadIdx.x * kPer; i < k; i += kBThreads * kPer) {
        XVec<T> v;
        v.load(x + (size_t)r * k + i);
        quantize(v, sxs[r], xqs + r * kw + i / 4);
      }
  }
}

// Block (column tile) of TN = 4 G columns, all of K. A thread loads V words
// (4 V columns) of a packed row at once: W = G / V threads cover a row, P =
// 8 / W of them share a segment, and slot t / 8 takes chunk c's segment 32 c
// + slot. Thread t: columns (t % W) 4 V .., part t / W % P. Row bound R sets
// the per-row sums' registers, so how many blocks an SM holds (three at one
// row, two above).
template <typename T, bool kFused, int R, int G, int V>
__global__ void __launch_bounds__(kBThreads, R == 1 ? 3 : 2)
block_w4a8_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ xq_g,
                       const float* __restrict__ sx_g, const uint8_t* __restrict__ w,
                       const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ out,
                       int rows, int n, int k_half, int blk) {
  constexpr int TN = 4 * G, W = G / V, P = 8 / W, CW = 4 * V;
  // groups of 4 packed rows a load batch: 32 words a thread (16 at 8 rows,
  // whose sums take 64 registers)
  constexpr int kQ = (R < kKmMaxRows ? kBQuads : kBQuads / 2) / V;
  // xq [rows][K] int8 as words; then each segment's fold codes of the two
  // halves (Segments::fold_code); then a chunk's Z [2][kBSlots][R][TN] int
  extern __shared__ int xqs[];
  __shared__ float ssm[2][kBSlots][TN];          // a chunk's block scales
  __shared__ float red[kBThreads / 32][R];
  __shared__ float sxs[R];
  __shared__ float yhi[R][TN];
  const int k = 2 * k_half, kw = k / 4;
  const Segments seg(k_half, blk);
  int2* codes = reinterpret_cast<int2*>(xqs + (rows * kw + 3) / 4 * 4);
  int* zsm = reinterpret_cast<int*>(codes + (seg.count + 1) / 2 * 2);
  const int wi = threadIdx.x % W, part = threadIdx.x / W % P, slot = threadIdx.x / 8;
  const int n0 = blockIdx.x * TN + wi * CW;
  const bool cols = n0 < n;                      // n % CW == 0: all in or all out
  const size_t st = n / 4;                       // packed row stride in words

  // The words of groups q0, q0 + P, ... of 4 packed rows of segment i and
  // its two blocks' scales, all in flight at once.
  unsigned wv[kQ][4][V];
  uint2 sl[V], sh[V];
  auto load = [&](int i, int q0) {
    const int a = seg.start(i), nq = (seg.end(i) - a) / 4;
    const unsigned* wp = reinterpret_cast<const unsigned*>(w + (size_t)a * n + n0);
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const int q = q0 + u * P;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (q < nq) {
          load_words<V>(wp + (4 * q + j) * st, wv[u][j]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) wv[u][j][v] = 0u;
        }
      }
    }
    if (q0 == part)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        load_words<2>(reinterpret_cast<const unsigned*>(s + (size_t)(a / blk) * n + n0 + 4 * v),
                      reinterpret_cast<unsigned(&)[2]>(sl[v]));
        load_words<2>(
            reinterpret_cast<const unsigned*>(s + (size_t)((k_half + a) / blk) * n + n0 + 4 * v),
            reinterpret_cast<unsigned(&)[2]>(sh[v]));
      }
  };
  // 1. one row's activations, then the first chunk's weights, on their way
  // before the block quantizes
  XVec<T> keep[kXRegs];
  const bool cached = kFused && R == 1 && k <= kXRegs * kBThreads * XVec<T>::kN;
  if (cached)
#pragma unroll
    for (int j = 0; j < kXRegs; ++j) {
      const int i = (threadIdx.x + j * kBThreads) * XVec<T>::kN;
      if (i < k) keep[j].load(x + i);
    }
  if (cols && slot < seg.count) load(slot, part);

  // 2. xq of every row in shared memory; the fold codes
  if constexpr (kFused) {
    block_quantize<T, R>(x, rows, k, sxs, red, xqs, cached, keep);
  } else {
    if (threadIdx.x < rows) sxs[threadIdx.x] = sx_g[threadIdx.x];
    for (int i = threadIdx.x; i < rows * kw; i += kBThreads)
      xqs[i] = reinterpret_cast<const int*>(xq_g)[i];
  }
  for (int i = threadIdx.x; i < seg.count; i += kBThreads)
    codes[i] = make_int2(seg.fold_code(0, i), seg.fold_code(1, i));
  __syncthreads();

  // 3. chunk by chunk: exact Z of 32 segments into shared memory, then the
  // ordered fold by thread (half h, row r, column c), two passes past 4 rows
  float y[2] = {0.f, 0.f};
  int z[2] = {0, 0};
  for (int base = 0; base < seg.count; base += kBSlots) {
    const int i = base + slot;
    int zl[R][CW], zh[R][CW];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) zl[r][c] = zh[r][c] = 0;
    if (cols && i < seg.count) {
      const int a = seg.start(i), nq = (seg.end(i) - a) / 4;
      for (int q0 = part; q0 < nq; q0 += kQ * P) {
        if (base > 0 || q0 > part) load(i, q0);  // the first batch is already here
#pragma unroll
        for (int u = 0; u < kQ; ++u) {
          const int q = q0 + u * P;
          if (q >= nq) break;
          const int xw = (a + 4 * q) / 4;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            unsigned col[4];
            pgk_transpose4(wv[u][0][v], wv[u][1][v], wv[u][2][v], wv[u][3][v], col);
            int lo[4], hi[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              lo[c] = pgk_lo_nibbles(col[c]);
              hi[c] = pgk_hi_nibbles(col[c]);
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (r < rows) {
                const int xl = xqs[r * kw + xw], xh = xqs[r * kw + k_half / 4 + xw];
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  zl[r][4 * v + c] = __dp4a(lo[c], xl, zl[r][4 * v + c]);
                  zh[r][4 * v + c] = __dp4a(hi[c], xh, zh[r][4 * v + c]);
                }
              }
            }
          }
        }
      }
    }
    // the P threads of a segment are lanes W apart: exact integer sums
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c)
#pragma unroll
        for (int o = W; o < 8; o <<= 1) {
          zl[r][c] += __shfl_xor_sync(0xffffffffu, zl[r][c], o);
          zh[r][c] += __shfl_xor_sync(0xffffffffu, zh[r][c], o);
        }
    if (part == 0 && cols && i < seg.count) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows)
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            zsm[((0 * kBSlots + slot) * R + r) * TN + wi * CW + c] = zl[r][c];
            zsm[((1 * kBSlots + slot) * R + r) * TN + wi * CW + c] = zh[r][c];
          }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const __nv_bfloat16* lb = reinterpret_cast<const __nv_bfloat16*>(&sl[v]);
        const __nv_bfloat16* hb = reinterpret_cast<const __nv_bfloat16*>(&sh[v]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ssm[0][slot][wi * CW + 4 * v + c] = __bfloat162float(lb[c]);
          ssm[1][slot][wi * CW + 4 * v + c] = __bfloat162float(hb[c]);
        }
      }
    }
    __syncthreads();
    const int last = min(kBSlots, seg.count - base);
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int idx = threadIdx.x + pass * kBThreads;
      const int h = idx / (rows * TN), r = idx / TN % rows, c = idx % TN;
      if (h > 1 || blockIdx.x * TN + c >= n) continue;
      float acc = y[pass];
      int zz = z[pass];
      // eight segments' sums, codes and scales loaded ahead of their chain;
      // the fold of a block that ends is selected, not branched to
      for (int j0 = 0; j0 < last; j0 += 8) {
        int zj[8], cj[8];
        float sj[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool in = j0 + j < last;
          zj[j] = in ? zsm[((h * kBSlots + j0 + j) * R + r) * TN + c] : 0;
          cj[j] = in ? (h ? codes[base + j0 + j].y : codes[base + j0 + j].x) : 0;
          sj[j] = in ? ssm[h][j0 + j][c] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          zz += zj[j];
          const float folded = __fadd_rn(acc, __fmul_rn((float)zz, sj[j]));
          const bool ends = cj[j] & 1;           // the block ends: fold it
          acc = ends ? folded : acc;
          zz = ends ? 0 : zz;
        }
      }
      y[pass] = acc;
      z[pass] = zz;
    }
    __syncthreads();
  }
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int idx = threadIdx.x + pass * kBThreads;
    const int h = idx / (rows * TN), r = idx / TN % rows, c = idx % TN;
    if (h == 1 && blockIdx.x * TN + c < n) yhi[r][c] = y[pass];
  }
  __syncthreads();
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int idx = threadIdx.x + pass * kBThreads;
    const int h = idx / (rows * TN), r = idx / TN % rows, c = idx % TN;
    const int gn = blockIdx.x * TN + c;
    if (h == 0 && gn < n)
      out[(size_t)r * n + gn] = __float2bfloat16_rn(__fmul_rn(__fadd_rn(y[pass], yhi[r][c]),
                                                              sxs[r]));
  }
}

struct BlockArgs {
  const void *x, *xq, *sx, *w, *s;
  void* out;
  int rows, n, k_half, blk;
  cudaStream_t st;
};

template <typename T, bool kFused, int R, int G, int V>
cudaError_t launch_block(const BlockArgs& a) {
  const Segments seg(a.k_half, a.blk);
  const size_t smem = (size_t)(a.rows * a.k_half / 2 + 3) / 4 * 16 +
                      (size_t)(seg.count + 1) / 2 * 16 + (size_t)2 * kBSlots * R * 4 * G * 4;
  auto kern = block_w4a8_gemv_kernel<T, kFused, R, G, V>;
  if (smem > 32 * 1024) {                        // past 48 KB with the static arrays
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<(a.n + 4 * G - 1) / (4 * G), kBThreads, smem, a.st>>>(
      static_cast<const T*>(a.x), static_cast<const int8_t*>(a.xq),
      static_cast<const float*>(a.sx), static_cast<const uint8_t*>(a.w),
      static_cast<const __nv_bfloat16*>(a.s), static_cast<__nv_bfloat16*>(a.out), a.rows, a.n,
      a.k_half, a.blk);
  return cudaGetLastError();
}

// The load width: 8-byte words at one row (the decode step), one word
// above (the per-row sums' registers), one where N is not a multiple of 8.
// (16-byte words at one row spilled registers at three blocks an SM.)
template <typename T, bool kFused, int R, int G>
cudaError_t launch_width(const BlockArgs& a) {
  constexpr int kWide = R == 1 ? 2 : 1;
  if constexpr (kWide > 1) {
    if (a.n % (4 * kWide) == 0) return launch_block<T, kFused, R, G, kWide>(a);
  }
  return launch_block<T, kFused, R, G, 1>(a);
}

template <typename T, bool kFused, int R>
cudaError_t launch_groups(const BlockArgs& a) {
  switch (block_groups(a.n)) {
    case 8: return launch_width<T, kFused, R, 8>(a);
    case 4: return launch_width<T, kFused, R, 4>(a);
    default: return launch_width<T, kFused, R, 2>(a);
  }
}

template <typename T>
cudaError_t launch_rows(const BlockArgs& a, bool fused) {
  if (!fused) return launch_groups<T, false, kKmMaxRows>(a);
  if (a.rows == 1) return launch_groups<T, true, 1>(a);
  if (a.rows <= 4) return launch_groups<T, true, 4>(a);
  return launch_groups<T, true, kKmMaxRows>(a);
}

}  // namespace

// x [rows, 2*k_half] bf16 (x_f32 == 0) or f32, row-major, 16-byte aligned;
// w [k_half, n] uint8; s [2*k_half/blk, n] bf16; out [rows, n] bf16. fused
// == 0 runs act_quant.cuh first into xq [rows, 2*k_half] int8 and sx [rows]
// f32 (scratch; unused when fused). Requires rows <= 8, n % 4 == 0,
// blk % 8 == 0 and (2*k_half) % blk == 0; the block keeps xq of every row
// and a code a segment in shared memory (rows * K + 8 K / B bytes and the
// chunk's sums must fit).
PGK_API int pgk_block_w4a8_gemv(const void* x, int x_f32, const void* w, const void* s,
                                void* xq, void* sx, void* out, int rows, int n, int k_half,
                                int blk, int fused, void* stream) {
  if (rows < 1 || rows > kKmMaxRows || n < 4 || n % 4 || blk < 8 || blk % 8 ||
      k_half < 1 || (2 * k_half) % blk || reinterpret_cast<uintptr_t>(x) % 16 ||
      (!fused && (xq == nullptr || sx == nullptr)))
    return (int)cudaErrorInvalidValue;
  const BlockArgs a{x, xq, sx, w, s, out, rows, n, k_half, blk, static_cast<cudaStream_t>(stream)};
  if (!fused) {
    cudaError_t e = pgk_act_quant(x, x_f32, rows, 2 * k_half, static_cast<int8_t*>(xq),
                                  static_cast<float*>(sx), a.st);
    if (e != cudaSuccess) return (int)e;
  }
  return x_f32 ? (int)launch_rows<float>(a, fused) : (int)launch_rows<__nv_bfloat16>(a, fused);
}

// The launch plan (kernels/gemv_quant.py block_w4a8_plan is the same rule):
// plan[0..2] = columns a block, blocks, segments.
PGK_API int pgk_block_w4a8_plan(int n, int k_half, int blk, int* plan) {
  if (n < 1 || blk < 8 || k_half < 1) return (int)cudaErrorInvalidValue;
  const int tn = 4 * block_groups(n);
  plan[0] = tn;
  plan[1] = (n + tn - 1) / tn;
  plan[2] = Segments(k_half, blk).count;
  return 0;
}
