// int4 w4a16 GEMV for rows <= 8: y[r, n] = bf16(acc[r, n] * scale[n]) with
// acc[r, n] = sum_k x[r, k] * nibble(n, k) in f32 and x rounded to bf16.
//
// Replaces pygpukit_tpu/kernels/gemv_quant.py _gemv_packed_pallas (:158,
// pallas_call :164) and _gemv_packed_stacked_pallas (:210, :216): the same
// _packed_tile_dots math (:123) on a 2-D [N, K/2] or a stacked [L, N, K/2]
// weight (here a layer of a stack is a free view). The reference multiplies
// x_hi / 16 by the high nibble * 16; both factors are exact powers of two
// apart, so x_hi * nibble is the same product.
//
// Bound: bytes. Decode streams every packed weight byte once per step (K/2
// bytes a column, split-half packed: byte r of column n holds K row r in
// its low nibble and K row K/2 + r in its high one) for at most 8 rows of
// x: 2-12 MB a projection, 6.6 us for the 1.1B model's four at 3.35 TB/s.
// The design is w4a8_gemv.cu's on bf16 tensor cores:
// - Products: mma.sync m16n8k16 bf16 -> f32 with the weight as A (16
//   output columns) and x as B (the activation rows as n 8, zero past
//   `rows`). Every product of a bf16 x and a nibble is exact in f32, so
//   only the order of the f32 sums differs from the plain version, and
//   that order is fixed.
// - Fragments without a shuffle: a byte's two nibbles (K rows r and K/2 +
//   r) are one A register's k pair, so the mma's k runs over such pairs.
//   Lane (g, t) (g = lane / 4, t = lane % 4) loads one 16-byte chunk c of
//   column g's packed bytes and the same chunk of column g + 8; k-step j of
//   the chunk takes its bytes 2j (k pair t) and 2j + 1 (k pair t + 4), so a
//   16-byte load is 8 k-steps of A as loaded. B is x paired alike: x[g][r]
//   and x[g][K/2 + r] of the same rows, one PRMT a register. The 4 lanes
//   of a group take 4 consecutive chunks a round: 64 contiguous bytes of
//   each of 16 columns, whole sectors.
// - Dequantization: w4a16_mma.cuh's nibble pair (PRMT, LOP3, HSUB2: the
//   exact signed nibbles as bf16x2), without a multiply: the scale is the
//   column's and is applied once to the f32 sum.
// - The card full: a block owns a 16-column tile over all of K and its
//   warps split K (4 warps up to 32 chunks of a column, 8 up to 128, 16
//   above, as w4a8_gemv.cu); a lane has kBatch rounds (2 kBatch weight
//   vectors) in flight before their math. N 2048 runs 128 blocks, N 11264
//   704. (4 rounds in flight, half the warps and an ordinary launch
//   measured slower; 1 or 3 rounds, twice the warps and no L2 hint within
//   1%: PERF.md.)
// - The warps' f32 sums meet in shared memory and are added in ascending
//   warp order; no sum crosses blocks, so no scratch, no counter, no
//   atomics: a launch and a graph replay give the same bits.
// - The store: one __fmul_rn by the column's scale, one bf16 round.
// - The launch: the programmatic dependent of the grid before it on the
//   stream. The first weights and the scale are loaded before
//   griddepcontrol.wait, x after it (an ordinary launch passes it at once,
//   and stream capture keeps the edge).
#include "w4a16_mma.cuh"

namespace {

constexpr int kTile = 16;          // output columns a block: the products' M
constexpr int kBatch = 2;          // rounds a lane has in flight, 2 weight vectors each
constexpr int kMaxRows = 8;        // activation rows: the products' N
// 16-byte chunks of a column up to which a block runs 4 warps, then 8 (16 above)
constexpr int kNarrowChunks = 32;
constexpr int kWideChunks = 128;
__host__ __device__ inline int gemv_warps(int k_half) {
  return k_half / 16 <= kNarrowChunks ? 4 : k_half / 16 <= kWideChunks ? 8 : 16;
}

// A packed weight chunk, streamed past L1 (read once); volatile so it is
// issued where it stands, ahead of the wait.
__device__ __forceinline__ uint4 ld_weights(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The two k-steps of word q of a chunk (bytes 4q .. 4q + 3): wa is column
// g's word, wb column g + 8's; xl / xh the x words of the same K rows in
// the low and high half (word 2q + s holds rows 2(2q + s), + 1).
__device__ __forceinline__ void word_products(float (&d)[4], uint32_t wa, uint32_t wb,
                                              uint32_t xl0, uint32_t xh0, uint32_t xl1,
                                              uint32_t xh1) {
  using w4a16::as_u32;
  using w4a16::nibble_pair;
  const uint32_t wa4 = wa >> 4, wb4 = wb >> 4;
  w4a16::mma_bf16(d, as_u32(nibble_pair<0>(wa, wa4)), as_u32(nibble_pair<0>(wb, wb4)),
                  as_u32(nibble_pair<1>(wa, wa4)), as_u32(nibble_pair<1>(wb, wb4)),
                  __byte_perm(xl0, xh0, 0x5410), __byte_perm(xl0, xh0, 0x7632));
  w4a16::mma_bf16(d, as_u32(nibble_pair<2>(wa, wa4)), as_u32(nibble_pair<2>(wb, wb4)),
                  as_u32(nibble_pair<3>(wa, wa4)), as_u32(nibble_pair<3>(wb, wb4)),
                  __byte_perm(xl1, xh1, 0x5410), __byte_perm(xl1, xh1, 0x7632));
}

// W warps a block over the 16 columns n0 .. n0 + 15 of tile blockIdx.x;
// warp w takes the 16-byte chunks [w nch / W, (w + 1) nch / W) of every
// column, lane t of each group of 4 the chunks c0 + 4 i + t (round i).
template <int W>
__global__ void __launch_bounds__(32 * W)
w4a16_gemv_kernel(const uint8_t* __restrict__ w, const float* __restrict__ scale,
                  const __nv_bfloat16* x, __nv_bfloat16* __restrict__ out, int rows, int n,
                  int k_half) {
  __shared__ float red[W][kMaxRows][kTile];    // each warp's D, [activation row][column]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kTile;
  const int nch = k_half / 16;
  const int c0 = warp * nch / W, c1 = (warp + 1) * nch / W;
  const int rounds = (c1 - c0 + 3) / 4;
  // a ragged tile's lanes past N read column N - 1 and store nothing
  const uint8_t* wa = w + (size_t)min(n0 + g, n - 1) * k_half;
  const uint8_t* wb = w + (size_t)min(n0 + g + 8, n - 1) * k_half;

  uint4 va[kBatch], vb[kBatch];
  auto load = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + 4 * (i0 + u) + t;
      if (c < c1) {
        va[u] = ld_weights(wa + 16 * c);
        vb[u] = ld_weights(wb + 16 * c);
      } else {
        va[u] = vb[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  // 1. the first weights on their way; the epilogue's scale behind them
  load(0);
  const int er = threadIdx.x / kTile, ec = threadIdx.x % kTile;
  const bool stores = er < rows && n0 + ec < n;
  const float esc = stores ? scale[n0 + ec] : 0.f;

  // 2. x is the grid before's: the wait a programmatic launch needs
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // 3. the products, batch by batch
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  const __nv_bfloat16* xrow = x + (size_t)g * 2 * k_half;
  const bool xlive = g < rows;
  for (int i0 = 0; i0 < rounds; i0 += kBatch) {
    if (i0 > 0) load(i0);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i0 + u < rounds) {                       // uniform across the warp
        const int c = c0 + 4 * (i0 + u) + t;
        uint4 xl[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
        uint4 xh[2] = {xl[0], xl[1]};
        if (xlive && c < c1) {
          const uint4* pl = reinterpret_cast<const uint4*>(xrow + 16 * c);
          const uint4* ph = reinterpret_cast<const uint4*>(xrow + k_half + 16 * c);
          xl[0] = __ldg(pl);
          xl[1] = __ldg(pl + 1);
          xh[0] = __ldg(ph);
          xh[1] = __ldg(ph + 1);
        }
        // bytes 0-7 pair with x rows 0-7 of the chunk (xl[0], xh[0]), 8-15 with 8-15
        word_products(d, va[u].x, vb[u].x, xl[0].x, xh[0].x, xl[0].y, xh[0].y);
        word_products(d, va[u].y, vb[u].y, xl[0].z, xh[0].z, xl[0].w, xh[0].w);
        word_products(d, va[u].z, vb[u].z, xl[1].x, xh[1].x, xl[1].y, xh[1].y);
        word_products(d, va[u].w, vb[u].w, xl[1].z, xh[1].z, xl[1].w, xh[1].w);
      }
    }
  }

  // 4. the warps' sums meet, in ascending warp order; one multiply, one round
  red[warp][2 * t][g] = d[0];
  red[warp][2 * t + 1][g] = d[1];
  red[warp][2 * t][g + 8] = d[2];
  red[warp][2 * t + 1][g + 8] = d[3];
  __syncthreads();
  if (stores) {
    float acc = red[0][er][ec];
#pragma unroll
    for (int v = 1; v < W; ++v) acc = __fadd_rn(acc, red[v][er][ec]);
    out[(size_t)er * n + n0 + ec] = __float2bfloat16_rn(__fmul_rn(acc, esc));
  }
}

template <int W>
cudaError_t launch_gemv(const uint8_t* w, const float* scale, const __nv_bfloat16* x,
                        __nv_bfloat16* out, int rows, int n, int k_half, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kTile - 1) / kTile);
  cfg.blockDim = dim3(32 * W);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, w4a16_gemv_kernel<W>, w, scale, x, out, rows, n, k_half);
}

}  // namespace

// x [rows, 2*k_half] bf16, row-major, 16-byte aligned; w [n, k_half] uint8,
// 16-byte aligned; scale [n] f32; out [rows, n] bf16. Requires rows <= 8 and
// k_half % 16 == 0.
PGK_API int pgk_w4a16_gemv(const void* x, const void* w, const void* scale, void* out,
                           int rows, int n, int k_half, void* stream) {
  if (rows < 1 || rows > kMaxRows || k_half < 16 || k_half % 16 != 0 || n < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const int warps = gemv_warps(k_half);
  const cudaError_t e = warps == 4 ? launch_gemv<4>(wb, sc, xb, o, rows, n, k_half, st)
                        : warps == 8 ? launch_gemv<8>(wb, sc, xb, o, rows, n, k_half, st)
                                     : launch_gemv<16>(wb, sc, xb, o, rows, n, k_half, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The launch plan (kernels/gemv_quant.py w4a16_plan is the same rule):
// plan[0..3] = columns a block, blocks, warps a block, rounds a lane has in
// flight.
PGK_API int pgk_w4a16_plan(int rows, int n, int k_half, int* plan) {
  if (rows < 1 || rows > kMaxRows || n < 1 || k_half < 16 || k_half % 16)
    return (int)cudaErrorInvalidValue;
  plan[0] = kTile;
  plan[1] = (n + kTile - 1) / kTile;
  plan[2] = gemv_warps(k_half);
  plan[3] = kBatch;
  return 0;
}
