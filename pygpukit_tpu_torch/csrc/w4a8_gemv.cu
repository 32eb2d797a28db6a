// w4a8 int4 GEMV for rows <= 8: y[r, n] = bf16((acc[r, n] * scale[n]) * sx[r])
// with acc[r, n] = sum_k xq[r, k] * w[n, k] in exact int32.
//
// Replaces pygpukit_tpu/kernels/gemv_quant.py
//   _gemv_w4a8_stacked_fusedq_pallas (:609, pallas_call :616), which
//   quantizes the activations inside the kernel, and _gemv_w4a8_stacked_pallas
//   (:534) and _gemv_w4a8_pallas (:457), the same math with the quantization
//   outside or on a 2-D weight (a layer of a stacked [L, N, K/2] weight is a
//   free view here).
//
// Bound: bytes. Decode streams every packed weight byte once per step (K/2
// bytes a column) for at most 8 activation rows: 2-12 MB a projection, 0.6-3.4
// us at 3.35 TB/s. At that size a call is a short chain of round trips, so
// the design keeps the chain short and the card full:
// - No prologue before the weights: a lane's first weight loads leave before
//   anything waits on the activations. xq is read straight into registers
//   from global memory (L1/L2; at most 45 KB, read by every block), never
//   staged whole in shared memory.
// - Integer tensor cores for the products: mma.sync m16n8k32 u8 x s8 -> s32.
//   Operand A is the weight, 16 output columns x 32 K values; operand B is
//   xq, its 8 columns the activation rows (zero past `rows`). The integer dot
//   is exact in any K order, so K is permuted: lane (g, t) (g = lane / 4, t =
//   lane % 4) loads one 16-byte chunk c of column g's packed bytes and the
//   same chunk of column g + 8, and its 8 words' 32 low and 32 high nibbles
//   are A's registers of four products as they stand; B of the same products
//   is xq[g][16c .. 16c + 15] and xq[g][K/2 + 16c ..], two 16-byte loads. No
//   shuffle moves a fragment. The 4 lanes of a group take 4 consecutive
//   chunks a round: 64 contiguous bytes of each of 16 columns, whole sectors.
// - Nibbles as unsigned: u = nibble ^ 8 is the signed value v plus 8 (one
//   LOP3 a word for the low nibbles, a shift and a LOP3 for the high ones),
//   so the products sum v xq + 8 xq; each lane also sums its xq bytes with
//   __dp4a, and acc = D - 8 S is exact.
// - The card full: a block owns a 16-column tile over all of K; its warps
//   split K (4 warps up to 32 chunks of a column, 8 up to 128, 16 above, so
//   a warp has at most 4 rounds of 4 chunks for K up to 8192), each with 4
//   rounds (8 weight vectors a lane) in flight before their math; the warps'
//   int32 sums meet in shared memory (exact, any order). N 2048 runs 128
//   blocks of 8 warps, N 11264 704. No sum crosses blocks, so no counter and
//   no scratch.
// - The two f32 multiplies are __fmul_rn (no FMA) and the bf16 store rounds
//   once, as the plain version; the output is bitwise its.
// The activation quantization is its own launch (w4a8_quant_kernel: a row
// a block, held in registers, one barrier; op for op act_quant.cuh), and
// this kernel is its programmatic dependent (pdl): the quantization signals
// griddepcontrol.launch_dependents first thing, so this grid starts while it
// runs, issues its first weight loads, then waits (griddepcontrol.wait) for
// xq and sx. pdl == 0 launches the two one after the other, for phase 3 of
// chip_smoke.py to time beside it. (Tried and removed: every block
// quantizing x into shared memory itself, as the reference's fusedq kernel
// does. It redoes the quantization in every block and measured slower than
// pdl at rows 1, 2, 5 and 8: PERF.md.)
#include "act_quant.cuh"

namespace {

constexpr int kTile = 16;          // output columns a block: the products' M
constexpr int kBatch = 4;          // rounds a lane has in flight, 2 weight vectors each
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

// Unsigned nibbles of a word's four bytes: u = nibble ^ 8 = v + 8 in [0, 15].
__device__ __forceinline__ unsigned lo_u(unsigned w) { return (w & 0x0F0F0F0Fu) ^ 0x08080808u; }
__device__ __forceinline__ unsigned hi_u(unsigned w) {
  return ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// d += A (16 x 32 u8) . B (32 x 8 s8)
__device__ __forceinline__ void mma_u8s8(int (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, int b0, int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The four products of one chunk: the low nibbles pair with xl (K 16c ..),
// the high with xh (K/2 + 16c ..); va is column g's chunk, vb column g + 8's.
__device__ __forceinline__ void chunk_products(int (&d)[4], const uint4& va, const uint4& vb,
                                               const int4& xl, const int4& xh) {
  mma_u8s8(d, lo_u(va.x), lo_u(vb.x), lo_u(va.y), lo_u(vb.y), xl.x, xl.y);
  mma_u8s8(d, lo_u(va.z), lo_u(vb.z), lo_u(va.w), lo_u(vb.w), xl.z, xl.w);
  mma_u8s8(d, hi_u(va.x), hi_u(vb.x), hi_u(va.y), hi_u(vb.y), xh.x, xh.y);
  mma_u8s8(d, hi_u(va.z), hi_u(vb.z), hi_u(va.w), hi_u(vb.w), xh.z, xh.w);
}

__device__ __forceinline__ int byte_sum(const int4& v, int s) {
  s = __dp4a(v.x, 0x01010101, s);
  s = __dp4a(v.y, 0x01010101, s);
  s = __dp4a(v.z, 0x01010101, s);
  return __dp4a(v.w, 0x01010101, s);
}

// 16 bytes of activations as floats (8 bf16 or 4 f32)
template <typename T>
__device__ __forceinline__ float x_at(const uint4& raw, int i) {
  if constexpr (sizeof(T) == 4) {
    return reinterpret_cast<const float*>(&raw)[i];
  } else {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&raw)[i]);
  }
}

// The quantization before the GEMV: one block a row holds the row in
// registers (16-byte loads, kQuantVecs a thread), so it reads x once and
// meets one barrier; op for op act_quant.cuh (sx = max(amax / 127, 1e-12)
// by an IEEE divide, xq = clamp(rintf(x / sx), -127, 127)), whose launch
// takes the rows too long for the registers. It signals
// griddepcontrol.launch_dependents first, so a GEMV launched as its
// programmatic dependent starts while it runs. (act_quant.cuh's kernel, one
// pass for the amax and one to quantize, cost the GEMV about twice as much:
// PERF.md.)
constexpr int kQuantThreads = 256;
constexpr int kQuantVecs = 6;

template <typename T>
__host__ __device__ constexpr int quant_max_k() {
  return kQuantThreads * kQuantVecs * (16 / (int)sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
w4a8_quant_kernel(const T* __restrict__ x, int k, int8_t* __restrict__ xq,
                  float* __restrict__ sx) {
  asm volatile("griddepcontrol.launch_dependents;");
  constexpr int kPer = 16 / sizeof(T);
  __shared__ float red[kQuantThreads / 32];
  const T* xr = x + (size_t)blockIdx.x * k;
  uint4 v[kQuantVecs];
#pragma unroll
  for (int j = 0; j < kQuantVecs; ++j) {
    const int i = (threadIdx.x + j * kQuantThreads) * kPer;
    v[j] = i < k ? *reinterpret_cast<const uint4*>(xr + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < kQuantVecs; ++j)
#pragma unroll
    for (int e = 0; e < kPer; ++e) m = fmaxf(m, fabsf(x_at<T>(v[j], e)));
  m = pgk_warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) m = fmaxf(m, red[w]);
  const float s = fmaxf(m / 127.0f, 1e-12f);
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  int8_t* qr = xq + (size_t)blockIdx.x * k;
#pragma unroll
  for (int j = 0; j < kQuantVecs; ++j) {
    const int i = (threadIdx.x + j * kQuantThreads) * kPer;
    if (i < k) {
      uint32_t q[kPer / 4];
#pragma unroll
      for (int w4 = 0; w4 < kPer / 4; ++w4) {
        q[w4] = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float t = fminf(fmaxf(rintf(x_at<T>(v[j], 4 * w4 + e) / s), -127.f), 127.f);
          q[w4] |= (uint32_t)(uint8_t)(int8_t)t << (8 * e);
        }
      }
      if constexpr (kPer == 8) {
        *reinterpret_cast<uint2*>(qr + i) = make_uint2(q[0], q[1]);
      } else {
        *reinterpret_cast<uint32_t*>(qr + i) = q[0];
      }
    }
  }
}

template <typename T>
cudaError_t launch_quant(const void* x, int rows, int k, int8_t* xq, float* sx,
                         cudaStream_t st) {
  if (k > quant_max_k<T>()) return pgk_act_quant(x, sizeof(T) == 4, rows, k, xq, sx, st);
  w4a8_quant_kernel<T><<<rows, kQuantThreads, 0, st>>>(static_cast<const T*>(x), k, xq, sx);
  return cudaGetLastError();
}

// W warps a block over the 16 columns n0 .. n0 + 15 of tile blockIdx.x;
// warp w takes the 16-byte chunks [w nch / W, (w + 1) nch / W) of every
// column, lane t of each group of 4 the chunks c0 + 4 i + t (round i).
template <int W>
__global__ void __launch_bounds__(32 * W, 32 / W)
w4a8_gemv_kernel(const uint8_t* __restrict__ w, const float* __restrict__ scale,
                 const int8_t* xq, const float* sx, __nv_bfloat16* __restrict__ out, int rows,
                 int n, int k_half) {
  __shared__ int red[W][kMaxRows][kTile];    // each warp's D, [activation row][column]
  __shared__ int sred[W][kMaxRows];          // each warp's xq byte sums
  __shared__ float sxs[kMaxRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k = 2 * k_half;
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

  // 2. the quantization's xq and sx: the wait a programmatic launch needs
  // (an ordinary one passes it at once)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (threadIdx.x < rows) sxs[threadIdx.x] = sx[threadIdx.x];

  // 3. the products, batch by batch
  int d[4] = {0, 0, 0, 0};
  int s = 0;
  const int8_t* xrow = xq + (size_t)g * k;
  for (int i0 = 0; i0 < rounds; i0 += kBatch) {
    if (i0 > 0) load(i0);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i0 + u < rounds) {                       // uniform across the warp
        const int c = c0 + 4 * (i0 + u) + t;
        int4 xl = make_int4(0, 0, 0, 0), xh = xl;
        if (g < rows && c < c1) {
          xl = *reinterpret_cast<const int4*>(xrow + 16 * c);
          xh = *reinterpret_cast<const int4*>(xrow + k_half + 16 * c);
        }
        s = byte_sum(xh, byte_sum(xl, s));
        chunk_products(d, va[u], vb[u], xl, xh);
      }
    }
  }

  // 4. the warps' exact sums meet; acc = D - 8 S; two f32 multiplies
  red[warp][2 * t][g] = d[0];
  red[warp][2 * t + 1][g] = d[1];
  red[warp][2 * t][g + 8] = d[2];
  red[warp][2 * t + 1][g + 8] = d[3];
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  if (t == 0) sred[warp][g] = s;
  __syncthreads();
  if (stores) {
    int dd = 0, ss = 0;
#pragma unroll
    for (int v = 0; v < W; ++v) {
      dd += red[v][er][ec];
      ss += sred[v][er];
    }
    const int acc = dd - 8 * ss;
    out[(size_t)er * n + n0 + ec] =
        __float2bfloat16_rn(__fmul_rn(__fmul_rn((float)acc, esc), sxs[er]));
  }
}

template <int W>
cudaError_t launch_gemv(const uint8_t* w, const float* scale, const int8_t* xq, const float* sx,
                        __nv_bfloat16* out, int rows, int n, int k_half, int pdl,
                        cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kTile - 1) / kTile);
  cfg.blockDim = dim3(32 * W);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, w4a8_gemv_kernel<W>, w, scale, xq, sx, out, rows, n, k_half);
}

}  // namespace

// x [rows, 2*k_half] bf16 (x_f32 == 0) or f32, row-major, 16-byte aligned;
// w [n, k_half] uint8, 16-byte aligned; scale [n] f32; xq [rows, 2*k_half]
// int8 (16-byte aligned) and sx [rows] f32 are scratch; out [rows, n] bf16.
// The quantization (w4a8_quant_kernel, or act_quant.cuh's launch past
// quant_max_k) runs first; pdl != 0 launches this kernel as its programmatic
// dependent. Requires rows <= 8 and k_half % 16 == 0.
PGK_API int pgk_w4a8_gemv(const void* x, int x_f32, const void* w, const void* scale, void* xq,
                          void* sx, void* out, int rows, int n, int k_half, int pdl,
                          void* stream) {
  if (rows < 1 || rows > kMaxRows || k_half < 16 || k_half % 16 != 0 || n < 1 ||
      xq == nullptr || sx == nullptr || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(xq) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(sx);
  cudaError_t e = x_f32 ? launch_quant<float>(x, rows, 2 * k_half, q, s, st)
                        : launch_quant<__nv_bfloat16>(x, rows, 2 * k_half, q, s, st);
  if (e != cudaSuccess) return (int)e;
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const int warps = gemv_warps(k_half);
  e = warps == 4   ? launch_gemv<4>(wb, sc, q, s, o, rows, n, k_half, pdl, st)
      : warps == 8 ? launch_gemv<8>(wb, sc, q, s, o, rows, n, k_half, pdl, st)
                   : launch_gemv<16>(wb, sc, q, s, o, rows, n, k_half, pdl, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The launch plan (kernels/gemv_quant.py w4a8_gemv_plan is the same rule):
// plan[0..2] = columns a block, blocks, warps a block.
PGK_API int pgk_w4a8_gemv_plan(int rows, int n, int k_half, int* plan) {
  if (rows < 1 || rows > kMaxRows || n < 1 || k_half < 16 || k_half % 16)
    return (int)cudaErrorInvalidValue;
  plan[0] = kTile;
  plan[1] = (n + kTile - 1) / kTile;
  plan[2] = gemv_warps(k_half);
  return 0;
}
