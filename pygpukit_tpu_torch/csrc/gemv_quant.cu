// Quantized-storage GEMV: y[n] = bf16((sum_k bf16(W[n, k]) * bf16(x[k])) *
// scale[n]), sums in f32, W an N-major [N, K] weight (K contiguous per output)
// in fp8 e4m3fn, fp8 e5m2, int8 or bf16.
//
// Replaces pygpukit_tpu/kernels/gemv_quant.py _gemv_pallas (:54, pallas_call
// :59; gemv_quant :82, the library GEMV over quantized storage). Its bn/bk
// tiles and the 7 padding rows of x are TPU tiling and have no counterpart
// here.
//
// Bound: bytes. Every weight byte is read once: N K elt bytes (x, scale and
// y are small), two flops per weight element. The four 1.1B projections
// move 88 MB in bf16 (26.3 us at 3.35 TB/s) and half that in fp8 or int8.
// The first port (x converted into shared memory by every block before its
// first weight load, one FMA chain a lane, four vectors in flight, one
// convert per element) streamed fp8 and int8 no faster than bf16. So:
// - no prologue: a warp's first weight loads leave before anything else;
//   x is read from global memory through L1 (it is small and every warp
//   reads it), the weights with no L1 allocation so they do not evict it;
// - a warp owns a row, and its 32 lanes walk consecutive 16-byte vectors
//   (coalesced), eight of them a lane in flight at once (4 KB a warp)
//   before the math of the batch; at one warp a row and 63 registers a
//   thread, an SM holds enough warps that their loads cover each other's
//   math. (Measured on the H100: two or four rows a warp, sharing each
//   converted x between them, or 16 vectors in flight, ran slower, as did
//   a persistent grid fed by TMA bulk copies through a shared-memory ring:
//   four consumer warps an SM could not convert fp8 fast enough);
// - paired converts: fp8x2 -> f16x2 by one cvt, then f32 (exact); int8 to
//   f32 by the 2^23 magic (exact, no int-to-float convert); bf16 by a shift
//   or a mask;
// - four accumulators a lane (element pair i into i % 4), folded (a0 + a1)
//   + (a2 + a3), then the warp's lanes by xor shuffles: a fixed order, so a
//   replay gives the same bits.
// Rows that are not whole 16-byte vectors on 16-byte boundaries (K * elt %
// 16 != 0, or w off 16 bytes) take the same walk over the row's whole
// vectors, after a scalar head up to its first boundary and with a scalar
// tail; there, and when x is off 16 bytes, each vector's x comes from the
// aligned vectors around it, shifted into place in registers.
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Kind { kE4M3 = 0, kE5M2 = 1, kInt8 = 2, kBf16 = 3 };
constexpr int kWarps = 4;          // warps per block, a row each
constexpr int kBatch = 8;          // 16-byte vectors a lane has in flight
constexpr int kAcc = 4;            // accumulators per row and lane

template <int KIND>
struct Storage {
  using T = uint8_t;
};
template <>
struct Storage<kBf16> {
  using T = bf16;
};

__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Element pair p (0 <= p < 16 / (2 * elt)) of a 16-byte vector, as f32.
template <int KIND>
__device__ __forceinline__ float2 pair_f32(const uint4& v, int p) {
  const uint32_t wd = (&v.x)[(KIND == kBf16 ? p : p >> 1)];
  if constexpr (KIND == kBf16) {
    return make_float2(__uint_as_float(wd << 16), __uint_as_float(wd & 0xffff0000u));
  } else if constexpr (KIND == kInt8) {
    const uint32_t u = wd ^ 0x80808080u;           // offset binary: v + 128
    const uint32_t sel = (p & 1) ? 0x5442u : 0x5440u;
    return make_float2(__uint_as_float(__byte_perm(u, 0x4B00u, sel)) - 8388736.f,
                       __uint_as_float(__byte_perm(u, 0x4B00u, sel + 1)) - 8388736.f);
  } else {
    const __nv_fp8x2_storage_t pair = (__nv_fp8x2_storage_t)((p & 1) ? wd >> 16 : wd & 0xffffu);
    const __half2_raw h =
        __nv_cvt_fp8x2_to_halfraw2(pair, KIND == kE4M3 ? __NV_E4M3 : __NV_E5M2);
    return __half22float2(*reinterpret_cast<const __half2*>(&h));
  }
}

// x[k0 .. k0 + 2 * kPairs) rounded to bf16, as f32 pairs; k0 is a multiple
// of the vector's element count, so the loads are 16-byte aligned.
template <bool XF32, int kPairs>
__device__ __forceinline__ void load_x(const void* x, int k0, float2 (&xf)[kPairs]) {
  if constexpr (XF32) {
    const float4* xv = reinterpret_cast<const float4*>(static_cast<const float*>(x) + k0);
#pragma unroll
    for (int i = 0; i < kPairs / 2; ++i) {
      const float4 f = __ldg(xv + i);
      xf[2 * i] = make_float2(__bfloat162float(__float2bfloat16_rn(f.x)),
                              __bfloat162float(__float2bfloat16_rn(f.y)));
      xf[2 * i + 1] = make_float2(__bfloat162float(__float2bfloat16_rn(f.z)),
                                  __bfloat162float(__float2bfloat16_rn(f.w)));
    }
  } else {
    const uint4* xv = reinterpret_cast<const uint4*>(static_cast<const bf16*>(x) + k0);
#pragma unroll
    for (int i = 0; i < kPairs / 4; ++i) {
      const uint4 u = __ldg(xv + i);
#pragma unroll
      for (int j = 0; j < 4; ++j) xf[4 * i + j] = pair_f32<kBf16>(u, j);
    }
  }
}

// x[i] rounded to bf16, as f32.
template <bool XF32>
__device__ __forceinline__ float x_at(const void* x, int i) {
  return XF32 ? __bfloat162float(__float2bfloat16_rn(__ldg(static_cast<const float*>(x) + i)))
              : __bfloat162float(__ldg(static_cast<const bf16*>(x) + i));
}

// load_x for any k0 and any x alignment: the 16-byte aligned vectors that
// hold x[k0 .. k0 + 2 kPairs), one more than aligned values need, their
// 32-bit words moved into place by q = r / 4 whole words (selects of a
// warp-uniform q, so no local memory) and, for bf16, half a word (a funnel
// shift), r being the start's offset in its vector. The last vector holds
// a value the call needs, so no read leaves x's 16-byte blocks.
template <bool XF32, int kPairs>
__device__ __forceinline__ void load_x_any(const void* x, int k0, float2 (&xf)[kPairs]) {
  constexpr int kWords = XF32 ? 2 * kPairs : kPairs;     // 32-bit words of x needed
  constexpr int kVecs = kWords / 4 + 1;
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) + (size_t)k0 * (XF32 ? 4 : 2);
  const int r = (int)(a & 15);
  if (r == 0) {
    load_x<XF32>(x, k0, xf);
    return;
  }
  const uint4* base = reinterpret_cast<const uint4*>(a - r);
  uint32_t w[4 * kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const uint4 u = __ldg(base + i);
    w[4 * i] = u.x;
    w[4 * i + 1] = u.y;
    w[4 * i + 2] = u.z;
    w[4 * i + 3] = u.w;
  }
  const int q = r >> 2;
  uint32_t sw[kWords + 1];
#pragma unroll
  for (int i = 0; i <= kWords; ++i)
    sw[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  if constexpr (XF32) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p)
      xf[p] = make_float2(__bfloat162float(__float2bfloat16_rn(__uint_as_float(sw[2 * p]))),
                          __bfloat162float(__float2bfloat16_rn(__uint_as_float(sw[2 * p + 1]))));
  } else {
    const int sh = (r & 2) * 8;
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const uint32_t wd = __funnelshift_r(sw[p], sw[p + 1], sh);
      xf[p] = make_float2(__uint_as_float(wd << 16), __uint_as_float(wd & 0xffff0000u));
    }
  }
}

template <int KIND>
__device__ __forceinline__ void fold_vector(const uint4& w, const float2* xf, float (&acc)[kAcc]) {
  constexpr int kPairs = 8 / (int)sizeof(typename Storage<KIND>::T);
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const float2 wf = pair_f32<KIND>(w, p);
    acc[p % kAcc] = fmaf(wf.x, xf[p].x, acc[p % kAcc]);
    acc[p % kAcc] = fmaf(wf.y, xf[p].y, acc[p % kAcc]);
  }
}

__device__ __forceinline__ void store_row(bf16* out, const float* scale, int row, float s) {
  out[row] = __float2bfloat16_rn(scale != nullptr ? s * scale[row] : s);
}

template <int KIND>
__device__ __forceinline__ float elem_f32(typename Storage<KIND>::T v) {
  if constexpr (KIND == kE4M3) {
    __nv_fp8_e4m3 f;
    f.__x = (__nv_fp8_storage_t)v;
    return float(f);
  } else if constexpr (KIND == kE5M2) {
    __nv_fp8_e5m2 f;
    f.__x = (__nv_fp8_storage_t)v;
    return float(f);
  } else if constexpr (KIND == kInt8) {
    return (float)(int8_t)v;
  } else {
    return __bfloat162float(v);
  }
}

// Warp gw: row gw, 16-byte vectors v = base + 32 u + lane, kBatch of them
// loaded before their math. kAligned: every row starts on a 16-byte
// boundary and is whole vectors, and x is 16-byte aligned; otherwise the
// vectors start at the row's first boundary, after a head of fewer than 16
// bytes, a tail of fewer than 16 follows (a lane an element of each), and
// x takes load_x_any.
template <int KIND, bool XF32, bool kAligned>
__global__ void __launch_bounds__(kWarps * 32)
gemv_quant_kernel(const void* __restrict__ w, const void* __restrict__ x,
                  const float* __restrict__ scale, bf16* __restrict__ out, int n, int k) {
  using T = typename Storage<KIND>::T;
  constexpr int kEl = 16 / (int)sizeof(T);          // elements per vector
  constexpr int kPairs = kEl / 2;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const T* wr = static_cast<const T*>(w) + (size_t)row * k;
  const int head =
      kAligned ? 0 : min(k, (int)(((16 - ((uintptr_t)wr & 15)) & 15) / sizeof(T)));
  const int n_vec = (k - head) / kEl;
  const uint4* wv = reinterpret_cast<const uint4*>(wr + head);
  float acc[kAcc] = {};
  for (int base = 0; base < n_vec; base += 32 * kBatch) {
    uint4 wb[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int v = base + u * 32 + lane;
      if (v < n_vec) wb[u] = ld_stream(wv + v);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int v = base + u * 32 + lane;
      if (v < n_vec) {
        float2 xf[kPairs];
        if constexpr (kAligned)
          load_x<XF32>(x, v * kEl, xf);
        else
          load_x_any<XF32>(x, head + v * kEl, xf);
        fold_vector<KIND>(wb[u], xf, acc);
      }
    }
  }
  if constexpr (!kAligned) {
    if (lane < head) acc[0] = fmaf(elem_f32<KIND>(wr[lane]), x_at<XF32>(x, lane), acc[0]);
    const int i = head + n_vec * kEl + lane;
    if (i < k) acc[1] = fmaf(elem_f32<KIND>(wr[i]), x_at<XF32>(x, i), acc[1]);
  }
  const float s = pgk_warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
  if (lane == 0) store_row(out, scale, row, s);
}

template <int KIND, bool XF32>
cudaError_t launch_gemv(const void* w, const void* x, const float* scale, bf16* out, int n,
                        int k, cudaStream_t st) {
  constexpr int kElt = (int)sizeof(typename Storage<KIND>::T);
  const bool aligned =
      (uintptr_t)w % 16 == 0 && (uintptr_t)x % 16 == 0 && (size_t)k * kElt % 16 == 0;
  const int grid = (n + kWarps - 1) / kWarps;
  if (aligned)
    gemv_quant_kernel<KIND, XF32, true><<<grid, kWarps * 32, 0, st>>>(w, x, scale, out, n, k);
  else
    gemv_quant_kernel<KIND, XF32, false><<<grid, kWarps * 32, 0, st>>>(w, x, scale, out, n, k);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_kind(const void* w, const void* x, int x_f32, const float* scale, bf16* out,
                        int n, int k, cudaStream_t st) {
  return x_f32 ? launch_gemv<KIND, true>(w, x, scale, out, n, k, st)
               : launch_gemv<KIND, false>(w, x, scale, out, n, k, st);
}

}  // namespace

// w [n, k] of `kind` (0 fp8 e4m3fn, 1 fp8 e5m2, 2 int8, 3 bf16), rows
// contiguous; x [k] f32 (x_f32 != 0) or bf16; scale [n] f32 or null (1.0);
// out [n] bf16. Requires n, k >= 1. A row a warp, four warps a block
// (kernels/gemv_quant.py gemv_quant_plan mirrors the walk); rows that are
// not whole 16-byte vectors on 16-byte boundaries add a scalar head and
// tail.
PGK_API int pgk_gemv_quant(const void* w, int kind, const void* x, int x_f32,
                           const void* scale, void* out, int n, int k, void* stream) {
  if (n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  bf16* o = static_cast<bf16*>(out);
  switch (kind) {
    case kE4M3: return (int)launch_kind<kE4M3>(w, x, x_f32, sc, o, n, k, st);
    case kE5M2: return (int)launch_kind<kE5M2>(w, x, x_f32, sc, o, n, k, st);
    case kInt8: return (int)launch_kind<kInt8>(w, x, x_f32, sc, o, n, k, st);
    case kBf16: return (int)launch_kind<kBf16>(w, x, x_f32, sc, o, n, k, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The walk's constants for kernels/gemv_quant.py's mirror: plan[0] warps a
// block (a row each), plan[1] the 16-byte vectors a lane has in flight.
PGK_API int pgk_gemv_quant_plan(int* plan) {
  plan[0] = kWarps;
  plan[1] = kBatch;
  return 0;
}
