// One decode query per head against a KV sequence: the body shared by
// batch_decode_attention.cu (dense serving pools) and paged_attention.cu
// (block pools behind a block table). The two kernels differ only in where
// position p's K and V rows (and int8 row scales) live, which they pass in
// as a row-offset functor; everything below is the same arithmetic.
//
// Replaces the reference's _bda_kernel (pygpukit_tpu/kernels/
// batch_decode_attention.py) and _paged_kernel (kernels/paged_attention.py).
//
// Bound: bytes. A call reads every live K and V row of every slot once:
// 2 * live * Hk * D * elt bytes (4.69 MB in bf16 at batch 8, MAX 1024 and the
// 1.1B shape, 1.4 us at 3.35 TB/s) for G = Hq/Hk dot products a row, far
// below the tensor cores' rate. What held the first port back was not the
// arithmetic but latency: one block per (slot, kv head) gave B * Hk = 32
// blocks for 132 SMs, each walking its chunks one after another with no load
// in flight during the math. So:
// - split-KV: pass one runs one block per (split, slot, kv head). n_split
//   comes from the shapes alone (B, Hk, MAX; kernels/batch_decode_attention.
//   attention_splits), and each block reads its slot's ctx from device
//   memory and takes an equal share, in 64-row chunks, of the live window
//   [max(ctx - window, 0), min(ctx, MAX)) (split_bounds there, mirrored
//   below). The launch plan never reads the host, so a step captures into a
//   CUDA graph. Each block writes its (m, l, acc); pass two folds the splits
//   in ascending order, as flash_decode_combine_kernel does. An empty split
//   writes m = -1e30, l = 0 and weighs nothing. No atomics: a replay is
//   bitwise.
// - K and V chunks arrive by 16-byte cp.async into a two-stage ring, the
//   next chunk's load in flight during this chunk's math; ragged edges and
//   dead rows are zero-filled through the source size. Shared rows are
//   padded by 16 bytes (an odd number of 16-byte units), so the score
//   loop's one-row-per-lane 16-byte reads hit distinct banks.
// - Every storage the reference takes converts in-kernel: bf16, f32, fp8
//   e4m3/e5m2 and int8 values go to the query dtype (exact but for f32
//   storage under bf16 queries), int8 {"q", "s"} row scales fold into the
//   score column (after * scale, before the softcap) and into p (after the
//   row sum l, before P is rounded). fp8 and int8 halve the bytes read.
// - Tensor cores are not used: the G = 8 heads of a kv group would fill half
//   of an m16n8k16 row tile, the products are a small share of the time of
//   a byte-bound chunk, and CUDA-core f32 FMAs keep one code path for all
//   storages and the exact f32 route.
// The arithmetic is the reference's: s = (q.k) * scale, optional softcap
// cap * tanh(s / cap), -1e30 and p = 0 on dead positions (pos >= live or pos
// < ctx - window), l floored at 1e-30, P rounded to the query dtype before
// P@V (f32 queries keep it f32).
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include <type_traits>

#include "mma.cuh"

constexpr int kPgkAttnChunk = 64;
constexpr int kPgkAttnStages = 2;
constexpr float kPgkAttnNegInf = -1e30f;

// storage kinds, as kernels/batch_decode_attention.py _KV_KINDS numbers them
enum : int { kPgkKvBf16 = 0, kPgkKvF32 = 1, kPgkKvE4m3 = 2, kPgkKvE5m2 = 3, kPgkKvInt8 = 4 };

template <class T>
__device__ __forceinline__ float pgk_kv_f32(T v) { return float(v); }
template <>
__device__ __forceinline__ float pgk_kv_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float pgk_kv_f32<int8_t>(int8_t v) { return (float)v; }

// A stored value in the query dtype, as f32 (only f32 storage under bf16
// queries rounds).
template <class Q, class KV>
__device__ __forceinline__ float pgk_kv_as_q(KV v) {
  const float f = pgk_kv_f32(v);
  if constexpr (std::is_same<Q, __nv_bfloat16>::value && std::is_same<KV, float>::value)
    return __bfloat162float(__float2bfloat16_rn(f));
  return f;
}

// Two neighbouring stored values in the query dtype: fp8 through one paired
// convert to f16 (exact), int8 by the 2^23 magic (exact; no int-to-float
// convert), the rest one at a time.
template <class Q, class KV>
__device__ __forceinline__ float2 pgk_kv2_as_q(const KV* e) {
  if constexpr (std::is_same<KV, __nv_fp8_e4m3>::value || std::is_same<KV, __nv_fp8_e5m2>::value) {
    const __nv_fp8x2_storage_t pair = *reinterpret_cast<const __nv_fp8x2_storage_t*>(e);
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        pair, std::is_same<KV, __nv_fp8_e4m3>::value ? __NV_E4M3 : __NV_E5M2);
    return __half22float2(*reinterpret_cast<const __half2*>(&h));
  } else if constexpr (std::is_same<KV, int8_t>::value) {
    const uint32_t u = (uint32_t)(*reinterpret_cast<const uint16_t*>(e)) ^ 0x8080u;
    return make_float2(__uint_as_float(__byte_perm(u, 0x4B00u, 0x5440u)) - 8388736.f,
                       __uint_as_float(__byte_perm(u, 0x4B00u, 0x5441u)) - 8388736.f);
  } else {
    return make_float2(pgk_kv_as_q<Q>(e[0]), pgk_kv_as_q<Q>(e[1]));
  }
}

template <class Q>
__device__ __forceinline__ float pgk_round_q(float x) {
  if constexpr (std::is_same<Q, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

template <class Q>
__device__ __forceinline__ Q pgk_from_f32(float x) {
  if constexpr (std::is_same<Q, __nv_bfloat16>::value) return __float2bfloat16_rn(x);
  return x;
}

template <class T, int N>
struct alignas(sizeof(T) * N) PgkVec {
  T v[N];
};

template <class KV, int D>
struct PgkAttnSmem {
  static constexpr int kVecs = D * (int)sizeof(KV) / 16;   // 16-byte vectors per row
  static constexpr int kRow = kVecs + 1;                    // padded row, 16-byte units (odd)
  static constexpr int kTile = kPgkAttnChunk * kRow;        // one K or V chunk, 16-byte units
  static size_t bytes(int g) {
    return (size_t)2 * kPgkAttnStages * kTile * 16 + (size_t)g * (D + kPgkAttnChunk) * 4;
  }
};

// [start, end) of split `split` of n_split: 64-row chunks of the live window
// [max(lo, 0), live) dealt out evenly and in order (split_bounds in
// kernels/batch_decode_attention.py is the same function).
__device__ __forceinline__ void pgk_split_bounds(int lo, int live, int split, int n_split,
                                                 int& start, int& end) {
  const int lo0 = lo > 0 ? lo : 0;
  start = end = 0;
  if (live <= lo0) return;
  const int c_begin = lo0 / kPgkAttnChunk;
  const int c_end = (live + kPgkAttnChunk - 1) / kPgkAttnChunk;
  const int per = (c_end - c_begin + n_split - 1) / n_split;
  const int cs = c_begin + split * per;
  start = max(lo0, cs * kPgkAttnChunk);
  end = min(live, (cs + per) * kPgkAttnChunk);
  if (end < start) end = start;
}

// Pass one for one (split, slot, kv head) block of 32 * G threads, a warp
// per query head. qb: the G query heads [G, D]; kbase/vbase: this kv head's
// K and V, position p at rows(p) elements from them (called only for live
// p); ksb/vsb: int8 row scales, position p at rows.scale(p) (null for other
// storage). ctx: the length the window counts back from; live <= ctx: the
// positions that hold rows. Writes head gh's (m, l, acc) at pm[gh * n_split
// + split], pl[...] and pacc[(gh * n_split + split) * D ...].
template <class Q, class KV, int D, class Rows>
__device__ __forceinline__ void pgk_decode_attention_split(
    const Q* __restrict__ qb, const KV* __restrict__ kbase, const KV* __restrict__ vbase,
    const __nv_bfloat16* __restrict__ ksb, const __nv_bfloat16* __restrict__ vsb, Rows rows,
    int g_heads, int ctx, int live, int window, int split, int n_split, float scale,
    float softcap, float* __restrict__ pm, float* __restrict__ pl, float* __restrict__ pacc) {
  using L = PgkAttnSmem<KV, D>;
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  constexpr int kChunk = kPgkAttnChunk;
  constexpr int kEl = 16 / (int)sizeof(KV);   // elements per 16-byte vector
  constexpr int kDPL = D / 32;                // output dims per lane: lane * kDPL + j
  extern __shared__ __align__(16) uint4 pgk_attn_smem[];
  uint4* ks = pgk_attn_smem;                                   // [stage][chunk][kRow]
  uint4* vs = ks + kPgkAttnStages * L::kTile;
  float* qs = reinterpret_cast<float*>(vs + kPgkAttnStages * L::kTile);   // [G][D]
  float* ps = qs + g_heads * D;                                           // [G][chunk]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < g_heads * D; i += blockDim.x) qs[i] = pgk_kv_f32(qb[i]);

  const int lo = window > 0 ? ctx - window : -(1 << 30);
  int start, end;
  pgk_split_bounds(lo, live, split, n_split, start, end);
  const int c0 = start / kChunk;
  const int n_chunks = end > start ? (end - 1) / kChunk - c0 + 1 : 0;

  auto load = [&](int c, int buf) {
    uint4* kd = ks + buf * L::kTile;
    uint4* vd = vs + buf * L::kTile;
    for (int i = threadIdx.x; i < kChunk * L::kVecs; i += blockDim.x) {
      const int r = i / L::kVecs, v = i % L::kVecs;
      const int p = c * kChunk + r;
      const bool ok = p >= start && p < end;
      const size_t off = ok ? rows(p) : 0;
      cp_async16(kd + r * L::kRow + v, reinterpret_cast<const uint4*>(kbase + off) + v, ok);
      cp_async16(vd + r * L::kRow + v, reinterpret_cast<const uint4*>(vbase + off) + v, ok);
    }
    cp_async_commit();
  };

  // int8 row scales of this lane's two rows, a chunk ahead of their use
  auto load_scales = [&](int c, float (&kq)[2], float (&vq)[2]) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = c * kChunk + lane + 32 * u;
      const bool ok = p >= start && p < end;
      const size_t so = ok ? rows.scale(p) : 0;
      kq[u] = ok ? __bfloat162float(ksb[so]) : 1.f;
      vq[u] = ok ? __bfloat162float(vsb[so]) : 1.f;
    }
  };

  float m = kPgkAttnNegInf, l = 0.f;
  float acc[kDPL];
#pragma unroll
  for (int j = 0; j < kDPL; ++j) acc[j] = 0.f;
  float ksc[2] = {1.f, 1.f}, vsc[2] = {1.f, 1.f}, ksn[2], vsn[2];

  if (n_chunks > 0) {
    load(c0, 0);
    if (kInt8) load_scales(c0, ksn, vsn);
  }
  for (int i = 0; i < n_chunks; ++i) {
    if (kInt8) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        ksc[u] = ksn[u];
        vsc[u] = vsn[u];
      }
      if (i + 1 < n_chunks) load_scales(c0 + i + 1, ksn, vsn);
    }
    if (i + 1 < n_chunks) {
      load(c0 + i + 1, (i + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // chunk i landed for every thread; qs written
    const uint4* kt = ks + (i & 1) * L::kTile;
    const uint4* vt = vs + (i & 1) * L::kTile;
    const int cbase = (c0 + i) * kChunk;
    const float* qh = qs + warp * D;
    float sv[2];
    bool dead[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = lane + 32 * u;
      const int p = cbase + r;
      dead[u] = p < start || p >= end;
      const uint4* kr = kt + r * L::kRow;
      float dot = 0.f;
#pragma unroll
      for (int v = 0; v < L::kVecs; ++v) {
        const uint4 w = kr[v];
        const KV* e = reinterpret_cast<const KV*>(&w);
#pragma unroll
        for (int x = 0; x < kEl; x += 2) {
          const float2 kf = pgk_kv2_as_q<Q>(e + x);
          dot += qh[v * kEl + x] * kf.x;
          dot += qh[v * kEl + x + 1] * kf.y;
        }
      }
      float sc = dot * scale;
      if (kInt8) sc *= ksc[u];
      if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      sv[u] = dead[u] ? kPgkAttnNegInf : sc;
    }
    const float m_new = fmaxf(m, pgk_warp_max(fmaxf(sv[0], sv[1])));
    float p0 = dead[0] ? 0.f : expf(sv[0] - m_new);
    float p1 = dead[1] ? 0.f : expf(sv[1] - m_new);
    const float alpha = expf(m - m_new);
    l = l * alpha + pgk_warp_sum(p0 + p1);
    if (kInt8) {
      p0 *= vsc[0];
      p1 *= vsc[1];
    }
    float* pw = ps + warp * kChunk;
    pw[lane] = pgk_round_q<Q>(p0);
    pw[lane + 32] = pgk_round_q<Q>(p1);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kDPL; ++j) acc[j] *= alpha;
    for (int r = 0; r < kChunk; ++r) {
      const float pr = pw[r];
      const PgkVec<KV, kDPL> vv =
          reinterpret_cast<const PgkVec<KV, kDPL>*>(vt + r * L::kRow)[lane];
#pragma unroll
      for (int j = 0; j < kDPL; j += 2) {
        const float2 vf = pgk_kv2_as_q<Q>(vv.v + j);
        acc[j] += pr * vf.x;
        acc[j + 1] += pr * vf.y;
      }
    }
    m = m_new;
    __syncthreads();                    // buffer i & 1 is refilled by the next iteration's load
  }
  const int slot = warp * n_split + split;
  if (lane == 0) {
    pm[slot] = m;
    pl[slot] = l;
  }
#pragma unroll
  for (int j = 0; j < kDPL; ++j) pacc[(size_t)slot * D + lane * kDPL + j] = acc[j];
}

// Pass two: one warp per (slot, query head) folds its splits in ascending
// order: out = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30), w_s = exp(m_s -
// max_s m_s).
template <class Q, int D>
__global__ void pgk_attn_combine_kernel(const float* __restrict__ pm,
                                        const float* __restrict__ pl,
                                        const float* __restrict__ pacc, Q* __restrict__ out,
                                        int n_split) {
  constexpr int kDPL = D / 32;
  const size_t h = blockIdx.x;
  const int lane = threadIdx.x;
  const float* mh = pm + h * n_split;
  float mx = kPgkAttnNegInf;
  for (int c = 0; c < n_split; ++c) mx = fmaxf(mx, mh[c]);
  float l = 0.f, acc[kDPL];
#pragma unroll
  for (int j = 0; j < kDPL; ++j) acc[j] = 0.f;
  for (int c = 0; c < n_split; ++c) {
    const float w = expf(mh[c] - mx);
    l += pl[h * n_split + c] * w;
    const float* a = pacc + (h * n_split + c) * D + lane * kDPL;
#pragma unroll
    for (int j = 0; j < kDPL; ++j) acc[j] += a[j] * w;
  }
  const float lf = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < kDPL; ++j) out[h * D + lane * kDPL + j] = pgk_from_f32<Q>(acc[j] / lf);
}

// Launch pass one (`kernel` over (n_split, bh) blocks of 32 * g threads
// with the shared memory the body needs) and pass two over `heads`
// (slot, query head) pairs. `part` holds pm, pl [heads, n_split] and pacc
// [heads, n_split, D], f32.
template <class Q, class KV, int D, class Kernel, class... Args>
static cudaError_t pgk_launch_attention(Kernel kernel, int g, int n_split, int bh, int heads,
                                        float* part, Q* out, cudaStream_t st, Args... args) {
  const size_t smem = PgkAttnSmem<KV, D>::bytes(g);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(n_split, bh), g * 32, smem, st>>>(args...);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)heads * n_split;
  pgk_attn_combine_kernel<Q, D><<<heads, 32, 0, st>>>(part, part + n, part + 2 * n, out, n_split);
  return cudaGetLastError();
}

// Calls Launch<Q, KV, D>::run(args...) for the query kind (0 bf16, 1 f32),
// the storage kind (kPgkKv*) and D in {64, 128}.
template <template <class, class, int> class Launch, class Q, int D, class... A>
static cudaError_t pgk_attn_dispatch_kv(int kv_kind, A... args) {
  switch (kv_kind) {
    case kPgkKvBf16: return Launch<Q, __nv_bfloat16, D>::run(args...);
    case kPgkKvF32: return Launch<Q, float, D>::run(args...);
    case kPgkKvE4m3: return Launch<Q, __nv_fp8_e4m3, D>::run(args...);
    case kPgkKvE5m2: return Launch<Q, __nv_fp8_e5m2, D>::run(args...);
    case kPgkKvInt8: return Launch<Q, int8_t, D>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <template <class, class, int> class Launch, class... A>
static cudaError_t pgk_attn_dispatch(int q_kind, int kv_kind, int d, A... args) {
  if (d == 64) {
    if (q_kind == 0) return pgk_attn_dispatch_kv<Launch, __nv_bfloat16, 64>(kv_kind, args...);
    if (q_kind == 1) return pgk_attn_dispatch_kv<Launch, float, 64>(kv_kind, args...);
  } else if (d == 128) {
    if (q_kind == 0) return pgk_attn_dispatch_kv<Launch, __nv_bfloat16, 128>(kv_kind, args...);
    if (q_kind == 1) return pgk_attn_dispatch_kv<Launch, float, 128>(kv_kind, args...);
  }
  return cudaErrorInvalidValue;
}
