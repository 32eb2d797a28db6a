// One decode query per head against a KV sequence: the body shared by
// batch_decode_attention.cu (dense serving pools), paged_attention.cu
// (block pools behind a block table) and flash_decode.cu (one query row over
// a fixed [MAX, Hk, D] cache). The kernels differ only in where position p's
// K and V rows (and int8 row scales) live, which they pass in as a
// row-offset functor; everything below is the same arithmetic.
//
// Replaces the reference's _bda_kernel (pygpukit_tpu/kernels/
// batch_decode_attention.py), _paged_kernel (kernels/paged_attention.py)
// and _decode_pallas (kernels/flash_attention.py).
//
// Bound: bytes. A call reads every live K and V row of every slot once:
// 2 * live * Hk * D * elt bytes (4.69 MB in bf16 at batch 8, MAX 1024 and the
// 1.1B shape, 1.4 us at 3.35 TB/s) for G = Hq/Hk dot products a row, far
// below the tensor cores' rate. What held the first port back was not the
// arithmetic but latency: one block per (slot, kv head) gave B * Hk = 32
// blocks for 132 SMs, each walking its chunks one after another with no load
// in flight during the math. So:
// - split-KV: pass one runs one block per (split, slot, kv head). n_split
//   comes from the shapes alone (B, Hk, MAX; kernels/attention_split.
//   attention_splits), and each block reads its slot's ctx from device
//   memory and takes an equal share, in 64-row chunks, of the live window
//   [max(ctx - window, 0), min(ctx, MAX)) (split_bounds there, mirrored
//   below). The launch plan never reads the host, so a step captures into a
//   CUDA graph. Each block writes its (m, l, acc), and the splits are folded
//   in ascending order (pgk_attn_fold): by a second launch
//   (pgk_attn_combine_kernel; rows 6 and 17) or, in flash_decode, by the
//   block of a group that arrives last (pgk_attn_fold_last: an atomic
//   ticket elects the folding block and never orders a sum). An empty split
//   writes m = -1e30, l = 0 and weighs nothing. A replay is bitwise.
// - K and V chunks arrive by 16-byte cp.async into a two-stage ring, the
//   next chunk's load in flight during this chunk's math (the first chunk's
//   load is issued before the query rows are read); ragged edges and
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

// The output dims a lane owns in the CUDA-core body (dims lane * kDPL + j,
// j < kDPL): D / 32, rounded up where D is not a multiple of 32 (D 80: 3,
// the last lanes owning fewer or none; pgk_lane_owns says which).
template <int D>
__host__ __device__ constexpr int pgk_lane_dims() {
  return (D + 31) / 32;
}
template <int D>
__device__ __forceinline__ bool pgk_lane_owns(int lane, int j) {
  return D % 32 == 0 || lane * pgk_lane_dims<D>() + j < D;
}

// The CUDA-core body's shared memory: a ring of kStages K and V chunks,
// then the G query rows and the G rows of P. Two chunks in flight up to
// 512-byte rows; f32 rows at D 256 (1 KB: two stages would take 266 KB of
// the 227 KB a block may have) keep one, loaded after the chunk before it
// is consumed. A shared row holds the kCols = 32 * kDPL dims the lanes own,
// the ones past D zero-filled (D 80 takes the D-96 rows); the pools keep
// their D columns.
template <class KV, int D>
struct PgkAttnSmem {
  static_assert(D % 16 == 0 && D > 0, "a row must be whole 16-byte vectors in every storage");
  static constexpr int kCols = 32 * pgk_lane_dims<D>();    // dims of a shared row
  static constexpr int kVecs = D * (int)sizeof(KV) / 16;   // 16-byte vectors per pool row
  static constexpr int kSVecs = kCols * (int)sizeof(KV) / 16;   // per shared row
  static_assert(kSVecs % 2 == 0, "the padded shared row must stay an odd number of units");
  static constexpr int kRow = kSVecs + 1;                   // padded row, 16-byte units (odd)
  static constexpr int kTile = kPgkAttnChunk * kRow;        // one K or V chunk, 16-byte units
  static constexpr int kStages = kCols * (int)sizeof(KV) > 512 ? 1 : 2;
  static size_t bytes(int g) {
    return (size_t)2 * kStages * kTile * 16 + (size_t)g * (D + kPgkAttnChunk) * 4;
  }
};

// [start, end) of split `split` of n_split: 64-row chunks of the live window
// [max(lo, 0), live) dealt out evenly and in order (split_bounds in
// kernels/attention_split.py is the same function).
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

// How many of the n_split splits above are not empty: they are the first
// ones (live_splits in kernels/attention_split.py is the same function).
__device__ __forceinline__ int pgk_live_splits(int lo, int live, int n_split) {
  const int lo0 = lo > 0 ? lo : 0;
  if (live <= lo0) return 0;
  const int chunks = (live + kPgkAttnChunk - 1) / kPgkAttnChunk - lo0 / kPgkAttnChunk;
  const int per = (chunks + n_split - 1) / n_split;
  return (chunks + per - 1) / per;
}

// One warp's running state for its query head after a split: max, sum and
// unnormalised accumulator (lane holds dims lane * kDPL + j).
template <int D>
struct PgkAttnState {
  float m, l, acc[pgk_lane_dims<D>()];
};

// Writes head gh's (m, l, acc) at pm[gh * n_split + split], pl[...] and
// pacc[(gh * n_split + split) * D ...] (gh: the warp).
template <int D>
__device__ __forceinline__ void pgk_attn_store(const PgkAttnState<D>& st, float* __restrict__ pm,
                                               float* __restrict__ pl, float* __restrict__ pacc,
                                               int split, int n_split) {
  constexpr int kDPL = pgk_lane_dims<D>();
  const int lane = threadIdx.x & 31;
  const int slot = (threadIdx.x >> 5) * n_split + split;
  if (lane == 0) {
    pm[slot] = st.m;
    pl[slot] = st.l;
  }
#pragma unroll
  for (int j = 0; j < kDPL; ++j)
    if (pgk_lane_owns<D>(lane, j)) pacc[(size_t)slot * D + lane * kDPL + j] = st.acc[j];
}

// The output of a head whose context is one split (or none): acc / max(l,
// 1e-30), the bits pgk_attn_fold gives for one split (its weight is exp(0)).
template <class Q, int D>
__device__ __forceinline__ void pgk_attn_finish(const PgkAttnState<D>& st, Q* __restrict__ out) {
  constexpr int kDPL = pgk_lane_dims<D>();
  const int lane = threadIdx.x & 31;
  const float lf = fmaxf(st.l, 1e-30f);
#pragma unroll
  for (int j = 0; j < kDPL; ++j)
    if (pgk_lane_owns<D>(lane, j)) out[lane * kDPL + j] = pgk_from_f32<Q>(st.acc[j] / lf);
}

// Pass one for one (split, slot, kv head) block of 32 * G threads, a warp
// per query head. qb: the G query heads [G, D]; kbase/vbase: this kv head's
// K and V, position p at rows(p) elements from them (called only for live
// p); ksb/vsb: int8 row scales, position p at rows.scale(p) (null for other
// storage). ctx: the length the window counts back from; live <= ctx: the
// positions that hold rows. Returns the warp's head's state after the split.
template <class Q, class KV, int D, class Rows>
__device__ __forceinline__ PgkAttnState<D> pgk_decode_attention_run(
    const Q* __restrict__ qb, const KV* __restrict__ kbase, const KV* __restrict__ vbase,
    const __nv_bfloat16* __restrict__ ksb, const __nv_bfloat16* __restrict__ vsb, Rows rows,
    int g_heads, int ctx, int live, int window, int split, int n_split, float scale,
    float softcap) {
  using L = PgkAttnSmem<KV, D>;
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  constexpr int kChunk = kPgkAttnChunk;
  constexpr int kEl = 16 / (int)sizeof(KV);   // elements per 16-byte vector
  constexpr int kDPL = pgk_lane_dims<D>();    // output dims per lane: lane * kDPL + j
  // V elements a lane reads at once: its kDPL dims, in 16-byte pieces (an
  // odd kDPL, 3 at D 80 and 96, reads them one at a time)
  constexpr int kVB = kDPL * (int)sizeof(KV) > 16 ? 16 / (int)sizeof(KV) : kDPL;
  extern __shared__ __align__(16) uint4 pgk_attn_smem[];
  uint4* ks = pgk_attn_smem;                                   // [stage][chunk][kRow]
  uint4* vs = ks + L::kStages * L::kTile;
  float* qs = reinterpret_cast<float*>(vs + L::kStages * L::kTile);       // [G][D]
  float* ps = qs + g_heads * D;                                           // [G][chunk]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int lo = window > 0 ? ctx - window : -(1 << 30);
  int start, end;
  pgk_split_bounds(lo, live, split, n_split, start, end);
  const int c0 = start / kChunk;
  const int n_chunks = end > start ? (end - 1) / kChunk - c0 + 1 : 0;

  auto load = [&](int c, int buf) {
    uint4* kd = ks + buf * L::kTile;
    uint4* vd = vs + buf * L::kTile;
    for (int i = threadIdx.x; i < kChunk * L::kSVecs; i += blockDim.x) {
      const int r = i / L::kSVecs, v = i % L::kSVecs;
      const int p = c * kChunk + r;
      const bool ok = p >= start && p < end && v < L::kVecs;   // dims past D: zeros
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
  // behind the first chunk's load; the loop's first barrier publishes them
  for (int i = threadIdx.x; i < g_heads * D; i += blockDim.x) qs[i] = pgk_kv_f32(qb[i]);
  for (int i = 0; i < n_chunks; ++i) {
    if (kInt8) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        ksc[u] = ksn[u];
        vsc[u] = vsn[u];
      }
      if (i + 1 < n_chunks) load_scales(c0 + i + 1, ksn, vsn);
    }
    if (L::kStages > 1 && i + 1 < n_chunks) {
      load(c0 + i + 1, (i + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // chunk i landed for every thread; qs written
    const uint4* kt = ks + (i % L::kStages) * L::kTile;
    const uint4* vt = vs + (i % L::kStages) * L::kTile;
    const int cbase = (c0 + i) * kChunk;
    const float4* qh = reinterpret_cast<const float4*>(qs + warp * D);
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
        for (int x = 0; x < kEl; x += 4) {
          const float4 q4 = qh[(v * kEl + x) / 4];
          const float2 k01 = pgk_kv2_as_q<Q>(e + x);
          const float2 k23 = pgk_kv2_as_q<Q>(e + x + 2);
          dot += q4.x * k01.x;
          dot += q4.y * k01.y;
          dot += q4.z * k23.x;
          dot += q4.w * k23.y;
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
    for (int r4 = 0; r4 < kChunk; r4 += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(pw + r4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float pr = u == 0 ? p4.x : u == 1 ? p4.y : u == 2 ? p4.z : p4.w;
        if constexpr (kDPL % 2 == 0) {
          const PgkVec<KV, kVB>* vrow = reinterpret_cast<const PgkVec<KV, kVB>*>(
              vt + (r4 + u) * L::kRow) + lane * (kDPL / kVB);
#pragma unroll
          for (int h = 0; h < kDPL; h += kVB) {
            const PgkVec<KV, kVB> vv = vrow[h / kVB];
#pragma unroll
            for (int j = 0; j < kVB; j += 2) {
              const float2 vf = pgk_kv2_as_q<Q>(vv.v + j);
              acc[h + j] += pr * vf.x;
              acc[h + j + 1] += pr * vf.y;
            }
          }
        } else {                           // the same exact converts, one element each
          const KV* vrow = reinterpret_cast<const KV*>(vt + (r4 + u) * L::kRow) + lane * kDPL;
#pragma unroll
          for (int j = 0; j < kDPL; ++j) acc[j] += pr * pgk_kv_as_q<Q>(vrow[j]);
        }
      }
    }
    m = m_new;
    __syncthreads();                    // buffer i % kStages is refilled by the next load
    if (L::kStages == 1 && i + 1 < n_chunks) load(c0 + i + 1, 0);
  }
  PgkAttnState<D> st;
  st.m = m;
  st.l = l;
#pragma unroll
  for (int j = 0; j < kDPL; ++j) st.acc[j] = acc[j];
  return st;
}

// Pass one of the two-launch kernels: the split's state written for
// pgk_attn_combine_kernel (pgk_attn_store's layout).
template <class Q, class KV, int D, class Rows>
__device__ __forceinline__ void pgk_decode_attention_split(
    const Q* __restrict__ qb, const KV* __restrict__ kbase, const KV* __restrict__ vbase,
    const __nv_bfloat16* __restrict__ ksb, const __nv_bfloat16* __restrict__ vsb, Rows rows,
    int g_heads, int ctx, int live, int window, int split, int n_split, float scale,
    float softcap, float* __restrict__ pm, float* __restrict__ pl, float* __restrict__ pacc) {
  pgk_attn_store<D>(pgk_decode_attention_run<Q, KV, D>(qb, kbase, vbase, ksb, vsb, rows, g_heads,
                                                       ctx, live, window, split, n_split, scale,
                                                       softcap),
                    pm, pl, pacc, split, n_split);
}

// One warp folds one query head's first n splits in ascending order: out =
// sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30), w_s = exp(m_s - max_s m_s).
// mh, lh: the head's maxima and sums; ah: its [splits, D] accumulators. The
// loads run ahead of the sums (the first eight splits' accumulators beside
// the maxima, then eight splits ahead), but the sums themselves run split
// after split, so the bits are those of a plain ordered loop. The reads go
// to L2 (__ldcg): in the one-launch fold other blocks wrote them.
template <class Q, int D>
__device__ __forceinline__ void pgk_attn_fold(const float* __restrict__ mh,
                                              const float* __restrict__ lh,
                                              const float* __restrict__ ah, Q* __restrict__ out,
                                              int n) {
  constexpr int kDPL = pgk_lane_dims<D>();
  constexpr int kAhead = 8;                      // divides 32
  const int lane = threadIdx.x & 31;
  float nxt[kAhead][kDPL];
  auto fetch = [&](int c) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int j = 0; j < kDPL; ++j)
        nxt[u][j] = c + u < n && pgk_lane_owns<D>(lane, j)
                        ? __ldcg(ah + (size_t)(c + u) * D + lane * kDPL + j)
                        : 0.f;
  };
  fetch(0);
  float m_mine = lane < n ? __ldcg(mh + lane) : kPgkAttnNegInf;
  float l_mine = lane < n ? __ldcg(lh + lane) : 0.f;
  float mx = m_mine;
  for (int c = lane + 32; c < n; c += 32) mx = fmaxf(mx, __ldcg(mh + c));
  mx = pgk_warp_max(mx);
  float l = 0.f, acc[kDPL];
#pragma unroll
  for (int j = 0; j < kDPL; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < n; c0 += 32) {
    if (c0 > 0) {
      m_mine = c0 + lane < n ? __ldcg(mh + c0 + lane) : kPgkAttnNegInf;
      l_mine = c0 + lane < n ? __ldcg(lh + c0 + lane) : 0.f;
    }
    const float w_mine = c0 + lane < n ? expf(m_mine - mx) : 0.f;
    const int count = min(32, n - c0);
    for (int b = 0; b < count; b += kAhead) {
      float cur[kAhead][kDPL];
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
#pragma unroll
        for (int j = 0; j < kDPL; ++j) cur[u][j] = nxt[u][j];
      if (c0 + b + kAhead < n) fetch(c0 + b + kAhead);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (b + u < count) {                       // uniform across the warp
          const float w = __shfl_sync(0xffffffffu, w_mine, b + u);
          l += __shfl_sync(0xffffffffu, l_mine, b + u) * w;
#pragma unroll
          for (int j = 0; j < kDPL; ++j) acc[j] += cur[u][j] * w;
        }
      }
    }
  }
  const float lf = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < kDPL; ++j)
    if (pgk_lane_owns<D>(lane, j)) out[lane * kDPL + j] = pgk_from_f32<Q>(acc[j] / lf);
}

// Pass two: one warp per (slot, query head) folds its splits.
template <class Q, int D>
__global__ void pgk_attn_combine_kernel(const float* __restrict__ pm,
                                        const float* __restrict__ pl,
                                        const float* __restrict__ pacc, Q* __restrict__ out,
                                        int n_split) {
  const size_t h = blockIdx.x;
  pgk_attn_fold<Q, D>(pm + h * n_split, pl + h * n_split, pacc + h * n_split * D, out + h * D,
                      n_split);
}

// Whether this block is the last of n_live to arrive at the group's
// counter (which it then resets to 0). Every thread calls it after storing
// its share of the block's results: a barrier, then thread 0's acq_rel
// ticket (release: the block's stores, which the barrier ordered before it;
// acquire: every other block's), then a barrier that hands the answer and
// the acquire to the block.
__device__ __forceinline__ int pgk_take_ticket(unsigned* arrivals, int n_live) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned ticket;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(arrivals)
                 : "memory");
    last = ticket == (unsigned)n_live - 1;
    if (last) atomicExch(arrivals, 0u);   // every block of the group has arrived
  }
  __syncthreads();
  return last;
}

// The one-launch fold, called by each of the n_live blocks of a group (the
// non-empty splits of one kv head) after it stored its split's (m, l, acc):
// the block publishes them, takes a ticket from the group's arrival
// counter, and the block that arrives last folds the group's n_live splits,
// its warps taking the g_heads query heads in turn (pm, pl, pacc, out: the
// group's first head; n_split: the splits per head in pm), then resets the
// counter to 0. The counters are zero before a launch and after it, so a
// captured graph replays; two launches in flight at once (on two streams)
// must not share them.
template <class Q, int D>
__device__ __forceinline__ void pgk_attn_fold_last(unsigned* __restrict__ arrivals, int n_live,
                                                   int n_split, int g_heads, const float* pm,
                                                   const float* pl, const float* pacc,
                                                   Q* __restrict__ out) {
  if (!pgk_take_ticket(arrivals, n_live)) return;
  for (int h = threadIdx.x >> 5; h < g_heads; h += blockDim.x >> 5)
    pgk_attn_fold<Q, D>(pm + h * n_split, pl + h * n_split, pacc + (size_t)h * n_split * D,
                        out + h * D, n_live);
}

// ---------------------------------------------------------------------------
// The tensor-core body: bf16 queries over bf16 rows, G <= 16 query heads
// ---------------------------------------------------------------------------
// The CUDA-core body above converts every K and V element once per query
// head and takes a shared load per product; at the single-stream step's
// short contexts that issue time is most of a launch, at long ones more
// than the bytes' time (measured on the H100 by phase stamps). Here
// the G heads of a kv head are the rows of one m16n8k16 tile (padded to
// 16): S = Q K^T and O += P V are warp MMAs with f32 sums, Q's A fragments
// come from global memory once, K (ldmatrix) and V (ldmatrix.trans) from
// shared rows padded by 16 bytes (eight rows hit distinct banks), and P
// goes from the S accumulators to the A fragments of P V in registers,
// rounded to bf16 as the reference rounds it. The softmax runs in base 2:
// the scale and log2(e) fold into one multiply and p = 2^(s2 - m2) is one
// ex2.approx (as flash_attention's bf16 path computes it); with G <= 8 the
// tile's upper eight rows are padding and skip it. A block of kPgkMmaWarps
// warps takes one split; warp w runs the online softmax over the split's
// chunks w, w + 4, ... (its own cp.async ring, no block barrier in the
// loop), and the warps' states fold in a fixed order at the end. One
// launch is mostly latency at the single-stream step's contexts, so the
// code on that path is kept short: every warp's loads leave first, and the
// fold computes each head's weights once.
// D 96 (Phi-3) runs the D-128 shape with 6 k-steps of Q K^T and 12 n-tiles
// of P V (208-byte padded rows: 13 16-byte units, odd, so ldmatrix's eight
// rows still hit distinct banks), one stage a warp.
// D 80 (Phi-2) runs the D-96 shape: its shared rows hold 96 columns, the 16
// past the row zero-filled by the cp.async source size (the pools keep 80),
// Q's sixth k-step is zeros, so Q K^T's 6 k-steps (3 pairs) give the 80
// columns' sums, and P V takes the 10 n-tiles of the 80 columns alone.
// At D 256 a warp's tile is 32 rows (a 64-row tile of K and V is 66 KB, and
// four warps' would pass the 227 KB a block may have), and the Q fragments
// (64 registers at D 256, beside O's 128) are read from global memory (L1)
// per tile, one k-step pair at a time, instead of held.
constexpr int kPgkMmaWarps = 4;

template <int D>
struct PgkMmaSmem {
  static_assert(D % 16 == 0 && D > 0, "whole k-steps and n-tile pairs");
  static constexpr int kRows = D > 128 ? 32 : kPgkAttnChunk;    // rows of a warp's tile
  static constexpr int kStages = D == 64 ? 2 : 1;               // tiles in flight a warp
  static constexpr int kCols = (D + 31) / 32 * 32;              // columns of a shared row
  static constexpr int kRowBytes = kCols * 2 + 16;
  static constexpr int kTile = kRows * kRowBytes;               // one K or V tile
  static constexpr int kWarpBytes = kStages * 2 * kTile;
  static constexpr int kBytes = kPgkMmaWarps * kWarpBytes;      // the merge reuses it
  static constexpr int kState = D + 2;                          // m, l, o[D] of a warp's head
};

// The block's state after pgk_decode_attention_mma, in shared memory: ws,
// each warp's [16][D + 2] rows (m in base 2, l, o[D]); hw, each head's
// [2 + warps]: m (base e), l, and the warps' weights.
struct PgkMmaState {
  const float* ws;
  const float* hw;
};

// 2^x (ex2.approx, flushing denormals; 2^-huge = 0).
__device__ __forceinline__ float pgk_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One split [start, end) of a kv head for its g_heads (<= 16; <= 8 unless
// kUpper) query heads qb [G, D]; rows(p) as in pgk_decode_attention_run.
template <int D, bool kUpper, class Rows>
__device__ __forceinline__ PgkMmaState pgk_decode_attention_mma(
    const __nv_bfloat16* __restrict__ qb, const __nv_bfloat16* __restrict__ kbase,
    const __nv_bfloat16* __restrict__ vbase, Rows rows, int g_heads, int start, int end,
    float scale) {
  using L = PgkMmaSmem<D>;
  constexpr int kChunk = L::kRows;           // the warp's unit: a tile of kRows positions
  constexpr int kKS = L::kCols / 16;         // k-steps of Q K^T (in pairs; past D zeros)
  constexpr int kDN = D / 8;                 // n-tiles of P V (in pairs)
  constexpr int kNT = kChunk / 8;            // n-tiles of S
  constexpr int kVecs = D / 8;               // 16-byte vectors a pool row
  constexpr int kSVecs = L::kCols / 8;       // a shared row's
  constexpr bool kQHeld = D <= 128;          // Q's fragments held in registers
  static_assert(kKS % 2 == 0 && kDN % 2 == 0, "k-steps and n-tiles go in pairs");
  extern __shared__ __align__(16) uint8_t pgk_mma_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint8_t* ring = pgk_mma_smem + warp * L::kWarpBytes;
  const int c_first = start / kChunk;
  const int n_chunks = end > start ? (end - 1) / kChunk - c_first + 1 : 0;
  const int mine = n_chunks > warp ? (n_chunks - warp + kPgkMmaWarps - 1) / kPgkMmaWarps : 0;

  auto load = [&](int i) {                   // this warp's i-th chunk into stage i % kStages
    const int c = c_first + warp + kPgkMmaWarps * i;
    uint8_t* kd = ring + (i % L::kStages) * 2 * L::kTile;
    uint8_t* vd = kd + L::kTile;
    for (int e = lane; e < kChunk * kSVecs; e += 32) {
      const int r = e / kSVecs, v = e % kSVecs;
      const int p = c * kChunk + r;
      const bool ok = p >= start && p < end && v < kVecs;   // columns past D: zeros
      const size_t off = ok ? rows(p) : 0;
      cp_async16(kd + r * L::kRowBytes + v * 16, reinterpret_cast<const uint4*>(kbase + off) + v,
                 ok);
      cp_async16(vd + r * L::kRowBytes + v * 16, reinterpret_cast<const uint4*>(vbase + off) + v,
                 ok);
    }
    cp_async_commit();
  };
  for (int i = 0; i < mine && i < L::kStages; ++i) load(i);

  // Q as A fragments (heads g and g + 8, dims ks * 16 + 2t and + 8), behind the loads
  auto q_frag = [&](int ks, uint32_t (&a)[4]) {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(qb + g * D + ks * 16 + 2 * t);
    const uint32_t* q8 = q0 + 4 * D;         // eight heads on
    const bool in = ks * 16 < D;             // a k-step past D is zeros
    a[0] = in && g < g_heads ? q0[0] : 0u;
    a[1] = in && g + 8 < g_heads ? q8[0] : 0u;
    a[2] = in && g < g_heads ? q0[4] : 0u;
    a[3] = in && g + 8 < g_heads ? q8[4] : 0u;
  };
  uint32_t qa[kQHeld ? kKS : 1][4];
  if constexpr (kQHeld) {
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) q_frag(ks, qa[ks]);
  }

  // scores in base 2: s2 = (q.k) * scale * log2(e), p = 2^(s2 - m2)
  const float scale2 = scale * 1.4426950408889634f;
  float m[2] = {kPgkAttnNegInf, kPgkAttnNegInf}, l[2] = {0.f, 0.f};
  float o[kDN][4];
#pragma unroll
  for (int dn = 0; dn < kDN; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  for (int i = 0; i < mine; ++i) {
    if (L::kStages > 1 && i + 1 < mine) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncwarp();
    const uint8_t* kt = ring + (i % L::kStages) * 2 * L::kTile;
    const uint8_t* vt = kt + L::kTile;
    const int cbase = (c_first + warp + kPgkMmaWarps * i) * kChunk;
    float sc[kNT][4];
    if constexpr (kQHeld) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
        for (int j = 0; j < kKS / 2; ++j) {
          uint32_t b[4];
          ldmatrix_x4(b, kt + (nt * 8 + (lane & 7)) * L::kRowBytes + ((lane >> 3) * 8 + j * 32) * 2);
          mma_bf16_16816(sc[nt], qa[2 * j], b[0], b[1]);
          mma_bf16_16816(sc[nt], qa[2 * j + 1], b[2], b[3]);
        }
      }
    } else {                                 // the same sums, k-step pairs outermost
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int j = 0; j < kKS / 2; ++j) {
        uint32_t a0[4], a1[4];
        q_frag(2 * j, a0);
        q_frag(2 * j + 1, a1);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          uint32_t b[4];
          ldmatrix_x4(b, kt + (nt * 8 + (lane & 7)) * L::kRowBytes + ((lane >> 3) * 8 + j * 32) * 2);
          mma_bf16_16816(sc[nt], a0, b[0], b[1]);
          mma_bf16_16816(sc[nt], a1, b[2], b[3]);
        }
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < (kUpper ? 4 : 2); ++e) {
        const int p = cbase + nt * 8 + 2 * t + (e & 1);
        sc[nt][e] = p < start || p >= end ? kPgkAttnNegInf : sc[nt][e] * scale2;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < (kUpper ? 2 : 1); ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = pgk_ex2(m[r] - mx[r]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!kUpper && e >= 2) {                 // rows past the G <= 8 heads: P = 0
          sc[nt][e] = 0.f;
          continue;
        }
        const int p = cbase + nt * 8 + 2 * t + (e & 1);
        sc[nt][e] = p < start || p >= end ? 0.f : pgk_ex2(sc[nt][e] - mx[e >> 1]);
        rs[e >> 1] += sc[nt][e];
      }
#pragma unroll
    for (int r = 0; r < (kUpper ? 2 : 1); ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int dn = 0; dn < kDN; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      if (kUpper) {
        o[dn][2] *= alpha[1];
        o[dn][3] *= alpha[1];
      }
    }
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int e = 0; e < kDN / 2; ++e) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * L::kRowBytes +
                                 (2 * e + (lane >> 4)) * 16);
        mma_bf16_16816(o[2 * e], pa, b[0], b[1]);
        mma_bf16_16816(o[2 * e + 1], pa, b[2], b[3]);
      }
    }
    __syncwarp();                            // the stage is free
    if (i + L::kStages < mine) load(i + L::kStages);
  }

  // the warps' states, then each head's weights: m2 = max_w m2_w, the
  // weights 2^(m2_w - m2), l = sum_w l_w weight_w, in warp order
  __syncthreads();                           // every warp is done with its ring
  float* ws = reinterpret_cast<float*>(pgk_mma_smem);          // [warp][16][kState]
  float* hw = ws + kPgkMmaWarps * 16 * L::kState;             // [G][2 + warps]
#pragma unroll
  for (int r = 0; r < (kUpper ? 2 : 1); ++r) {
    float* row = ws + (warp * 16 + g + 8 * r) * L::kState;
    if (t == 0) {
      row[0] = m[r];
      row[1] = l[r];
    }
#pragma unroll
    for (int dn = 0; dn < kDN; ++dn) {
      row[2 + dn * 8 + 2 * t] = o[dn][2 * r];
      row[2 + dn * 8 + 2 * t + 1] = o[dn][2 * r + 1];
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < g_heads) {
    const int h = threadIdx.x;
    float top = kPgkAttnNegInf, lsum = 0.f, wt[kPgkMmaWarps];
#pragma unroll
    for (int w = 0; w < kPgkMmaWarps; ++w) top = fmaxf(top, ws[(w * 16 + h) * L::kState]);
#pragma unroll
    for (int w = 0; w < kPgkMmaWarps; ++w) {
      wt[w] = pgk_ex2(ws[(w * 16 + h) * L::kState] - top);
      lsum += ws[(w * 16 + h) * L::kState + 1] * wt[w];
      hw[h * (2 + kPgkMmaWarps) + 2 + w] = wt[w];
    }
    hw[h * (2 + kPgkMmaWarps)] = top * 0.6931471805599453f;    // back to base e for the fold
    hw[h * (2 + kPgkMmaWarps) + 1] = lsum;
  }
  __syncthreads();
  return {ws, hw};
}

// Head h's accumulator elements d .. d + 3 of the block state
// pgk_decode_attention_mma returned: sum_w o_w[h][d] weight_w, in warp
// order.
template <int D>
__device__ __forceinline__ float4 pgk_mma_acc4(const PgkMmaState& st, int h, int d) {
  constexpr int kS = PgkMmaSmem<D>::kState;
  const float* wt = st.hw + h * (2 + kPgkMmaWarps) + 2;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kPgkMmaWarps; ++w) {
    const float* o = st.ws + (w * 16 + h) * kS + 2 + d;   // 8-byte aligned: kS and d even
    const float2 a = *reinterpret_cast<const float2*>(o);
    const float2 b = *reinterpret_cast<const float2*>(o + 2);
    acc.x += a.x * wt[w];
    acc.y += a.y * wt[w];
    acc.z += b.x * wt[w];
    acc.w += b.y * wt[w];
  }
  return acc;
}

// Splits a tensor-core block can fold in one pass (pgk_mma_fold_last stages
// them all in the ring): the plan keeps n_split within it
// (kernels/flash_attention.decode_plan mirrors it).
template <int D>
__host__ __device__ constexpr int pgk_mma_fold_splits(int g_heads) {
  return (PgkMmaSmem<D>::kBytes - g_heads * 4) / (g_heads * (D + 3) * 4);
}

// The tensor-core kernels' one-launch fold: as pgk_attn_fold_last, the
// n_live blocks of a group take tickets and the last one folds, but it
// stages every split of the group in shared memory with one round of
// cp.async (accumulators) and L2 loads (maxima, sums), computes each head's
// maximum, weights and sum once (a thread a head), and then every thread
// folds its output elements in ascending split order. part layout: pacc
// [G][n_split][D], then pm and pl [G][n_split] (pacc first keeps its rows
// 16-byte aligned).
template <int D>
__device__ __forceinline__ void pgk_mma_fold_last(unsigned* __restrict__ arrivals, int n_live,
                                                  int n_split, int g_heads, const float* pacc,
                                                  const float* pm, const float* pl,
                                                  __nv_bfloat16* __restrict__ out) {
  if (!pgk_take_ticket(arrivals, n_live)) return;
  extern __shared__ __align__(16) uint8_t pgk_mma_smem[];
  float* sacc = reinterpret_cast<float*>(pgk_mma_smem);        // [G][n_live][D]
  float* sm = sacc + g_heads * n_live * D;                     // [G][n_live]
  float* sl = sm + g_heads * n_live;
  float* sw = sl + g_heads * n_live;
  float* sden = sw + g_heads * n_live;                         // [G]
  const int run = n_live * D / 4;                              // 16-byte pieces a head
  for (int i = threadIdx.x; i < g_heads * run; i += blockDim.x) {
    const int h = i / run, j = i % run;
    cp_async16(sacc + h * n_live * D + j * 4, pacc + (size_t)h * n_split * D + j * 4, true);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < g_heads * n_live; i += blockDim.x) {
    const int h = i / n_live, c = i % n_live;
    sm[i] = __ldcg(pm + h * n_split + c);
    sl[i] = __ldcg(pl + h * n_split + c);
  }
  cp_async_wait<0>();
  __syncthreads();
  if ((int)threadIdx.x < g_heads) {
    const float* mh = sm + threadIdx.x * n_live;
    float top = kPgkAttnNegInf, lsum = 0.f;
    for (int c = 0; c < n_live; ++c) top = fmaxf(top, mh[c]);
    for (int c = 0; c < n_live; ++c) {
      const float w = expf(mh[c] - top);
      sw[threadIdx.x * n_live + c] = w;
      lsum += sl[threadIdx.x * n_live + c] * w;
    }
    sden[threadIdx.x] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g_heads * D; i += blockDim.x) {
    const int h = i / D, d = i % D;
    const float* a = sacc + h * n_live * D + d;
    const float* w = sw + h * n_live;
    float acc = 0.f;
    for (int c = 0; c < n_live; ++c) acc += a[c * D] * w[c];
    out[i] = __float2bfloat16_rn(acc / sden[h]);
  }
}

// Launch pass one (`kernel` over (n_split, bh) blocks of 32 * g threads
// with the shared memory the body needs) and pass two over `heads`
// (slot, query head) pairs. `part` holds pm, pl [heads, n_split] and pacc
// [heads, n_split, D], f32.
template <class Q, class KV, int D, class Kernel, class... Args>
static cudaError_t pgk_launch_attention(Kernel kernel, int g, int n_split, int bh, int heads,
                                        float* part, Q* out, cudaStream_t st, Args... args) {
  // set whatever the size: at exactly 48 KB (int8 rows at G 16) the int8
  // writer's static reduction buffer would push the block past the default
  const size_t smem = PgkAttnSmem<KV, D>::bytes(g);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n_split, bh), g * 32, smem, st>>>(args...);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)heads * n_split;
  pgk_attn_combine_kernel<Q, D><<<heads, 32, 0, st>>>(part, part + n, part + 2 * n, out, n_split);
  return cudaGetLastError();
}

// Calls Launch<Q, KV, D>::run(args...) for the query kind (0 bf16, 1 f32),
// the storage kind (kPgkKv*) and D in {64, 80, 96, 128, 256}; any other D
// is cudaErrorInvalidValue.
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
  } else if (d == 80) {
    if (q_kind == 0) return pgk_attn_dispatch_kv<Launch, __nv_bfloat16, 80>(kv_kind, args...);
    if (q_kind == 1) return pgk_attn_dispatch_kv<Launch, float, 80>(kv_kind, args...);
  } else if (d == 96) {
    if (q_kind == 0) return pgk_attn_dispatch_kv<Launch, __nv_bfloat16, 96>(kv_kind, args...);
    if (q_kind == 1) return pgk_attn_dispatch_kv<Launch, float, 96>(kv_kind, args...);
  } else if (d == 128) {
    if (q_kind == 0) return pgk_attn_dispatch_kv<Launch, __nv_bfloat16, 128>(kv_kind, args...);
    if (q_kind == 1) return pgk_attn_dispatch_kv<Launch, float, 128>(kv_kind, args...);
  } else if (d == 256) {
    if (q_kind == 0) return pgk_attn_dispatch_kv<Launch, __nv_bfloat16, 256>(kv_kind, args...);
    if (q_kind == 1) return pgk_attn_dispatch_kv<Launch, float, 256>(kv_kind, args...);
  }
  return cudaErrorInvalidValue;
}
