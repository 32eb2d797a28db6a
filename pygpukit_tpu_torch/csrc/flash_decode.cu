// Flash decoding: one query row per head over a fixed cache [MAX, Hk, D]
// whose rows [0, ctx) are live, in one launch.
//
// Replaces pygpukit_tpu/kernels/flash_attention.py _decode_pallas (:194,
// pallas_call :199), which grids over every MAX block and takes ctx_len as
// a runtime scalar in SMEM.
//
// Bound: bytes, and at short contexts the latency of a launch. A call reads
// each live K and V row once: 2 ctx Hk D elt bytes (8.4 MB at ctx 8192, Hk
// 4, D 64, bf16: 2.5 us at 3.35 TB/s; 147 KB at the decode step's ctx 144,
// 0.05 us, where one launch's start and drain are the time). So:
// - bf16 with G = Hq / Hk <= 16 runs decode_attention.cuh's tensor-core body
//   (the G heads are the rows of warp MMAs, a block of four warps a split,
//   a warp a 64-row chunk at a time, 32 rows at D 256); f32, and G 17 to 32, its CUDA-core
//   body (a warp a head). Position p of kv head h is at p * Hk * D + h * D,
//   the cache's own row layout, read in place;
// - the launch plan comes from the shapes alone (kernels/flash_attention.
//   decode_plan: MAX, Hk, G, D and the dtype), and each block reads ctx
//   itself, from device memory when the caller gives a pointer, so a CUDA
//   graph captured at one position replays at the next;
// - one launch: splits past the context exit at once, a context of one
//   split is written by its block, and otherwise the last of a kv head's
//   non-empty splits to finish folds them in ascending order (an atomic
//   ticket elects it and orders no sum, so a replay is bitwise). The
//   arrival counters are a __device__ array of this library, zero when it
//   loads and left at zero by every launch; two launches in flight at once
//   on different streams must not share them (the port runs on one
//   stream).
// The CUDA-core route's G up to 32 heads take a warp each: up to 16 the
// block takes 512 threads' registers, above that 1024 threads cap a thread
// at 64.
#include "decode_attention.cuh"

namespace {

constexpr int kMaxKvHeads = 4096;
__device__ unsigned flash_decode_arrivals[kMaxKvHeads] = {};

struct CacheRows {
  int row;                             // Hk * D elements per cache position
  __device__ size_t operator()(int p) const { return (size_t)p * row; }
  __device__ size_t scale(int) const { return 0; }
};

// Block (split, kv head): the split's share of [0, min(max(ctx, 0), MAX)).
// Splits past the context exit at once; a context of one split (or none) is
// written by its block; otherwise each non-empty split is published and the
// last to finish folds them. part: pm, pl [hq, n_split], pacc [hq, n_split,
// D].
template <class Q, int D, int kThreads>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Q* __restrict__ q, const Q* __restrict__ kc, const Q* __restrict__ vc,
                    const int* __restrict__ ctx_dev, int ctx_val, Q* __restrict__ out,
                    float* __restrict__ part, int hq, int hk, int max_len, int n_split,
                    float scale) {
  constexpr int kNoWindow = -(1 << 30);
  const int g_heads = hq / hk;
  const int kvh = blockIdx.y;
  const int split = blockIdx.x;
  const int ctx = ctx_dev != nullptr ? *ctx_dev : ctx_val;
  const int live = ctx < 0 ? 0 : (ctx < max_len ? ctx : max_len);
  const int n_live = pgk_live_splits(kNoWindow, live, n_split);
  if (split >= (n_live > 1 ? n_live : 1)) return;
  const size_t head0 = (size_t)kvh * g_heads;
  const PgkAttnState<D> st = pgk_decode_attention_run<Q, Q, D>(
      q + head0 * D, kc + (size_t)kvh * D, vc + (size_t)kvh * D, nullptr, nullptr,
      CacheRows{hk * D}, g_heads, ctx, live, 0, split, n_split, scale, 0.f);
  if (n_live <= 1) {
    pgk_attn_finish<Q, D>(st, out + (head0 + (threadIdx.x >> 5)) * D);
    return;
  }
  const size_t n = (size_t)hq * n_split;
  float* pm = part + head0 * n_split;
  float* pl = part + n + head0 * n_split;
  float* pacc = part + 2 * n + head0 * n_split * D;
  pgk_attn_store<D>(st, pm, pl, pacc, split, n_split);
  pgk_attn_fold_last<Q, D>(flash_decode_arrivals + kvh, n_live, n_split, g_heads, pm, pl, pacc,
                           out + head0 * D);
}

// The same grid and fold for bf16 with G <= 16 on the tensor-core body
// (kUpper: G > 8, both row halves of the MMA tile hold heads).
template <int D, bool kUpper>
__global__ void __launch_bounds__(kPgkMmaWarps * 32)
flash_decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                        const __nv_bfloat16* __restrict__ vc, const int* __restrict__ ctx_dev,
                        int ctx_val, __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                        int hq, int hk, int max_len, int n_split, float scale) {
  constexpr int kNoWindow = -(1 << 30);
  constexpr int kHw = 2 + kPgkMmaWarps;
  const int g_heads = hq / hk;
  const int kvh = blockIdx.y;
  const int split = blockIdx.x;
  const int ctx = ctx_dev != nullptr ? *ctx_dev : ctx_val;
  const int live = ctx < 0 ? 0 : (ctx < max_len ? ctx : max_len);
  const int n_live = pgk_live_splits(kNoWindow, live, n_split);
  if (split >= (n_live > 1 ? n_live : 1)) return;
  int start, end;
  pgk_split_bounds(kNoWindow, live, split, n_split, start, end);
  const size_t head0 = (size_t)kvh * g_heads;
  const PgkMmaState st = pgk_decode_attention_mma<D, kUpper>(
      q + head0 * D, kc + (size_t)kvh * D, vc + (size_t)kvh * D, CacheRows{hk * D}, g_heads,
      start, end, scale);
  if (n_live <= 1) {                       // acc / max(l, 1e-30), as a fold of one split
    for (int i = threadIdx.x; i < g_heads * D / 4; i += blockDim.x) {
      const int h = i / (D / 4), d = i % (D / 4) * 4;
      const float4 a = pgk_mma_acc4<D>(st, h, d);
      const float den = fmaxf(st.hw[h * kHw + 1], 1e-30f);
      const uint2 y = make_uint2(pack_bf16(a.x / den, a.y / den), pack_bf16(a.z / den, a.w / den));
      *reinterpret_cast<uint2*>(out + head0 * D + h * D + d) = y;
    }
    return;
  }
  const size_t n = (size_t)hq * n_split;
  float* pacc = part + head0 * n_split * D;
  float* pm = part + n * D + head0 * n_split;
  float* pl = part + n * (D + 1) + head0 * n_split;
  for (int i = threadIdx.x; i < g_heads * D / 4; i += blockDim.x) {
    const int h = i / (D / 4), d = i % (D / 4) * 4;
    *reinterpret_cast<float4*>(pacc + ((size_t)h * n_split + split) * D + d) =
        pgk_mma_acc4<D>(st, h, d);
    if (d == 0) {
      pm[h * n_split + split] = st.hw[h * kHw];
      pl[h * n_split + split] = st.hw[h * kHw + 1];
    }
  }
  pgk_mma_fold_last<D>(flash_decode_arrivals + kvh, n_live, n_split, g_heads, pacc, pm, pl,
                       out + head0 * D);
}

template <int D, bool kUpper>
cudaError_t launch_decode_mma(const void* q, const void* kc, const void* vc, const int* ctx_dev,
                              int ctx_val, void* out, void* part, int hq, int hk, int max_len,
                              int n_split, float scale, cudaStream_t st) {
  constexpr int smem = PgkMmaSmem<D>::kBytes;
  if (n_split > pgk_mma_fold_splits<D>(hq / hk)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_decode_mma_kernel<D, kUpper>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  using bf16 = __nv_bfloat16;
  flash_decode_mma_kernel<D, kUpper><<<dim3(n_split, hk), kPgkMmaWarps * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
      ctx_dev, ctx_val, static_cast<bf16*>(out), static_cast<float*>(part), hq, hk, max_len,
      n_split, scale);
  return cudaGetLastError();
}

template <class Q, int D>
cudaError_t launch_decode(const void* q, const void* kc, const void* vc, const int* ctx_dev,
                          int ctx_val, void* out, void* part, int hq, int hk, int max_len,
                          int n_split, float scale, cudaStream_t st) {
  const int g = hq / hk;
  if (std::is_same<Q, __nv_bfloat16>::value && g <= 16)
    return g <= 8 ? launch_decode_mma<D, false>(q, kc, vc, ctx_dev, ctx_val, out, part, hq, hk,
                                                max_len, n_split, scale, st)
                  : launch_decode_mma<D, true>(q, kc, vc, ctx_dev, ctx_val, out, part, hq, hk,
                                               max_len, n_split, scale, st);
  const auto kernel =
      g <= 16 ? &flash_decode_kernel<Q, D, 512> : &flash_decode_kernel<Q, D, 1024>;
  // set whatever the size: the fold's static ticket word counts beside it
  const size_t smem = PgkAttnSmem<Q, D>::bytes(g);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n_split, hk), g * 32, smem, st>>>(
      static_cast<const Q*>(q), static_cast<const Q*>(kc), static_cast<const Q*>(vc), ctx_dev,
      ctx_val, static_cast<Q*>(out), static_cast<float*>(part), hq, hk, max_len, n_split, scale);
  return cudaGetLastError();
}

}  // namespace

// q [hq, d], caches [max_len, hk, d], out [hq, d]; contiguous, 16-byte
// aligned, all bf16 (is_f32 == 0) or all f32. The context is *ctx_dev (one
// int32 on the device) when ctx_dev is not null, else ctx_val; below 0 it
// counts as 0 (zeros out), above max_len as max_len. part: hq * n_split *
// (d + 2) f32 scratch; n_split >= 1 from the shapes alone. Requires d in
// {64, 80, 96, 128, 256} (any other: cudaErrorInvalidValue), hq % hk == 0,
// hq / hk <= 32, hk <= 4096 (max_len 0: zeros).
PGK_API int pgk_flash_decode(const void* q, const void* kc, const void* vc, const void* ctx_dev,
                             int ctx_val, void* out, void* part, int hq, int hk, int d,
                             int max_len, int n_split, int is_f32, float scale, void* stream) {
  if (hk < 1 || hk > kMaxKvHeads || hq % hk != 0 || hq / hk > 32 || max_len < 0 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cd = static_cast<const int*>(ctx_dev);
  if (d == 64)
    return is_f32 ? (int)launch_decode<float, 64>(q, kc, vc, cd, ctx_val, out, part, hq, hk,
                                                  max_len, n_split, scale, st)
                  : (int)launch_decode<__nv_bfloat16, 64>(q, kc, vc, cd, ctx_val, out, part,
                                                          hq, hk, max_len, n_split, scale, st);
  if (d == 80)
    return is_f32 ? (int)launch_decode<float, 80>(q, kc, vc, cd, ctx_val, out, part, hq, hk,
                                                  max_len, n_split, scale, st)
                  : (int)launch_decode<__nv_bfloat16, 80>(q, kc, vc, cd, ctx_val, out, part,
                                                          hq, hk, max_len, n_split, scale, st);
  if (d == 96)
    return is_f32 ? (int)launch_decode<float, 96>(q, kc, vc, cd, ctx_val, out, part, hq, hk,
                                                  max_len, n_split, scale, st)
                  : (int)launch_decode<__nv_bfloat16, 96>(q, kc, vc, cd, ctx_val, out, part,
                                                          hq, hk, max_len, n_split, scale, st);
  if (d == 128)
    return is_f32 ? (int)launch_decode<float, 128>(q, kc, vc, cd, ctx_val, out, part, hq, hk,
                                                   max_len, n_split, scale, st)
                  : (int)launch_decode<__nv_bfloat16, 128>(q, kc, vc, cd, ctx_val, out, part,
                                                           hq, hk, max_len, n_split, scale, st);
  if (d == 256)
    return is_f32 ? (int)launch_decode<float, 256>(q, kc, vc, cd, ctx_val, out, part, hq, hk,
                                                   max_len, n_split, scale, st)
                  : (int)launch_decode<__nv_bfloat16, 256>(q, kc, vc, cd, ctx_val, out, part,
                                                           hq, hk, max_len, n_split, scale, st);
  return (int)cudaErrorInvalidValue;
}
