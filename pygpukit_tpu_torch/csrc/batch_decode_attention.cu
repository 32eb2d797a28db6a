// Batched decode attention over the dense serving pools: one query per head
// for every slot b against layer `layer` of the merged [B, L, MAX, Hk*D]
// pools (int8 pools: [B, L, MAX] bf16 row scales beside them).
//
// Replaces pygpukit_tpu/kernels/batch_decode_attention.py _bda_kernel.
//
// The body (bound, design, split, masking, rounding) is decode_attention.cuh's;
// here position p of slot b's layer is row p of the slot's [MAX, Hk*D] plane
// (its scale entry p of the slot's [MAX] scale row), live up to min(ctx, MAX).
#include "decode_attention.cuh"

namespace {

struct DenseRows {
  int lanes_row;                       // Hk * D elements per pool row
  __device__ size_t operator()(int p) const { return (size_t)p * lanes_row; }
  __device__ size_t scale(int p) const { return (size_t)p; }
};

template <class Q, class KV, int D>
__global__ void bda_kernel(const Q* __restrict__ q, const KV* __restrict__ k_pool,
                           const KV* __restrict__ v_pool, const __nv_bfloat16* __restrict__ k_scale,
                           const __nv_bfloat16* __restrict__ v_scale,
                           const int* __restrict__ ctx_lens, float* __restrict__ part, int hq,
                           int hk, int layer, int n_layers, int max_len, int n_split, float scale,
                           float softcap, int window) {
  const int g_heads = hq / hk;
  const int b = blockIdx.y / hk;
  const int h = blockIdx.y % hk;
  const int lanes_row = hk * D;
  const int ctx = ctx_lens[b];
  const int live = ctx < max_len ? ctx : max_len;
  const size_t plane = ((size_t)b * n_layers + layer) * max_len;
  const size_t pool_off = plane * lanes_row + (size_t)h * D;
  const size_t head0 = (size_t)b * hq + (size_t)h * g_heads;
  const size_t n = (size_t)(gridDim.y / hk) * hq * n_split;
  const bool int8 = std::is_same<KV, int8_t>::value;
  pgk_decode_attention_split<Q, KV, D>(
      q + head0 * D, k_pool + pool_off, v_pool + pool_off, int8 ? k_scale + plane : nullptr,
      int8 ? v_scale + plane : nullptr, DenseRows{lanes_row}, g_heads, ctx, live, window,
      blockIdx.x, n_split, scale, softcap, part + head0 * n_split, part + n + head0 * n_split,
      part + 2 * n + head0 * n_split * D);
}

template <class Q, class KV, int D>
struct LaunchBda {
  static cudaError_t run(const void* q, const void* k_pool, const void* v_pool,
                         const void* k_scale, const void* v_scale, const void* ctx_lens,
                         void* out, void* part, int b, int hq, int hk, int layer, int n_layers,
                         int max_len, int n_split, float scale, float softcap, int window,
                         cudaStream_t st) {
    return pgk_launch_attention<Q, KV, D>(
        bda_kernel<Q, KV, D>, hq / hk, n_split, b * hk, b * hq, static_cast<float*>(part),
        static_cast<Q*>(out), st, static_cast<const Q*>(q), static_cast<const KV*>(k_pool),
        static_cast<const KV*>(v_pool), static_cast<const __nv_bfloat16*>(k_scale),
        static_cast<const __nv_bfloat16*>(v_scale), static_cast<const int*>(ctx_lens),
        static_cast<float*>(part), hq, hk, layer, n_layers, max_len, n_split, scale, softcap,
        window);
  }
};

}  // namespace

// q [b, hq, d] (q_kind 0 bf16, 1 f32); pools [b, n_layers, max_len, hk*d] of
// storage kv_kind (kPgkKv*; int8 with [b, n_layers, max_len] bf16 row scales
// k_scale and v_scale, else those may be null); ctx_lens [b] int32 (lengths
// including the row just written; may exceed max_len); out [b, hq, d] in q's
// dtype; part: b * hq * n_split * (d + 2) f32 scratch (pm, pl [b*hq,
// n_split], then pacc [b*hq, n_split, d]). softcap <= 0 disables it, window
// <= 0 means none. Requires d in {64, 128}, hq % hk == 0, hq / hk <= 16,
// n_split >= 1, 16-byte aligned pools.
PGK_API int pgk_batch_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                       const void* k_scale, const void* v_scale,
                                       const void* ctx_lens, void* out, void* part, int b,
                                       int hq, int hk, int d, int layer, int n_layers,
                                       int max_len, int n_split, int q_kind, int kv_kind,
                                       float scale, float softcap, int window, void* stream) {
  if (b < 1 || hk < 1 || hq % hk != 0 || hq / hk > 16 || layer < 0 || layer >= n_layers ||
      max_len < 1 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  return (int)pgk_attn_dispatch<LaunchBda>(q_kind, kv_kind, d, q, k_pool, v_pool, k_scale,
                                           v_scale, ctx_lens, out, part, b, hq, hk, layer,
                                           n_layers, max_len, n_split, scale, softcap, window,
                                           static_cast<cudaStream_t>(stream));
}
