// Batched decode attention over the dense serving pools: one query per head
// for every slot b against layer `layer` of the merged [B, L, MAX, Hk*D] pools.
//
// Replaces pygpukit_tpu/kernels/batch_decode_attention.py _bda_kernel.
//
// The body (bound, design, masking, rounding) is decode_attention.cuh's; here
// position p of slot b's layer is row p of the slot's [MAX, Hk*D] plane, live
// up to min(ctx, MAX).
#include "decode_attention.cuh"

namespace {

struct DenseRows {
  int lanes_row;                       // Hk * D elements per pool row
  __device__ size_t operator()(int p) const { return (size_t)p * lanes_row; }
};

template <int D>
__global__ void bda_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k_pool,
                           const __nv_bfloat16* __restrict__ v_pool,
                           const int* __restrict__ ctx_lens,
                           __nv_bfloat16* __restrict__ out, int hq, int hk,
                           int layer, int n_layers, int max_len, float scale,
                           float softcap, int window) {
  const int g_heads = hq / hk;
  const int b = blockIdx.x / hk;
  const int h = blockIdx.x % hk;
  const int lanes_row = hk * D;
  const int ctx = ctx_lens[b];
  const int live = ctx < max_len ? ctx : max_len;
  const size_t pool_off = ((size_t)b * n_layers + layer) * max_len * lanes_row + (size_t)h * D;
  const size_t head_off = ((size_t)b * hq + (size_t)h * g_heads) * D;
  pgk_decode_attention_block<D>(q + head_off, k_pool + pool_off, v_pool + pool_off,
                                DenseRows{lanes_row}, g_heads, ctx, live, window,
                                scale, softcap, out + head_off);
}

template <int D>
cudaError_t launch_bda(const void* q, const void* k_pool, const void* v_pool,
                       const void* ctx_lens, void* out, int b, int hq, int hk,
                       int layer, int n_layers, int max_len, float scale,
                       float softcap, int window, cudaStream_t st) {
  return pgk_launch_attention(
      bda_kernel<D>, D, hq / hk, b * hk, st,
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(ctx_lens),
      static_cast<__nv_bfloat16*>(out), hq, hk, layer, n_layers, max_len, scale,
      softcap, window);
}

}  // namespace

// q [b, hq, d] bf16; pools [b, n_layers, max_len, hk*d] bf16; ctx_lens [b]
// int32 (lengths including the row just written; may exceed max_len);
// out [b, hq, d] bf16. softcap <= 0 disables it, window <= 0 means none.
// Requires d in {64, 128}, hq % hk == 0 and hq / hk <= 16.
PGK_API int pgk_batch_decode_attention(const void* q, const void* k_pool,
                                       const void* v_pool, const void* ctx_lens,
                                       void* out, int b, int hq, int hk, int d,
                                       int layer, int n_layers, int max_len,
                                       float scale, float softcap, int window,
                                       void* stream) {
  if (b < 1 || hk < 1 || hq % hk != 0 || hq / hk > 16 || layer < 0 ||
      layer >= n_layers || max_len < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (d == 64)
    e = launch_bda<64>(q, k_pool, v_pool, ctx_lens, out, b, hq, hk, layer,
                       n_layers, max_len, scale, softcap, window, st);
  else if (d == 128)
    e = launch_bda<128>(q, k_pool, v_pool, ctx_lens, out, b, hq, hk, layer,
                        n_layers, max_len, scale, softcap, window, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)e;
}
