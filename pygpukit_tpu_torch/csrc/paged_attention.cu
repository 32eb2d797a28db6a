// Paged decode attention: one query per head for every slot b against the
// slot's blocks of one layer's block pool [NB, Hk, BS, D], as the slot's row
// of the block table [B, MB] picks them.
//
// Replaces pygpukit_tpu/kernels/paged_attention.py _paged_kernel (the
// scalar-prefetch Pallas kernel that the block table drives), for every slot
// in one launch where the reference engine calls it once per slot.
//
// The body (bound, design, masking, rounding) is decode_attention.cuh's; here
// position p is offset p % BS of physical block tables[b, p / BS]. The table
// takes the place of the TPU's scalar prefetch: each load reads its entry
// (an L1 hit after the first), and only entries j < ceil(live / BS) are ever
// read. live = min(ctx, MB * BS): a context past the table's capacity sees
// the whole table, as the reference's mask over MB * BS gathered rows does.
// Unlike the Pallas kernel, which hard-codes 1/sqrt(D), the caller passes the
// scale (the engine's cfg.attn_scale), a softcap and a window.
#include "decode_attention.cuh"

namespace {

template <int D>
struct PagedRows {
  const int* tbl;                      // this slot's row of the block table
  int bs;                              // rows per block
  size_t block_stride;                 // Hk * BS * D elements per block
  __device__ size_t operator()(int p) const {
    return (size_t)tbl[p / bs] * block_stride + (size_t)(p % bs) * D;
  }
};

template <int D>
__global__ void paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                                       const __nv_bfloat16* __restrict__ k_pool,
                                       const __nv_bfloat16* __restrict__ v_pool,
                                       const int* __restrict__ tables,
                                       const int* __restrict__ ctx_lens,
                                       __nv_bfloat16* __restrict__ out, int hq,
                                       int hk, int bs, int max_blocks, float scale,
                                       float softcap, int window) {
  const int g_heads = hq / hk;
  const int b = blockIdx.x / hk;
  const int h = blockIdx.x % hk;
  const int ctx = ctx_lens[b];
  const int cap = max_blocks * bs;
  const int live = ctx < cap ? ctx : cap;
  const size_t head_pool = (size_t)h * bs * D;
  const size_t head_off = ((size_t)b * hq + (size_t)h * g_heads) * D;
  const PagedRows<D> rows{tables + (size_t)b * max_blocks, bs, (size_t)hk * bs * D};
  pgk_decode_attention_block<D>(q + head_off, k_pool + head_pool, v_pool + head_pool,
                                rows, g_heads, ctx, live, window, scale, softcap,
                                out + head_off);
}

template <int D>
cudaError_t launch_paged(const void* q, const void* k_pool, const void* v_pool,
                         const void* tables, const void* ctx_lens, void* out, int b,
                         int hq, int hk, int bs, int max_blocks, float scale,
                         float softcap, int window, cudaStream_t st) {
  return pgk_launch_attention(
      paged_attention_kernel<D>, D, hq / hk, b * hk, st,
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(ctx_lens), static_cast<__nv_bfloat16*>(out), hq, hk,
      bs, max_blocks, scale, softcap, window);
}

}  // namespace

// q [b, hq, d] bf16; pools [nb, hk, bs, d] bf16 (one layer); tables
// [b, max_blocks] int32 physical block ids; ctx_lens [b] int32; out
// [b, hq, d] bf16. softcap <= 0 disables it, window <= 0 means none.
// Requires d in {64, 128}, hq % hk == 0, hq / hk <= 16.
PGK_API int pgk_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                const void* tables, const void* ctx_lens, void* out,
                                int b, int hq, int hk, int d, int bs, int max_blocks,
                                float scale, float softcap, int window, void* stream) {
  if (b < 1 || hk < 1 || hq % hk != 0 || hq / hk > 16 || bs < 1 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (d == 64)
    e = launch_paged<64>(q, k_pool, v_pool, tables, ctx_lens, out, b, hq, hk, bs,
                         max_blocks, scale, softcap, window, st);
  else if (d == 128)
    e = launch_paged<128>(q, k_pool, v_pool, tables, ctx_lens, out, b, hq, hk, bs,
                          max_blocks, scale, softcap, window, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)e;
}
