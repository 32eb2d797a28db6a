// Paged decode attention: one query per head for every slot b against the
// slot's blocks of one layer's block pool [NB, Hk, BS, D] (int8 pools: [NB,
// BS] bf16 row scales beside it), as the slot's row of the block table
// [B, MB] picks them.
//
// Replaces pygpukit_tpu/kernels/paged_attention.py _paged_kernel (the
// scalar-prefetch Pallas kernel that the block table drives), for every slot
// in one launch where the reference engine calls it once per slot.
//
// The body (bound, design, split, masking, rounding) is decode_attention.cuh's;
// here position p is offset p % BS of physical block tables[b, p / BS]. The
// table takes the place of the TPU's scalar prefetch: each row's copy reads
// its entry (an L1 hit after the first), and only entries j < ceil(live /
// BS) are ever read; cp.async, not TMA, stages the rows because every block
// of BS rows is its own lookup. live = min(ctx, MB * BS): a context past the
// table's capacity sees the whole table, as the reference's mask over MB * BS
// gathered rows does. Unlike the Pallas kernel, which hard-codes 1/sqrt(D),
// the caller passes the scale (the engine's cfg.attn_scale), a softcap and a
// window.
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
  __device__ size_t scale(int p) const { return (size_t)tbl[p / bs] * bs + p % bs; }
};

template <class Q, class KV, int D>
__device__ __forceinline__ void paged_body(const Q* __restrict__ q, const KV* __restrict__ k_pool,
                                           const KV* __restrict__ v_pool,
                                           const __nv_bfloat16* __restrict__ k_scale,
                                           const __nv_bfloat16* __restrict__ v_scale,
                                           const int* __restrict__ tables,
                                           const int* __restrict__ ctx_lens,
                                           float* __restrict__ part, int hq, int hk, int bs,
                                           int max_blocks, int n_split, float scale,
                                           float softcap, int window) {
  const int g_heads = hq / hk;
  const int b = blockIdx.y / hk;
  const int h = blockIdx.y % hk;
  const int ctx = ctx_lens[b];
  const int cap = max_blocks * bs;
  const int live = ctx < cap ? ctx : cap;
  const size_t head_pool = (size_t)h * bs * D;
  const size_t head0 = (size_t)b * hq + (size_t)h * g_heads;
  const size_t n = (size_t)(gridDim.y / hk) * hq * n_split;
  const PagedRows<D> rows{tables + (size_t)b * max_blocks, bs, (size_t)hk * bs * D};
  pgk_decode_attention_split<Q, KV, D>(
      q + head0 * D, k_pool + head_pool, v_pool + head_pool, k_scale, v_scale, rows, g_heads,
      ctx, live, window, blockIdx.x, n_split, scale, softcap, part + head0 * n_split,
      part + n + head0 * n_split, part + 2 * n + head0 * n_split * D);
}

#define PGK_PAGED_PARAMS                                                                     \
  const Q *__restrict__ q, const KV *__restrict__ k_pool, const KV *__restrict__ v_pool,     \
      const __nv_bfloat16 *__restrict__ k_scale, const __nv_bfloat16 *__restrict__ v_scale,  \
      const int *__restrict__ tables, const int *__restrict__ ctx_lens,                      \
      float *__restrict__ part, int hq, int hk, int bs, int max_blocks, int n_split,         \
      float scale, float softcap, int window
#define PGK_PAGED_ARGS                                                                       \
  q, k_pool, v_pool, k_scale, v_scale, tables, ctx_lens, part, hq, hk, bs, max_blocks,       \
      n_split, scale, softcap, window

// As batch_decode_attention.cu: 9 to 16 query heads a kv head (512
// threads) cap a thread at 128 registers.
template <class Q, class KV, int D>
__global__ void paged_attention_kernel(PGK_PAGED_PARAMS) { paged_body<Q, KV, D>(PGK_PAGED_ARGS); }

template <class Q, class KV, int D>
__global__ void __launch_bounds__(512) paged_attention_kernel_wide(PGK_PAGED_PARAMS) {
  paged_body<Q, KV, D>(PGK_PAGED_ARGS);
}

template <class Q, class KV, int D>
struct LaunchPaged {
  static cudaError_t run(const void* q, const void* k_pool, const void* v_pool,
                         const void* k_scale, const void* v_scale, const void* tables,
                         const void* ctx_lens, void* out, void* part, int b, int hq, int hk,
                         int bs, int max_blocks, int n_split, float scale, float softcap,
                         int window, cudaStream_t st) {
    return pgk_launch_attention<Q, KV, D>(
        hq / hk > 8 ? paged_attention_kernel_wide<Q, KV, D> : paged_attention_kernel<Q, KV, D>,
        hq / hk, n_split, b * hk, b * hq,
        static_cast<float*>(part), static_cast<Q*>(out), st, static_cast<const Q*>(q),
        static_cast<const KV*>(k_pool), static_cast<const KV*>(v_pool),
        static_cast<const __nv_bfloat16*>(k_scale), static_cast<const __nv_bfloat16*>(v_scale),
        static_cast<const int*>(tables), static_cast<const int*>(ctx_lens),
        static_cast<float*>(part), hq, hk, bs, max_blocks, n_split, scale, softcap, window);
  }
};

}  // namespace

// q [b, hq, d] (q_kind 0 bf16, 1 f32); pools [nb, hk, bs, d] of storage
// kv_kind (one layer; int8 with [nb, bs] bf16 row scales k_scale and
// v_scale, else those may be null); tables [b, max_blocks] int32 physical
// block ids; ctx_lens [b] int32; out [b, hq, d] in q's dtype; part: b * hq *
// n_split * (d + 2) f32 scratch. softcap <= 0 disables it, window <= 0 means
// none. Requires d in {64, 80, 96, 128, 256}, hq % hk == 0, hq / hk <= 16, n_split >= 1,
// 16-byte aligned pools.
PGK_API int pgk_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                const void* k_scale, const void* v_scale, const void* tables,
                                const void* ctx_lens, void* out, void* part, int b, int hq,
                                int hk, int d, int bs, int max_blocks, int n_split, int q_kind,
                                int kv_kind, float scale, float softcap, int window,
                                void* stream) {
  if (b < 1 || hk < 1 || hq % hk != 0 || hq / hk > 16 || bs < 1 || max_blocks < 1 ||
      n_split < 1)
    return (int)cudaErrorInvalidValue;
  return (int)pgk_attn_dispatch<LaunchPaged>(q_kind, kv_kind, d, q, k_pool, v_pool, k_scale,
                                             v_scale, tables, ctx_lens, out, part, b, hq, hk,
                                             bs, max_blocks, n_split, scale, softcap, window,
                                             static_cast<cudaStream_t>(stream));
}
