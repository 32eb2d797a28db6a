// Batched decode attention over the dense serving pools: one query per head
// for every slot b against layer `layer` of the merged [B, L, MAX, Hk*D]
// pools (int8 pools: [B, L, MAX] bf16 row scales beside them).
//
// Replaces pygpukit_tpu/kernels/batch_decode_attention.py _bda_kernel.
//
// The body (bound, design, split, masking, rounding) is decode_attention.cuh's;
// here position p of slot b's layer is row p of the slot's [MAX, Hk*D] plane
// (its scale entry p of the slot's [MAX] scale row), live up to min(ctx, MAX).
//
// The step's row write, fused (kernels/kv_row_write.py kv_write_attention;
// it replaces pygpukit_tpu/kernels/kv_row_write.py kv_rows_write on the
// batch-rows step, and kv_row_write.cu keeps its own launch for every other
// caller): given the new rows and the positions, pass one first stores
// slot b's new K and V rows at p = clamp(poss[b], 0, MAX - 1), in the pool's
// storage (kv_row.cuh, bitwise the plain write), and then attends. A row
// written alone costs a launch of its own (a graph node of 8 KB, about
// 1.5 us a layer); here the blocks that read row p write it:
// - for each (slot, kv head) one block writes the head's D-wide segment:
//   the block of the split whose split_bounds range holds p, or split 0
//   when no split holds it (no live split, or p outside the window); no
//   other block reads row p (the splits' ranges do not overlap, and the
//   heads' segments do not either). A __syncthreads stands between the
//   write and the body's first pool load (cp.async through L2);
// - int8: the row scale spans the whole Hk*D row, so each writing block
//   takes the amax of the whole new row and writes the same scale bits.
// kernels/attention_split.py writes_row is the same rule.
#include "decode_attention.cuh"
#include "kv_row.cuh"

namespace {

struct DenseRows {
  int lanes_row;                       // Hk * D elements per pool row
  __device__ size_t operator()(int p) const { return (size_t)p * lanes_row; }
  __device__ size_t scale(int p) const { return (size_t)p; }
};

// Whether split `split` writes the new row p of its (slot, kv head): the
// split whose range of the live window [max(lo, 0), live) holds p, or split
// 0 when none does.
__device__ __forceinline__ bool bda_writes_row(int p, int lo, int live, int split, int n_split) {
  const int lo0 = lo > 0 ? lo : 0;
  if (p < lo0 || p >= live) return split == 0;
  int start, end;
  pgk_split_bounds(lo, live, split, n_split, start, end);
  return p >= start && p < end;
}

// Stores head h's segment of slot b's new K and V rows (k_new, v_new: the
// slot's [Hk*D] rows) at pool offset `row_off` (scale entry `srow`).
template <class Q, class KV, int D>
__device__ __forceinline__ void bda_write_row(const Q* __restrict__ kn, const Q* __restrict__ vn,
                                              KV* __restrict__ k_pool, KV* __restrict__ v_pool,
                                              __nv_bfloat16* __restrict__ k_scale,
                                              __nv_bfloat16* __restrict__ v_scale,
                                              size_t row_off, size_t srow, int h, int lanes_row) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    __shared__ float red[2][32];
    const __nv_bfloat16 ks = kv_row_int8_scale(kv_row_amax(kn, lanes_row, red[0]));
    const __nv_bfloat16 vs = kv_row_int8_scale(kv_row_amax(vn, lanes_row, red[1]));
    const float kf = __bfloat162float(ks), vf = __bfloat162float(vs);
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      k_pool[row_off + i] = kv_row_int8(pgk_to_f32(kn[h * D + i]), kf);
      v_pool[row_off + i] = kv_row_int8(pgk_to_f32(vn[h * D + i]), vf);
    }
    if (threadIdx.x == 0) {
      k_scale[srow] = ks;
      v_scale[srow] = vs;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      k_pool[row_off + i] = kv_row_convert<KV>(pgk_to_f32(kn[h * D + i]));
      v_pool[row_off + i] = kv_row_convert<KV>(pgk_to_f32(vn[h * D + i]));
    }
  }
}

// k_new, v_new, poss: the fused row write's operands, or null (no write).
template <class Q, class KV, int D>
__device__ __forceinline__ void bda_body(const Q* __restrict__ q, KV* __restrict__ k_pool,
                                         KV* __restrict__ v_pool,
                                         __nv_bfloat16* __restrict__ k_scale,
                                         __nv_bfloat16* __restrict__ v_scale,
                                         const int* __restrict__ ctx_lens,
                                         const Q* __restrict__ k_new, const Q* __restrict__ v_new,
                                         const int* __restrict__ poss, float* __restrict__ part,
                                         int hq, int hk, int layer, int n_layers, int max_len,
                                         int n_split, float scale, float softcap, int window) {
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
  if (poss != nullptr) {
    int p = poss[b];
    p = p < 0 ? 0 : (p > max_len - 1 ? max_len - 1 : p);
    const int lo = window > 0 ? ctx - window : -(1 << 30);
    if (bda_writes_row(p, lo, live, blockIdx.x, n_split)) {
      bda_write_row<Q, KV, D>(k_new + (size_t)b * lanes_row, v_new + (size_t)b * lanes_row,
                              k_pool, v_pool, k_scale, v_scale,
                              pool_off + (size_t)p * lanes_row, plane + p, h, lanes_row);
      __syncthreads();                 // the row stored before any thread loads it
    }
  }
  pgk_decode_attention_split<Q, KV, D>(
      q + head0 * D, k_pool + pool_off, v_pool + pool_off, int8 ? k_scale + plane : nullptr,
      int8 ? v_scale + plane : nullptr, DenseRows{lanes_row}, g_heads, ctx, live, window,
      blockIdx.x, n_split, scale, softcap, part + head0 * n_split, part + n + head0 * n_split,
      part + 2 * n + head0 * n_split * D);
}

#define PGK_BDA_PARAMS                                                                       \
  const Q *__restrict__ q, KV *__restrict__ k_pool, KV *__restrict__ v_pool,                 \
      __nv_bfloat16 *__restrict__ k_scale, __nv_bfloat16 *__restrict__ v_scale,              \
      const int *__restrict__ ctx_lens, const Q *__restrict__ k_new,                         \
      const Q *__restrict__ v_new, const int *__restrict__ poss, float *__restrict__ part,   \
      int hq, int hk, int layer, int n_layers, int max_len, int n_split, float scale,        \
      float softcap, int window
#define PGK_BDA_ARGS                                                                         \
  q, k_pool, v_pool, k_scale, v_scale, ctx_lens, k_new, v_new, poss, part, hq, hk, layer,    \
      n_layers, max_len, n_split, scale, softcap, window

// Up to 8 query heads a kv head (256 threads) the compiler takes the
// registers it likes; 9 to 16 (512 threads) cap a thread at 128, or the
// launch would ask for more than an SM holds.
template <class Q, class KV, int D>
__global__ void bda_kernel(PGK_BDA_PARAMS) { bda_body<Q, KV, D>(PGK_BDA_ARGS); }

template <class Q, class KV, int D>
__global__ void __launch_bounds__(512) bda_kernel_wide(PGK_BDA_PARAMS) {
  bda_body<Q, KV, D>(PGK_BDA_ARGS);
}

template <class Q, class KV, int D>
struct LaunchBda {
  static cudaError_t run(const void* q, const void* k_pool, const void* v_pool,
                         const void* k_scale, const void* v_scale, const void* ctx_lens,
                         const void* k_new, const void* v_new, const void* poss, void* out,
                         void* part, int b, int hq, int hk, int layer, int n_layers,
                         int max_len, int n_split, float scale, float softcap, int window,
                         cudaStream_t st) {
    return pgk_launch_attention<Q, KV, D>(
        hq / hk > 8 ? bda_kernel_wide<Q, KV, D> : bda_kernel<Q, KV, D>, hq / hk, n_split,
        b * hk, b * hq, static_cast<float*>(part),
        static_cast<Q*>(out), st, static_cast<const Q*>(q), (KV*)k_pool, (KV*)v_pool,
        (__nv_bfloat16*)k_scale, (__nv_bfloat16*)v_scale, static_cast<const int*>(ctx_lens),
        static_cast<const Q*>(k_new), static_cast<const Q*>(v_new),
        static_cast<const int*>(poss), static_cast<float*>(part), hq, hk, layer, n_layers,
        max_len, n_split, scale, softcap, window);
  }
};

}  // namespace

// q [b, hq, d] (q_kind 0 bf16, 1 f32); pools [b, n_layers, max_len, hk*d] of
// storage kv_kind (kPgkKv*; int8 with [b, n_layers, max_len] bf16 row scales
// k_scale and v_scale, else those may be null); ctx_lens [b] int32 (lengths
// including the row just written; may exceed max_len); out [b, hq, d] in q's
// dtype; part: b * hq * n_split * (d + 2) f32 scratch (pm, pl [b*hq,
// n_split], then pacc [b*hq, n_split, d]). softcap <= 0 disables it, window
// <= 0 means none. k_new, v_new [b, hk*d] in q's dtype and poss [b] int32:
// the fused row write's operands (written in place first), or all null.
// Requires d in {64, 80, 96, 128, 256}, hq % hk == 0, hq / hk <= 16, n_split >= 1,
// 16-byte aligned pools.
PGK_API int pgk_batch_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                       const void* k_scale, const void* v_scale,
                                       const void* ctx_lens, const void* k_new,
                                       const void* v_new, const void* poss, void* out,
                                       void* part, int b, int hq, int hk, int d, int layer,
                                       int n_layers, int max_len, int n_split, int q_kind,
                                       int kv_kind, float scale, float softcap, int window,
                                       void* stream) {
  if (b < 1 || hk < 1 || hq % hk != 0 || hq / hk > 16 || layer < 0 || layer >= n_layers ||
      max_len < 1 || n_split < 1 || (poss != nullptr && (k_new == nullptr || v_new == nullptr)))
    return (int)cudaErrorInvalidValue;
  return (int)pgk_attn_dispatch<LaunchBda>(q_kind, kv_kind, d, q, k_pool, v_pool, k_scale,
                                           v_scale, ctx_lens, k_new, v_new, poss, out, part, b,
                                           hq, hk, layer, n_layers, max_len, n_split, scale,
                                           softcap, window,
                                           static_cast<cudaStream_t>(stream));
}
