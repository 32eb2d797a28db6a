// Per-slot KV row write for the batch-rows decode step: for every slot b,
// k_pool[b, layer, clamp(poss[b]), :] = convert(k_new[b, :]) (and the same for
// v), in the pools' storage.
//
// Replaces pygpukit_tpu/kernels/kv_row_write.py _krw_kernel (kv_rows_write).
//
// Bound: bytes, and at these sizes launch latency: a call moves 2 * B rows
// in and out (8 KB for B = 8, Hk*D = 256 in bf16). The TPU kernel needed a
// read-modify-write blend of an 8-row window because Mosaic could not store
// a single dynamic sublane; on the card a block simply stores its row.
// Design: grid (B, 2), one block per (slot, K or V), threads striding the
// row. Positions clamp to [0, MAX-1], as lax.dynamic_update_slice clamps in
// the XLA write the TPU kernel replaced, so a free slot decoding past the end
// of its pool never writes outside it.
//
// Every storage the engines build, bitwise as the plain version
// (kv_row.cuh, which batch_decode_attention.cu's fused write shares).
#include "kv_row.cuh"

namespace {

constexpr int kKrwThreads = 256;

template <class N, class P>
__global__ void __launch_bounds__(kKrwThreads)
kv_rows_write_kernel(const N* __restrict__ k_new, const N* __restrict__ v_new,
                     P* __restrict__ k_pool, P* __restrict__ v_pool,
                     __nv_bfloat16* __restrict__ k_scale, __nv_bfloat16* __restrict__ v_scale,
                     const int* __restrict__ poss, int layer, int n_layers, int max_len,
                     int row) {
  const int b = blockIdx.x;
  const bool is_v = blockIdx.y == 1;
  int p = poss[b];
  p = p < 0 ? 0 : (p > max_len - 1 ? max_len - 1 : p);
  const size_t plane_row = ((size_t)b * n_layers + layer) * max_len + p;
  const N* src = (is_v ? v_new : k_new) + (size_t)b * row;
  P* dst = (is_v ? v_pool : k_pool) + plane_row * row;
  if constexpr (std::is_same<P, int8_t>::value) {
    __shared__ float red[kKrwThreads / 32];
    const __nv_bfloat16 sb = kv_row_int8_scale(kv_row_amax(src, row, red));
    const float sf = __bfloat162float(sb);
    for (int i = threadIdx.x; i < row; i += kKrwThreads) dst[i] = kv_row_int8(pgk_to_f32(src[i]), sf);
    if (threadIdx.x == 0) (is_v ? v_scale : k_scale)[plane_row] = sb;
  } else {
    for (int i = threadIdx.x; i < row; i += kKrwThreads)
      dst[i] = kv_row_convert<P>(pgk_to_f32(src[i]));
  }
}

template <class N, class P>
cudaError_t launch_krw(const void* k_new, const void* v_new, void* k_pool, void* v_pool,
                       void* k_scale, void* v_scale, const void* poss, int b, int layer,
                       int n_layers, int max_len, int row, cudaStream_t st) {
  kv_rows_write_kernel<N, P><<<dim3(b, 2), kKrwThreads, 0, st>>>(
      static_cast<const N*>(k_new), static_cast<const N*>(v_new), static_cast<P*>(k_pool),
      static_cast<P*>(v_pool), static_cast<__nv_bfloat16*>(k_scale),
      static_cast<__nv_bfloat16*>(v_scale), static_cast<const int*>(poss), layer, n_layers,
      max_len, row);
  return cudaGetLastError();
}

template <class N>
cudaError_t launch_krw_pool(int pool_kind, const void* k_new, const void* v_new, void* k_pool,
                            void* v_pool, void* k_scale, void* v_scale, const void* poss, int b,
                            int layer, int n_layers, int max_len, int row, cudaStream_t st) {
#define PGK_KRW(P) \
  launch_krw<N, P>(k_new, v_new, k_pool, v_pool, k_scale, v_scale, poss, b, layer, n_layers, \
                   max_len, row, st)
  switch (pool_kind) {   // the storage kinds of decode_attention.cuh
    case 0: return PGK_KRW(__nv_bfloat16);
    case 1: return PGK_KRW(float);
    case 2: return PGK_KRW(__nv_fp8_e4m3);
    case 3: return PGK_KRW(__nv_fp8_e5m2);
    case 4: return PGK_KRW(int8_t);
    default: return cudaErrorInvalidValue;
  }
#undef PGK_KRW
}

}  // namespace

// k_new, v_new [b, row] (new_kind 0 bf16, 1 f32); pools [b, n_layers,
// max_len, row] of storage pool_kind (0 bf16, 1 f32, 2 fp8 e4m3, 3 fp8
// e5m2, 4 int8 with [b, n_layers, max_len] bf16 row scales k_scale and
// v_scale, else those may be null), written in place; poss [b] int32.
PGK_API int pgk_kv_rows_write(const void* k_new, const void* v_new, void* k_pool, void* v_pool,
                              void* k_scale, void* v_scale, const void* poss, int b, int layer,
                              int n_layers, int max_len, int row, int new_kind, int pool_kind,
                              void* stream) {
  if (b < 1 || layer < 0 || layer >= n_layers || max_len < 1 || row < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (new_kind == 0)
    return (int)launch_krw_pool<__nv_bfloat16>(pool_kind, k_new, v_new, k_pool, v_pool, k_scale,
                                               v_scale, poss, b, layer, n_layers, max_len, row,
                                               st);
  if (new_kind == 1)
    return (int)launch_krw_pool<float>(pool_kind, k_new, v_new, k_pool, v_pool, k_scale,
                                       v_scale, poss, b, layer, n_layers, max_len, row, st);
  return (int)cudaErrorInvalidValue;
}
