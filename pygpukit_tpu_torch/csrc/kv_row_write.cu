// Per-slot KV row write for the batch-rows decode step: for every slot b,
// k_pool[b, layer, clamp(poss[b]), :] = k_new[b, :] (and the same for v).
//
// Replaces pygpukit_tpu/kernels/kv_row_write.py _krw_kernel (kv_rows_write).
//
// Bound: bytes, and at these sizes launch latency: a call moves
// 2 * B * Hk*D * 2 bytes (8 KB for B = 8, Hk*D = 256). The TPU kernel needed a
// read-modify-write blend of an 8-row window because Mosaic could not store a
// single dynamic sublane; on the card a block simply stores its slot's row.
// Design: grid = B, one block per slot, threads striding the row. Positions
// clamp to [0, MAX-1], as lax.dynamic_update_slice clamps in the XLA write
// the TPU kernel replaced, so a free slot decoding past the end of its pool
// never writes outside it. The copy is of raw 16-bit patterns: bitwise.
#include "common.cuh"

namespace {

__global__ void kv_rows_write_kernel(const uint16_t* __restrict__ k_new,
                                     const uint16_t* __restrict__ v_new,
                                     uint16_t* __restrict__ k_pool,
                                     uint16_t* __restrict__ v_pool,
                                     const int* __restrict__ poss, int layer,
                                     int n_layers, int max_len, int row) {
  const int b = blockIdx.x;
  int p = poss[b];
  p = p < 0 ? 0 : (p > max_len - 1 ? max_len - 1 : p);
  const size_t dst = (((size_t)b * n_layers + layer) * max_len + p) * row;
  const size_t src = (size_t)b * row;
  for (int i = threadIdx.x; i < row; i += blockDim.x) {
    k_pool[dst + i] = k_new[src + i];
    v_pool[dst + i] = v_new[src + i];
  }
}

}  // namespace

// k_new, v_new [b, row] 16-bit (bf16); pools [b, n_layers, max_len, row]
// 16-bit, written in place; poss [b] int32.
PGK_API int pgk_kv_rows_write(const void* k_new, const void* v_new,
                              void* k_pool, void* v_pool, const void* poss,
                              int b, int layer, int n_layers, int max_len,
                              int row, void* stream) {
  if (b < 1 || layer < 0 || layer >= n_layers || max_len < 1 || row < 1)
    return (int)cudaErrorInvalidValue;
  kv_rows_write_kernel<<<b, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(k_new), static_cast<const uint16_t*>(v_new),
      static_cast<uint16_t*>(k_pool), static_cast<uint16_t*>(v_pool),
      static_cast<const int*>(poss), layer, n_layers, max_len, row);
  return (int)cudaGetLastError();
}
