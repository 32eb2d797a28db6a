// K-major weights for the block w4a8 GEMV (block_w4a8_gemv.cu): stored
// [K/2 packed, N] with N contiguous, as the model keeps them. A thread that
// loads one 32-bit word (4 columns) from each of 4 consecutive K rows
// transposes them in registers (pgk_transpose4), so each column's 4 K values
// sit in one word.
#pragma once

#include "common.cuh"

namespace {

constexpr int kKmMaxRows = 8;                   // activation rows at most

// w_j holds row j's bytes of 4 columns (column c in byte c). On return col[c]
// holds column c's bytes of the 4 rows (row j in byte j).
__device__ __forceinline__ void pgk_transpose4(unsigned w0, unsigned w1, unsigned w2,
                                               unsigned w3, unsigned (&col)[4]) {
  const unsigned a = __byte_perm(w0, w1, 0x5140);   // w0c0 w1c0 w0c1 w1c1
  const unsigned b = __byte_perm(w0, w1, 0x7362);   // w0c2 w1c2 w0c3 w1c3
  const unsigned c = __byte_perm(w2, w3, 0x5140);
  const unsigned d = __byte_perm(w2, w3, 0x7362);
  col[0] = __byte_perm(a, c, 0x5410);
  col[1] = __byte_perm(a, c, 0x7632);
  col[2] = __byte_perm(b, d, 0x5410);
  col[3] = __byte_perm(b, d, 0x7632);
}

}  // namespace
