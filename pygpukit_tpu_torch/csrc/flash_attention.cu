// Flash attention (prefill) and flash decoding.
//
// Replaces pygpukit_tpu/kernels/flash_attention.py _flash_pallas (the
// prefill kernel) and _decode_pallas (one query row over a fixed cache).
//
// Both compute the reference's online-softmax recurrence: running max from
// -1e30, sum and accumulator in f32, s = (q.k) * scale, masked keys at -1e30
// with p = 0, p = exp(s - m_new), alpha = exp(m_prev - m_new), P rounded to
// the input dtype before P.V, out = acc / max(l, 1e-30) in the input dtype.
// No atomics and every reduction in a fixed order: a replay is bitwise.
//
// flash_attention. Bound: operations. The causal work is 4 Hq D S(S+1)/2
// flops for (q + k + v + out) bytes once, so above S of a few hundred the
// tensor cores bound it (1.1B layer at S 2048: 17.2 GFLOP, 17.4 us at 989
// TFLOP/s; 18.9 MB, 5.6 us at 3.35 TB/s). Design (bf16): one block of four
// warps per (query head, 64-query tile), heaviest causal tiles first; each
// warp keeps its 16 query rows as mma A fragments in registers. K and V
// tiles of 64 keys stream through shared memory with 16-byte cp.async,
// double-buffered; Q.K^T and P.V run on the tensor cores (mma.sync m16n8k16
// bf16 -> f32), B fragments through ldmatrix (.trans for V), and the score
// accumulators turn into P's A fragments in registers. Tiles past the
// causal diagonal are never loaded. GQA: a query head reads its kv head's
// tiles; the G heads of a group hit the same tiles in L2, so the expanded
// K/V of the reference's jnp.repeat never exist. f32 inputs run on CUDA
// cores (f32 FMA, never TF32: the reference holds f32 at HIGHEST), 16 query
// rows per block, one lane per key for the scores and per head dimension
// for P.V.
//
// flash_decode. Bound: bytes. One query row per head reads every live K and
// V row once (2 ctx Hk D elt bytes, 8.4 MB at ctx 8192, Hk 4, D 64, bf16:
// 2.5 us). One block per kv head would give 4 blocks for 132 SMs, so the
// context splits into chunks (flash decoding): pass one runs the recurrence
// over one chunk per block for the G query heads of one kv head (a warp
// each; K/V staged once in shared memory as f32), pass two folds the
// chunks' (m, l, acc) in ascending chunk order. The split depends only on
// ctx and Hk, so a replay gives the same bits.
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------------------
// flash_attention, bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 64;              // query rows per block (4 warps x 16)
constexpr int kBN = 64;              // keys per tile
constexpr int kThreads = 128;

template <int D>
constexpr int fa_smem_bytes() {
  return 2 * 2 * kBN * (D + 8) * 2;  // {K, V} x 2 buffers x padded rows
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int s, int hq, int hk,
                  int causal, float scale) {
  constexpr int kStride = D + 8;     // padded shared row: ldmatrix rows hit distinct banks
  constexpr int kKS = D / 16;        // k-steps of Q.K^T
  constexpr int kDT = D / 8;         // 8-wide output column tiles
  constexpr int kNT = kBN / 8;       // 8-key score tiles
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* ks = reinterpret_cast<bf16*>(fa_smem);          // [2][kBN][kStride]
  bf16* vs = ks + 2 * kBN * kStride;                    // [2][kBN][kStride]

  const int n_q = (s + kBM - 1) / kBM;
  const int qt = n_q - 1 - (int)blockIdx.x;             // heaviest causal tiles first
  const int h = blockIdx.y;
  const int kvh = h / (hq / hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBM;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;       // this thread's two rows
  const size_t row_q = (size_t)hq * D, row_kv = (size_t)hk * D;

  uint32_t qa[kKS][4];
  {
    const bf16* p0 = q + (size_t)r0 * row_q + (size_t)h * D;
    const bf16* p1 = q + (size_t)r1 * row_q + (size_t)h * D;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = r0 < s ? ld_u32(p0 + c) : 0u;
      qa[kk][1] = r1 < s ? ld_u32(p1 + c) : 0u;
      qa[kk][2] = r0 < s ? ld_u32(p0 + c + 8) : 0u;
      qa[kk][3] = r1 < s ? ld_u32(p1 + c + 8) : 0u;
    }
  }

  auto load_tile = [&](int j, int buf) {
    constexpr int kVec = D / 8;                         // 16-byte vectors per row
    bf16* kd = ks + buf * kBN * kStride;
    bf16* vd = vs + buf * kBN * kStride;
    for (int i = threadIdx.x; i < kBN * kVec; i += kThreads) {
      const int r = i / kVec, c = (i % kVec) * 8;
      const int p = j * kBN + r;
      const bool ok = p < s;
      const size_t off = (size_t)(ok ? p : 0) * row_kv + (size_t)kvh * D + c;
      cp_async16(kd + r * kStride + c, k + off, ok);
      cp_async16(vd + r * kStride + c, v + off, ok);
    }
    cp_async_commit();
  };

  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int n_kv = (s + kBN - 1) / kBN;
  const int diag = min(s - 1, q0 + kBM - 1) / kBN;      // last tile a row of this block sees
  const int last = causal ? min(n_kv - 1, diag) : n_kv - 1;
  load_tile(0, 0);
  for (int j = 0; j <= last; ++j) {
    if (j < last) {
      load_tile(j + 1, (j + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + (j & 1) * kBN * kStride;
    const bf16* vt = vs + (j & 1) * kBN * kStride;

    float sc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; nt += 2) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        // matrices: keys nt*8.. x (d lo, d hi), keys nt*8+8.. x (d lo, d hi)
        uint32_t b[4];
        const int key = nt * 8 + (lane & 7) + (lane >> 4) * 8;
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(b, kt + key * kStride + col);
        mma_bf16(sc[nt], qa[kk], b[0], b[1]);
        mma_bf16(sc[nt + 1], qa[kk], b[2], b[3]);
      }
    }

    // scale, mask, running max (rows r0: e 0-1, r1: e 2-3)
    const int kv0 = j * kBN;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool dead = key >= s || (causal && key > row);
        const float x = dead ? kNegInf : sc[nt][e] * scale;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_new[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m_i[i], mx[i]);
      alpha[i] = expf(m_i[i] - m_new[i]);
    }
    // p, its row sums, and P rounded to bf16 as A fragments (keys 16kk..)
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool dead = key >= s || (causal && key > row);
        p[e] = dead ? 0.f : expf(sc[nt][e] - m_new[e >> 1]);
      }
      rs[0] += p[0] + p[1];
      rs[1] += p[2] + p[3];
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_i[i] = l_i[i] * alpha[i] + rs[i];
      m_i[i] = m_new[i];
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt < kDT; dt += 2) {
        // matrices: keys (16kk.., 16kk+8..) x d dt*8.., then x d dt*8+8..
        uint32_t b[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = dt * 8 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b, vt + key * kStride + col);
        mma_bf16(acc[dt], pa[kk], b[0], b[1]);
        mma_bf16(acc[dt + 1], pa[kk], b[2], b[3]);
      }
    }
    __syncthreads();                   // this buffer is refilled two tiles on
  }

  const float l0 = fmaxf(l_i[0], 1e-30f), l1 = fmaxf(l_i[1], 1e-30f);
  bf16* o0 = o + (size_t)r0 * row_q + (size_t)h * D;
  bf16* o1 = o + (size_t)r1 * row_q + (size_t)h * D;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < s) *reinterpret_cast<uint32_t*>(o0 + c) = pack_bf16(acc[dt][0] / l0, acc[dt][1] / l0);
    if (r1 < s) *reinterpret_cast<uint32_t*>(o1 + c) = pack_bf16(acc[dt][2] / l1, acc[dt][3] / l1);
  }
}

// ---------------------------------------------------------------------------
// flash_attention, f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 4;                       // query rows per warp
constexpr int kF32Q = 4 * kF32Rows;               // query rows per block
constexpr int kF32C = 32;                         // keys per tile

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int s, int hq, int hk,
                 int causal, float scale) {
  constexpr int kPad = D + 1;                     // lane-per-key row reads hit distinct banks
  constexpr int kDPL = D / 32;                    // output dims per lane: lane + 32 j
  __shared__ float ks[kF32C][kPad];
  __shared__ float vs[kF32C][kPad];
  __shared__ float qs[kF32Q][D];
  __shared__ float ps[4][kF32Rows][kF32C];

  const int n_q = (s + kF32Q - 1) / kF32Q;
  const int qt = n_q - 1 - (int)blockIdx.x;
  const int h = blockIdx.y;
  const int kvh = h / (hq / hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * kF32Q;
  const size_t row_q = (size_t)hq * D, row_kv = (size_t)hk * D;

  for (int i = threadIdx.x; i < kF32Q * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r][c] = q0 + r < s ? q[(size_t)(q0 + r) * row_q + (size_t)h * D + c] : 0.f;
  }
  float m[kF32Rows], l[kF32Rows], acc[kF32Rows][kDPL];
#pragma unroll
  for (int rr = 0; rr < kF32Rows; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < kDPL; ++j) acc[rr][j] = 0.f;
  }

  const int key_end = causal ? min(s, q0 + kF32Q) : s;
  for (int kv0 = 0; kv0 < key_end; kv0 += kF32C) {
    __syncthreads();                              // previous tile fully consumed
    for (int i = threadIdx.x; i < kF32C * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int p = kv0 + r;
      const size_t off = (size_t)p * row_kv + (size_t)kvh * D + c;
      ks[r][c] = p < s ? k[off] : 0.f;
      vs[r][c] = p < s ? v[off] : 0.f;
    }
    __syncthreads();
    const int key = kv0 + lane;
#pragma unroll
    for (int rr = 0; rr < kF32Rows; ++rr) {
      const int row = q0 + warp * kF32Rows + rr;
      const float* qr = qs[warp * kF32Rows + rr];
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot += qr[d] * ks[lane][d];
      const bool dead = key >= s || (causal && key > row);
      const float x = dead ? kNegInf : dot * scale;
      const float m_new = fmaxf(m[rr], pgk_warp_max(x));
      const float p = dead ? 0.f : expf(x - m_new);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + pgk_warp_sum(p);
      m[rr] = m_new;
      ps[warp][rr][lane] = p;                     // rounding to f32 is the identity
#pragma unroll
      for (int j = 0; j < kDPL; ++j) acc[rr][j] *= alpha;
    }
    __syncwarp();
    for (int c = 0; c < kF32C; ++c) {
#pragma unroll
      for (int rr = 0; rr < kF32Rows; ++rr) {
        const float pr = ps[warp][rr][c];
#pragma unroll
        for (int j = 0; j < kDPL; ++j) acc[rr][j] += pr * vs[c][lane + 32 * j];
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int rr = 0; rr < kF32Rows; ++rr) {
    const int row = q0 + warp * kF32Rows + rr;
    if (row >= s) continue;
    const float lf = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDPL; ++j)
      o[(size_t)row * row_q + (size_t)h * D + lane + 32 * j] = acc[rr][j] / lf;
  }
}

template <int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* out, int s, int hq,
                         int hk, int causal, int is_f32, float scale, cudaStream_t st) {
  if (is_f32) {
    const dim3 grid((s + kF32Q - 1) / kF32Q, hq);
    flash_f32_kernel<D><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), s, hq, hk, causal, scale);
    return cudaGetLastError();
  }
  constexpr int smem = fa_smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((s + kBM - 1) / kBM, hq);
  flash_bf16_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), s, hq, hk, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash_decode: split context, then an ordered combine
// ---------------------------------------------------------------------------

constexpr int kDecC = 64;                         // cache rows staged per step

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

static inline size_t decode_smem_bytes(int d, int g) {
  return (size_t)(2 * kDecC * (d + 1) + g * d + g * kDecC) * 4;
}

// Block (chunk c, kv head): keys [c * chunk, min(live, (c + 1) * chunk)) for
// the G query heads of the kv head, one warp each. Writes the chunk's
// running max, sum and unnormalised accumulator.
template <typename T, int D>
__global__ void flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                                          const T* __restrict__ vc, float* __restrict__ pm,
                                          float* __restrict__ pl, float* __restrict__ pacc,
                                          int live, int hq, int hk, int chunk, int n_split,
                                          float scale) {
  constexpr int kPad = D + 1;
  constexpr int kDPL = D / 32;
  constexpr int kVec = 16 / (int)sizeof(T);       // elements per 16-byte load
  extern __shared__ __align__(16) float dec_smem[];
  const int g_heads = hq / hk;
  float* ks = dec_smem;                           // [kDecC][kPad]
  float* vs = ks + kDecC * kPad;
  float* qs = vs + kDecC * kPad;                  // [G][D]
  float* ps = qs + g_heads * D;                   // [G][kDecC]
  const int split = blockIdx.x, kvh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = kvh * g_heads + warp;

  for (int i = threadIdx.x; i < g_heads * D; i += blockDim.x)
    qs[i] = pgk_to_f32(q[(size_t)kvh * g_heads * D + i]);
  const int begin = split * chunk;
  const int end = min(live, begin + chunk);
  float m = kNegInf, l = 0.f, acc[kDPL];
#pragma unroll
  for (int j = 0; j < kDPL; ++j) acc[j] = 0.f;

  for (int c0 = begin; c0 < end; c0 += kDecC) {
    __syncthreads();
    for (int i = threadIdx.x; i < kDecC * (D / kVec); i += blockDim.x) {
      const int r = i / (D / kVec), c = (i % (D / kVec)) * kVec;
      const int p = c0 + r;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (p < end) {
        const size_t off = (size_t)p * hk * D + (size_t)kvh * D + c;
        kr = *reinterpret_cast<const uint4*>(kc + off);
        vr = *reinterpret_cast<const uint4*>(vc + off);
      }
      const T* ke = reinterpret_cast<const T*>(&kr);
      const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ks[r * kPad + c + e] = pgk_to_f32(ke[e]);
        vs[r * kPad + c + e] = pgk_to_f32(ve[e]);
      }
    }
    __syncthreads();
    const float* qh = qs + warp * D;
    float sv[2];
    bool dead[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = lane + 32 * u;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot += qh[d] * ks[r * kPad + d];
      dead[u] = c0 + r >= end;
      sv[u] = dead[u] ? kNegInf : dot * scale;
    }
    const float m_new = fmaxf(m, pgk_warp_max(fmaxf(sv[0], sv[1])));
    const float p0 = dead[0] ? 0.f : expf(sv[0] - m_new);
    const float p1 = dead[1] ? 0.f : expf(sv[1] - m_new);
    const float alpha = expf(m - m_new);
    l = l * alpha + pgk_warp_sum(p0 + p1);
    m = m_new;
    float* pw = ps + warp * kDecC;
    pw[lane] = round_to<T>(p0);
    pw[lane + 32] = round_to<T>(p1);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kDPL; ++j) acc[j] *= alpha;
    for (int r = 0; r < kDecC; ++r) {
      const float pr = pw[r];
#pragma unroll
      for (int j = 0; j < kDPL; ++j) acc[j] += pr * vs[r * kPad + lane + 32 * j];
    }
  }
  const size_t slot = (size_t)h * n_split + split;
  if (lane == 0) {
    pm[slot] = m;
    pl[slot] = l;
  }
#pragma unroll
  for (int j = 0; j < kDPL; ++j) pacc[slot * D + lane + 32 * j] = acc[j];
}

// One warp per query head: fold the chunks in ascending order.
template <typename T, int D>
__global__ void flash_decode_combine_kernel(const float* __restrict__ pm,
                                            const float* __restrict__ pl,
                                            const float* __restrict__ pacc, T* __restrict__ out,
                                            int n_split) {
  constexpr int kDPL = D / 32;
  const int h = blockIdx.x, lane = threadIdx.x;
  const float* mh = pm + (size_t)h * n_split;
  float mx = kNegInf;
  for (int c = 0; c < n_split; ++c) mx = fmaxf(mx, mh[c]);
  float l = 0.f, acc[kDPL];
#pragma unroll
  for (int j = 0; j < kDPL; ++j) acc[j] = 0.f;
  for (int c = 0; c < n_split; ++c) {
    const float w = expf(mh[c] - mx);
    l += pl[(size_t)h * n_split + c] * w;
    const float* a = pacc + ((size_t)h * n_split + c) * D;
#pragma unroll
    for (int j = 0; j < kDPL; ++j) acc[j] += a[lane + 32 * j] * w;
  }
  const float lf = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < kDPL; ++j) out[(size_t)h * D + lane + 32 * j] = from_f32<T>(acc[j] / lf);
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* kc, const void* vc, void* out, void* pm,
                          void* pl, void* pacc, int live, int hq, int hk, int chunk,
                          int n_split, float scale, cudaStream_t st) {
  const int g = hq / hk;
  if (n_split > 0) {
    const size_t smem = decode_smem_bytes(D, g);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(flash_decode_split_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return e;
    }
    flash_decode_split_kernel<T, D><<<dim3(n_split, hk), 32 * g, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
        static_cast<float*>(pm), static_cast<float*>(pl), static_cast<float*>(pacc), live, hq,
        hk, chunk, n_split, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  flash_decode_combine_kernel<T, D><<<hq, 32, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pl),
      static_cast<const float*>(pacc), static_cast<T*>(out), n_split);
  return cudaGetLastError();
}

}  // namespace

// q [s, hq, d], k and v [s, hk, d], out [s, hq, d]; contiguous, 16-byte
// aligned, all bf16 (is_f32 == 0) or all f32. causal masks keys > query.
// Requires s >= 1, d in {64, 128}, hq % hk == 0.
PGK_API int pgk_flash_attention(const void* q, const void* k, const void* v, void* out, int s,
                                int hq, int hk, int d, int causal, int is_f32, float scale,
                                void* stream) {
  if (s < 1 || hk < 1 || hq % hk != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return (int)launch_flash<64>(q, k, v, out, s, hq, hk, causal, is_f32, scale, st);
  if (d == 128) return (int)launch_flash<128>(q, k, v, out, s, hq, hk, causal, is_f32, scale, st);
  return (int)cudaErrorInvalidValue;
}

// q [hq, d], caches [max_len, hk, d] (rows [0, live) read), out [hq, d];
// contiguous, 16-byte aligned, all bf16 or all f32. pm, pl [hq, n_split] and
// pacc [hq, n_split, d] f32 scratch; n_split = ceil(live / chunk), chunk a
// multiple of 64 (n_split 0 writes zeros, as the reference does for an empty
// context). Requires d in {64, 128}, hq % hk == 0, hq / hk <= 32.
PGK_API int pgk_flash_decode(const void* q, const void* kc, const void* vc, void* out, void* pm,
                             void* pl, void* pacc, int live, int hq, int hk, int d, int chunk,
                             int n_split, int is_f32, float scale, void* stream) {
  if (hk < 1 || hq % hk != 0 || hq / hk > 32 || chunk < 1 || chunk % kDecC != 0 ||
      n_split < 0 || (long long)n_split * chunk < live || live < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return is_f32 ? (int)launch_decode<float, 64>(q, kc, vc, out, pm, pl, pacc, live, hq, hk,
                                                  chunk, n_split, scale, st)
                  : (int)launch_decode<bf16, 64>(q, kc, vc, out, pm, pl, pacc, live, hq, hk,
                                                 chunk, n_split, scale, st);
  if (d == 128)
    return is_f32 ? (int)launch_decode<float, 128>(q, kc, vc, out, pm, pl, pacc, live, hq, hk,
                                                   chunk, n_split, scale, st)
                  : (int)launch_decode<bf16, 128>(q, kc, vc, out, pm, pl, pacc, live, hq, hk,
                                                  chunk, n_split, scale, st);
  return (int)cudaErrorInvalidValue;
}
