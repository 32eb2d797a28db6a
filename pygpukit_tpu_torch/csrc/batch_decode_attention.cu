// Batched decode attention over the dense serving pools: one query per head
// for every slot b against layer `layer` of the merged [B, L, MAX, Hk*D] pools.
//
// Replaces pygpukit_tpu/kernels/batch_decode_attention.py _bda_kernel.
//
// Bound: bytes. Each step reads every live K and V row of every slot once
// (2 * ctx * Hk*D * 2 bytes per slot) for G = Hq/Hk = 8 dot products per row.
// Design: one block per (slot, kv head) and one warp per query head of the
// group, so a K/V chunk loaded into shared memory once serves all G heads.
// Chunks of 64 rows cover only the live context [max(0, ctx - window),
// min(ctx, MAX)); dead capacity is never read. Scores, the running max and
// the sum follow the reference's online softmax: scale, optional softcap
// cap*tanh(s/cap), mask pos >= ctx or pos < ctx - window to -1e30, explicit
// p = 0 on dead positions, l floored at 1e-30 at the end, and P rounded to the
// query dtype (bf16) before the P@V product as the reference does. Warp
// reductions run in a fixed xor-tree order: no atomics, bitwise replayable.
// 16-byte global loads; shared rows are padded to D/2 + 1 words so the
// per-lane row reads of the score loop hit distinct banks.
// Occupancy note: B * Hk = 32 blocks on the 1.1B shape underfill the card's
// 132 SMs; splitting the context across blocks (split-KV with a second
// combine pass) is the next step for long contexts.
#include "common.cuh"

namespace {

constexpr int kChunk = 64;
constexpr float kNegInf = -1e30f;

template <int D>
__global__ void bda_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k_pool,
                           const __nv_bfloat16* __restrict__ v_pool,
                           const int* __restrict__ ctx_lens,
                           __nv_bfloat16* __restrict__ out, int hq, int hk,
                           int layer, int n_layers, int max_len, float scale,
                           float softcap, int window) {
  constexpr int kDW = D / 2 + 1;       // padded 32-bit words per shared row
  constexpr int kDPL = D / 32;         // output dims per lane
  constexpr int kVec = D / 8;          // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char pgk_bda_smem[];
  const int g_heads = hq / hk;
  uint32_t* ks = reinterpret_cast<uint32_t*>(pgk_bda_smem);
  uint32_t* vs = ks + kChunk * kDW;
  float* qs = reinterpret_cast<float*>(vs + kChunk * kDW);      // [G, D]
  float* ps = qs + g_heads * D;                                 // [G, C]

  // blockDim.x == 32 * g_heads: warp w serves query head h * g_heads + w
  const int b = blockIdx.x / hk;
  const int h = blockIdx.x % hk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lanes_row = hk * D;

  const __nv_bfloat16* qb = q + ((size_t)b * hq + (size_t)h * g_heads) * D;
  for (int i = threadIdx.x; i < g_heads * D; i += blockDim.x)
    qs[i] = __bfloat162float(qb[i]);

  const int ctx = ctx_lens[b];
  const int live = ctx < max_len ? ctx : max_len;
  const int lo = window > 0 ? ctx - window : -(1 << 30);
  const int c_begin = lo > 0 ? lo / kChunk : 0;
  const int c_end = live > 0 ? (live + kChunk - 1) / kChunk : 0;
  const size_t pool_off = ((size_t)b * n_layers + layer) * max_len * lanes_row + (size_t)h * D;
  const __nv_bfloat16* kbase = k_pool + pool_off;
  const __nv_bfloat16* vbase = v_pool + pool_off;

  float m = kNegInf, l = 0.f;
  float acc[kDPL];
#pragma unroll
  for (int j = 0; j < kDPL; ++j) acc[j] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    __syncthreads();                    // previous chunk fully consumed
    for (int i = threadIdx.x; i < kChunk * kVec; i += blockDim.x) {
      const int r = i / kVec, v = i % kVec;
      const int p = c * kChunk + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (p < max_len) {
        kv = *reinterpret_cast<const uint4*>(kbase + (size_t)p * lanes_row + v * 8);
        vv = *reinterpret_cast<const uint4*>(vbase + (size_t)p * lanes_row + v * 8);
      }
      uint32_t* kd = ks + r * kDW + v * 4;
      uint32_t* vd = vs + r * kDW + v * 4;
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
    __syncthreads();
    {
      const float* qh = qs + warp * D;
      float s[2];
      bool dead[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int r = lane + 32 * t;
        const int p = c * kChunk + r;
        const uint32_t* kr = ks + r * kDW;
        float dot = 0.f;
#pragma unroll 8
        for (int wd = 0; wd < D / 2; ++wd) {
          const float2 kf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(kr + wd));
          dot += qh[2 * wd] * kf.x;
          dot += qh[2 * wd + 1] * kf.y;
        }
        float sv = dot * scale;
        if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
        dead[t] = p >= ctx || p < lo || p >= max_len;
        s[t] = dead[t] ? kNegInf : sv;
      }
      const float m_new = fmaxf(m, pgk_warp_max(fmaxf(s[0], s[1])));
      const float p0 = dead[0] ? 0.f : expf(s[0] - m_new);
      const float p1 = dead[1] ? 0.f : expf(s[1] - m_new);
      const float alpha = expf(m - m_new);
      l = l * alpha + pgk_warp_sum(p0 + p1);
      float* pw = ps + warp * kChunk;
      pw[lane] = __bfloat162float(__float2bfloat16_rn(p0));
      pw[lane + 32] = __bfloat162float(__float2bfloat16_rn(p1));
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kDPL; ++j) acc[j] *= alpha;
      for (int r = 0; r < kChunk; ++r) {
        const float pr = pw[r];
        const uint32_t* vr = vs + r * kDW + lane * (kDPL / 2);
#pragma unroll
        for (int j = 0; j < kDPL / 2; ++j) {
          const float2 vf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vr + j));
          acc[2 * j] += pr * vf.x;
          acc[2 * j + 1] += pr * vf.y;
        }
      }
      m = m_new;
    }
  }
  {
    const float l_floor = fmaxf(l, 1e-30f);
    __nv_bfloat16* o = out + ((size_t)b * hq + (size_t)h * g_heads + warp) * D + lane * kDPL;
#pragma unroll
    for (int j = 0; j < kDPL; ++j) o[j] = __float2bfloat16_rn(acc[j] / l_floor);
  }
}

template <int D>
cudaError_t launch_bda(const void* q, const void* k_pool, const void* v_pool,
                       const void* ctx_lens, void* out, int b, int hq, int hk,
                       int layer, int n_layers, int max_len, float scale,
                       float softcap, int window, cudaStream_t st) {
  const int g = hq / hk;
  const size_t smem = (size_t)(2 * kChunk * (D / 2 + 1) + g * D + g * kChunk) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bda_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  bda_kernel<D><<<b * hk, g * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(ctx_lens),
      static_cast<__nv_bfloat16*>(out), hq, hk, layer, n_layers, max_len, scale,
      softcap, window);
  return cudaGetLastError();
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
