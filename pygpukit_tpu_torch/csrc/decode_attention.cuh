// One decode query per head against a KV sequence, for one (slot, kv head)
// block: the body shared by batch_decode_attention.cu (dense serving pools)
// and paged_attention.cu (block pools behind a block table). The two kernels
// differ only in where position p's K and V rows live, which they pass in as
// a row-offset functor; everything below is the same arithmetic.
//
// Bound: bytes. Each call reads every live K and V row of the sequence once
// (2 * ctx * D * 2 bytes per kv head) for G = Hq/Hk dot products per row.
// Design: one block per (slot, kv head) and one warp per query head of the
// group, so a K/V chunk loaded into shared memory once serves all G heads.
// Chunks of 64 rows cover only the live context [max(0, ctx - window), live);
// dead capacity is never read. Scores, the running max and the sum follow the
// reference's online softmax: scale, optional softcap cap*tanh(s/cap), mask
// pos >= live or pos < ctx - window to -1e30, explicit p = 0 on dead
// positions, l floored at 1e-30 at the end, and P rounded to the query dtype
// (bf16) before the P@V product as the reference kernels do. Warp reductions
// run in a fixed xor-tree order: no atomics, bitwise replayable. 16-byte
// global loads; shared rows are padded to D/2 + 1 words so the per-lane row
// reads of the score loop hit distinct banks.
// Occupancy note: B * Hk = 32 blocks on the 1.1B shape underfill the card's
// 132 SMs; splitting the context across blocks (split-KV with a second
// combine pass) is the next step for long contexts.
#pragma once

#include "common.cuh"

constexpr int kPgkAttnChunk = 64;
constexpr float kPgkAttnNegInf = -1e30f;

// Dynamic shared memory of one block serving g query heads at head dim d.
static inline size_t pgk_attn_smem_bytes(int d, int g) {
  return (size_t)(2 * kPgkAttnChunk * (d / 2 + 1) + g * d + g * kPgkAttnChunk) * 4;
}

// qb, ob: [G, D] query and output heads of this block (blockDim.x == 32 * G).
// kbase, vbase: this kv head's K and V; row_off(p) is position p's element
// offset from them, called only for p < live. ctx: the context length the
// window counts back from; live <= ctx: positions that hold rows.
template <int D, class RowOffset>
__device__ __forceinline__ void pgk_decode_attention_block(
    const __nv_bfloat16* __restrict__ qb, const __nv_bfloat16* __restrict__ kbase,
    const __nv_bfloat16* __restrict__ vbase, RowOffset row_off, int g_heads,
    int ctx, int live, int window, float scale, float softcap,
    __nv_bfloat16* __restrict__ ob) {
  constexpr int kDW = D / 2 + 1;       // padded 32-bit words per shared row
  constexpr int kDPL = D / 32;         // output dims per lane
  constexpr int kVec = D / 8;          // 16-byte vectors per row
  constexpr int kChunk = kPgkAttnChunk;
  extern __shared__ __align__(16) unsigned char pgk_attn_smem[];
  uint32_t* ks = reinterpret_cast<uint32_t*>(pgk_attn_smem);
  uint32_t* vs = ks + kChunk * kDW;
  float* qs = reinterpret_cast<float*>(vs + kChunk * kDW);      // [G, D]
  float* ps = qs + g_heads * D;                                 // [G, C]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < g_heads * D; i += blockDim.x)
    qs[i] = __bfloat162float(qb[i]);

  const int lo = window > 0 ? ctx - window : -(1 << 30);
  const int c_begin = lo > 0 ? lo / kChunk : 0;
  const int c_end = live > 0 ? (live + kChunk - 1) / kChunk : 0;

  float m = kPgkAttnNegInf, l = 0.f;
  float acc[kDPL];
#pragma unroll
  for (int j = 0; j < kDPL; ++j) acc[j] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    __syncthreads();                    // previous chunk fully consumed
    for (int i = threadIdx.x; i < kChunk * kVec; i += blockDim.x) {
      const int r = i / kVec, v = i % kVec;
      const int p = c * kChunk + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (p < live) {
        const size_t o = row_off(p) + (size_t)v * 8;
        kv = *reinterpret_cast<const uint4*>(kbase + o);
        vv = *reinterpret_cast<const uint4*>(vbase + o);
      }
      uint32_t* kd = ks + r * kDW + v * 4;
      uint32_t* vd = vs + r * kDW + v * 4;
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
    __syncthreads();
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
      dead[t] = p >= live || p < lo;
      s[t] = dead[t] ? kPgkAttnNegInf : sv;
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
  const float l_floor = fmaxf(l, 1e-30f);
  __nv_bfloat16* o = ob + warp * D + lane * kDPL;
#pragma unroll
  for (int j = 0; j < kDPL; ++j) o[j] = __float2bfloat16_rn(acc[j] / l_floor);
}

// Launch `kernel` over `blocks` blocks of 32 * g threads with the shared
// memory the body needs, raising the dynamic limit past 48 KB when asked.
template <class Kernel, class... Args>
static cudaError_t pgk_launch_attention(Kernel kernel, int d, int g, int blocks,
                                        cudaStream_t st, Args... args) {
  const size_t smem = pgk_attn_smem_bytes(d, g);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, g * 32, smem, st>>>(args...);
  return cudaGetLastError();
}
