// Whole-model decode step: every layer of a batch-1 decode step in one
// launch (norms, the q|k|v, o, gate|up and down projections, NeoX rope and
// the fixed-cache attention), between the embedding row and the head.
//
// Replaces pygpukit_tpu/kernels/fused_decode.py fused_decode_step (the
// Pallas kernel that streams tile arenas through VMEM with a hand-rolled
// DMA chain). Same function, same roundings: every projection output,
// every residual add and the activation round through bf16; norms, rope,
// the softmax and P stay in f32; the current token's k/v join the softmax
// as an extra term and the cache is never written here (the caller
// scatters k_new/v_new at pos).
//
// Bound: bytes. A step reads every weight once (1.1B shape: 22 layers x
// 44.0M bf16 parameters = 1.94 GB, 0.58 ms at 3.35 TB/s) and K/V rows
// [0, pos) of each layer; the arithmetic is two operations per weight.
//
// Design: one cooperative launch, one block of 512 threads per SM, all
// co-resident, with a grid-wide barrier between dependent stages. Per
// layer:
//   A  residual row, rms, q|k|v GEMV units      | barrier
//   B  fold q/k/v, rope, attention units        | barrier
//   C  combine attention, o GEMV units          | barrier
//   D  residual row, rms, gate|up GEMV units    | barrier
//   E  silu(gate)*up, down GEMV units           | barrier
// A GEMV unit is (256 output columns, a slice of K): warp w streams rows
// k = k0 + w, k0 + w + 16, ... of the row-major [K, N] weight, each lane
// 16 contiguous bytes (8 columns), so one row of a unit is one 512-byte
// coalesced read; the 16 warps' sums fold in warp order and the unit
// writes one f32 partial row for its slice. Units go round-robin over the
// blocks; the number of K slices per projection is picked on the host so
// the units fill the grid (o and down: K split 16 ways at the 1.1B shape).
// The weight stream never drains at a barrier (the rule of the reference's
// kernel, whose last tile of a projection starts the next one's first):
// the units' schedule is static and no weight depends on the activations,
// so a block that has issued its last loads of a stage arrives at the
// barrier, then asks the TMA engine to prefetch its next unit's first
// l2_rows rows into L2 (cp.async.bulk.prefetch.tensor: 64-row boxes of a
// 3-D tensor map over the [L, K, N] weight, no shared memory, nothing to
// wait for), then waits. The o unit's rows are asked for after q|k|v,
// across the attention stage. While blocks wait, fold a residual row or
// attend, DRAM keeps filling L2, and the unit after the barrier streams
// its first rows from L2.
// The consumer of a projection folds its slices in ascending order: the
// attention units fold the q/k/v columns of their kv head, every block
// folds the o and down rows into its own copy of the residual row (and
// takes the rms of it in one fixed order rather than waiting at another
// barrier), the down units fold the gate/up columns of their slice. Block
// 0 alone stores the residual row. No atomics touch data and every sum
// runs in a fixed order, so two calls give the same bits.
// Attention: units (kv head, context chunk); pos is read from device
// memory; the live chunks are the fewest of at most `chunks` that hold
// 16 rows each (ceil(pos / 16), one at pos 0), each ceil(pos / live
// chunks) cache rows, 32 rows a step staged in shared memory with an
// online softmax per query head (a warp each), P in f32; chunk 0 also
// holds the new token's term. Stage C folds the live chunks of the heads
// its K slice covers and divides (IEEE) before rounding to bf16.
// Scratch (partial rows, chunk state, residual rows) is a few MB and stays
// in L2; cross-block data is read with ld.global.cg, never from L1.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTN = 256;                 // output columns per GEMV unit
constexpr int kTR = 32;                  // cache rows per attention step
constexpr int kChunkRows = 16;           // cache rows an attention unit takes at least
constexpr int kMaxSlices = 32;
constexpr int kMaxChunks = 64;
constexpr float kNegInf = -1e30f;

struct Dims {
  int L, H, I, HQ, HK, D, MAX;
  float eps, scale;
};

// The host's plan, passed to the kernel and mirrored by the Python
// wrapper as int[9]: grid, K slices of qkv / o / gate|up / down, context
// chunks per kv head at most, scratch f32 words, dynamic shared bytes, and
// the weight rows of a unit prefetched into L2 before a barrier.
struct Plan {
  int grid, ks_qkv, ks_o, ks_gu, ks_d, chunks, scratch, smem, l2_rows;
};
constexpr int kPlanInts = 9;
constexpr int kBoxRows = 64;             // weight rows of a prefetch box
constexpr int kL2Rows = 128;             // a unit's rows prefetched at most: 64 KB

__host__ __device__ inline size_t up4(size_t n) { return (n + 3) & ~size_t(3); }

// Offsets (f32 words) into the scratch.
struct Layout {
  size_t qkv, o, gu, d, am, al, acc, x0, x1, total;
};

__host__ __device__ inline Layout make_layout(const Dims& m, const Plan& p) {
  const size_t nqkv = (size_t)m.H + 2 * (size_t)m.HK * m.D;
  Layout s;
  s.qkv = 0;
  s.o = s.qkv + up4(p.ks_qkv * nqkv);
  s.gu = s.o + up4((size_t)p.ks_o * m.H);
  s.d = s.gu + up4((size_t)p.ks_gu * 2 * m.I);
  s.am = s.d + up4((size_t)p.ks_d * m.H);
  s.al = s.am + up4((size_t)m.HQ * p.chunks);
  s.acc = s.al + up4((size_t)m.HQ * p.chunks);
  s.x0 = s.acc + up4((size_t)m.HQ * p.chunks * m.D);
  s.x1 = s.x0 + up4(m.H);
  s.total = s.x1 + up4(m.H);
  return s;
}

// The weights' tensor maps (q|k|v, o, gate|up, down), [L, K, N] as 3-D (N
// inner), boxes of kTN columns x kBoxRows rows: the L2 prefetches.
struct Args {
  CUtensorMap tm[4];
  const bf16* h0;
  const float* cosr;
  const float* sinr;
  const int* pos;
  const bf16* wqkv;
  const bf16* wo;
  const bf16* wgu;
  const bf16* wd;
  const float* attn_norm;
  const float* mlp_norm;
  const float* final_norm;
  const bf16* kc;
  const bf16* vc;
  bf16* h_out;
  float* k_new;
  float* v_new;
  float* scratch;
  unsigned* barrier;
  Dims m;
  Plan p;
};

// Shared memory: a reduction area, a few words, then the stage's rows.
constexpr size_t kRedBytes = (size_t)kWarps * kTN * 4;
constexpr size_t kSmallBytes = 32 * 4;
constexpr size_t kRowOff = kRedBytes + kSmallBytes;

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline size_t attn_smem_bytes(int g, int d) {
  // raw q/k/v, roped q, k_new, v_new, scores, m, l, acc; a step's K and V
  // rows (bf16)
  return up16((size_t)((g + 2) * d + g * d + 2 * d + g * kTR + 2 * g + g * d) * 4) +
         (size_t)kTR * (2 * d + 8) * 2;
}

// The stage rows area: the residual row (f32) and its normed bf16 copy,
// the o / down unit's x slice, or the attention unit's state.
__host__ __device__ inline size_t rows_bytes(const Dims& m, const Plan& p) {
  const int ks_max = max((m.H + p.ks_o - 1) / p.ks_o, (m.I + p.ks_d - 1) / p.ks_d);
  size_t rows = up16((size_t)m.H * 4) + up16((size_t)m.H * 2);
  rows = rows > up16((size_t)ks_max * 2) ? rows : up16((size_t)ks_max * 2);
  const size_t attn = attn_smem_bytes(m.HQ / m.HK, m.D);
  return rows > attn ? rows : attn;
}

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Grid-wide barrier over a counter that only grows, in two halves: after
// the block's stores, thread 0 adds one with release semantics (a red, no
// reply awaited); the e-th wait spins until e * gridDim.x blocks arrived
// (an acquire load). Between the two a block asks for its next weights.
// Needs every block resident (the cooperative launch refuses a grid that
// does not fit).
__device__ __forceinline__ void grid_arrive(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar) : "memory");
}

__device__ __forceinline__ void grid_wait(const unsigned* bar, unsigned& epoch) {
  ++epoch;
  if (threadIdx.x == 0) {
    const unsigned target = epoch * gridDim.x;
    while (ld_acquire(bar) < target) __nanosleep(32);
  }
  __syncthreads();
}

// Unit u of a [k, n] projection cut into `slices` K slices of kTN-column
// tiles: rows [k0, k1) of columns [col0, col0 + kTN).
struct Unit {
  int k0, k1, col0;
};

__device__ __forceinline__ Unit unit_of(int k, int n, int slices, int u) {
  const int nt = (n + kTN - 1) / kTN, ks = (k + slices - 1) / slices;
  const int t = u % nt, sl = u / nt;
  const int k0 = min(k, sl * ks);
  return Unit{k0, min(k, k0 + ks), t * kTN};
}

// Projection st of a layer (0 q|k|v, 1 o, 2 gate|up, 3 down) as a [k, n]
// weight in `sl` K slices.
__device__ __forceinline__ void proj_dims(const Args& a, int st, int& k, int& n, int& sl) {
  const Dims& m = a.m;
  k = st == 3 ? m.I : m.H;
  n = st == 0 ? m.H + 2 * m.HK * m.D : st == 2 ? 2 * m.I : m.H;
  sl = st == 0 ? a.p.ks_qkv : st == 1 ? a.p.ks_o : st == 2 ? a.p.ks_gu : a.p.ks_d;
}

// Ask for the first l2_rows rows of this block's first unit of projection
// st of layer `layer` in L2: 64-row boxes, issued by the first lanes of
// warp 0, nothing waited for.
__device__ __forceinline__ void prefetch_l2(const Args& a, int st, int layer) {
  int k, n, sl;
  proj_dims(a, st, k, n, sl);
  if ((int)blockIdx.x >= (n + kTN - 1) / kTN * sl) return;
  const Unit u = unit_of(k, n, sl, blockIdx.x);
  const int boxes = (min(u.k1 - u.k0, a.p.l2_rows) + kBoxRows - 1) / kBoxRows;
  if ((int)threadIdx.x < boxes)
    asm volatile("cp.async.bulk.prefetch.tensor.3d.L2.global.tile [%0, {%1, %2, %3}];" ::"l"(
                     reinterpret_cast<uint64_t>(&a.tm[st])),
                 "r"(u.col0), "r"(u.k0 + (int)threadIdx.x * kBoxRows), "r"(layer)
                 : "memory");
}

// acc[0..7] += x * the 8 bf16 of w.
__device__ __forceinline__ void fma8(float* acc, float x, uint4 w) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] = fmaf(x, __uint_as_float(u[i] << 16), acc[2 * i]);
    acc[2 * i + 1] = fmaf(x, __uint_as_float(u[i] & 0xffff0000u), acc[2 * i + 1]);
  }
}

// One GEMV unit: out[c] = sum_{k0 <= k < k1} x[k] W[k, c] for the columns
// c of [col0, col0 + kTN) below N (x indexed as xs[k - xoff]).
__device__ void gemv_unit(const bf16* __restrict__ w, int n, const Unit& un, const bf16* xs,
                          int xoff, float* red, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = un.col0 + lane * 8;
  const int k1 = un.k1;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  if (col < n) {
    const bf16* wp = w + col;
    int k = un.k0 + warp;
    for (; k + 3 * kWarps < k1; k += 4 * kWarps) {
      const uint4 w0 = __ldcs(reinterpret_cast<const uint4*>(wp + (size_t)k * n));
      const uint4 w1 = __ldcs(reinterpret_cast<const uint4*>(wp + (size_t)(k + kWarps) * n));
      const uint4 w2 =
          __ldcs(reinterpret_cast<const uint4*>(wp + (size_t)(k + 2 * kWarps) * n));
      const uint4 w3 =
          __ldcs(reinterpret_cast<const uint4*>(wp + (size_t)(k + 3 * kWarps) * n));
      fma8(acc, __bfloat162float(xs[k - xoff]), w0);
      fma8(acc, __bfloat162float(xs[k + kWarps - xoff]), w1);
      fma8(acc, __bfloat162float(xs[k + 2 * kWarps - xoff]), w2);
      fma8(acc, __bfloat162float(xs[k + 3 * kWarps - xoff]), w3);
    }
    for (; k < k1; k += kWarps) {
      const uint4 w0 = __ldcs(reinterpret_cast<const uint4*>(wp + (size_t)k * n));
      fma8(acc, __bfloat162float(xs[k - xoff]), w0);
    }
  }
  float* r = red + warp * kTN + lane * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = acc[i];
  __syncthreads();
  if (threadIdx.x < kTN && un.col0 + (int)threadIdx.x < n) {
    float s = 0.f;
    for (int v = 0; v < kWarps; ++v) s += red[v * kTN + threadIdx.x];
    __stcg(out + un.col0 + threadIdx.x, s);
  }
  __syncthreads();
}

// Sum of a column over the K slices of a partial area, ascending.
__device__ __forceinline__ float fold(const float* p, int slices, size_t stride, int col) {
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += __ldcg(p + k * stride + col);
  return s;
}

// xs[n] = bf16(base[n] + bf16(sum of the partial rows)) for every n, or
// the embedding row at layer 0.
__device__ void residual_row(const Args& a, const float* base, const float* part, int slices,
                             bool first, float* xs) {
  const int h = a.m.H;
  for (int n = threadIdx.x; n < h; n += kThreads)
    xs[n] = first ? __bfloat162float(a.h0[n])
                  : rbf(__fadd_rn(__ldcg(base + n), rbf(fold(part, slices, h, n))));
  __syncthreads();
}

// out[i] = bf16((x[i] * rsqrt(mean(x^2) + eps)) * w[i]); one fixed order.
template <typename Out>
__device__ void rms_row(const float* xs, const float* __restrict__ w, int h, float eps,
                        float* small, Out* out) {
  float s = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) s = fmaf(xs[i], xs[i], s);
  s = pgk_warp_sum(s);
  if ((threadIdx.x & 31) == 0) small[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < kWarps; ++i) t += small[i];
  const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(t, (float)h), eps));
  for (int i = threadIdx.x; i < h; i += kThreads)
    out[i] = __float2bfloat16_rn(__fmul_rn(__fmul_rn(xs[i], r), w[i]));
  __syncthreads();
}

// Stage B: attention units (kv head, chunk).
__device__ void attention_stage(const Args& a, const Layout& lay, int layer, int live,
                                int nch, unsigned char* smem) {
  const Dims& m = a.m;
  const int g_heads = m.HQ / m.HK, d = m.D, half = d / 2, kvd = m.HK * d;
  const int nqkv = m.H + 2 * kvd, chunks = a.p.chunks;   // chunks: the slots' stride
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* raw = reinterpret_cast<float*>(smem + kRowOff);      // [(G + 2) D]
  float* qs = raw + (g_heads + 2) * d;                         // [G, D]
  float* kn = qs + g_heads * d;                                // [D]
  float* vn = kn + d;                                          // [D]
  float* st = vn + d;                                          // [G, kTR]
  float* mm = st + g_heads * kTR;                              // [G]
  float* ll = mm + g_heads;                                    // [G]
  float* acc = ll + g_heads;                                   // [G, D]
  // a step's K rows [kTR][D + 8] (padded a 16-byte piece, so the 32 rows a
  // warp's scores read fall in different banks) and V rows [kTR][D]
  bf16* ks = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(acc + g_heads * d) + 15) & ~uintptr_t(15));
  bf16* vs = ks + kTR * (d + 8);
  const float* pqkv = a.scratch + lay.qkv;
  const int rows_per = max(1, (live + nch - 1) / nch);
  const size_t cache_layer = (size_t)layer * m.MAX * kvd;

  for (int u = blockIdx.x; u < m.HK * nch; u += gridDim.x) {
    const int h = u % m.HK, c = u / m.HK;
    const int nq = g_heads * d;
    for (int i = threadIdx.x; i < nq + 2 * d; i += kThreads) {
      const int col = i < nq ? h * nq + i
                             : (i < nq + d ? m.H + h * d + (i - nq)
                                           : m.H + kvd + h * d + (i - nq - d));
      raw[i] = rbf(fold(pqkv, a.p.ks_qkv, nqkv, col));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < (g_heads + 1) * half; i += kThreads) {
      const int j = i / half, e = i % half;
      const float* src = raw + j * d;
      const float v0 = src[e], v1 = src[e + half], cs = a.cosr[e], sn = a.sinr[e];
      float* dst = j < g_heads ? qs + j * d : kn;
      dst[e] = rbf(__fsub_rn(__fmul_rn(v0, cs), __fmul_rn(v1, sn)));
      dst[e + half] = rbf(__fadd_rn(__fmul_rn(v1, cs), __fmul_rn(v0, sn)));
    }
    for (int i = threadIdx.x; i < d; i += kThreads) vn[i] = raw[(g_heads + 1) * d + i];
    __syncthreads();
    if (c == 0)
      for (int i = threadIdx.x; i < d; i += kThreads) {
        a.k_new[(size_t)layer * kvd + h * d + i] = kn[i];
        a.v_new[(size_t)layer * kvd + h * d + i] = vn[i];
      }
    // chunk 0 starts from the new token's term (m = s_new, l = 1, acc = v_new)
    for (int g = warp; g < g_heads; g += kWarps) {
      float part = 0.f;
      for (int e = lane; e < d; e += 32) part = fmaf(qs[g * d + e], kn[e], part);
      const float s_new = pgk_warp_sum(part) * m.scale;
      if (lane == 0) {
        mm[g] = c == 0 ? s_new : kNegInf;
        ll[g] = c == 0 ? 1.f : 0.f;
      }
      for (int e = lane; e < d; e += 32) acc[g * d + e] = c == 0 ? vn[e] : 0.f;
    }
    __syncthreads();
    const int r0 = c * rows_per, r1 = min(live, r0 + rows_per);
    const bf16* kbase = a.kc + cache_layer + h * d;
    const bf16* vbase = a.vc + cache_layer + h * d;
    for (int t0 = r0; t0 < r1; t0 += kTR) {
      const int nr = min(kTR, r1 - t0);
      // the step's K and V rows into shared memory, every thread's 16-byte
      // pieces loaded at once (one round trip to DRAM a step)
      const int pieces = nr * (d / 8);
      for (int i = threadIdx.x; i < 2 * pieces; i += kThreads) {
        const int v = i >= pieces, j = i - v * pieces, r = j / (d / 8), e = (j % (d / 8)) * 8;
        *reinterpret_cast<uint4*>(v ? vs + r * d + e : ks + r * (d + 8) + e) =
            *reinterpret_cast<const uint4*>((v ? vbase : kbase) + (size_t)(t0 + r) * kvd + e);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < g_heads * kTR; i += kThreads) {
        const int g = i / kTR, r = i % kTR;
        float s = kNegInf;
        if (r < nr) {
          const bf16* kr = ks + r * (d + 8);
          const float* q = qs + g * d;
          float dot = 0.f;
          for (int e = 0; e < d; e += 8) {
            float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            fma8(part, 1.f, *reinterpret_cast<const uint4*>(kr + e));
#pragma unroll
            for (int j = 0; j < 8; ++j) dot = fmaf(q[e + j], part[j], dot);
          }
          s = dot * m.scale;
        }
        st[g * kTR + r] = s;
      }
      __syncthreads();
      for (int g = warp; g < g_heads; g += kWarps) {
        const float s = st[g * kTR + lane];             // kTR == 32: lane = row
        const float m_old = mm[g];
        const float m_new = fmaxf(m_old, pgk_warp_max(lane < nr ? s : kNegInf));
        const float p = lane < nr ? expf(s - m_new) : 0.f;
        const float alpha = expf(m_old - m_new);
        const float psum = pgk_warp_sum(p);
        __syncwarp();
        st[g * kTR + lane] = p;
        __syncwarp();
        for (int e = lane; e < d; e += 32) {
          float o = 0.f;
          for (int r = 0; r < nr; ++r)
            o = fmaf(st[g * kTR + r], __bfloat162float(vs[r * d + e]), o);
          acc[g * d + e] = fmaf(acc[g * d + e], alpha, o);
        }
        __syncwarp();
        if (lane == 0) {
          mm[g] = m_new;
          ll[g] = fmaf(ll[g], alpha, psum);
        }
      }
      __syncthreads();
    }
    for (int g = warp; g < g_heads; g += kWarps) {
      const size_t slot = (size_t)(h * g_heads + g) * chunks + c;
      if (lane == 0) {
        __stcg(a.scratch + lay.am + slot, mm[g]);
        __stcg(a.scratch + lay.al + slot, ll[g]);
      }
      for (int e = lane; e < d; e += 32) __stcg(a.scratch + lay.acc + slot * d + e, acc[g * d + e]);
    }
    __syncthreads();
  }
}

// GEMV units of projection st of layer l. mode 0: x is the row xn (all of
// K); 1: x is attention output combined from the `nch` live chunks for the
// unit's slice; 2: x is silu(gate) * up for the unit's slice.
__device__ void gemv_stage(const Args& a, const Layout& lay, int st, const bf16* __restrict__ w,
                           float* out, int mode, const bf16* xn, int nch, unsigned char* smem) {
  const Dims& m = a.m;
  float* red = reinterpret_cast<float*>(smem);
  bf16* slice = reinterpret_cast<bf16*>(smem + kRowOff);
  int k, n, slices;
  proj_dims(a, st, k, n, slices);
  const int nt = (n + kTN - 1) / kTN;
  for (int u = blockIdx.x; u < nt * slices; u += gridDim.x) {
    const Unit un = unit_of(k, n, slices, u);
    const int k0 = un.k0, k1 = un.k1;
    const bf16* x = xn;
    int xoff = 0;
    if (mode == 1) {
      const int chunks = a.p.chunks, d = m.D;
      for (int i = threadIdx.x; i < k1 - k0; i += kThreads) {
        const int kk = k0 + i, hq = kk / d, e = kk % d;
        const float* pm = a.scratch + lay.am + (size_t)hq * chunks;
        const float* pl = a.scratch + lay.al + (size_t)hq * chunks;
        const float* pa = a.scratch + lay.acc + (size_t)hq * chunks * d + e;
        float mx = kNegInf;
        for (int c = 0; c < nch; ++c) mx = fmaxf(mx, __ldcg(pm + c));
        float den = 0.f, num = 0.f;
        for (int c = 0; c < nch; ++c) {
          const float f = expf(__ldcg(pm + c) - mx);
          den = fmaf(__ldcg(pl + c), f, den);
          num = fmaf(__ldcg(pa + (size_t)c * d), f, num);
        }
        slice[i] = __float2bfloat16_rn(__fdiv_rn(num, den));
      }
    } else if (mode == 2) {
      const float* pgu = a.scratch + lay.gu;
      for (int i = threadIdx.x; i < k1 - k0; i += kThreads) {
        const float g = rbf(fold(pgu, a.p.ks_gu, 2 * (size_t)m.I, k0 + i));
        const float up = rbf(fold(pgu, a.p.ks_gu, 2 * (size_t)m.I, m.I + k0 + i));
        slice[i] = __float2bfloat16_rn(__fmul_rn(__fdiv_rn(g, __fadd_rn(1.f, expf(-g))), up));
      }
    }
    if (mode != 0) {
      __syncthreads();
      x = slice;
      xoff = k0;
    }
    gemv_unit(w, n, un, x, xoff, red, out + (size_t)(u / nt) * n);
  }
}

// The grid-wide barrier between two stages: arrive, ask for the next
// projection's rows in L2 (projection st of layer `layer`; st < 0: none),
// wait.
__device__ __forceinline__ void stage_end(const Args& a, unsigned& epoch, int st, int layer) {
  grid_arrive(a.barrier);
  if (st >= 0) prefetch_l2(a, st, layer);
  grid_wait(a.barrier, epoch);
}

__global__ void __launch_bounds__(kThreads, 1)
fused_decode_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dims& m = a.m;
  const Layout lay = make_layout(m, a.p);
  float* small = reinterpret_cast<float*>(smem + kRedBytes);
  float* xs = reinterpret_cast<float*>(smem + kRowOff);
  bf16* xn = reinterpret_cast<bf16*>(smem + kRowOff + up16((size_t)m.H * 4));
  const int kvd = m.HK * m.D, nqkv = m.H + 2 * kvd;
  const int live = min(max(*a.pos, 0), m.MAX);
  // the live chunks: kChunkRows rows each at least, the plan's at most
  const int nch = min(a.p.chunks, max(1, (live + kChunkRows - 1) / kChunkRows));
  float* x0 = a.scratch + lay.x0;
  float* x1 = a.scratch + lay.x1;
  unsigned epoch = 0;
  prefetch_l2(a, 0, 0);

  for (int l = 0; l < m.L; ++l) {
    // A: x = x1 + down(l - 1) (the embedding row at layer 0); q|k|v
    residual_row(a, x1, a.scratch + lay.d, a.p.ks_d, l == 0, xs);
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < m.H; i += kThreads) __stcg(x0 + i, xs[i]);
    rms_row(xs, a.attn_norm + (size_t)l * m.H, m.H, m.eps, small, xn);
    gemv_stage(a, lay, 0, a.wqkv + (size_t)l * m.H * nqkv, a.scratch + lay.qkv, 0, xn, nch,
               smem);
    stage_end(a, epoch, 1, l);                    // o's rows across the attention stage
    // B: rope, attention over rows [0, pos) and the new token
    attention_stage(a, lay, l, live, nch, smem);
    stage_end(a, epoch, -1, l);
    // C: o projection of the combined attention row
    gemv_stage(a, lay, 1, a.wo + (size_t)l * m.H * m.H, a.scratch + lay.o, 1, nullptr, nch,
               smem);
    stage_end(a, epoch, 2, l);
    // D: x = x0 + o; gate|up
    residual_row(a, x0, a.scratch + lay.o, a.p.ks_o, false, xs);
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < m.H; i += kThreads) __stcg(x1 + i, xs[i]);
    rms_row(xs, a.mlp_norm + (size_t)l * m.H, m.H, m.eps, small, xn);
    gemv_stage(a, lay, 2, a.wgu + (size_t)l * m.H * 2 * m.I, a.scratch + lay.gu, 0, xn, nch,
               smem);
    stage_end(a, epoch, 3, l);
    // E: down projection of silu(gate) * up
    gemv_stage(a, lay, 3, a.wd + (size_t)l * m.I * m.H, a.scratch + lay.d, 2, nullptr, nch,
               smem);
    stage_end(a, epoch, l + 1 < m.L ? 0 : -1, l + 1);   // the next layer's q|k|v
  }
  if (blockIdx.x == 0) {
    residual_row(a, x1, a.scratch + lay.d, a.p.ks_d, m.L == 0, xs);
    rms_row(xs, a.final_norm, m.H, m.eps, small, a.h_out);
  }
}

// K slices for a [k, n] GEMV: the fewest rows per block, plus a little for
// every slice its consumer folds.
int choose_slices(int k, int n, int grid) {
  const int nt = (n + kTN - 1) / kTN;
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= kMaxSlices && s * 16 <= k; ++s) {
    const long long waves = ((long long)nt * s + grid - 1) / grid;
    const long long cost = waves * ((k + s - 1) / s) + 8LL * s;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  return best;
}

bool dims_ok(const Dims& m) {
  return m.L >= 1 && m.HK >= 1 && m.HQ % m.HK == 0 && m.HQ / m.HK <= 32 && m.D % 8 == 0 &&
         m.D <= 128 && m.HQ * m.D == m.H && m.H % 8 == 0 && m.I % 8 == 0 && m.MAX >= 1;
}

}  // namespace

// Plan a launch for these dimensions on the current device: writes
// plan[0..8] (grid, K slices of qkv / o / gate|up / down, chunks at most,
// scratch f32 words, dynamic shared bytes, the rows of a unit prefetched
// into L2; kernels/fused_decode.py fused_plan mirrors it). Fails when the
// dimensions are outside the kernel's limits or one block of 512 threads
// does not fit an SM.
PGK_API int pgk_fused_decode_plan(int L, int H, int I, int HQ, int HK, int D, int MAX,
                                  int* plan) {
  const Dims m{L, H, I, HQ, HK, D, MAX, 0.f, 0.f};
  if (!dims_ok(m)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  Plan p{};
  p.grid = sms;
  const int nqkv = H + 2 * HK * D;
  p.ks_qkv = choose_slices(H, nqkv, p.grid);
  p.ks_o = choose_slices(H, H, p.grid);
  p.ks_gu = choose_slices(H, 2 * I, p.grid);
  p.ks_d = choose_slices(I, H, p.grid);
  p.chunks = min(kMaxChunks, max(1, p.grid / HK));
  const size_t words = make_layout(m, p).total;
  if (words > (size_t)0x7fffffff) return (int)cudaErrorInvalidValue;
  p.scratch = (int)words;
  p.smem = (int)(kRowOff + rows_bytes(m, p));
  p.l2_rows = kL2Rows;
  e = cudaFuncSetAttribute(fused_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           p.smem);
  if (e != cudaSuccess) return (int)e;
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fused_decode_kernel, kThreads,
                                                    (size_t)p.smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int vals[kPlanInts] = {p.grid,   p.ks_qkv,  p.ks_o, p.ks_gu,   p.ks_d,
                               p.chunks, p.scratch, p.smem, p.l2_rows};
  for (int i = 0; i < kPlanInts; ++i) plan[i] = vals[i];
  return (int)cudaSuccess;
}

// One decode step (shapes in pygpukit_tpu_torch/kernels/fused_decode.py):
// h0 [H] bf16, cos/sin [D] f32 (the rope row at pos; the first D/2 read),
// pos [1] int32 on the device, wqkv [L, H, H + 2 Hk D], wo [L, H, H], wgu
// [L, H, 2 I], wd [L, I, H] bf16 row-major, norms [L, H] and [H] f32,
// caches [L, MAX, Hk D] bf16; writes h_out [H] bf16, k_new and v_new
// [L, Hk D] f32. scratch holds plan[6] f32 words; barrier one zeroed
// unsigned. All contiguous and 16-byte aligned. One cooperative launch;
// plan[7] bytes of dynamic shared memory.
PGK_API int pgk_fused_decode(const void* h0, const void* cosr, const void* sinr,
                             const void* pos, const void* wqkv, const void* wo,
                             const void* wgu, const void* wd, const void* attn_norm,
                             const void* mlp_norm, const void* final_norm, const void* kc,
                             const void* vc, void* h_out, void* k_new, void* v_new,
                             void* scratch, void* barrier, const int* plan, int L, int H,
                             int I, int HQ, int HK, int D, int MAX, float eps, float scale,
                             void* stream) {
  const Dims m{L, H, I, HQ, HK, D, MAX, eps, scale};
  if (!dims_ok(m)) return (int)cudaErrorInvalidValue;
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4],
               plan[5], plan[6], plan[7], plan[8]};
  Args a{{},
         static_cast<const bf16*>(h0),
         static_cast<const float*>(cosr),
         static_cast<const float*>(sinr),
         static_cast<const int*>(pos),
         static_cast<const bf16*>(wqkv),
         static_cast<const bf16*>(wo),
         static_cast<const bf16*>(wgu),
         static_cast<const bf16*>(wd),
         static_cast<const float*>(attn_norm),
         static_cast<const float*>(mlp_norm),
         static_cast<const float*>(final_norm),
         static_cast<const bf16*>(kc),
         static_cast<const bf16*>(vc),
         static_cast<bf16*>(h_out),
         static_cast<float*>(k_new),
         static_cast<float*>(v_new),
         static_cast<float*>(scratch),
         static_cast<unsigned*>(barrier),
         m,
         p};
  const void* ws[4] = {wqkv, wo, wgu, wd};
  const int ks[4] = {H, H, H, I}, ns[4] = {H + 2 * HK * D, H, 2 * I, H};
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < 4 && e == cudaSuccess; ++i)
    e = pgk_tensor_map_bf16_3d(&a.tm[i], ws[i], ns[i], ks[i], L, (uint64_t)ns[i] * 2,
                               (uint64_t)ns[i] * ks[i] * 2, kTN, kBoxRows,
                               CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fused_decode_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
