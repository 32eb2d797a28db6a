// Flash attention (prefill).
//
// Replaces pygpukit_tpu/kernels/flash_attention.py _flash_pallas. (The
// decode kernel, _decode_pallas, is flash_decode.cu.)
//
// It computes the reference's online-softmax recurrence: running max from
// -1e30, sum and accumulator in f32, s = (q.k) * scale, masked keys at -1e30
// with p = 0, p = exp(s - m_new), alpha = exp(m_prev - m_new), P rounded to
// the input dtype before P.V, out = acc / max(l, 1e-30) in the input dtype.
// No atomics and every reduction in a fixed order: a replay is bitwise.
//
// flash_attention. Bound: operations. The causal work is 4 Hq D S(S+1)/2
// flops for (q + k + v + out) bytes once, so above S of a few hundred the
// tensor cores bound it (1.1B layer at S 2048: 17.2 GFLOP, 17.4 us at 989
// TFLOP/s; 18.9 MB, 5.6 us at 3.35 TB/s). At D 64 the exponentials bound it
// as much: Hq S(S+1)/2 ex2 at 16 a clock per SM take about as long again.
// Only wgmma reaches the tensor cores' full rate, so the bf16 path takes
// the Hopper shape:
// - one block per (query head, 128-row query tile), heaviest causal tiles
//   first, of three warpgroups: a producer (one thread issues every TMA
//   load; setmaxnreg hands its registers to the others) and two consumers
//   of 64 query rows each, which the SMs interleave;
// - TMA loads the Q tile once and 128-key K and V tiles into a two-stage
//   ring, 128-byte swizzled, as 64-column sub-tiles of the [S, H*D]
//   row-major views (GQA: the box starts at column kvh*D, so no head is
//   expanded; rows past S arrive as zeros). Full/empty mbarriers per stage,
//   K and V apart: a K stage frees once S has read it;
// - S = Q.K^T is wgmma m64n128k16 with both operands in shared memory (K
//   stored [keys][D] is K-major); P.V is wgmma with P from registers (the f32
//   score accumulator packed to bf16 pairs is the A-register layout, no
//   shuffle) and V [keys][D] MN-major (the transpose bit);
// - the online softmax runs in registers, scale*log2(e) folded into one
//   FFMA before ex2; masks apply only on the diagonal and ragged tiles, and
//   tiles past the causal diagonal are never loaded.
// At D 256 the key tile is 64 (S = Q.K^T is m64n64k16, P.V m64n256k16):
// the 128-row Q tile (64 KB) and two stages of 64-key K and V tiles (32 KB
// each) take 193 KB of the 227 KB a block may have, where 128-key tiles
// would take 320 KB; a consumer thread holds O's 64 x 256 f32 block in
// 128 registers.
// At D 96 (Phi-3) the rows are not whole 128-byte sub-tiles: Q, K and V
// arrive as three 32-column sub-tiles under the 64-byte swizzle (64-byte
// TMA boxes; descriptors of layout type 2, 512-byte 8-row groups), S =
// Q.K^T takes 6 k-steps of m64n128k16 and P.V is one m64n96k16 a k-step
// (V's LBO the 32-column sub-tile's bytes); O is 48 registers a thread and
// the key tile stays 128 (123 KB of shared memory).
// At D 80 (Phi-2) the rows are two and a half 32-column sub-tiles: they
// land as D 96's three, through 3-D tensor maps over [S][H][80] (box 32
// columns x 1 head x the tile's rows) whose inner extent is 80, so the
// third sub-tile's last 16 columns read as zeros (out of bounds) and no
// tensor is padded. S = Q.K^T takes the 5 k-steps of the 80 columns; P.V
// is D 96's m64n96k16 over V's zero columns, whose 16 outputs are not
// stored.
// Each consumer runs S, softmax and P.V of a tile one after another. FA3's
// overlap of one tile's softmax with the next tile's products, and its
// ping-pong turn between the consumers, both measured slower or no faster
// here (ptxas serialized the overlapped products: C7513/C7514).
// f32 inputs run on CUDA cores (f32 FMA, never TF32: the reference holds f32
// at HIGHEST), 16 query rows per block, one lane per key for the scores and
// per head dimension for P.V.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;        // the f32 kernel's block

// ---------------------------------------------------------------------------
// flash_attention, bf16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kFaBM = 128;           // query rows per block: two consumer warpgroups of 64
constexpr int kFaStages = 2;         // K/V ring depth
constexpr int kFaThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr int kFaConsumers = 256;

template <int D>
struct FaLayout {
  static_assert(D % 16 == 0 && D > 0, "whole k-steps of 16 columns");
  static constexpr int kBN = D > 128 ? 64 : 128;           // keys per tile
  static constexpr int kCols = D % 64 == 0 ? 64 : 32;      // columns of a swizzled sub-tile
  static constexpr int kSw = kCols * 2;                    // its row bytes: the swizzle span
  static constexpr int kSub = (D + kCols - 1) / kCols;     // sub-tiles a row
  static constexpr int kDP = kSub * kCols;                 // a shared row's columns (>= D)
  static constexpr bool kRagged = kDP != D;                // the last sub-tile reads zeros
  static constexpr int kQBytes = kFaBM * kDP * 2;
  static constexpr int kTileBytes = kBN * kDP * 2;         // one K or V tile
  static constexpr int kBarOff = kQBytes + 2 * kFaStages * kTileBytes;
  static constexpr int kBytes = kBarOff + 8 * (1 + 4 * kFaStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n64_tb(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<96>(float (&o)[48], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n96_tb(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_m64n128_tb(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_m64n256_tb(o, a, db);
}

// S += Q (64 x 16) K^T (kBN keys x 16), both K-major in shared.
template <int kBN>
__device__ __forceinline__ void wgmma_qk(float (&sc)[kBN / 2], uint64_t da, uint64_t db, int acc);
template <>
__device__ __forceinline__ void wgmma_qk<128>(float (&sc)[64], uint64_t da, uint64_t db, int acc) {
  wgmma_ss_m64n128(sc, da, db, acc);
}
template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&sc)[32], uint64_t da, uint64_t db, int acc) {
  wgmma_ss_m64n64(sc, da, db, acc);
}

// Online softmax of one 64 x kBN score tile (rows r0: e 0-1, r1: e 2-3 of
// each 8-key group n) into P's bf16 A registers; returns O's rescale factors
// in alpha. The max is taken on the raw scores (scale > 0), so a score costs
// one FFMA into ex2: p = 2^(s * scale * log2(e) - m). Masked keys (past S,
// or past the row when causal) count as -1e30 with p = 0; only a tile that
// holds one (past S, or past the warpgroup's first row q_lo) takes that
// path. The scores are only read: a product may be writing the next tile's
// into other registers meanwhile.
template <int kBN, bool kMasked>
__device__ __forceinline__ void fa_softmax_tile(const float (&sc)[kBN / 2],
                                                uint32_t (&pa)[kBN / 16][4], float (&m_i)[2],
                                                float (&l_i)[2], float (&alpha)[2], int kv0,
                                                int s, int causal, int r0, int r1, int t,
                                                float scale_log2) {
  auto dead = [&](int n, int e) {
    const int key = kv0 + n * 8 + 2 * t + (e & 1);
    return key >= s || (causal && key > (e < 2 ? r0 : r1));
  };
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1] = fmaxf(mx[e >> 1], kMasked && dead(n, e) ? kNegInf : sc[4 * n + e]);
  float m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // a row with every key masked so far keeps -1e30 (never scaled)
    m_new[i] = fmaxf(m_i[i], mx[i] == kNegInf ? kNegInf : mx[i] * scale_log2);
    alpha[i] = ex2(m_i[i] - m_new[i]);
  }
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = ex2(fmaf(sc[4 * n + e], scale_log2, -m_new[e >> 1]));
      if (kMasked && dead(n, e)) p[e] = 0.f;
    }
    rs[0] += p[0] + p[1];
    rs[1] += p[2] + p[3];
    pa[n >> 1][(n & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
    pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    l_i[i] = l_i[i] * alpha[i] + rs[i];
    m_i[i] = m_new[i];
  }
}

template <int kBN>
__device__ __forceinline__ void fa_softmax(const float (&sc)[kBN / 2], uint32_t (&pa)[kBN / 16][4],
                                           float (&m_i)[2], float (&l_i)[2], float (&alpha)[2],
                                           int kv0, int s, int causal, int q_lo, int r0, int r1,
                                           int t, float scale_log2) {
  if (kv0 + kBN > s || (causal && kv0 + kBN - 1 > q_lo))
    fa_softmax_tile<kBN, true>(sc, pa, m_i, l_i, alpha, kv0, s, causal, r0, r1, t, scale_log2);
  else
    fa_softmax_tile<kBN, false>(sc, pa, m_i, l_i, alpha, kv0, s, causal, r0, r1, t, scale_log2);
}

// A descriptor of D's sub-tiles: the 128-byte swizzle, or the 64-byte one
// of 32-column rows; SBO one 8-row group.
template <int D>
__device__ __forceinline__ uint64_t fa_desc(const bf16* p, uint32_t lbo_bytes) {
  constexpr int kSw = FaLayout<D>::kSw;
  return kSw == 128 ? wgmma_desc_sw128(p, lbo_bytes, 8 * kSw)
                    : wgmma_desc_sw64(p, lbo_bytes, 8 * kSw);
}

template <int D, int kBN = FaLayout<D>::kBN>
__device__ __forceinline__ void fa_issue_s(float (&sc)[kBN / 2], const bf16* qw, const bf16* kt) {
  constexpr int kCols = FaLayout<D>::kCols;
  constexpr int kSteps = kCols / 16;                       // k-steps a sub-tile
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int sub = kk / kSteps, kin = (kk % kSteps) * 16;
    wgmma_qk<kBN>(sc, fa_desc<D>(qw + sub * kFaBM * kCols + kin, 16),
                  fa_desc<D>(kt + sub * kBN * kCols + kin, 16), kk > 0);
  }
  wgmma_commit();
}

template <int D, int kBN = FaLayout<D>::kBN, int kDP = FaLayout<D>::kDP>
__device__ __forceinline__ void fa_issue_pv(float (&o)[kDP / 2], const uint32_t (&pa)[kBN / 16][4],
                                            const bf16* vt) {
  constexpr int kCols = FaLayout<D>::kCols;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_pv<kDP>(o, pa[kk], fa_desc<D>(vt + kk * 16 * kCols, kBN * kCols * 2));
  wgmma_commit();
}

template <int D>
__device__ __forceinline__ void fa_rescale(float (&o)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[4 * n + 0] *= alpha[0];
    o[4 * n + 1] *= alpha[0];
    o[4 * n + 2] *= alpha[1];
    o[4 * n + 3] *= alpha[1];
  }
}

template <int D>
__global__ void __launch_bounds__(kFaThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int s, int hq,
                  int hk, int causal, float scale_log2) {
  using L = FaLayout<D>;
  constexpr int kFaBN = L::kBN;
  constexpr int kDP = L::kDP;
  extern __shared__ __align__(1024) unsigned char fa_raw[];
  unsigned char* base = fa_raw + ((1024 - (smem_u32(fa_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(base);                        // [kSub][kFaBM][kCols]
  bf16* ks = reinterpret_cast<bf16*>(base + L::kQBytes);           // [stage][kSub][kFaBN][kCols]
  bf16* vs = ks + kFaStages * kFaBN * kDP;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::kBarOff);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kFaStages;
  uint64_t* k_empty = v_full + kFaStages;
  uint64_t* v_empty = k_empty + kFaStages;

  const int n_q = (s + kFaBM - 1) / kFaBM;
  const int qt = n_q - 1 - (int)blockIdx.x;                        // heaviest causal tiles first
  const int h = blockIdx.y;
  const int kvh = h / (hq / hk);
  const int q0 = qt * kFaBM;
  const int n_kv = (s + kFaBN - 1) / kFaBN;
  const int last = causal ? min(n_kv - 1, (min(s - 1, q0 + kFaBM - 1)) / kFaBN) : n_kv - 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kFaStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], kFaConsumers);
      mbar_init(&v_empty[st], kFaConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the ring full; a K stage frees
    // once S has read it, a V stage once P.V has
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      // sub-tile `sub` of head `head`'s rows from `row`: a 2-D box at column
      // head * D, or (ragged D) a 3-D box whose columns past D are zeros;
      // either way the box's full bytes count toward the barrier
      auto load = [&](bf16* dst, const CUtensorMap* map, uint64_t* bar, int head, int sub,
                      int row) {
        if constexpr (L::kRagged)
          tma_load_3d(dst, map, bar, sub * L::kCols, head, row);
        else
          tma_load_2d(dst, map, bar, head * D + sub * L::kCols, row);
      };
      mbar_arrive_expect_tx(q_full, L::kQBytes);
      for (int sub = 0; sub < L::kSub; ++sub)
        load(qs + sub * kFaBM * L::kCols, &tq, q_full, h, sub, q0);
      for (int j = 0; j <= last; ++j) {
        const int st = j % kFaStages;
        const uint32_t free_ph = ((j / kFaStages) & 1) ^ 1;
        mbar_wait(&k_empty[st], free_ph);
        mbar_arrive_expect_tx(&k_full[st], L::kTileBytes);
        for (int sub = 0; sub < L::kSub; ++sub)
          load(ks + st * kFaBN * kDP + sub * kFaBN * L::kCols, &tk, &k_full[st], kvh, sub,
               j * kFaBN);
        mbar_wait(&v_empty[st], free_ph);
        mbar_arrive_expect_tx(&v_full[st], L::kTileBytes);
        for (int sub = 0; sub < L::kSub; ++sub)
          load(vs + st * kFaBN * kDP + sub * kFaBN * L::kCols, &tv, &v_full[st], kvh, sub,
               j * kFaBN);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int ct = threadIdx.x - 128;
    const int cwg = ct >> 7;                                      // consumer warpgroup
    const int warp = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const int q_lo = q0 + cwg * 64;
    const int r0 = q_lo + warp * 16 + g, r1 = r0 + 8;             // this thread's two rows
    const bf16* qw = qs + cwg * 64 * L::kCols;                    // its 64 rows of each sub-tile

    float oacc[kDP / 2];                                          // columns past D: zeros
#pragma unroll
    for (int i = 0; i < kDP / 2; ++i) oacc[i] = 0.f;
    float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f}, alpha[2];
    float sc[kFaBN / 2];                                          // S: 64 rows x kFaBN keys
    uint32_t pa[kFaBN / 16][4];                                   // P as bf16 A registers
    mbar_wait(q_full, 0);
    for (int j = 0; j <= last; ++j) {
      const int st = j % kFaStages;
      const uint32_t ph = (j / kFaStages) & 1;
      mbar_wait(&k_full[st], ph);
      wgmma_fence();
      fa_issue_s<D>(sc, qw, ks + st * kFaBN * kDP);
      wgmma_wait<0>();
      wgmma_fence_regs(sc);
      mbar_arrive(&k_empty[st]);
      fa_softmax<kFaBN>(sc, pa, m_i, l_i, alpha, j * kFaBN, s, causal, q_lo, r0, r1, t,
                        scale_log2);
      fa_rescale<kDP>(oacc, alpha);
      mbar_wait(&v_full[st], ph);
      wgmma_fence_regs(oacc);
      wgmma_fence();
      fa_issue_pv<D>(oacc, pa, vs + st * kFaBN * kDP);
      wgmma_wait<0>();
      wgmma_fence_regs(oacc);
      mbar_arrive(&v_empty[st]);
    }

    const float l0 = fmaxf(l_i[0], 1e-30f), l1 = fmaxf(l_i[1], 1e-30f);
    const size_t row_q = (size_t)hq * D;
    bf16* o0 = o + (size_t)r0 * row_q + (size_t)h * D;
    bf16* o1 = o + (size_t)r1 * row_q + (size_t)h * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (r0 < s)
        *reinterpret_cast<uint32_t*>(o0 + c) = pack_bf16(oacc[4 * n] / l0, oacc[4 * n + 1] / l0);
      if (r1 < s)
        *reinterpret_cast<uint32_t*>(o1 + c) =
            pack_bf16(oacc[4 * n + 2] / l1, oacc[4 * n + 3] / l1);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_attention, f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 4;                       // query rows per warp
constexpr int kF32Q = 4 * kF32Rows;               // query rows per block
constexpr int kF32C = 32;                         // keys per tile

// The f32 kernel's shared memory (dynamic: 84 KB at D 256): K and V tiles
// [kF32C][D + 1], the query rows [kF32Q][D], P [4][kF32Rows][kF32C].
template <int D>
constexpr size_t f32_smem_bytes() {
  return ((size_t)2 * kF32C * (D + 1) + (size_t)kF32Q * D + 4 * kF32Rows * kF32C) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int s, int hq, int hk,
                 int causal, float scale) {
  constexpr int kPad = D + 1;                     // lane-per-key row reads hit distinct banks
  constexpr int kDPL = (D + 31) / 32;             // output dims per lane: lane + 32 j < D
  auto owns = [&](int lane, int j) { return D % 32 == 0 || lane + 32 * j < D; };
  extern __shared__ float f32_raw[];
  auto ks = reinterpret_cast<float (*)[kPad]>(f32_raw);
  auto vs = reinterpret_cast<float (*)[kPad]>(f32_raw + kF32C * kPad);
  auto qs = reinterpret_cast<float (*)[D]>(f32_raw + 2 * kF32C * kPad);
  auto ps = reinterpret_cast<float (*)[kF32Rows][kF32C]>(f32_raw + 2 * kF32C * kPad + kF32Q * D);

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
        for (int j = 0; j < kDPL; ++j)
          if (owns(lane, j)) acc[rr][j] += pr * vs[c][lane + 32 * j];
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
      if (owns(lane, j)) o[(size_t)row * row_q + (size_t)h * D + lane + 32 * j] = acc[rr][j] / lf;
  }
}

template <int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* out, int s, int hq,
                         int hk, int causal, int is_f32, float scale, cudaStream_t st) {
  if (is_f32) {
    constexpr size_t smem = f32_smem_bytes<D>();
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(flash_f32_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    const dim3 grid((s + kF32Q - 1) / kF32Q, hq);
    flash_f32_kernel<D><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), s, hq, hk, causal, scale);
    return cudaGetLastError();
  }
  CUtensorMap tq, tk, tv;
  using L = FaLayout<D>;
  const uint64_t qrow = (uint64_t)hq * D, kvrow = (uint64_t)hk * D;
  const CUtensorMapSwizzle sw =
      L::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  // [rows][heads][D] with boxes of kCols x 1 x box_rows (ragged D), else
  // the [rows][heads * D] plane with boxes of kCols x box_rows
  auto map = [&](CUtensorMap* m, const void* base, int heads, uint32_t box_rows) {
    if (L::kRagged) {
      const uint64_t dims[3] = {(uint64_t)D, (uint64_t)heads, (uint64_t)s};
      const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)heads * D * 2};
      const uint32_t box[3] = {(uint32_t)L::kCols, 1, box_rows};
      return pgk_tensor_map_bf16_nd(m, base, 3, dims, strides, box,
                                    CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sw);
    }
    const uint64_t row = (uint64_t)heads * D;
    return pgk_tensor_map_bf16(m, base, row, s, row * 2, L::kCols, box_rows, sw);
  };
  cudaError_t e = map(&tq, q, hq, kFaBM);
  if (e == cudaSuccess) e = map(&tk, k, hk, L::kBN);
  if (e == cudaSuccess) e = map(&tv, v, hk, L::kBN);
  if (e != cudaSuccess) return e;
  constexpr int smem = FaLayout<D>::kBytes;
  e = cudaFuncSetAttribute(flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s + kFaBM - 1) / kFaBM, hq);
  flash_bf16_kernel<D><<<grid, kFaThreads, smem, st>>>(
      tq, tk, tv, static_cast<bf16*>(out), s, hq, hk, causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// q [s, hq, d], k and v [s, hk, d], out [s, hq, d]; contiguous, 16-byte
// aligned, all bf16 (is_f32 == 0) or all f32. causal masks keys > query.
// Requires s >= 1, d in {64, 80, 96, 128, 256} (any other:
// cudaErrorInvalidValue), hq % hk == 0.
PGK_API int pgk_flash_attention(const void* q, const void* k, const void* v, void* out, int s,
                                int hq, int hk, int d, int causal, int is_f32, float scale,
                                void* stream) {
  if (s < 1 || hk < 1 || hq % hk != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return (int)launch_flash<64>(q, k, v, out, s, hq, hk, causal, is_f32, scale, st);
  if (d == 80) return (int)launch_flash<80>(q, k, v, out, s, hq, hk, causal, is_f32, scale, st);
  if (d == 96) return (int)launch_flash<96>(q, k, v, out, s, hq, hk, causal, is_f32, scale, st);
  if (d == 128) return (int)launch_flash<128>(q, k, v, out, s, hq, hk, causal, is_f32, scale, st);
  if (d == 256) return (int)launch_flash<256>(q, k, v, out, s, hq, hk, causal, is_f32, scale, st);
  return (int)cudaErrorInvalidValue;
}
