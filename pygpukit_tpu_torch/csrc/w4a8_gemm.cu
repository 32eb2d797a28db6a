// w4a8 int4 GEMM for M > 8 rows (prefill): the w4a8 GEMV's math,
// y[m, n] = bf16((acc[m, n] * scale[n]) * sx[m]), acc exact in int32.
//
// Replaces pygpukit_tpu/kernels/gemv_quant.py _gemm_w4a8_pallas (:830,
// pallas_call :836).
//
// Bound: operations. Every packed weight byte feeds 2 M int8 MACs, so from
// M = 256 on the int8 tensor cores (1,979 TOP/s dense) bound the product.
//
// Design: int8 wgmma (m64n128k32, s8 x s8 -> s32) with the operands swapped,
// Y^T = W . X^T. The weight is wgmma's register operand A and the int8
// activations xq = quantize(x) its shared-memory operand B, so M is wgmma's
// N and the packed weight is unpacked straight into A's fragments:
// - A tile is 128 weight rows (two consumer warpgroups of 64) x 128
//   activation rows. A stage of the TMA ring holds 128 packed bytes of K of
//   the weight ([N, K/2], K contiguous) and the two 128-column boxes of xq
//   ([M, K], K contiguous) that those bytes pair with: columns j .. j + 127
//   (the low nibbles) and K/2 + j .. (the high nibbles). Both are K-major, as
//   8-bit wgmma requires, 128-byte swizzled. TMA fills zeros past every edge;
//   a low box that runs past K/2 meets zero weight bytes there.
// - Unpacking costs one shift and one AND a word: (w << 4) & 0xF0F0F0F0 is 16
//   times each signed low nibble as an int8 lane, w & 0xF0F0F0F0 16 times
//   each high nibble, so the sums are 16 acc, exact (|16 acc| <= 128 * 127 * K
//   < 2^31 for K <= 131072) and acc = sum >> 4.
// - A producer warpgroup (one thread issues the loads) feeds a 4-stage ring;
//   each consumer warpgroup unpacks a stage's fragments, then runs its 8
//   products as one commit group.
// - Persistent grid of at most one block an SM over units (a tile and a
//   range of K stages). Where the tiles alone fill the card poorly (the
//   prefill's M 256: 16 to 88 tiles a projection on 132 SMs) K is split: each
//   split stores its exact int32 sums, and the last split of a tile to arrive
//   (an atomic ticket on a per-tile counter) adds the others' and writes the
//   tile. Integer sums are exact in any order, so the output is bitwise the
//   plain version's whatever the split or arrival order. The plan is a
//   function of (M, N, K/2) and the card's SM count alone
//   (kernels/gemv_quant.py w4a8_gemm_plan mirrors it), so a captured graph
//   stays valid. The counters are a __device__ array of the library, zero
//   when it loads and reset by the block that folds: two split launches in
//   flight at once on different streams must not share them (the port runs
//   on one stream).
// - The epilogue scales with __fmul_rn twice (no FMA), rounds to bf16 and
//   transposes the tile through shared memory, so a thread stores 16 bytes
//   of one output row.
// The activation quantization (act_quant.cuh) runs first, as its own launch.
#include "act_quant.cuh"
#include "hopper_gemm.cuh"

namespace {

constexpr int kTW = 128;                      // weight rows (output columns) a tile
constexpr int kTA = 128;                      // activation rows a tile: wgmma's N
constexpr int kKB = 128;                      // packed bytes of K a stage
constexpr int kStages = 4;
constexpr int kThreads = 384;                 // producer warpgroup + two consumers
constexpr int kConsumers = 256;
constexpr int kMaxSplits = 8;
constexpr int kMaxSplitTiles = 4096;
constexpr int kBoxBytes = kTW * kKB;          // 16 KB: the weight box and each xq box
constexpr int kStageBytes = 3 * kBoxBytes;
constexpr int kEpiOff = kStages * kStageBytes;
constexpr int kBarOff = kEpiOff + kTA * kTW * 2;
constexpr int kSmem = kBarOff + 16 * kStages + 16 + 1024;   // + alignment slack
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

__device__ unsigned w4a8_gemm_arrivals[kMaxSplitTiles] = {};

struct W4a8Plan {
  int tiles_m, tiles_n, n_k, splits, units, grid;
};

// The launch plan: tiles of kTA x kTW, n_k stages of K, and the K splits
// whose waves of units cost least (waves x stages a unit, fewest splits on a
// tie) among those that keep the units within two waves.
__host__ __device__ inline W4a8Plan w4a8_plan(int m, int n, int k_half, int sms) {
  W4a8Plan p;
  p.tiles_m = hg_cdiv(m, kTA);
  p.tiles_n = hg_cdiv(n, kTW);
  p.n_k = hg_cdiv(k_half, kKB);
  const int tiles = p.tiles_m * p.tiles_n;
  p.splits = 1;
  if (tiles <= kMaxSplitTiles) {
    long best = (long)hg_cdiv(tiles, sms) * p.n_k;
    for (int s = 2; s <= kMaxSplits && s <= p.n_k && tiles * s <= 2 * sms; ++s) {
      const long cost = (long)hg_cdiv(tiles * s, sms) * hg_cdiv(p.n_k, s);
      if (cost < best) {
        best = cost;
        p.splits = s;
      }
    }
  }
  p.units = tiles * p.splits;
  p.grid = p.units < sms ? p.units : sms;
  return p;
}

// Unit u: split u % splits of tile u / splits (tiles in hg_raster order),
// stages [k0, k1).
__device__ __forceinline__ void w4_unit(int u, const W4a8Plan& p, int& tm, int& tn, int& k0,
                                        int& k1) {
  const int s = u % p.splits;
  hg_raster(u / p.splits, p.tiles_m, p.tiles_n, tm, tn);
  k0 = s * p.n_k / p.splits;
  k1 = (s + 1) * p.n_k / p.splits;
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// One stage for a consumer warpgroup: unpack the packed words of its rows
// r1 and r1 + 8 (lane 4 g + t: bytes 32 kc + 4 t and 32 kc + 16 + 4 t of each
// 32-byte K step kc; the 128-byte swizzle puts 16-byte chunk c of row r at
// c ^ (r % 8)) into the fragments, then the 8 products, one commit group,
// awaited before the stage is released. No product is in flight while the
// fragments are written (ptxas serializes every product otherwise, C7513);
// the other consumer warpgroup's products keep the tensor cores busy.
__device__ __forceinline__ void w4_stage(int (&acc)[64], const unsigned char* base,
                                         uint64_t* full, uint64_t* empty, uint32_t& it, int r1,
                                         int t, bool first) {
  uint32_t f[8][4];
  const int st = it % kStages;
  mbar_wait(&full[st], (it / kStages) & 1);
  const unsigned char* ws = base + st * kStageBytes;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int hb = 0; hb < 2; ++hb)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r1 + 8 * hr;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            ws + row * kKB + (((2 * kc + hb) ^ (row & 7)) << 4) + 4 * t);
        f[2 * kc][hr + 2 * hb] = (w << 4) & 0xF0F0F0F0u;     // 16 x the low nibbles
        f[2 * kc + 1][hr + 2 * hb] = w & 0xF0F0F0F0u;        // 16 x the high nibbles
      }
  const unsigned char* xlo = ws + kBoxBytes;
  const unsigned char* xhi = ws + 2 * kBoxBytes;
  wgmma_fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    wgmma_rs_m64n128k32_s8(acc, f[2 * kc], wgmma_desc_sw128(xlo + 32 * kc, 16, 1024),
                           !(first && kc == 0));
    wgmma_rs_m64n128k32_s8(acc, f[2 * kc + 1], wgmma_desc_sw128(xhi + 32 * kc, 16, 1024), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_regs(acc);
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
  ++it;
}

__global__ void __launch_bounds__(kThreads, 1)
w4a8_gemm_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
                 const float* __restrict__ scale, const float* __restrict__ sx,
                 int* __restrict__ part, __nv_bfloat16* __restrict__ out, int m, int n,
                 int k_half, W4a8Plan plan) {
  extern __shared__ __align__(1024) unsigned char w4_raw[];
  unsigned char* base = w4_raw + ((1024 - (smem_u32(w4_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kBarOff);
  uint64_t* empty = full + kStages;
  int* last_flag = reinterpret_cast<int*>(empty + kStages);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  uint32_t it = 0;
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    for (int u = blockIdx.x; u < plan.units; u += gridDim.x) {
      int tm, tn, k0, k1;
      w4_unit(u, plan, tm, tn, k0, k1);
      for (int kt = k0; kt < k1; ++kt, ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], kStageBytes);
        unsigned char* dst = base + st * kStageBytes;
        tma_load_2d(dst, &tw, &full[st], kt * kKB, tn * kTW);
        tma_load_2d(dst + kBoxBytes, &tx, &full[st], kt * kKB, tm * kTA);
        tma_load_2d(dst + 2 * kBoxBytes, &tx, &full[st], k_half + kt * kKB, tm * kTA);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int ctid = threadIdx.x - 128;
  const int cwg = ctid >> 7, wt = ctid & 127;
  const int warp = wt >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const int r1 = 64 * cwg + 16 * warp + g;          // this thread's weight rows r1, r1 + 8
  // the warpgroup's 64 weight rows x kTA activation rows, bf16, stored by
  // activation row (128 bytes, 16-byte chunk c at c ^ (row % 8))
  __nv_bfloat16* epi = reinterpret_cast<__nv_bfloat16*>(base + kEpiOff) + cwg * (kTA * 64);
  const bool vec = n % 8 == 0;
  int acc[64];
  for (int u = blockIdx.x; u < plan.units; u += gridDim.x) {
    int tm, tn, k0, k1;
    w4_unit(u, plan, tm, tn, k0, k1);
    for (int kt = k0; kt < k1; ++kt) w4_stage(acc, base, full, empty, it, r1, t, kt == k0);

    // split K: publish this split's sums; the last split of the tile folds
    const int splits = plan.splits;
    if (splits > 1) {
      int4* mine = reinterpret_cast<int4*>(part) + (size_t)u * (kConsumers * 16);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        __stcg(mine + i * kConsumers + ctid,
               make_int4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]));
      named_sync(1, kConsumers);
      if (ctid == 0) {
        // the barrier orders every consumer's stores before this fence, which
        // makes them visible to the device before the ticket (cumulativity)
        __threadfence();
        const int tile = u / splits;
        const bool last = atomicAdd(&w4a8_gemm_arrivals[tile], 1u) == (unsigned)(splits - 1);
        if (last) {
          w4a8_gemm_arrivals[tile] = 0;            // every split has arrived
          __threadfence();
        }
        *last_flag = last;
      }
      named_sync(1, kConsumers);
      if (!*last_flag) continue;
    }
    // the tile's sums: this split's, plus the others' (all 16 loads of a
    // split in flight at once)
    int v[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) v[i] = acc[i];
    const int u0 = u - u % splits;
    for (int s = 0; s < splits; ++s) {
      if (u0 + s == u) continue;
      const int4* other = reinterpret_cast<const int4*>(part) + (size_t)(u0 + s) * (kConsumers * 16);
      int4 p[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) p[i] = __ldcg(other + i * kConsumers + ctid);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        v[4 * i] += p[i].x;
        v[4 * i + 1] += p[i].y;
        v[4 * i + 2] += p[i].z;
        v[4 * i + 3] += p[i].w;
      }
    }
    // the scales this thread multiplies by, loaded before the chain of
    // shared-memory stores (which the compiler cannot move them past)
    const int n1 = tn * kTW + r1;
    const float sc1 = n1 < n ? scale[n1] : 0.f;
    const float sc2 = n1 + 8 < n ? scale[n1 + 8] : 0.f;
    float sxv[32];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gm = tm * kTA + 8 * i + 2 * t + e;
        sxv[2 * i + e] = gm < m ? sx[gm] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < 16; ++i) {               // v[4 i ..]: activation rows 8 i + 2 t, + 1
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * warp + g + (e >> 1) * 8;      // of the warpgroup's 64
        const int ma = 8 * i + 2 * t + (e & 1);
        const int gn = tn * kTW + 64 * cwg + row;
        const float y = __fmul_rn(__fmul_rn(__int2float_rn(v[4 * i + e] >> 4), e >> 1 ? sc2 : sc1),
                                  sxv[2 * i + (e & 1)]);
        epi[ma * 64 + ((((row >> 3) ^ (ma & 7))) << 3) + (row & 7)] =
            __float2bfloat16_rn(gn < n ? y : 0.f);
      }
    }
    named_sync(2 + cwg, 128);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int idx = q * 128 + wt, ma = idx >> 3, c = idx & 7;
      const int gm = tm * kTA + ma, gn = tn * kTW + 64 * cwg + 8 * c;
      if (gm >= m || gn >= n) continue;
      const uint4 val = *reinterpret_cast<const uint4*>(epi + ma * 64 + ((c ^ (ma & 7)) << 3));
      __nv_bfloat16* dst = out + (size_t)gm * n + gn;
      if (vec && gn + 8 <= n) {
        *reinterpret_cast<uint4*>(dst) = val;
      } else {
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&val);
        for (int e = 0; e < 8 && gn + e < n; ++e) dst[e] = h[e];
      }
    }
    named_sync(2 + cwg, 128);                    // the buffer is free for the next tile
  }
}

int card_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

}  // namespace

// x [m, 2*k_half] bf16 (x_f32 == 0) or f32; w [n, k_half] uint8; scale [n]
// f32; xq [m, 2*k_half] int8 and sx [m] f32 are scratch, and part (int32,
// plan units x 16384 values, read only when the plan splits K); out [m, n]
// bf16. Requires k_half % 16 == 0, k_half <= 65536 and 16-byte aligned w
// and xq.
PGK_API int pgk_w4a8_gemm(const void* x, int x_f32, const void* w, const void* scale, void* xq,
                          void* sx, void* part, void* out, int m, int n, int k_half,
                          void* stream) {
  if (m < 1 || n < 1 || k_half < 16 || k_half % 16 != 0 || k_half > 65536 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(xq) % 16)
    return (int)cudaErrorInvalidValue;
  const int sms = card_sms();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = pgk_act_quant(x, x_f32, m, 2 * k_half, static_cast<int8_t*>(xq),
                                static_cast<float*>(sx), st);
  if (e != cudaSuccess) return (int)e;
  const W4a8Plan plan = w4a8_plan(m, n, k_half, sms);
  if (plan.splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap tw, tx;
  e = pgk_tensor_map_u8(&tw, w, k_half, n, k_half, kKB, kTW);
  if (e == cudaSuccess) e = pgk_tensor_map_u8(&tx, xq, 2 * k_half, m, 2 * k_half, kKB, kTA);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(w4a8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (e != cudaSuccess) return (int)e;
  w4a8_gemm_kernel<<<plan.grid, kThreads, kSmem, st>>>(
      tw, tx, static_cast<const float*>(scale), static_cast<const float*>(sx),
      static_cast<int*>(part), static_cast<__nv_bfloat16*>(out), m, n, k_half, plan);
  return (int)cudaGetLastError();
}

// The launch plan on this card (kernels/gemv_quant.py w4a8_gemm_plan is the
// same rule): plan[0..6] = tiles_m, tiles_n, n_k, splits, units, grid, and
// the SMs it planned for.
PGK_API int pgk_w4a8_gemm_plan(int m, int n, int k_half, int* plan) {
  const int sms = card_sms();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const W4a8Plan p = w4a8_plan(m, n, k_half, sms);
  const int v[7] = {p.tiles_m, p.tiles_n, p.n_k, p.splits, p.units, p.grid, sms};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
  return 0;
}
