"""The launch plans and arithmetic of the block w4a16 GEMV
(``csrc/block_w4a16_gemv.cu`` on ``csrc/w4a16_mma.cuh``, row 12) and of the
whole-model decode step (``csrc/fused_decode.cu``, row 18) on the CPU,
where the kernels cannot run, held against their Python mirrors
(``kernels/gemv_quant.py`` ``block_w4a16_plan``, ``block_w4a16_warp_rounds``;
``kernels/fused_decode.py`` ``fused_plan``, ``fused_schedule``):

- row 12's tiles cover N once and its warps (split-major, a tile's splits
  one cluster) K's 32-row rounds once, with at least 132 blocks at the four
  1.1B projections;
- its paired dequantization (a byte's nibbles as one bf16x2: the nibble
  ^ 8 ORed into the bf16 of 128, 136 taken away, one bf16 multiply by the
  two rows' scales) equals ``bf16(f32(nibble) * f32(s))`` for every
  nibble and every finite bf16 scale;
- a numpy emulation of its mma.sync fragments (a byte's k = r and
  K/2 + r as one A register, x paired alike, lane (g, t) owning 8 columns
  and 8 packed rows of a round), its per-warp sums, warp fold and ascending
  split fold stays within one bf16 ulp plus 1e-4 of max |y| of
  ``block_w4a16_matmul_plain`` at rows 1-8, K 96 and 2080 (a block
  straddles K/2), K/2 % 8 == 4 (a lane's high rows straddle a block), ragged
  N; the round-level emulation of its sums at the 1.1B projections too
  (64-column tiles, 8 columns a lane);
- row 18's schedule runs every unit of every stage on one block once; what
  a block asks for in L2 before a barrier is the first rows of the unit it
  runs next, in whole boxes; each barrier waits for every block's arrival;
  the short units are asked for whole.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pygpukit_tpu_torch.kernels.fused_decode import (BOX_ROWS, H100_SMEM_OPTIN, STAGES,
                                                     UNIT_N, fused_plan, fused_schedule)
from pygpukit_tpu_torch.kernels.gemv_quant import (W4A16_MAX_SPLITS, W4A16_MAX_WARPS,
                                                   W4A16_ROUND, W4A16_TILE_N,
                                                   block_w4a16_matmul_plain, block_w4a16_plan,
                                                   block_w4a16_warp_rounds)

PROJ_SHAPES = [(2560, 2048), (2048, 2048), (11264, 2048), (2048, 5632)]
SMS = 132


# ---------------------------------------------------------------------------
# bf16 helpers: bits <-> values, round to nearest even
# ---------------------------------------------------------------------------

def bf16_value(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def f32_to_bf16_bits(f):
    u = np.asarray(f, np.float32).view(np.uint32)
    inf_nan = (u & 0x7F800000) == 0x7F800000
    rounded = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    return np.where(inf_nan, u >> 16, rounded).astype(np.uint16)


def f64_to_bf16_bits(v):
    """Round float64 values once to bf16 (nearest even; 8 significant bits,
    the subnormal spacing 2^-133, overflow to inf)."""
    v = np.asarray(v, np.float64)
    a = np.abs(v)
    _, e = np.frexp(a)
    ulp = np.ldexp(1.0, np.maximum(e - 8, -133))
    r = np.round(a / ulp) * ulp
    r = np.where(r >= 2.0 ** 128, np.inf, r)
    return f32_to_bf16_bits(np.copysign(r, v).astype(np.float32))


def dq_pair(byte, s_lo, s_hi):
    """The kernel's paired dequantization of packed bytes: the low (K row
    r) and high (K/2 + r) nibble, each (u | 0x4300) - 136 with u = nibble ^
    8, times its scale, the exact product rounded once to bf16. Returns the
    two halves' bf16 values."""
    b = np.asarray(byte, np.uint32)
    lo = bf16_value(((b & 0xF) ^ 8) | 0x4300).astype(np.float64) - 136.0
    hi = bf16_value((((b >> 4) & 0xF) ^ 8) | 0x4300).astype(np.float64) - 136.0
    return (bf16_value(f64_to_bf16_bits(lo * np.asarray(s_lo, np.float64))),
            bf16_value(f64_to_bf16_bits(hi * np.asarray(s_hi, np.float64))))


# ---------------------------------------------------------------------------
# row 12: the plan
# ---------------------------------------------------------------------------

@settings(max_examples=300, deadline=None)
@given(rows=st.integers(1, 8), n4=st.integers(1, 5000), kh4=st.integers(1, 3000))
def test_block_w4a16_plan_covers_n_and_k_once(rows, n4, kh4):
    n, k_half = 4 * n4, 4 * kh4
    p = block_w4a16_plan(n, k_half, rows)
    assert p["tile_n"] == W4A16_TILE_N == 64
    assert p["tiles"] * p["tile_n"] >= n > (p["tiles"] - 1) * p["tile_n"]
    assert p["rounds"] * W4A16_ROUND >= k_half > (p["rounds"] - 1) * W4A16_ROUND
    assert p["splits"] in (1, 2, 4, 8) and p["splits"] <= W4A16_MAX_SPLITS
    assert 1 <= p["warps"] <= W4A16_MAX_WARPS
    assert p["splits"] == 1 or 2 * (p["splits"] // 2) <= p["rounds"]
    covered = np.zeros(p["rounds"], np.int64)
    prev = 0
    for i0, i1 in block_w4a16_warp_rounds(p["rounds"], p["splits"], p["warps"]):
        assert i0 == prev <= i1                       # ascending, contiguous
        covered[i0:i1] += 1
        prev = i1
    assert prev == p["rounds"] and (covered == 1).all()
    assert p["smem"] == (p["warps"] + p["splits"]) * rows * p["tile_n"] * 4 <= 227 * 1024


@pytest.mark.parametrize("n,k", PROJ_SHAPES)
def test_block_w4a16_plan_fills_the_card_at_the_projections(n, k):
    p = block_w4a16_plan(n, k // 2)
    assert p["blocks"] == p["tiles"] * p["splits"] >= SMS


# ---------------------------------------------------------------------------
# row 12: the paired dequantization
# ---------------------------------------------------------------------------

def test_paired_bf16_multiply_is_the_reference_weight():
    bits = np.arange(1 << 16, dtype=np.uint32)
    finite = (bits & 0x7F80) != 0x7F80
    s = bf16_value(bits[finite])                                  # every finite bf16
    for byte in range(256):
        lo_nib = ((byte & 0xF) ^ 8) - 8                           # signed nibbles
        hi_nib = ((byte >> 4) ^ 8) - 8
        lo, hi = dq_pair(np.full(s.shape, byte), s, s[::-1])
        with np.errstate(over="ignore"):                      # 8 x the largest: inf
            ref_lo = bf16_value(f32_to_bf16_bits(np.float32(lo_nib) * s))
            ref_hi = bf16_value(f32_to_bf16_bits(np.float32(hi_nib) * s[::-1]))
        assert np.array_equal(lo.view(np.uint32), ref_lo.view(np.uint32)), byte
        assert np.array_equal(hi.view(np.uint32), ref_hi.view(np.uint32)), byte


# ---------------------------------------------------------------------------
# row 12: the fragments, sums and fold
# ---------------------------------------------------------------------------

def _block_inputs(rows, n, k, b, seed):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    sbits = f32_to_bf16_bits((rng.random((k // b, n)) * 1e-2 + 1e-3).astype(np.float32))
    xbits = f32_to_bf16_bits(rng.standard_normal((rows, k)).astype(np.float32) * 2)
    return packed, sbits, xbits


def _plain(packed, sbits, xbits):
    x = torch.from_numpy(bf16_value(xbits)).to(torch.bfloat16)
    s = torch.from_numpy(bf16_value(sbits)).to(torch.bfloat16)
    return block_w4a16_matmul_plain(x, torch.from_numpy(packed), s).float().numpy()


def _within(y, ref):
    tol = np.abs(ref) * 2.0 ** -7 + 1e-4 * np.abs(ref).max()
    return bool((np.abs(y - ref) <= tol).all()), float(np.abs(y - ref).max())


def _weights(packed, sbits, b):
    """The dequantized low-half (K row r) and high-half (K/2 + r) weights
    [K/2, N], as the kernel's paired multiply makes them."""
    k_half = packed.shape[0]
    s = bf16_value(sbits)
    r = np.arange(k_half)
    return dq_pair(packed, s[r // b], s[(k_half + r) // b])


def emulate_fragments(packed, sbits, xbits, b):
    """The kernel lane by lane: for each tile, warp (split-major), round and
    k-step, product m's A[mu, kappa] is the weight of column tile * TN +
    (mu % 8) V + 2m + mu // 8 at K row r(kappa) (+ K/2 for the odd kappa),
    r(kappa) = 32 i + 8 ((kappa % 8) // 2) + 2j + kappa // 8; B[kappa, n]
    is x[n] at the same K; D += A B with the products exact and one f32
    rounding an mma. Then the warps' sums ascending, the splits' ascending,
    one bf16 rounding."""
    k_half, n = packed.shape
    rows = xbits.shape[0]
    p = block_w4a16_plan(n, k_half, rows)
    tn, v = p["tile_n"], p["tile_n"] // 8
    wlo, whi = _weights(packed, sbits, b)
    x = bf16_value(xbits).astype(np.float64)
    kap = np.arange(16)
    mu = np.arange(16)
    y = np.zeros((rows, p["tiles"] * tn), np.float32)
    warp_rounds = block_w4a16_warp_rounds(p["rounds"], p["splits"], p["warps"])
    for tile in range(p["tiles"]):
        splits = []
        for sp in range(p["splits"]):
            warps = []
            for w in range(p["warps"]):
                i0, i1 = warp_rounds[sp * p["warps"] + w]
                d = np.zeros((v // 2, 16, 8), np.float32)
                for i in range(i0, i1):
                    for j in range(4):
                        r = 32 * i + 8 * ((kap % 8) // 2) + 2 * j + kap // 8
                        live = r < k_half
                        rc = np.minimum(r, k_half - 1)
                        kidx = rc + (kap % 2) * k_half
                        bmat = np.zeros((16, 8))
                        bmat[:, :rows] = np.where(live[:, None], x[:, kidx].T, 0.0)
                        for m in range(v // 2):
                            col = tile * tn + (mu % 8) * v + 2 * m + mu // 8
                            cc = np.minimum(col, n - 1)
                            a = np.where((kap % 2 == 0)[None, :], wlo[rc][:, cc].T,
                                         whi[rc][:, cc].T).astype(np.float64)
                            a = np.where(live[None, :] & (col < n)[:, None], a, 0.0)
                            d[m] = (a @ bmat + d[m].astype(np.float64)).astype(np.float32)
                part = np.zeros((8, tn), np.float32)          # [act row][column of the tile]
                for m in range(v // 2):
                    cols = (mu % 8) * v + 2 * m + mu // 8
                    part[:, cols] = d[m].T
                warps.append(part)
            blk = warps[0].copy()
            for wp in warps[1:]:
                blk = (blk + wp).astype(np.float32)
            splits.append(blk)
        tot = splits[0].copy()
        for sp in splits[1:]:
            tot = (tot + sp).astype(np.float32)
        y[:, tile * tn:(tile + 1) * tn] = tot[:rows]
    return bf16_value(f32_to_bf16_bits(y[:, :n]))


@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("n,k,b", [(100, 96, 32), (256, 2080, 32), (132, 40, 8), (64, 64, 32)])
def test_block_w4a16_fragments_are_within_the_plain_tolerance(rows, n, k, b):
    packed, sbits, xbits = _block_inputs(rows, n, k, b, seed=rows * 7 + n)
    ok, err = _within(emulate_fragments(packed, sbits, xbits, b), _plain(packed, sbits, xbits))
    assert ok, err


def emulate_rounds(packed, sbits, xbits, b):
    """The kernel's sums a round at a time (each round's 64 K values summed
    exactly, rounded once to f32 into its warp's accumulator), the warps
    ascending, the splits ascending: every column at once."""
    k_half, n = packed.shape
    rows = xbits.shape[0]
    p = block_w4a16_plan(n, k_half, rows)
    wlo, whi = _weights(packed, sbits, b)
    x = bf16_value(xbits).astype(np.float64)
    warp_rounds = block_w4a16_warp_rounds(p["rounds"], p["splits"], p["warps"])
    total = None
    for sp in range(p["splits"]):
        blk = None
        for w in range(p["warps"]):
            i0, i1 = warp_rounds[sp * p["warps"] + w]
            acc = np.zeros((rows, n), np.float32)
            for i in range(i0, i1):
                r = np.arange(32 * i, min(32 * i + 32, k_half))
                part = x[:, r] @ wlo[r].astype(np.float64) + x[:, k_half + r] @ whi[r].astype(
                    np.float64)
                acc = (acc.astype(np.float64) + part).astype(np.float32)
            blk = acc if blk is None else (blk + acc).astype(np.float32)
        total = blk if total is None else (total + blk).astype(np.float32)
    return bf16_value(f32_to_bf16_bits(total))


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("n,k", PROJ_SHAPES)
def test_block_w4a16_round_sums_at_the_projections(rows, n, k):
    packed, sbits, xbits = _block_inputs(rows, n, k, 32, seed=n + k + rows)
    ok, err = _within(emulate_rounds(packed, sbits, xbits, 32), _plain(packed, sbits, xbits))
    assert ok, err


# ---------------------------------------------------------------------------
# row 18: the fused step's plan and schedule
# ---------------------------------------------------------------------------

DIMS_1B = dict(n_layers=22, hidden=2048, intermediate=5632, n_heads=32, n_kv_heads=4,
               head_dim=64)
DIMS_TINY = dict(n_layers=2, hidden=48, intermediate=96, n_heads=4, n_kv_heads=2, head_dim=12)


@pytest.mark.parametrize("dims,max_seq", [(DIMS_1B, 512), (DIMS_1B, 4096), (DIMS_TINY, 64)])
@pytest.mark.parametrize("pos", [0, 1, 143, 511, 3000])
def test_fused_schedule_runs_every_unit_once_and_prefetches_the_next(dims, max_seq, pos):
    plan = fused_plan(**dims, max_seq=max_seq)
    geo = dict(hidden=dims["hidden"], intermediate=dims["intermediate"],
               n_kv_heads=dims["n_kv_heads"], head_dim=dims["head_dim"])
    sched = fused_schedule(plan, **geo, pos=pos, max_seq=max_seq)
    grid = plan["grid"]
    live = min(pos, max_seq)
    # the fewest chunks of 16 rows that hold the context, the plan's at most
    assert sched["live_chunks"] == min(plan["chunks"], max(1, -(-live // 16)))
    for stage in STAGES:
        units = sched["units"][stage]
        seen = np.zeros(len(units), np.int64)
        for b in range(grid):
            for u in sched["blocks"][stage][b]:
                seen[u] += 1
        assert (seen == 1).all(), stage
        if stage != "attention":                      # the projection's K once a column tile
            n_cols = {}
            for k0, k1, col0 in units:
                n_cols.setdefault(col0, []).append((k0, k1))
            for col0, spans in n_cols.items():
                spans.sort()
                assert spans[0][0] == 0 and all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
    # before each barrier a block asks for the first rows of the unit it
    # runs next (its first unit of the next projection), in whole boxes
    nxt = {"qkv": "o", "o": "gate_up", "gate_up": "down", "down": "qkv"}
    for stage, target in nxt.items():
        for b in range(grid):
            pf = sched["prefetch"][stage][b]
            runs = sched["blocks"][target][b]
            if not runs:
                assert pf is None
                continue
            k0, k1, _ = sched["units"][target][runs[0]]
            assert pf[:2] == (target, runs[0])
            assert pf[2][0] == k0 and all(r < k1 for r in pf[2])
            assert len(pf[2]) == -(-min(k1 - k0, plan["l2_rows"]) // BOX_ROWS)
    assert all(p is None for p in sched["prefetch"]["attention"])
    # each barrier's counter grows by one a block: its target is the grid
    assert sched["barriers"] == [grid] * len(STAGES)


@pytest.mark.parametrize("dims,max_seq", [(DIMS_1B, 512), (DIMS_1B, 4096), (DIMS_TINY, 64)])
def test_fused_plan_slices_and_prefetch(dims, max_seq):
    """At the 1.1B shape a block asks for its next unit's first 128 rows in
    L2 (two boxes; an o unit whole), 64 KB a block, 8.7 MB in all; o and
    down run 16 K slices. Every plan fits one block of shared memory."""
    plan = fused_plan(**dims, max_seq=max_seq)
    assert plan["smem_bytes"] <= H100_SMEM_OPTIN
    assert plan["l2_rows"] % BOX_ROWS == 0
    if dims is DIMS_1B:
        h = dims["hidden"]
        assert plan["l2_rows"] == 128 == -(-h // plan["slices_o"])
        assert plan["grid"] * plan["l2_rows"] * UNIT_N * 2 <= 8.7e6
        assert plan["slices_o"] == plan["slices_down"] == 16
