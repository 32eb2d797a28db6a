"""The launch plans of the w4a8 GEMM (``csrc/w4a8_gemm.cu``) and of the
int4_block w4a8 GEMV (``csrc/block_w4a8_gemv.cu``) on the CPU, where the
kernels cannot run, held with hypothesis against their Python mirrors
(``kernels/gemv_quant.py`` ``w4a8_gemm_plan``, ``w4a8_gemm_unit``,
``block_w4a8_plan``, ``block_segments``):

- the GEMM's units own every output element exactly once and every K stage
  exactly once per tile, and a numpy emulation of its split-K int32 sums
  (the nibbles unpacked as 16 x their value, as the kernel does) equals the
  integer ``acc`` of ``w4a8_matmul_plain``, and its output bitwise;
- the GEMV's column tiles cover N once and fill a wave where a tile width
  can, its segments the packed rows once, each inside one block of each
  half; an emulation of its exact segment sums (quads of packed rows shared
  among a slot's threads) and its ascending fold, chunk by chunk, is bitwise
  ``block_w4a8_matmul_plain``
  at rows 1-8, at K 2048, 5632, 96 and 2080 (B 32 straddles K/2 at the last
  two) and narrow N;
- the fused activation quantization's emulation (a block's amax over 16-byte
  words, an IEEE divide, rint, a clamp) equals ``quantize_acts`` bit for bit.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pygpukit_tpu_torch.kernels.gemv_quant import (BLOCK_CHUNK, BLOCK_GROUPS, BLOCK_WAVE,
                                                   W4A8_MAX_SPLITS,
                                                   W4A8_STAGE_K, W4A8_TILE_M, W4A8_TILE_N,
                                                   block_segments, block_w4a8_matmul_plain,
                                                   block_w4a8_plan, quantize_acts,
                                                   w4a8_gemm_plan, w4a8_gemm_unit,
                                                   w4a8_matmul_plain)
from pygpukit_tpu_torch.llm.quant import unpack_int4

_SMS = st.sampled_from([132, 114, 1, 7])


@settings(max_examples=300, deadline=None)
@given(m=st.integers(9, 9000), n=st.integers(1, 20000), kh=st.integers(1, 400), sms=_SMS)
def test_w4a8_gemm_plan_owns_every_element_and_stage_once(m, n, kh, sms):
    k_half = 16 * kh
    plan = w4a8_gemm_plan(m, n, k_half, sms)
    tiles = plan["tiles_m"] * plan["tiles_n"]
    assert plan["n_k"] == -(-k_half // W4A8_STAGE_K)
    assert 1 <= plan["splits"] <= min(W4A8_MAX_SPLITS, plan["n_k"])
    assert plan["splits"] == 1 or tiles * plan["splits"] <= 2 * sms
    assert plan["units"] == tiles * plan["splits"] and plan["grid"] == min(plan["units"], sms)
    stages: dict = {}
    for b in range(plan["grid"]):                 # the persistent blocks' walk
        for u in range(b, plan["units"], plan["grid"]):
            tm, tn, k0, k1 = w4a8_gemm_unit(u, plan)
            assert k1 > k0
            stages.setdefault((tm, tn), []).append((k0, k1))
    assert sorted(stages) == [(i, j) for i in range(plan["tiles_m"])
                              for j in range(plan["tiles_n"])]
    for ranges in stages.values():
        got = np.zeros(plan["n_k"], np.int64)
        for k0, k1 in ranges:
            got[k0:k1] += 1
        assert (got == 1).all()
    rows = np.zeros(m, np.int64)
    cols = np.zeros(n, np.int64)
    for tm, tn in stages:
        rows[tm * W4A8_TILE_M:(tm + 1) * W4A8_TILE_M] += 1 if tn == 0 else 0
        cols[tn * W4A8_TILE_N:(tn + 1) * W4A8_TILE_N] += 1 if tm == 0 else 0
    assert (rows == 1).all() and (cols == 1).all()


def test_w4a8_gemm_plan_at_the_prefill_projections():
    """M 256 on the H100's 132 SMs: qkv, o and down split K (the tiles
    alone fill under a third of the card), gate_up's 176 tiles do not."""
    got = {name: w4a8_gemm_plan(256, n, k // 2)["splits"]
           for name, (n, k) in (("qkv", (2560, 2048)), ("o", (2048, 2048)),
                                ("gate_up", (11264, 2048)), ("down", (2048, 5632)))}
    assert got == {"qkv": 3, "o": 4, "gate_up": 1, "down": 4}
    assert w4a8_gemm_plan(8192, 14336, 2048)["splits"] == 1


def _emulate_w4a8_gemm(x: torch.Tensor, packed: np.ndarray, scale: np.ndarray, sms: int):
    """The kernel's arithmetic in numpy: each unit's int32 sums over its K
    stages with the nibbles as 16 x their value (the low box at columns j,
    the high box at K/2 + j, zero weight bytes past K/2), the splits of a
    tile added, >> 4, then the two f32 multiplies and one bf16 rounding."""
    n, k_half = packed.shape
    m = x.shape[0]
    xq, sx = quantize_acts(x)
    xq = xq.numpy().astype(np.int64)
    plan = w4a8_gemm_plan(m, n, k_half, sms)
    ktot = plan["n_k"] * W4A8_STAGE_K
    wpad = np.zeros((n, ktot), np.uint8)
    wpad[:, :k_half] = packed
    lo = ((wpad.astype(np.int64) << 4) & 0xF0).astype(np.uint8).view(np.int8).astype(np.int64)
    hi = (wpad & 0xF0).view(np.int8).astype(np.int64)
    xpad = np.zeros((m, k_half + ktot), np.int64)
    xpad[:, :2 * k_half] = xq
    acc = np.zeros((m, n), np.int64)
    for u in range(plan["units"]):
        tm, tn, k0, k1 = w4a8_gemm_unit(u, plan)
        rs = slice(tm * W4A8_TILE_M, (tm + 1) * W4A8_TILE_M)
        cs = slice(tn * W4A8_TILE_N, (tn + 1) * W4A8_TILE_N)
        j = slice(k0 * W4A8_STAGE_K, k1 * W4A8_STAGE_K)
        jh = slice(k_half + k0 * W4A8_STAGE_K, k_half + k1 * W4A8_STAGE_K)
        part = xpad[rs, j] @ lo[cs, j].T + xpad[rs, jh] @ hi[cs, j].T
        assert np.abs(part).max(initial=0) < 2 ** 31
        acc[rs, cs] += part.astype(np.int32)
    assert (acc % 16 == 0).all()
    acc >>= 4
    y = (torch.from_numpy(acc.astype(np.float32)) * torch.from_numpy(scale)[None]) * sx
    return acc, y.to(torch.bfloat16)


@pytest.mark.parametrize("m,n,k", [(300, 72, 96), (256, 40, 2048), (9, 1, 32), (130, 300, 544),
                                   (256, 264, 1056)])
@pytest.mark.parametrize("sms", [132, 5])
def test_w4a8_gemm_split_sums_equal_the_plain_integer_dot(m, n, k, sms):
    rng = np.random.default_rng(m * n + k)
    x = torch.from_numpy((rng.standard_normal((m, k)) * 2).astype(np.float32)).to(torch.bfloat16)
    packed = rng.integers(0, 256, (n, k // 2), dtype=np.uint8)
    scale = (rng.random(n) * 1e-3 + 1e-4).astype(np.float32)
    acc, y = _emulate_w4a8_gemm(x.float(), packed, scale, sms)
    xq, _ = quantize_acts(x.float())
    ref_acc = xq.numpy().astype(np.int64) @ unpack_int4(torch.from_numpy(packed)).numpy().astype(
        np.int64).T
    assert np.array_equal(acc, ref_acc)
    ref = w4a8_matmul_plain(x, torch.from_numpy(packed), torch.from_numpy(scale))
    assert torch.equal(y.view(torch.int16), ref.view(torch.int16))


@settings(max_examples=300, deadline=None)
@given(n4=st.integers(1, 6000), kb=st.integers(1, 300), b8=st.sampled_from([1, 2, 4, 8, 16]))
def test_block_plan_covers_the_segments_once(n4, kb, b8):
    n, b = 4 * n4, 8 * b8
    k = kb * b                                       # K % B == 0
    k_half = k // 2
    segs = block_segments(k_half, b)
    assert segs[0][0] == 0 and segs[-1][1] == k_half
    assert all(a < e and e == a2 for (a, e), (a2, _) in zip(segs, segs[1:]))
    for a, e in segs:                                # one block of each half
        assert a // b == (e - 1) // b
        assert (k_half + a) // b == (k_half + e - 1) // b
        assert (e - a) % 4 == 0
    plan = block_w4a8_plan(n, k_half, b)
    tn = plan["tile_n"]
    assert tn in [4 * gr for gr in BLOCK_GROUPS] and plan["tiles"] == -(-n // tn)
    wider = [4 * gr for gr in BLOCK_GROUPS if 4 * gr > tn]
    assert all(-(-n // w) < BLOCK_WAVE for w in wider)       # the widest that fills a wave
    assert plan["tiles"] >= BLOCK_WAVE or tn == 4 * BLOCK_GROUPS[-1]
    cols = np.zeros(n, np.int64)
    for t in range(plan["tiles"]):
        cols[t * tn:(t + 1) * tn] += 1
    assert (cols == 1).all()
    assert plan["segments"] == len(segs) and plan["chunks"] == -(-len(segs) // BLOCK_CHUNK)
    for rows in (1, 2, 8):                           # a row's words fit the tile and N
        p = block_w4a8_plan(n, k_half, b, rows)
        assert p["words"] in (1, 2, 4) and n % (4 * p["words"]) == 0
        assert p["words"] == 1 or (rows == 1 and 4 * p["words"] <= tn)
        assert p["parts"] * (tn // (4 * p["words"])) == 8


def _emulate_fused_quant(x: np.ndarray, words: int):
    """The kernel's quantization: a row's amax over ``words``-value loads
    (16 bytes) in any order (max is exact), an IEEE f32 divide by 127, the
    1e-12 floor, then rint(x / sx) clamped to [-127, 127]."""
    rows, k = x.shape
    chunks = np.abs(x).reshape(rows, k // words, words)
    amax = chunks.max(axis=(1, 2)).astype(np.float32)
    sx = np.maximum(amax / np.float32(127.0), np.float32(1e-12)).astype(np.float32)
    q = np.clip(np.rint(x / sx[:, None]), -127, 127).astype(np.int8)
    return q, sx


def _emulate_block_gemv(x: torch.Tensor, packed: np.ndarray, sblock: np.ndarray, b: int):
    """The kernel in numpy: the fused quantization; chunk by chunk, each
    segment's exact sums Z [2][rows][N] as its slot's threads take them
    (thread p of the plan's ``parts`` the groups of 4 packed rows p, p + P,
    ...), then
    the fold of each half in ascending segment order, a block's integers
    summed and folded with one f32 multiply and one f32 add when the block
    ends, carried across chunks; then bf16((Y_lo + Y_hi) * sx)."""
    k_half, n = packed.shape
    xf = x.float().numpy()
    words = 8 if x.dtype == torch.bfloat16 else 4
    xq, sx = _emulate_fused_quant(xf, words)
    q = unpack_int4(torch.from_numpy(packed), axis=-2).numpy().astype(np.int64)   # [K, N]
    segs = block_segments(k_half, b)
    rows = x.shape[0]
    plan = block_w4a8_plan(n, k_half, b, rows)
    parts = plan["parts"]
    z = np.zeros((2, len(segs), rows, n), np.int64)
    for base in range(0, len(segs), BLOCK_CHUNK):
        for i in range(base, min(base + BLOCK_CHUNK, len(segs))):
            a, e = segs[i]
            for p in range(parts):
                for qd in range(p, (e - a) // 4, parts):
                    r0 = a + 4 * qd
                    for h in range(2):
                        z[h, i] += xq[:, h * k_half + r0:h * k_half + r0 + 4].astype(
                            np.int64) @ q[h * k_half + r0:h * k_half + r0 + 4]
    assert np.abs(z).max(initial=0) < 2 ** 31
    s = sblock.astype(np.float32)
    y = []
    for h in range(2):
        acc = np.zeros((rows, n), np.float32)
        zz = np.zeros((rows, n), np.int64)
        for i, (a, e) in enumerate(segs):
            zz += z[h, i]
            ends = (e % b == 0 or e == k_half) if h == 0 else (k_half + e) % b == 0
            if ends:
                acc = (acc + (zz.astype(np.float32) * s[(h * k_half + a) // b])).astype(
                    np.float32)
                zz[:] = 0
        y.append(acc)
    out = ((y[0] + y[1]).astype(np.float32) * sx[:, None]).astype(np.float32)
    return torch.from_numpy(out).to(torch.bfloat16)


@pytest.mark.parametrize("rows", [1, 2, 5, 8])
@pytest.mark.parametrize("n,k", [(2048, 2048), (128, 5632), (36, 96), (40, 2080), (4, 2048),
                                 (11264, 96), (4400, 2080), (2060, 2048)])
def test_block_gemv_split_fold_is_bitwise_the_plain_version(rows, n, k):
    import ml_dtypes
    rng = np.random.default_rng(rows * 7 + k + n)
    x = torch.from_numpy((rng.standard_normal((rows, k)) * 2).astype(np.float32)).to(
        torch.bfloat16)
    packed = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    sblock = (rng.random((k // 32, n)) * 1e-3 + 1e-4).astype(ml_dtypes.bfloat16)
    got = _emulate_block_gemv(x, packed, sblock, 32)
    ref = block_w4a8_matmul_plain(x, torch.from_numpy(packed),
                                  torch.from_numpy(sblock.astype(np.float32)).to(torch.bfloat16))
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,k", [(1, 2048), (8, 5632), (3, 96), (8, 2080)])
def test_fused_quant_emulation_is_quantize_acts(rows, k, dtype):
    rng = np.random.default_rng(rows + k)
    x = torch.from_numpy((rng.standard_normal((rows, k)) * 3).astype(np.float32)).to(dtype)
    x[0, 5] = 0.0
    xq, sx = quantize_acts(x)
    q, s = _emulate_fused_quant(x.float().numpy(), 8 if dtype == torch.bfloat16 else 4)
    assert np.array_equal(q, xq.numpy())
    assert np.array_equal(s.view(np.int32), sx.reshape(-1).numpy().view(np.int32))
    zero = torch.zeros((1, k), dtype=dtype)                 # all zero: the 1e-12 floor
    q0, s0 = _emulate_fused_quant(zero.float().numpy(), 4)
    xq0, sx0 = quantize_acts(zero)
    assert np.array_equal(q0, xq0.numpy()) and s0[0] == sx0.item()
