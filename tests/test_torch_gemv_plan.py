"""The launch plans of the w4a8 GEMV (``csrc/w4a8_gemv.cu``) and of the
converting GEMV (``csrc/conv_gemv.cu``) on the CPU, where the kernels cannot
run, held against their Python mirrors (``kernels/gemv_quant.py``
``w4a8_gemv_plan``, ``w4a8_gemv_slices``, ``conv_gemv_plan``,
``conv_split_quads``):

- the w4a8 GEMV's blocks own every output column once and its warps every
  16-byte chunk of K once; a numpy emulation of its mma.sync fragments (K
  permuted so a lane's 16-byte chunk of a column is A's registers as it
  stands, xq's two 16-byte pieces B's; unsigned nibbles, corrected by
  8 x the xq byte sums) equals the plain integer dot exactly, and its output
  is bitwise ``w4a8_matmul_plain``, at rows 1-8, K 96, 2048 and 5632 and
  ragged N;
- its quantization kernel (a row's amax over 16-byte loads, an IEEE
  divide, rint, a clamp) equals ``quantize_acts`` bit for bit;
- the converting GEMV's tiles cover N once, its splits (a cluster of 1, 2,
  4 or 8 blocks) K's quads once, its K lanes each quad of a split once,
  with at least 132 blocks at the 1.1B projections; an emulation of its
  per-thread f32 sums, shuffle tree, warp fold and ascending split fold
  stays within one bf16 ulp plus 1e-4 of max |y| of ``conv_matmul_plain``
  for all four storage types.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pygpukit_tpu_torch.kernels.gemv_quant import (CONV_MAX_SPLITS, CONV_TARGET_BLOCKS,
                                                   CONV_THREADS, CONV_TILE_N, W4A8_GEMV_TILE,
                                                   conv_gemv_plan, conv_matmul_plain,
                                                   conv_row_bound, conv_split_quads,
                                                   quantize_acts, w4a8_gemv_plan,
                                                   w4a8_gemv_slices, w4a8_matmul_plain)
from pygpukit_tpu_torch.llm.quant import unpack_int4

PROJ_SHAPES = [(2560, 2048), (2048, 2048), (11264, 2048), (2048, 5632)]


# ---------------------------------------------------------------------------
# row 1: the w4a8 GEMV
# ---------------------------------------------------------------------------

@settings(max_examples=300, deadline=None)
@given(rows=st.integers(1, 8), n=st.integers(1, 20000), kh=st.integers(1, 600))
def test_w4a8_gemv_plan_owns_every_column_and_chunk_once(rows, n, kh):
    k_half = 16 * kh
    plan = w4a8_gemv_plan(rows, n, k_half)
    assert plan["tile_n"] == W4A8_GEMV_TILE
    cols = np.zeros(plan["blocks"] * W4A8_GEMV_TILE, np.int64)
    for b in range(plan["blocks"]):
        cols[b * W4A8_GEMV_TILE:(b + 1) * W4A8_GEMV_TILE] += 1
    assert (cols[:n] == 1).all() and (plan["blocks"] - 1) * W4A8_GEMV_TILE < n
    slices = w4a8_gemv_slices(k_half, plan["warps"])
    assert len(slices) == plan["warps"] in (4, 8, 16)
    got = np.zeros(kh, np.int64)
    for c0, c1 in slices:
        rounds = -(-(c1 - c0) // 4)
        if k_half <= 4096:                        # K up to 8192: one batch of 4 rounds a warp
            assert rounds <= 4
        for i in range(rounds):                   # lane t of a group: chunk c0 + 4 i + t
            for t in range(4):
                if c0 + 4 * i + t < c1:
                    got[c0 + 4 * i + t] += 1
    assert (got == 1).all()


def test_w4a8_gemv_plan_at_the_projections():
    """8 warps a block at K 2048, 16 at K 5632, 4 at K 1024, at every row
    count."""
    for rows in (1, 8):
        plans = [w4a8_gemv_plan(rows, n, k // 2) for n, k in PROJ_SHAPES]
        assert [p["blocks"] for p in plans] == [160, 128, 704, 128]
        assert [p["warps"] for p in plans] == [8, 8, 8, 16]
    assert w4a8_gemv_plan(1, 2048, 512)["warps"] == 4


def _quant_kernel(x: np.ndarray, words: int):
    """The GEMV's quantization kernel: a row's amax over ``words``-value
    16-byte loads in any order (max is exact), an IEEE f32 divide by 127,
    the 1e-12 floor, then rint(x / sx) clamped to [-127, 127]."""
    rows, k = x.shape
    amax = np.abs(x).reshape(rows, k // words, words).max(axis=(1, 2)).astype(np.float32)
    sx = np.maximum(amax / np.float32(127.0), np.float32(1e-12)).astype(np.float32)
    q = np.clip(np.rint(x / sx[:, None]), -127, 127).astype(np.int8)
    return q, sx


def _emulate_w4a8_gemv(xq: np.ndarray, packed: np.ndarray) -> np.ndarray:
    """The kernel's integer sums in numpy, fragment by fragment: block b's
    16 columns (lanes past N read column N - 1), each warp's chunk slice
    round by round, the four mma.sync m16n8k32 products of a round with A
    [16 columns, 32 K slots] of unsigned nibbles (nibble ^ 8) and B [32 K
    slots, 8 rows] of xq (zero past the rows), K slot 4 t + e of product j
    being byte 4 (2 (j % 2)) + e of lane t's chunk (slot 16 + 4 t + e: of
    word 2 (j % 2) + 1), low nibbles for j < 2, high after; then the warps'
    D summed, less 8 x the xq bytes the lanes summed."""
    n, k_half = packed.shape
    rows = xq.shape[0]
    plan = w4a8_gemv_plan(rows, n, k_half)
    u = np.stack([(packed & 0xF) ^ 8, (packed >> 4) ^ 8]).astype(np.int64)   # [2, N, K/2]
    xb = np.zeros((8, 2 * k_half), np.int64)
    xb[:rows] = xq
    tile = W4A8_GEMV_TILE
    cols = np.minimum(np.arange(plan["blocks"] * tile), n - 1)
    acc = np.zeros((plan["blocks"] * tile, 8), np.int64)
    for c0, c1 in w4a8_gemv_slices(k_half, plan["warps"]):
        d = np.zeros_like(acc)
        s = np.zeros(8, np.int64)
        for i in range(-(-(c1 - c0) // 4)):
            for j in range(4):
                half, word = j // 2, 2 * (j % 2)
                byte = np.zeros(32, np.int64)      # packed byte of each K slot
                live = np.zeros(32, bool)
                for t in range(4):
                    c = c0 + 4 * i + t
                    for e in range(4):
                        for slot, wd in ((4 * t + e, word), (16 + 4 * t + e, word + 1)):
                            byte[slot] = 16 * c + 4 * wd + e
                            live[slot] = c < c1
                byte = np.where(live, byte, 0)
                a = np.where(live[None], u[half][cols[:, None], byte[None]], 0)  # [cols, 32]
                b = np.where(live[:, None], xb[:, half * k_half + byte].T, 0)  # [32, 8]
                d += a @ b
                s += b.sum(axis=0)
        assert np.abs(d).max(initial=0) < 2 ** 31
        acc += d - 8 * s[None]
    return acc[:n, :rows].T


@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("n,k", [(40, 96), (1001, 2048), (37, 5632), (2048, 2048)])
def test_w4a8_gemv_fragments_are_bitwise_the_plain_version(rows, n, k):
    rng = np.random.default_rng(rows * 13 + n + k)
    x = torch.from_numpy((rng.standard_normal((rows, k)) * 2).astype(np.float32)).to(
        torch.bfloat16)
    packed = rng.integers(0, 256, (n, k // 2), dtype=np.uint8)
    scale = (rng.random(n) * 1e-3 + 1e-4).astype(np.float32)
    xq, sx = quantize_acts(x.float())
    acc = _emulate_w4a8_gemv(xq.numpy(), packed)
    ref_acc = xq.numpy().astype(np.int64) @ unpack_int4(torch.from_numpy(packed)).numpy().astype(
        np.int64).T
    assert np.array_equal(acc, ref_acc)
    y = ((torch.from_numpy(acc.astype(np.float32)) * torch.from_numpy(scale)[None]) * sx).to(
        torch.bfloat16)
    ref = w4a8_matmul_plain(x, torch.from_numpy(packed), torch.from_numpy(scale))
    assert torch.equal(y.view(torch.int16), ref.view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,k", [(1, 2048), (2, 5632), (8, 96), (5, 2048)])
def test_w4a8_quant_kernel_is_quantize_acts(rows, k, dtype):
    rng = np.random.default_rng(rows * 3 + k)
    x = torch.from_numpy((rng.standard_normal((rows, k)) * 3).astype(np.float32)).to(dtype)
    x[0, 7] = 0.0
    xq, sx = quantize_acts(x)
    q, s = _quant_kernel(x.float().numpy(), 8 if dtype == torch.bfloat16 else 4)
    assert np.array_equal(q, xq.numpy())
    assert np.array_equal(s.view(np.int32), sx.reshape(-1).numpy().view(np.int32))
    q0, s0 = _quant_kernel(np.zeros((1, k), np.float32), 4)     # all zero: the 1e-12 floor
    xq0, sx0 = quantize_acts(torch.zeros((1, k), dtype=dtype))
    assert np.array_equal(q0, xq0.numpy()) and s0[0] == sx0.item()


# ---------------------------------------------------------------------------
# row 10: the converting GEMV
# ---------------------------------------------------------------------------

@settings(max_examples=300, deadline=None)
@given(rows=st.integers(1, 8), n4=st.integers(1, 8000), k4=st.integers(1, 4000))
def test_conv_gemv_plan_covers_n_and_k_once(rows, n4, k4):
    n, k = 4 * n4, 4 * k4
    p = conv_gemv_plan(rows, n, k)
    assert p["tile_n"] == CONV_TILE_N and p["tiles"] == -(-n // CONV_TILE_N)
    assert p["klanes"] * (CONV_TILE_N // p["cols"]) == CONV_THREADS
    assert p["cols"] * conv_row_bound(rows) <= 32 and p["cols"] in (4, 8, 16)
    assert p["splits"] in (1, 2, 4, 8) and p["splits"] <= CONV_MAX_SPLITS
    assert p["blocks"] == p["tiles"] * p["splits"]
    if p["splits"] > 1:                            # a split keeps a quad for every K lane
        assert (k // 4) // p["splits"] >= p["klanes"]
        assert p["splits"] // 2 * p["tiles"] < CONV_TARGET_BLOCKS
    splits = conv_split_quads(k, p["splits"])
    got = np.zeros(k // 4, np.int64)
    for q0, q1 in splits:
        for kl in range(p["klanes"]):              # K lane kl: q0 + kl, q0 + kl + KL, ...
            got[q0 + kl:q1:p["klanes"]] += 1
    assert (got == 1).all()
    assert [a for a, _ in splits[1:]] == [b for _, b in splits[:-1]]


@pytest.mark.parametrize("rows", [1, 8])
def test_conv_gemv_plan_fills_the_card_at_the_projections(rows):
    for n, k in PROJ_SHAPES:
        assert conv_gemv_plan(rows, n, k)["blocks"] >= 132, (n, k)


_STORAGE = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2, "int8": torch.int8,
            "bf16": torch.bfloat16}


def _conv_weights(storage: str, k: int, n: int, rng) -> torch.Tensor:
    if storage == "int8":
        return torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    w = torch.from_numpy((rng.standard_normal((k, n)) * 64).astype(np.float32))
    return w.to(_STORAGE[storage])


def _emulate_conv_gemv(x: torch.Tensor, w: torch.Tensor, scale: np.ndarray) -> np.ndarray:
    """The kernel's f32 sums in numpy: every K lane of every split adds its
    quads' exact products in ascending K (an FMA of an exact product is a
    rounded add), a warp's lanes of a column meet by the xor tree (lane
    pairs CL, then 2 CL apart), the block's warps fold in ascending order,
    then the splits in ascending order; bf16(sum * scale)."""
    rows, k = x.shape
    n = w.shape[1]
    p = conv_gemv_plan(rows, n, k)
    kl_n, cl_n = p["klanes"], CONV_TILE_N // p["cols"]
    xf = x.to(torch.bfloat16).float().numpy()
    wf = w.float().numpy()
    parts = []
    for q0, q1 in conv_split_quads(k, p["splits"]):
        acc = np.zeros((kl_n, rows, n), np.float32)
        for i in range(-(-(q1 - q0) // kl_n)):
            for kl in range(kl_n):
                q = q0 + kl + i * kl_n
                if q >= q1:
                    continue
                for j in range(4):
                    kk = 4 * q + j
                    acc[kl] = (acc[kl] + (xf[:, kk:kk + 1] * wf[kk][None])).astype(np.float32)
        per_warp = 32 // cl_n                      # K lanes a warp holds
        warps = acc.reshape(kl_n // per_warp, per_warp, rows, n)
        while warps.shape[1] > 1:                  # xor tree: lane l + lane l ^ (CL 2^s)
            warps = (warps[:, 0::2] + warps[:, 1::2]).astype(np.float32)
        s = warps[0, 0]
        for v in range(1, warps.shape[0]):
            s = (s + warps[v, 0]).astype(np.float32)
        parts.append(s)
    y = parts[0]
    for part in parts[1:]:
        y = (y + part).astype(np.float32)
    return (y * scale[None]).astype(np.float32)


@pytest.mark.parametrize("storage", list(_STORAGE))
@pytest.mark.parametrize("rows,n,k", [(1, 256, 2048), (2, 132, 5632), (3, 2060, 96),
                                      (8, 100, 2052), (5, 516, 1000)])
def test_conv_gemv_split_fold_is_within_the_kernel_tolerance(storage, rows, n, k):
    rng = np.random.default_rng(rows * 5 + n + k)
    x = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32)).to(torch.bfloat16)
    w = _conv_weights(storage, k, n, rng)
    scale = (rng.random(n) * 1e-2 + 1e-3).astype(np.float32)
    got = torch.from_numpy(_emulate_conv_gemv(x, w, scale)).to(torch.bfloat16).float()
    ref = conv_matmul_plain(x, w, torch.from_numpy(scale)).float()
    tol = ref.abs() * 2.0 ** -7 + 1e-4 * ref.abs().max()
    assert bool(((got - ref).abs() <= tol).all())


def test_conv_gemv_emulation_splits_k_where_the_tiles_are_few():
    """The cases above reach the cluster fold: K 2048 at 4 tiles splits 8
    ways, K 96 at rows 3 not at all (a quad a K lane), K 5632 at rows 2 and
    3 tiles 8 ways."""
    assert conv_gemv_plan(1, 256, 2048)["splits"] == 8
    assert conv_gemv_plan(3, 2060, 96)["splits"] == 1
    assert conv_gemv_plan(8, 100, 2052)["splits"] == 8
    assert conv_gemv_plan(2, 132, 5632)["splits"] == 8
