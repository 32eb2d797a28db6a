"""The int4 w4a16 GEMV (``csrc/w4a16_gemv.cu``, row 8) and the row write
fused into the batch decode attention (``csrc/batch_decode_attention.cu``,
rows 5 and 6) on the CPU, where the kernels cannot run, held against their
Python mirrors (``kernels/gemv_quant.py`` ``w4a16_plan``,
``w4a8_gemv_slices``; ``kernels/attention_split.py`` ``writes_row``):

- row 8's 16-column tiles cover N once and its warps' slices K's 16-byte
  chunks once, with at least 128 blocks at the four 1.1B projections;
- its nibble pair (a byte's nibbles as one bf16x2: the nibble ^ 8 ORed
  into the bf16 of 128, 136 taken away) is exact for every byte;
- a numpy emulation of its mma.sync fragments (lane (g, t) loading the same
  16-byte chunk of columns g and g + 8, a byte's k = r and K/2 + r as one A
  register's k pair, x paired alike), its per-warp sums, the warp fold in
  ascending order and the scale stays within one bf16 ulp plus 1e-4 of max
  |y| of ``w4a16_matmul_plain`` at rows 1-8, K 64 and 5632 and ragged N,
  and at small sizes within the same of the JAX package's
  ``gemv_int4_packed`` (interpret mode) on weights carried across by
  ``params_from_jax``;
- the fused write's writer rule names exactly one split per (slot, kv
  head), whose range holds the clamped row, or split 0 when none does,
  over lengths from -2 to MAX + 4, windows and the splits of
  ``attention_splits``;
- ``kv_write_attention`` on CPU pools is the JAX package's row write and
  batch attention (interpret mode) on the same inputs.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from pygpukit_tpu.kernels.batch_decode_attention import \
    batch_decode_attention as jax_bda
from pygpukit_tpu.kernels.gemv_quant import gemv_int4_packed
from pygpukit_tpu.kernels.kv_row_write import kv_rows_write as jax_krw
from pygpukit_tpu.ops.embedding import kv_cache_zeros as jax_kv_zeros
from pygpukit_tpu_torch.kernels import kv_write_attention
from pygpukit_tpu_torch.kernels.attention_split import (attention_splits, split_bounds,
                                                        writes_row)
from pygpukit_tpu_torch.kernels.gemv_quant import (W4A16_BATCH, w4a8_gemv_slices,
                                                   w4a16_matmul, w4a16_matmul_plain,
                                                   w4a16_plan)
from pygpukit_tpu_torch.llm import params_from_jax
from pygpukit_tpu_torch.ops.embedding import kv_cache_zeros

torch.set_num_threads(2)

PROJ_SHAPES = [(2560, 2048), (2048, 2048), (11264, 2048), (2048, 5632)]


def bf16_value(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def f32_to_bf16(f):
    """f32 values rounded once to bf16 (nearest even), as f32."""
    u = np.asarray(f, np.float32).view(np.uint32)
    return bf16_value((u + 0x7FFF + ((u >> 16) & 1)) >> 16)


def nibble_pair(byte):
    """The kernel's nibble pair of packed bytes: (u | 0x4300) - 136 with u =
    nibble ^ 8, each half a bf16 subtraction (one rounding of the exact
    difference). Returns the low (K row r) and high (K/2 + r) halves."""
    b = np.asarray(byte, np.uint32)
    lo = bf16_value(((b & 0xF) ^ 8) | 0x4300).astype(np.float64) - 136.0
    hi = bf16_value((((b >> 4) & 0xF) ^ 8) | 0x4300).astype(np.float64) - 136.0
    return f32_to_bf16(lo.astype(np.float32)), f32_to_bf16(hi.astype(np.float32))


# ---------------------------------------------------------------------------
# row 8: the plan
# ---------------------------------------------------------------------------

@settings(max_examples=300, deadline=None)
@given(rows=st.integers(1, 8), n=st.integers(1, 20000), kh16=st.integers(1, 4000))
def test_w4a16_plan_covers_n_and_k_once(rows, n, kh16):
    k_half = 16 * kh16
    p = w4a16_plan(n, k_half, rows)
    assert p == w4a16_plan(n, k_half)                     # rows do not change it
    assert p["tile_n"] == 16 and p["batch"] == W4A16_BATCH == 2
    assert p["blocks"] * 16 >= n > (p["blocks"] - 1) * 16
    assert p["warps"] in (4, 8, 16)
    covered = np.zeros(kh16, np.int64)
    prev = 0
    for c0, c1 in w4a8_gemv_slices(k_half, p["warps"]):
        assert c0 == prev <= c1                           # ascending, contiguous
        covered[c0:c1] += 1
        prev = c1
    assert prev == kh16 and (covered == 1).all()


@pytest.mark.parametrize("n,k", PROJ_SHAPES)
def test_w4a16_plan_fills_the_card_at_the_projections(n, k):
    p = w4a16_plan(n, k // 2)
    assert p["blocks"] >= 128
    # a warp's chunks take at most two batches of its lanes' rounds
    assert max(c1 - c0 for c0, c1 in w4a8_gemv_slices(k // 2, p["warps"])) <= 8 * p["batch"]


# ---------------------------------------------------------------------------
# row 8: the nibble pair
# ---------------------------------------------------------------------------

def test_nibble_pair_is_exact_for_every_byte():
    byte = np.arange(256)
    lo, hi = nibble_pair(byte)
    assert np.array_equal(lo, ((byte & 0xF) ^ 8) - 8)
    assert np.array_equal(hi, ((byte >> 4) ^ 8) - 8)


# ---------------------------------------------------------------------------
# row 8: the fragments, sums and fold
# ---------------------------------------------------------------------------

def emulate_w4a16_gemv(x, packed, scale):
    """Row 8's kernel in numpy: every block (16-column tile) at once, its
    warps' slices, rounds and k-steps as the kernel takes them. x [rows, K]
    (bf16 values in f32), packed [N, K/2] uint8, scale [N] f32 -> y [rows,
    N] (bf16 values in f32)."""
    rows, k = x.shape
    n, k_half = packed.shape
    p = w4a16_plan(n, k_half, rows)
    tiles, warps = p["blocks"], p["warps"]
    cols = np.minimum(np.arange(tiles)[:, None] * 16 + np.arange(16)[None, :], n - 1)
    wt = packed[cols]                                    # [tiles, 16 columns, K/2]
    lo, hi = nibble_pair(wt)
    xb = np.zeros((8, k), np.float32)
    xb[:rows] = x                                        # B's columns past `rows` zero
    red = np.zeros((warps, tiles, 16, 8), np.float32)    # each warp's D
    for w, (c0, c1) in enumerate(w4a8_gemv_slices(k_half, warps)):
        d = np.zeros((tiles, 16, 8), np.float32)
        for i in range(-(-(c1 - c0) // 4)):
            for j in range(8):                           # k-step j: bytes 2j, 2j + 1
                a = np.zeros((tiles, 16, 16), np.float32)    # [column m, k]
                b = np.zeros((16, 8), np.float32)            # [k, activation row]
                for t in range(4):
                    c = c0 + 4 * i + t
                    if c >= c1:
                        continue                         # zero registers
                    for half, e in ((0, 2 * j), (1, 2 * j + 1)):   # k pairs t, t + 4
                        r = 16 * c + e                   # the packed row
                        kk = 2 * t + 8 * half
                        a[:, :, kk] = lo[:, :, r]
                        a[:, :, kk + 1] = hi[:, :, r]
                        b[kk] = xb[:, r]
                        b[kk + 1] = xb[:, k_half + r]
                # the products exact, their sum added once to the f32 sums
                d = (d.astype(np.float64) + np.einsum(
                    "tmk,kr->tmr", a.astype(np.float64), b.astype(np.float64))
                     ).astype(np.float32)
        red[w] = d
    acc = red[0]
    for w in range(1, warps):                            # ascending warp order
        acc = (acc + red[w]).astype(np.float32)
    y = f32_to_bf16(acc * scale[cols][:, :, None])       # one multiply, one round
    return y.transpose(2, 0, 1).reshape(8, tiles * 16)[:rows, :n]


def _inputs(rows, n, k, seed):
    rng = np.random.default_rng(seed)
    x = f32_to_bf16(rng.standard_normal((rows, k)).astype(np.float32) * 2)
    packed = rng.integers(0, 256, (n, k // 2), dtype=np.uint8)
    scale = (rng.random(n) * 1e-3 + 1e-4).astype(np.float32)
    return x, packed, scale


def _within_ulp(y, ref):
    """One bf16 ulp of the plain version plus 1e-4 of max |y|: both sum the
    same exact f32 products, in another order."""
    ref = np.asarray(ref, np.float32)
    tol = np.abs(ref) * 2.0 ** -7 + 1e-4 * np.abs(ref).max()
    return bool((np.abs(np.asarray(y, np.float32) - ref) <= tol).all())


@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("n,k", [(48, 64), (37, 64), (21, 5632), (16, 2048), (40, 1024)])
def test_w4a16_fragments_match_the_plain_version(rows, n, k):
    x, packed, scale = _inputs(rows, n, k, rows * 101 + n + k)
    y = emulate_w4a16_gemv(x, packed, scale)
    ref = w4a16_matmul_plain(torch.from_numpy(x), torch.from_numpy(packed),
                             torch.from_numpy(scale)).float().numpy()
    assert y.shape == ref.shape
    assert _within_ulp(y, ref), np.abs(y - ref).max()


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("n,k", [(256, 256), (200, 512)])
def test_w4a16_fragments_match_the_pallas_kernel(rows, n, k):
    """The emulation and the port's CPU wrapper against the JAX package's
    gemv_int4_packed in interpret mode, on weights carried across by
    params_from_jax."""
    x, packed, scale = _inputs(rows, n, k, rows + 7 * n)
    ref = np.asarray(gemv_int4_packed(jnp.asarray(packed), jnp.asarray(x, jnp.bfloat16),
                                      jnp.asarray(scale), bn=128, bk_half=128),
                     np.float32)
    w = params_from_jax({"packed": packed, "scale": scale, "x": x})
    got = w4a16_matmul(w["x"], w["packed"], w["scale"]).float().numpy()
    assert _within_ulp(got, ref), np.abs(got - ref).max()
    y = emulate_w4a16_gemv(x, packed, scale)
    assert _within_ulp(y, ref), np.abs(y - ref).max()


# ---------------------------------------------------------------------------
# rows 5 and 6: the fused write's writer rule
# ---------------------------------------------------------------------------

def writer_split(pos, ctx, max_len, window, n_split):
    """The first split that writes_row names (the tests below show there is
    exactly one)."""
    return next(s for s in range(n_split)
                if writes_row(s, pos, ctx, max_len, window, n_split))


@settings(max_examples=400, deadline=None)
@given(max_len=st.sampled_from([1, 16, 64, 100, 512, 1024, 4096]),
       b=st.sampled_from([1, 2, 8, 16]), hk=st.sampled_from([1, 4, 8]),
       pos_off=st.integers(-3, 3), frac=st.floats(0.0, 1.0),
       window=st.sampled_from([None, 0, 1, 7, 64, 100, 300]))
def test_one_writer_split_holds_the_clamped_row(max_len, b, hk, pos_off, frac, window):
    pos = int(frac * max_len) + pos_off                  # -3 .. MAX + 3: ctx -2 .. MAX + 4
    ctx = pos + 1
    n_split = attention_splits(b, hk, max_len)
    writers = [s for s in range(n_split)
               if writes_row(s, pos, ctx, max_len, window, n_split)]
    assert writers == [writer_split(pos, ctx, max_len, window, n_split)]
    p = min(max(pos, 0), max_len - 1)
    live = min(ctx, max_len)
    lo = ctx - window if window else -(1 << 30)
    bounds = split_bounds(lo, live, n_split)
    holders = [s for s, (start, end) in enumerate(bounds) if start <= p < end]
    if holders:
        assert writers == holders
    else:
        assert writers == [0]
        assert not max(lo, 0) <= p < live                # no split reads the row


def test_writer_rule_at_the_edges():
    mx = 1024
    n_split = attention_splits(8, 4, mx)
    assert writer_split(-1, 0, mx, None, n_split) == 0               # no live split
    assert writer_split(-3, -2, mx, None, n_split) == 0
    last = split_bounds(-(1 << 30), mx, n_split)
    tail = max(s for s, (a, e) in enumerate(last) if e > a)
    assert writer_split(mx - 1, mx, mx, None, n_split) == tail       # the last live row
    assert writer_split(mx + 3, mx + 4, mx, None, n_split) == tail   # clamped to MAX - 1
    assert writer_split(mx + 3, mx + 4, mx, 2, n_split) == 0         # outside the window
    assert writer_split(37, 38, mx, None, n_split) == 0
    assert writer_split(37, 38, mx, 16, n_split) == 0


# ---------------------------------------------------------------------------
# rows 5 and 6 together on the CPU: the JAX package's write and attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
def test_kv_write_attention_matches_the_pallas_kernels(kind, window):
    rng = np.random.default_rng(3)
    b, nl, mx, hq, hk, d = 4, 2, 64, 8, 2, 16
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32),
                "int8": (jnp.int8, torch.int8)}[kind]
    qdt = jnp.float32
    shape = (b, nl, mx, hk * d)
    jk, jv = (jax_kv_zeros(shape, jdt, merged=True) for _ in range(2))
    tk, tv = (kv_cache_zeros(shape, tdt, device="cpu", merged=True) for _ in range(2))
    kn = rng.standard_normal((b, hk, d)).astype(np.float32)
    vn = rng.standard_normal((b, hk, d)).astype(np.float32)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    # inside the pool: past it the Pallas kernel lands a row at pos % 8 of
    # its last window, where the port clamps as the reference's XLA write
    # (tests/test_torch_kernels.py)
    poss = np.array([0, 37, mx - 1, 5], np.int32)
    jk, jv = jax_krw(jk, jv, jnp.asarray(kn, qdt), jnp.asarray(vn, qdt), 1,
                     jnp.asarray(poss))
    ref = jax_bda(jnp.asarray(q), jk, jv, jnp.int32(1), jnp.asarray(poss + 1), chunk=16,
                  window=None if window is None else jnp.int32(window))
    got = kv_write_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(kn),
                             torch.from_numpy(vn), 1, torch.from_numpy(poss),
                             torch.from_numpy(poss + 1), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    for jp, tp in ((jk, tk), (jv, tv)):
        jl = [jp["q"], jp["s"]] if isinstance(jp, dict) else [jp]
        tl = [tp["q"], tp["s"]] if isinstance(tp, dict) else [tp]
        for a, t in zip(jl, tl):
            assert np.array_equal(np.asarray(a).view(np.uint8),
                                  t.contiguous().view(torch.uint8).numpy()), kind
