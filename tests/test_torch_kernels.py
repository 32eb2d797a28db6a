"""Plain versions of the port's kernels against the JAX package's Pallas
kernels, run in interpret mode as the JAX package's own tests run them:

- w4a8 (GEMV stacked, GEMV 2-D, GEMM): bitwise on the bf16 outputs, at the
  tile sizes of tests/test_kernels_interpret.py;
- kv_rows_write: bitwise, pools of every storage dtype;
- batch_decode_attention: rtol 1e-5 in f32 with GQA, softcap, window and
  ragged context lengths (the plain version is a full masked softmax, the
  Pallas kernel an online one over chunks: the two round differently).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygpukit_tpu.kernels.batch_decode_attention import \
    batch_decode_attention as jax_bda
from pygpukit_tpu.kernels.gemv_quant import (gemm_int4_w4a8, gemv_int4_w4a8,
                                             gemv_int4_w4a8_stacked)
from pygpukit_tpu.kernels.kv_row_write import kv_rows_write as jax_krw
from pygpukit_tpu.ops.embedding import kv_cache_zeros as jax_kv_zeros
from pygpukit_tpu.ops.embedding import kv_write as jax_kv_write
from pygpukit_tpu_torch.kernels import (batch_decode_attention, kv_rows_write,
                                        w4a8_matmul)
from pygpukit_tpu_torch.llm import params_from_jax
from pygpukit_tpu_torch.ops.embedding import kv_cache_zeros

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _packed_int4(rng, lead, n, k):
    w = rng.standard_normal(lead + (n, k)).astype(np.float32)
    scale = (np.abs(w).max(axis=-1) / 7.0).astype(np.float32)      # [..., N]
    q = np.clip(np.round(w / scale[..., None]), -7, 7).astype(np.int8)
    packed = ((q[..., :k // 2] & 0xF) | ((q[..., k // 2:] & 0xF) << 4)).astype(np.uint8)
    return packed, scale


def _bf16_bits(a):
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("xdt", ["f32", "bf16"])
def test_w4a8_gemv_stacked_bitwise(rng, rows, xdt):
    packed, scale = _packed_int4(rng, (2,), 256, 256)
    x = rng.standard_normal((rows, 256)).astype(np.float32)
    xj = jnp.asarray(x) if xdt == "f32" else jnp.asarray(x, jnp.bfloat16)
    xt = params_from_jax(np.asarray(xj))
    for layer in range(2):
        ref = gemv_int4_w4a8_stacked(jnp.asarray(packed), jnp.int32(layer), xj,
                                     jnp.asarray(scale[:, None, :]),
                                     bn=128, bk_half=128)
        got = w4a8_matmul(xt, torch.from_numpy(packed)[layer],
                          torch.from_numpy(scale)[layer])
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      _bf16_bits(ref))


def test_w4a8_gemv_2d_bitwise(rng):
    packed, scale = _packed_int4(rng, (), 256, 256)
    x = rng.standard_normal((2, 256)).astype(np.float32)
    ref = gemv_int4_w4a8(jnp.asarray(packed), jnp.asarray(x), jnp.asarray(scale),
                         bn=128, bk_half=128)
    got = w4a8_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                      torch.from_numpy(scale))
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  _bf16_bits(ref))


def test_w4a8_gemm_bitwise(rng):
    packed, scale = _packed_int4(rng, (), 384, 256)
    x = rng.standard_normal((24, 256)).astype(np.float32)
    ref = gemm_int4_w4a8(jnp.asarray(packed), jnp.asarray(x), jnp.asarray(scale),
                         bm=8, bn=128, bk_half=128)
    got = w4a8_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                      torch.from_numpy(scale))
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  _bf16_bits(ref))


B, L, MAX, HK, D = 8, 3, 64, 2, 8


def _pools_both(kind):
    """Matching zero pools for the JAX kernel and the port (merged)."""
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32),
                "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
                "int8": (jnp.int8, torch.int8)}[kind]
    shape = (B, L, MAX, HK * D)
    jp = [jax_kv_zeros(shape, jdt, merged=True) for _ in range(2)]
    tp = [kv_cache_zeros(shape, tdt, device="cpu", merged=True) for _ in range(2)]
    return jp, tp


def _assert_pools_equal(jpool, tpool):
    jl = jax.tree.leaves(jpool)
    tl = [tpool["q"], tpool["s"]] if isinstance(tpool, dict) else [tpool]
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        bb = b.view(torch.int16) if b.element_size() == 2 else b.view(torch.int8) \
            if b.element_size() == 1 else b
        np.testing.assert_array_equal(bb.numpy().view(np.uint8), a.view(np.uint8))


@pytest.mark.parametrize("kind", ["bf16", "f32", "fp8", "int8"])
def test_kv_rows_write_bitwise(rng, kind):
    rows_k = rng.standard_normal((B, HK, D)).astype(np.float32) * 3
    rows_v = rng.standard_normal((B, HK, D)).astype(np.float32)
    poss = np.array([0, 5, 17, 31, 32, MAX - 1, 8, 9], np.int32)
    (jk, jv), (tk, tv) = _pools_both(kind)
    jk2, jv2 = jax_krw(jk, jv, jnp.asarray(rows_k, jnp.bfloat16),
                       jnp.asarray(rows_v, jnp.bfloat16), 1, jnp.asarray(poss))
    kb = params_from_jax(np.asarray(jnp.asarray(rows_k, jnp.bfloat16)))
    vb = params_from_jax(np.asarray(jnp.asarray(rows_v, jnp.bfloat16)))
    kv_rows_write(tk, tv, kb, vb, 1, torch.from_numpy(poss))
    _assert_pools_equal(jk2, tk)
    _assert_pools_equal(jv2, tv)


def test_kv_rows_write_clamps_out_of_range_positions(rng):
    """Positions past the pool clamp to MAX-1, as the
    reference's XLA row write (lax.dynamic_update_slice) clamps: a free
    slot decoding at a stale position stays inside its own pool. The
    reference's Pallas kernel instead lands such a row in the last 8-row
    window at offset pos % 8; the port follows the XLA write."""
    rows_k = rng.standard_normal((B, HK, D)).astype(np.float32)
    rows_v = rng.standard_normal((B, HK, D)).astype(np.float32)
    poss = np.array([MAX - 1, MAX, MAX + 3, MAX + 40, 3, MAX + 7, 0, 2 * MAX], np.int32)
    (jk, jv), (tk, tv) = _pools_both("bf16")

    def ref_write(kc_b, vc_b, kb, vb, pb):
        kc_b = jax_kv_write(kc_b, kb.reshape(1, 1, -1), (1, pb, 0))
        vc_b = jax_kv_write(vc_b, vb.reshape(1, 1, -1), (1, pb, 0))
        return kc_b, vc_b

    jk2, jv2 = jax.vmap(ref_write)(jk, jv, jnp.asarray(rows_k, jnp.bfloat16),
                                   jnp.asarray(rows_v, jnp.bfloat16),
                                   jnp.asarray(poss))
    kv_rows_write(tk, tv, params_from_jax(np.asarray(jnp.asarray(rows_k, jnp.bfloat16))),
                  params_from_jax(np.asarray(jnp.asarray(rows_v, jnp.bfloat16))),
                  1, torch.from_numpy(poss))
    _assert_pools_equal(jk2, tk)
    _assert_pools_equal(jv2, tv)


@pytest.mark.parametrize("case", ["ragged_gqa", "softcap", "window", "mha_layer0"])
def test_batch_decode_attention_matches_pallas(rng, case):
    b, nl, max_len, hq, hk, d = 4, 3, 64, 8, 2, 16
    softcap, window, layer = None, None, 2
    if case == "softcap":
        softcap = 30.0
    elif case == "window":
        window = 9
    elif case == "mha_layer0":
        hq, hk, layer = 4, 4, 0
    kp = rng.standard_normal((b, nl, max_len, hk * d)).astype(np.float32)
    vp = rng.standard_normal((b, nl, max_len, hk * d)).astype(np.float32)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    lens = np.array([1, 17, 64, 90], np.int32)          # 90 > MAX: whole pool live
    ref = jax_bda(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                  jnp.int32(layer), jnp.asarray(lens), chunk=16, softcap=softcap,
                  window=None if window is None else jnp.int32(window))
    got = batch_decode_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                 torch.from_numpy(vp), layer, torch.from_numpy(lens),
                                 softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_batch_decode_attention_int8_pools(rng):
    """int8 {"q","s"} pools: the row scales fold into the score columns and
    into P, as in the reference kernel."""
    b, nl, max_len, hq, hk, d = 2, 2, 32, 4, 2, 8
    rows = rng.standard_normal((b, nl, max_len, hk * d)).astype(np.float32)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    lens = np.array([7, 30], np.int32)
    from pygpukit_tpu.ops.embedding import kv_quant_rows
    kq, ks = kv_quant_rows(jnp.asarray(rows), 1)
    jpool = {"q": kq, "s": ks}
    ref = jax_bda(jnp.asarray(q), jpool, jpool, jnp.int32(1), jnp.asarray(lens),
                  chunk=16)
    tpool = params_from_jax({"q": np.asarray(kq), "s": np.asarray(ks)})
    got = batch_decode_attention(torch.from_numpy(q), tpool, tpool, 1,
                                 torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
