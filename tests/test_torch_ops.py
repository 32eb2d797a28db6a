"""The PyTorch port's small ops against the JAX package on the same numpy
inputs: norms, activations and rope at rtol 1e-6 in f32; KV storage ops
(fp8 clamp, int8 row quant, clamped writes) bitwise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygpukit_tpu.ops import embedding as jemb
from pygpukit_tpu.ops.nn import activation as jact
from pygpukit_tpu.ops.nn import norm as jnorm
from pygpukit_tpu.ops.nn import rope as jrope
from pygpukit_tpu_torch.llm import params_from_jax
from pygpukit_tpu_torch.ops import embedding as temb
from pygpukit_tpu_torch.ops import nn as tnn

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(5)


def _close(got, ref, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def test_rmsnorm_layernorm(rng):
    x = rng.standard_normal((5, 48)).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    _close(tnn.rmsnorm_fn(tx, tw, 1e-5), jnorm.rmsnorm_fn(jnp.asarray(x), jnp.asarray(w), 1e-5))
    _close(tnn.layernorm_fn(tx, tw, tb, 1e-5),
           jnorm.layernorm_fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))


def test_swiglu_gelu(rng):
    g = rng.standard_normal((4, 96)).astype(np.float32) * 3
    u = rng.standard_normal((4, 96)).astype(np.float32)
    _close(tnn.swiglu_fn(torch.from_numpy(g), torch.from_numpy(u)),
           jact.swiglu_fn(jnp.asarray(g), jnp.asarray(u)))
    for approx in (True, False):
        _close(tnn.gelu_fn(torch.from_numpy(g), approx),
               jact.gelu_fn(jnp.asarray(g), approx))


def test_rope_tables_and_apply(rng):
    cos, sin = tnn.rope_init(64, 12, 10000.0, device="cpu")
    jcos, jsin = jrope.rope_init(64, 12, 10000.0)
    _close(cos.torch, jcos.jax)
    _close(sin.torch, jsin.jax)
    x = rng.standard_normal((7, 3, 12)).astype(np.float32)
    rows = np.asarray([0, 5, 9, 17, 33, 62, 63])
    c, s = np.asarray(jcos.jax)[rows], np.asarray(jsin.jax)[rows]
    got = tnn.apply_rope_fn(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(s))
    _close(got, jrope.apply_rope_fn(jnp.asarray(x), jnp.asarray(c), jnp.asarray(s)))


def test_to_kv_dtype_fp8_clamps_bitwise(rng):
    x = (rng.standard_normal((4, 16)) * 400).astype(np.float32)
    ref = np.asarray(jemb.to_kv_dtype(jnp.asarray(x), jnp.float8_e4m3fn))
    got = temb.to_kv_dtype(torch.from_numpy(x), torch.float8_e4m3fn)
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), ref.view(np.uint8))


def test_kv_quant_rows_bitwise(rng):
    x = rng.standard_normal((3, 2, 8)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    rq, rs = jemb.kv_quant_rows(xb, 2)
    q, s = temb.kv_quant_rows(params_from_jax(np.asarray(xb)), 2)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.view(torch.int16).numpy(),
                                  np.asarray(rs).view(np.int16))
    np.testing.assert_array_equal(
        temb.kv_dequant(q, s).view(torch.int16).numpy(),
        np.asarray(jemb.kv_dequant(rq, rs)).view(np.int16))


@pytest.mark.parametrize("start", [0, 5, 14, 40])
def test_kv_write_clamps_like_dynamic_update_slice(rng, start):
    """Rows land where lax.dynamic_update_slice puts them, start clamped
    into range; int8 dicts write rows and scales."""
    new = rng.standard_normal((1, 3, 8)).astype(np.float32)
    for dtype, tdtype in ((jnp.float32, torch.float32), (jnp.int8, torch.int8)):
        jc = jemb.kv_cache_zeros((2, 16, 8), dtype, merged=True)
        ref = jemb.kv_write(jc, jnp.asarray(new), (1, start, 0))
        tc = temb.kv_cache_zeros((2, 16, 8), tdtype, device="cpu", merged=True)
        got = temb.kv_write(tc, torch.from_numpy(new), (1, start, 0))
        if isinstance(ref, dict):
            np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
            np.testing.assert_array_equal(got["s"].view(torch.int16).numpy(),
                                          np.asarray(ref["s"]).view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
