"""The port's flash attention module against the JAX package on the CPU:

- ``flash_attention_plain`` and ``flash_decode_plain`` against the JAX
  Pallas kernels in interpret mode: f32 at rtol 1e-4 (the same f32 sums in
  another order), bf16 within one bf16 ulp of max |out| (both round P to
  bf16; at these lengths the Pallas kernels see one key block, so both
  round it against the same maximum);
- ``ops.nn.flash_attention_fn`` against the JAX ``flash_attention_fn`` on
  its CPU route, across the dense/chunked boundary (chunk 512, keys padded)
  with softcap and window, rtol 1e-4;
- the wrappers on CPU tensors are their plain versions and launch nothing;
  ``flash_decode`` takes ``ctx_len`` as an int or an int32 tensor (0-d or
  ``[1]``) and gives the same bits either way;
- ``flash_decode``'s launch plan (``decode_plan``): a split count from the
  shapes alone whose ``split_bounds`` cover the live context once, in order;
- ``PYGPUKIT_FLASH_ATTENTION`` by the route's decision function: ``pallas``
  and ``jax`` take the kernel on CUDA tensors, ``xla`` the plain route.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygpukit_tpu.kernels.flash_attention import flash_attention as jax_flash
from pygpukit_tpu.kernels.flash_attention import flash_decode as jax_decode
from pygpukit_tpu.ops.nn.attention import flash_attention_fn as jax_flash_fn
from pygpukit_tpu_torch.kernels import (LAUNCHES, flash_attention,
                                        flash_attention_plain, flash_decode,
                                        flash_decode_plain)
from pygpukit_tpu_torch.kernels.attention_split import (ATTN_CHUNK, SPLIT_BLOCKS,
                                                        live_splits, split_bounds)
from pygpukit_tpu_torch.kernels.flash_attention import (DECODE_MMA_BLOCKS,
                                                        DECODE_MMA_CHUNKS, decode_plan,
                                                        mma_fold_splits)
from pygpukit_tpu_torch.llm import params_from_jax
from pygpukit_tpu_torch.ops.nn import flash_attention_fn
from pygpukit_tpu_torch.ops.nn.attention import _kernel_scale, flash_attention_route

torch.set_num_threads(2)

_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor (identical bits)."""
    xj = jnp.asarray(rng.standard_normal(shape).astype(np.float32), _JDT[dtype])
    return xj, params_from_jax(np.asarray(xj))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _assert_close(got, ref, dtype):
    got, ref = _f32(got), _f32(ref)
    assert np.isfinite(got).all()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        assert np.abs(got - ref).max() <= ulp, (np.abs(got - ref).max(), ulp)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 77, 300])
def test_flash_attention_plain_matches_pallas(s, d, causal, dtype):
    rng = np.random.default_rng(s * 7 + d)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, (s, h, d), dtype) for h in (4, 2, 2))
    ref = jax_flash(qj, kj, vj, causal=causal)
    got = flash_attention_plain(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == (s, 4, d)
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("max_len,ctx", [(256, 1), (256, 100), (256, 256),
                                         (700, 1), (700, 100), (700, 700)])
def test_flash_decode_plain_matches_pallas(max_len, ctx, dtype):
    """MAX 700 is padded to two 512-row blocks by the reference."""
    rng = np.random.default_rng(max_len + ctx)
    qj, qt = _pair(rng, (1, 4, 64), dtype)
    kj, kt = _pair(rng, (max_len, 2, 64), dtype)
    vj, vt = _pair(rng, (max_len, 2, 64), dtype)
    ref = jax_decode(qj, kj, vj, ctx)
    got = flash_decode_plain(qt, kt, vt, ctx)
    assert got.dtype == qt.dtype and got.shape == (1, 4, 64)
    _assert_close(got, ref, dtype)


def test_flash_decode_plain_empty_context_is_zero():
    q, k = torch.ones((1, 4, 64)), torch.ones((8, 2, 64))
    assert torch.equal(flash_decode_plain(q, k, k, 0), torch.zeros_like(q))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("extra", [{}, dict(softcap=5.0), dict(window=64),
                                   dict(window=0), dict(scale=0.3)])
@pytest.mark.parametrize("s", [300, 1100])
def test_flash_attention_fn_matches_jax(s, extra, causal):
    """S 1100 with chunk 512: three chunks, the last padded by 436 keys."""
    rng = np.random.default_rng(s)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, (s, h, 16), "f32") for h in (4, 2, 2))
    kw = dict(extra, chunk_size=512, causal=causal)
    jkw = dict(kw, window=jnp.int32(extra["window"])) if "window" in extra else kw
    ref = np.asarray(jax_flash_fn(qj, kj, vj, **jkw))
    got = flash_attention_fn(qt, kt, vt, **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_cpu_wrappers_are_the_plain_versions():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((33, h, 64)).astype(np.float32))
               for h in (4, 2, 2))
    before = dict(LAUNCHES)
    assert torch.equal(flash_attention(q, k, v), flash_attention_plain(q, k, v))
    assert torch.equal(flash_attention(q, k, v, causal=False),
                       flash_attention_plain(q, k, v, causal=False))
    assert torch.equal(flash_decode(q[:1], k, v, 20), flash_decode_plain(q[:1], k, v, 20))
    flash_attention_fn(q, k, v)
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("d", [64, 128, 96])
def test_default_scale_is_compared_in_f32(d):
    """The config's ``head_dim ** -0.5`` differs from ``1/math.sqrt(D)`` in
    the last bit at D 96 and 128; both round to one f32, the kernel's."""
    assert _kernel_scale(d ** -0.5, d) and _kernel_scale(1.0 / math.sqrt(d), d)
    assert not _kernel_scale(1.01 / math.sqrt(d), d)


@pytest.mark.parametrize("ctx_of", [lambda m: 0, lambda m: 1, lambda m: 63, lambda m: 64,
                                    lambda m: 65, lambda m: m - 1, lambda m: m,
                                    lambda m: m + 5],
                         ids=["0", "1", "63", "64", "65", "MAX-1", "MAX", "MAX+5"])
@pytest.mark.parametrize("max_len,hk", [(512, 4), (8192, 4), (700, 1), (64, 8)])
def test_decode_plan_covers_the_context(max_len, hk, ctx_of):
    """The split count is a function of the shapes and the route alone
    (the same for every G a route takes: bf16 up to 16 query heads a kv
    head on the tensor cores, within what its last block folds in one pass,
    17 to 32 and f32 on the CUDA cores); the splits cover [0, min(ctx,
    MAX)) once, in ascending order, the non-empty ones first
    (``live_splits`` of them); 33 query heads a kv head raise."""
    ctx = ctx_of(max_len)
    chunks = -(-max_len // ATTN_CHUNK)
    mma = decode_plan(8 * hk, max_len, hk, 64, torch.bfloat16)
    cores = decode_plan(8 * hk, max_len, hk, 64, torch.float32)
    assert all(decode_plan(g * hk, max_len, hk, 64, torch.bfloat16) == mma for g in (1, 4, 8))
    assert all(decode_plan(g * hk, max_len, hk, 128, torch.float32) == cores
               for g in (1, 16, 32))
    assert decode_plan(32 * hk, max_len, hk, 64, torch.bfloat16) == cores
    assert mma == max(1, min(-(-chunks // DECODE_MMA_CHUNKS), -(-DECODE_MMA_BLOCKS // hk)))
    assert decode_plan(16 * hk, max_len, hk, 128) <= mma_fold_splits(16, 128) == 16
    assert cores == max(1, min(chunks, -(-SPLIT_BLOCKS // hk)))
    live = max(0, min(ctx, max_len))
    for n_split in (mma, cores):
        bounds = split_bounds(-(2 ** 30), live, n_split)
        assert len(bounds) == n_split
        covered = [p for start, end in bounds for p in range(start, end)]
        assert covered == list(range(live))
        n_live = live_splits(-(2 ** 30), live, n_split)
        assert all(end > start for start, end in bounds[:n_live])
        assert all(end == start for start, end in bounds[n_live:])
    with pytest.raises(ValueError):
        decode_plan(33 * hk, max_len, hk)


@pytest.mark.parametrize("form", ["0-d", "[1]"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("max_len,ctx", [(256, 0), (256, 100), (700, 700), (700, 900)])
def test_flash_decode_tensor_context(max_len, ctx, dtype, form):
    """ctx_len as an int32 tensor gives the int call's bits, and both match
    the reference kernel in interpret mode (tolerances as
    test_flash_decode_plain_matches_pallas); ctx 0 gives zeros. ctx past MAX
    reads the MAX rows (the reference would also read its block padding),
    so it is held to the reference at MAX."""
    rng = np.random.default_rng(max_len * 3 + ctx)
    qj, qt = _pair(rng, (1, 8, 64), dtype)
    kj, kt = _pair(rng, (max_len, 2, 64), dtype)
    vj, vt = _pair(rng, (max_len, 2, 64), dtype)
    ctx_t = torch.tensor(ctx if form == "0-d" else [ctx], dtype=torch.int32)
    before = dict(LAUNCHES)
    got = flash_decode(qt, kt, vt, ctx_t)
    assert dict(LAUNCHES) == before
    assert torch.equal(got, flash_decode(qt, kt, vt, ctx))
    if ctx == 0:
        assert torch.equal(got, torch.zeros_like(qt))
    else:
        assert torch.equal(got, flash_decode(qt, kt, vt, min(ctx, max_len)))
        _assert_close(got, jax_decode(qj, kj, vj, min(ctx, max_len)), dtype)


@pytest.mark.parametrize("mode,want", [("", "kernel"), ("pallas", "kernel"), ("jax", "kernel"),
                                       ("xla", "plain")])
def test_flash_attention_switch_route(monkeypatch, mode, want):
    """The jax-shipped TPU flash kernel computes the kernel's function, so
    both switch names take the one kernel; xla forces the plain route.
    CPU tensors, a softcap, a window or another scale stay plain."""
    monkeypatch.setenv("PYGPUKIT_FLASH_ATTENTION", mode)
    scale = 128 ** -0.5
    assert flash_attention_route("cuda", scale, 128) == want
    assert flash_attention_route("cpu", scale, 128) == "plain"
    for kw in (dict(softcap=30.0), dict(window=16)):
        assert flash_attention_route("cuda", scale, 128, **kw) == "plain"
    assert flash_attention_route("cuda", 0.1, 128) == "plain"
