"""The port's remaining LLM ops and core services against the JAX package
on the CPU, on the same numpy inputs:

- ``ops/embedding.py``: ``embedding_lookup_fn`` / ``_batch``,
  ``kv_compute_dtype``, ``kv_cache_update_fn`` / ``kv_cache_prefill_fn``
  on f32, bf16, fp8 and int8 caches and the Array-handle
  ``kv_cache_update`` / ``kv_cache_prefill``: bitwise;
- ``ops/nn/fused.py`` (``rmsnorm_residual``, ``linear_bias_gelu``,
  ``swiglu``, ``geglu``) and ``ops/batching.py``: f32 within rtol 1e-5,
  integer results exact;
- ``llm/sampling.sample_token``: the same ``np.random.Generator`` draws the
  same tokens as the reference's;
- ``core/stream.py``: priorities and the round-robin pool, the context
  manager, events' elapsed time at least 0 (and at least a slept 10 ms);
- ``core/device.py`` and ``core/memory.py`` on the CPU path, the card's
  published peaks, host copies bitwise; with no device named and no card,
  each raises.
Mirrors ``tests/test_core.py`` (streams, device info),
``tests/test_nn_ops.py::TestKVCache`` and
``tests/test_paged_batching.py::TestBatchingPrimitives``.
"""

import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import pygpukit_tpu as jgp
import pygpukit_tpu_torch as gp
from pygpukit_tpu.core import stream as jstream
from pygpukit_tpu.llm import sampling as jsampling
from pygpukit_tpu.ops import batching as jb
from pygpukit_tpu.ops import embedding as je
from pygpukit_tpu.ops.nn import fused as jf
from pygpukit_tpu_torch.core import device as tdevice
from pygpukit_tpu_torch.core import memory as tmemory
from pygpukit_tpu_torch.core import stream as tstream
from pygpukit_tpu_torch.core.host import tensor_from_numpy, tensor_to_numpy
from pygpukit_tpu_torch.llm import sampling as tsampling
from pygpukit_tpu_torch.ops import batching as tb
from pygpukit_tpu_torch.ops import embedding as te
from pygpukit_tpu_torch.ops.nn import fused as tf

F32_TOL = dict(rtol=1e-5, atol=1e-6)
CPU = "cpu"


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a))


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x).tobytes()
    return np.asarray(x).tobytes()


# --------------------------------------------------------------- embedding --

@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("ids_shape", [(5,), (2, 3)])
def test_embedding_lookup_is_the_references(dtype, ids_shape):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((11, 6)).astype(dtype)
    ids = rng.integers(0, 11, ids_shape).astype(np.int32)
    ref = je.embedding_lookup_fn(jnp.asarray(table), jnp.asarray(ids))
    got = te.embedding_lookup_fn(_t(table), _t(ids))
    assert tuple(got.shape) == ref.shape and _bytes(got) == _bytes(ref)
    arr = te.embedding_lookup_batch(gp.from_numpy(table, device=CPU), ids)
    assert _bytes(arr.torch) == _bytes(ref)


@pytest.mark.parametrize("name", ["float32", "bfloat16", "float16", "float8_e4m3fn",
                                  "float8_e5m2", "int8"])
def test_kv_compute_dtype_is_the_references(name):
    ref = je.kv_compute_dtype(jnp.dtype(name))
    got = te.kv_compute_dtype(getattr(torch, name))
    assert str(got).removeprefix("torch.") == jnp.dtype(ref).name


def _kv_caches(kind: str, max_len: int, hk: int, d: int):
    """(port cache, reference cache) of storage ``kind``, zeros."""
    if kind == "int8":
        return (te.kv_cache_zeros((max_len, hk, d), torch.int8, CPU, merged=False),
                je.kv_cache_zeros((max_len, hk, d), jnp.int8))
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "e4m3": torch.float8_e4m3fn}[kind]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "e4m3": jnp.float8_e4m3fn}[kind]
    return (te.kv_cache_zeros((max_len, hk, d), tdt, CPU, merged=False),
            je.kv_cache_zeros((max_len, hk, d), jdt))


def _leaves(c):
    return [c["q"], c["s"]] if isinstance(c, dict) else [c]


@pytest.mark.parametrize("kind", ["f32", "bf16", "e4m3", "int8"])
@pytest.mark.parametrize("device_pos", [False, True])
def test_kv_cache_update_and_prefill_fns_are_bitwise_the_references(kind, device_pos):
    """A 5-row prefill then a 1-row update at position 5, and one past the
    end (clamped as dynamic_update_slice clamps): every leaf bitwise."""
    rng = np.random.default_rng(1)
    tk, jk = _kv_caches(kind, 8, 2, 4)
    tv, jv = _kv_caches(kind, 8, 2, 4)
    rows = [rng.standard_normal((n, 2, 4)).astype(np.float32) * 30 for n in (5, 1, 2)]
    tk, tv = te.kv_cache_prefill_fn(tk, tv, _t(rows[0]), _t(rows[0] * 2))
    jk, jv = je.kv_cache_prefill_fn(jk, jv, jnp.asarray(rows[0]), jnp.asarray(rows[0] * 2))
    for r, pos in ((rows[1], 5), (rows[2], 7)):
        tpos = torch.tensor([pos], dtype=torch.int32) if device_pos else pos
        tk, tv = te.kv_cache_update_fn(tk, tv, _t(r), _t(r - 1), tpos)
        jk, jv = je.kv_cache_update_fn(jk, jv, jnp.asarray(r), jnp.asarray(r - 1),
                                       jnp.int32(pos))
    for mine, ref in zip(_leaves(tk) + _leaves(tv), _leaves(jk) + _leaves(jv)):
        assert _bytes(mine) == _bytes(ref)


def test_kv_cache_update_and_prefill_through_array_handles():
    """The reference test's prefill of 3 rows then an update at 3 (f32),
    each handle's tensor written in place, bitwise the reference's."""
    rng = np.random.default_rng(2)
    kc, vc = gp.zeros((8, 2, 4), device=CPU), gp.zeros((8, 2, 4), device=CPU)
    jkc, jvc = jgp.zeros((8, 2, 4)), jgp.zeros((8, 2, 4))
    k1, v1 = (rng.standard_normal((3, 2, 4), dtype=np.float32) for _ in range(2))
    k2, v2 = (rng.standard_normal((1, 2, 4), dtype=np.float32) for _ in range(2))
    te.kv_cache_prefill(kc, vc, gp.from_numpy(k1, device=CPU), v1)
    je.kv_cache_prefill(jkc, jvc, jgp.from_numpy(k1), jgp.from_numpy(v1))
    np.testing.assert_array_equal(kc.to_numpy()[:3], k1)
    held = kc.torch
    te.kv_cache_update(kc, vc, k2, gp.from_numpy(v2, device=CPU), 3)
    je.kv_cache_update(jkc, jvc, jgp.from_numpy(k2), jgp.from_numpy(v2), 3)
    assert kc.torch is held
    np.testing.assert_array_equal(kc.to_numpy()[3], k2[0])
    assert _bytes(kc.torch) == _bytes(jkc.to_numpy())
    assert _bytes(vc.torch) == _bytes(jvc.to_numpy())
    assert te.kv_cache_update_gqa is te.kv_cache_update
    assert te.kv_cache_prefill_gqa is te.kv_cache_prefill


# ------------------------------------------------------------------ fused --

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_residual_is_the_references(dtype):
    """(y, h) of x + residual: f32 within 1e-5, bf16 within one ulp."""
    rng = np.random.default_rng(3)
    x, res = (rng.standard_normal((4, 16), dtype=np.float32) for _ in range(2))
    w = rng.standard_normal(16, dtype=np.float32)
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jy, jh = jf.rmsnorm_residual_fn(jnp.asarray(x).astype(jd), jnp.asarray(res).astype(jd),
                                    jnp.asarray(w), 1e-6)
    ty, th = tf.rmsnorm_residual_fn(_t(x).to(td), _t(res).to(td), _t(w), 1e-6)
    tol = F32_TOL if dtype == "f32" else dict(rtol=2 ** -7, atol=1e-6)
    for mine, ref in ((ty, jy), (th, jh)):
        assert mine.dtype == td
        np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref, np.float32), **tol)
    y, h = tf.rmsnorm_residual(gp.from_numpy(x, device=CPU), res, w)
    out = gp.zeros((4, 16), device=CPU)
    y2, _ = tf.rmsnorm_residual(gp.from_numpy(x, device=CPU), res, w, out=out)
    assert y2 is out and torch.equal(out.torch, y.torch)
    np.testing.assert_allclose(h.to_numpy(), x + res, **F32_TOL)


def test_linear_bias_gelu_is_the_references():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 12), dtype=np.float32)
    w = rng.standard_normal((12, 7), dtype=np.float32)
    b = rng.standard_normal(7, dtype=np.float32)
    ref = jf.linear_bias_gelu_fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(tf.linear_bias_gelu_fn(_t(x), _t(w), _t(b)).numpy(),
                               np.asarray(ref), **F32_TOL)
    got = gp.linear_bias_gelu(gp.from_numpy(x, device=CPU), w, b)
    np.testing.assert_allclose(got.to_numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("name", ["swiglu", "geglu"])
def test_gated_activations_are_the_references(name):
    rng = np.random.default_rng(5)
    gate, up = (rng.standard_normal((3, 10), dtype=np.float32) for _ in range(2))
    ref = getattr(jf, name)(jgp.from_numpy(gate), jgp.from_numpy(up)).to_numpy()
    got = getattr(tf, name)(gp.from_numpy(gate, device=CPU), up).to_numpy()
    np.testing.assert_allclose(got, ref, **F32_TOL)


# --------------------------------------------------------------- batching --

def test_prepare_position_ids():
    lens = np.asarray([3, 2, 4], np.int32)
    got = tb.prepare_position_ids_fn(_t(lens), 9)
    assert got.tolist() == [0, 1, 2, 0, 1, 0, 1, 2, 3] and got.dtype == torch.int32
    for lens, n in (([3, 2, 4], 12), ([1], 4), ([5, 0, 2], 7)):
        ref = jb.prepare_position_ids_fn(jnp.asarray(lens, jnp.int32), n)
        assert tb.prepare_position_ids_fn(_t(np.asarray(lens, np.int32)), n).tolist() == \
            np.asarray(ref).tolist()
    arr = tb.prepare_position_ids(gp.from_numpy(np.asarray([3, 2, 4], np.int32), device=CPU),
                                  9)
    assert arr.to_numpy().tolist() == [0, 1, 2, 0, 1, 0, 1, 2, 3]


def test_scatter_last_logits():
    logits = np.arange(5 * 4, dtype=np.float32).reshape(5, 4)
    lens = np.asarray([2, 3], np.int32)
    out = tb.scatter_last_token_logits_fn(_t(logits), _t(lens)).numpy()
    np.testing.assert_array_equal(out[0], np.arange(4, 8))
    np.testing.assert_array_equal(out[1], np.arange(16, 20))
    ref = jb.scatter_last_token_logits_fn(jnp.asarray(logits), jnp.asarray(lens))
    assert out.tobytes() == np.asarray(ref).tobytes()
    arr = tb.scatter_last_token_logits(gp.from_numpy(logits, device=CPU), lens)
    assert arr.to_numpy().tobytes() == out.tobytes()


def test_argmax_and_eos():
    logits = np.asarray([[0.0, 2.0, 1.0], [3.0, 0.0, 0.0], [1.0, 1.0, 0.5]], np.float32)
    toks = tb.argmax_sample_fn(_t(logits))
    assert toks.tolist() == np.asarray(jb.argmax_sample_fn(jnp.asarray(logits))).tolist()
    assert toks.tolist() == [1, 0, 0] and toks.dtype == torch.int32
    assert tb.check_eos_fn(toks, 0).tolist() == [False, True, True]
    assert tb.argmax_sample(gp.from_numpy(logits, device=CPU)).to_numpy().tolist() == [1, 0, 0]
    assert tb.check_eos(gp.from_numpy(np.asarray([4, 2], np.int32), device=CPU),
                        2).to_numpy().tolist() == [False, True]


def test_gather_embeddings():
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    out = tb.gather_embeddings_fn(_t(table), _t(np.asarray([2, 0], np.int32))).numpy()
    np.testing.assert_array_equal(out[0], [6, 7, 8])
    ref = jb.gather_embeddings_fn(jnp.asarray(table), jnp.asarray([2, 0]))
    assert out.tobytes() == np.asarray(ref).tobytes()
    arr = tb.gather_embeddings(gp.from_numpy(table, device=CPU), np.asarray([3, 1]))
    np.testing.assert_array_equal(arr.to_numpy(), table[[3, 1]])


@pytest.mark.parametrize("x", [np.arange(1, 9, dtype=np.int32),
                               np.random.default_rng(6).standard_normal((4, 5)).astype(
                                   np.float32),
                               np.asarray([True, False, True, True])])
@pytest.mark.parametrize("axis", [0, -1])
def test_cumsum_is_the_references(x, axis):
    ref = np.asarray(jb.cumsum_fn(jnp.asarray(x), axis))
    got = tb.cumsum_fn(_t(x), axis)
    assert str(got.dtype).removeprefix("torch.") == ref.dtype.name
    np.testing.assert_allclose(got.numpy(), ref, **F32_TOL)


# ---------------------------------------------------------------- sampler --

@pytest.mark.parametrize("kw", [dict(temperature=0.0), dict(temperature=1.0),
                                dict(temperature=0.7, top_k=5), dict(temperature=1.3, top_p=0.9),
                                dict(temperature=0.8, top_k=20, top_p=0.5),
                                dict(temperature=1.0, top_k=1)])
def test_sample_token_draws_the_references_tokens(kw):
    """Twenty draws from two generators seeded alike: the same tokens."""
    logits = np.random.default_rng(9).standard_normal(200).astype(np.float32) * 3
    mine, ref = np.random.default_rng(42), np.random.default_rng(42)
    got = [tsampling.sample_token(logits, rng=mine, **kw) for _ in range(20)]
    want = [jsampling.sample_token(logits, rng=ref, **kw) for _ in range(20)]
    assert got == want and all(0 <= t < 200 for t in got)
    if kw["temperature"] == 0.0 or kw.get("top_k") == 1:
        assert set(got) == {int(logits.argmax())}


# ---------------------------------------------------------------- streams --

def test_stream_priorities_and_round_robin_pool():
    mgr = tstream.StreamManager(n_high=1, n_low=2)
    hi = mgr.get(tstream.StreamPriority.HIGH)
    lo1 = mgr.get(tstream.StreamPriority.LOW)
    lo2 = mgr.get(tstream.StreamPriority.LOW)
    assert hi.priority == tstream.StreamPriority.HIGH
    assert lo1 is not lo2
    assert mgr.get(tstream.StreamPriority.LOW) is lo1
    assert [int(p) for p in tstream.StreamPriority] == [int(p) for p in jstream.StreamPriority]
    lo1.record(torch.ones(3))
    lo1.record(gp.ones((2,), device=CPU))
    assert lo1._pending == []                       # a CPU tensor is already done
    mgr.synchronize_all()


def test_stream_context_manager():
    s = tstream.Stream()
    assert tstream.current_stream() is tstream.default_stream()
    with s:
        assert tstream.current_stream() is s
    assert tstream.current_stream() is tstream.default_stream()
    assert s.stream_id != tstream.Stream().stream_id


def test_event_timing_on_the_cpu():
    e1, e2 = tstream.Event(device=CPU), tstream.Event(device=CPU)
    e1.record()
    e2.record()
    assert e1.elapsed_ms(e2) >= 0
    e1.record()
    time.sleep(0.01)
    e2.record()
    assert e1.elapsed_ms(e2) >= 5
    assert e1.elapsed_us(e2) >= 5000


def test_unrecorded_event_raises():
    with pytest.raises(RuntimeError):
        tstream.Event(device=CPU).elapsed_ms(tstream.Event(device=CPU))


# ---------------------------------------------------------- device, memory --

def test_device_and_memory_info_on_the_cpu():
    info = tdevice.get_device_info(device=CPU)
    assert info.platform == "cpu" and info.num_devices >= 1
    assert info.peak_bf16_tflops > 0 and info.hbm_gib > 0
    assert info.name == "cpu #0"
    mem = tmemory.get_memory_info(device=CPU)
    assert mem.total_bytes > 0 and mem.free_bytes == mem.total_bytes - mem.used_bytes
    assert mem.total_gib == mem.total_bytes / (1 << 30)
    assert tdevice.device_count() == torch.cuda.device_count()
    assert tdevice.is_cuda_available() == torch.cuda.is_available()
    tmemory.synchronize(device=CPU)


def test_the_cards_published_peaks():
    """One table: the H100 SXM's dense bf16, int8 and f32 rates and HBM3
    bandwidth, matched from the device's name; another card has none."""
    peaks = tdevice.card_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "hbm_bytes_s": 3.35e12}
    with pytest.raises(KeyError):
        tdevice.card_peaks("Some Other Card")


@pytest.mark.parametrize("dtype", [np.float32, np.int32, ml_dtypes.bfloat16])
def test_host_copies_are_bitwise(dtype):
    a = (np.random.default_rng(10).standard_normal((3, 5)) * 100).astype(dtype)
    arr = tmemory.copy_to_device(a, device=CPU)
    assert arr.device.type == "cpu" and _bytes(arr.torch) == a.tobytes()
    assert tmemory.copy_to_host(arr).tobytes() == a.tobytes()
    fut = tmemory.copy_to_host_async(arr)
    arr.torch.zero_()
    assert fut.result().tobytes() == a.tobytes()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_without_a_card_the_default_device_raises():
    for call in (tdevice.get_device_info, tmemory.get_memory_info, tstream.Event,
                 lambda: tmemory.copy_to_device(np.zeros(2)), tmemory.synchronize):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_exported_where_the_reference_exports_them():
    for name in ("Event", "Stream", "StreamManager", "StreamPriority", "default_stream",
                 "device_count", "get_device_info", "get_memory_info", "synchronize",
                 "linear_bias_gelu"):
        assert hasattr(jgp, name) and hasattr(gp, name), name
    from pygpukit_tpu import ops as jops
    from pygpukit_tpu_torch import llm, ops
    for name in ("argmax_sample", "check_eos", "gather_embeddings", "prepare_position_ids",
                 "scatter_last_token_logits", "linear_bias_gelu", "kv_cache_update",
                 "kv_cache_prefill", "kv_cache_update_gqa", "kv_cache_prefill_gqa",
                 "embedding_lookup_batch"):
        assert hasattr(jops, name) and hasattr(ops, name), name
    assert llm.sample_token is tsampling.sample_token
    assert gp.is_cuda_available() == torch.cuda.is_available()
