"""The port's capture/replay runtime (``core/executable.py``), its decode
buffers (``llm/buffers.py``) and the device position, on the CPU:

- ``capture``/``replay``: the CPU path calls ``fn`` on the static inputs;
  donated arguments are bound by identity (another tensor raises); a
  non-static Python number is written into its one-element static tensor;
  a tensor leaf at another address is copied into the captured one;
  ``node_count`` counts the dispatched ATen operations; the warm-up runs on
  clones of the donated arguments;
- ``ExecutableCache``: hits, misses, first-in eviction at ``max_entries``
  (the evicted executable released), ``stats()``,
  ``global_executable_cache()``;
- the buffers' byte counts against the reference's for the 1.1B and tiny
  configs;
- the device position: ``decode_step_fn``, ``decode_window_fn`` (T 1, 3,
  5) and ``fused_decode_step_fn`` with ``pos`` a one-element int32 tensor
  against the same call with the int, bitwise (logits and both caches),
  on f32, bf16, fp8 and int8 caches, with the full and the chunked
  attention backend (chunk 8 over MAX 40: five chunks), a sliding window
  and a softcap, at positions 0, mid-cache and MAX - 1; the captured
  decode step of the model against the eager step, bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygpukit_tpu.llm import buffers as jax_buffers
from pygpukit_tpu.llm.config import TransformerConfig as JaxConfig
from pygpukit_tpu_torch.core import (Executable, ExecutableCache, capture,
                                     global_executable_cache)
from pygpukit_tpu_torch.llm import (BatchDecodeBuffers, CausalTransformerModel,
                                    DecodeBuffers, PrefillBuffers, TransformerConfig,
                                    init_params, kv_cache_nbytes)
from pygpukit_tpu_torch.llm import model as port_model
from pygpukit_tpu_torch.ops.embedding import kv_cache_zeros, kv_leaf

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _step(state, x, scale):
    """A donated-state update: state += x * scale; returns state * 2."""
    state.add_(x * scale)
    return state * 2


def test_cpu_replay_calls_fn_on_the_static_inputs():
    state = torch.zeros(4)
    x = torch.arange(4, dtype=torch.float32)
    exe = capture(_step, state, x, 3, donate_argnums=(0,), name="step")
    assert isinstance(exe, Executable) and exe.stats.captures == 1
    assert torch.equal(state, torch.zeros(4))           # the warm-up ran on a clone
    assert exe.node_count > 0                           # ATen ops of one call
    out = exe.replay(state, x, 3)
    assert torch.equal(state, x * 3) and torch.equal(out, x * 6)
    assert exe.stats.replays == 1
    assert exe.cost_analysis() == {} and exe.memory_analysis() is None


def test_python_number_is_written_into_its_static_tensor():
    state = torch.zeros(3)
    x = torch.ones(3)
    exe = capture(_step, state, x, 2, donate_argnums=(0,))
    static = exe._args[2]
    assert static.dtype == torch.int32 and static.shape == (1,) and int(static) == 2
    exe.replay(state, x, 5)
    assert int(static) == 5 and torch.equal(state, torch.full((3,), 5.0))
    exe.replay(state, x, 7)
    assert torch.equal(state, torch.full((3,), 12.0))


def test_tensor_at_another_address_is_copied_in():
    state = torch.zeros(2)
    x = torch.ones(2)
    exe = capture(_step, state, x, 1, donate_argnums=(0,))
    other = torch.full((2,), 4.0)
    exe.replay(state, other, 1)
    assert torch.equal(x, other) and torch.equal(state, other)
    with pytest.raises(ValueError, match="does not match"):
        exe.replay(state, torch.ones(3), 1)
    with pytest.raises(ValueError, match="does not match"):
        exe.replay(state, torch.ones(2, dtype=torch.float64), 1)


@pytest.mark.parametrize("other", [
    lambda s: torch.zeros(4),                            # another tensor
    lambda s: s.clone().reshape(2, 2),                   # another shape
    lambda s: torch.zeros(4, dtype=torch.float64),       # another dtype
])
def test_donated_argument_must_be_the_captured_tensor(other):
    state = torch.zeros(4)
    exe = capture(_step, state, torch.ones(4), 1, donate_argnums=(0,))
    with pytest.raises(ValueError, match="donated argument 0"):
        exe.replay(other(state), torch.ones(4), 1)
    exe.replay(state, torch.ones(4), 1)
    assert torch.equal(state, torch.ones(4))


def test_static_arguments_and_reset():
    exe = capture(lambda x, k: x * k, torch.ones(2), 3, static_argnums=(1,))
    assert exe._args[1] == 3
    assert torch.equal(exe.replay(torch.ones(2), 3), torch.full((2,), 3.0))
    with pytest.raises(ValueError, match="static argument 1"):
        exe.replay(torch.ones(2), 4)
    exe.reset()
    with pytest.raises(RuntimeError, match="after reset"):
        exe.replay(torch.ones(2), 3)


def test_executable_cache_hits_misses_and_fifo_eviction():
    cache = ExecutableCache(max_entries=2)
    x = torch.ones(2)
    a = cache.get_or_capture("a", lambda t: t + 1, x)
    assert cache.get_or_capture("a", lambda t: t + 2, x) is a
    b = cache.get_or_capture("b", lambda t: t + 2, x)
    assert cache.stats() == {"entries": 2, "hits": 1, "misses": 2}
    c = cache.get_or_capture("c", lambda t: t + 3, x)        # evicts "a", the oldest
    assert cache.stats() == {"entries": 2, "hits": 1, "misses": 3}
    with pytest.raises(RuntimeError, match="after reset"):
        a.replay(x)
    assert torch.equal(b.replay(x), x + 2) and torch.equal(c.replay(x), x + 3)
    assert cache.get_or_capture("a", lambda t: t + 4, x) is not a
    assert cache.stats()["misses"] == 4
    assert global_executable_cache() is global_executable_cache()
    assert isinstance(global_executable_cache(), ExecutableCache)


def test_shared_pool_cache_evicts_nothing():
    """An owner's cache (``shared_pool``) keeps every executable past
    ``max_entries``: evicting would free pool memory that live static
    outputs use. ``reset()`` releases them all."""
    cache = ExecutableCache(max_entries=1, shared_pool=True)
    x = torch.ones(2)
    a = cache.get_or_capture("a", lambda t: t + 1, x)
    b = cache.get_or_capture("b", lambda t: t + 2, x)
    assert cache.executables() == {"a": a, "b": b} and cache.get("a") is a
    assert torch.equal(a.replay(x), x + 1) and cache.nbytes == 0    # no pool on the CPU
    cache.reset()
    assert cache.executables() == {}
    with pytest.raises(RuntimeError, match="after reset"):
        b.replay(x)


CFG_1B = dict(vocab_size=32000, hidden_size=2048, num_layers=22, num_heads=32,
              num_kv_heads=4, intermediate_size=5632, max_position_embeddings=2048)
CFG_TINY = dict(vocab_size=97, hidden_size=48, num_layers=3, num_heads=4, num_kv_heads=2,
                intermediate_size=96, head_dim_override=12, max_position_embeddings=128)


@pytest.mark.parametrize("kw", [CFG_1B, CFG_TINY], ids=["1.1B", "tiny"])
@pytest.mark.parametrize("dtypes", [(jnp.bfloat16, torch.bfloat16),
                                    (jnp.float32, torch.float32),
                                    (jnp.int8, torch.int8)], ids=["bf16", "f32", "int8"])
def test_buffer_bytes_match_the_reference(kw, dtypes):
    jdt, tdt = dtypes
    jcfg, tcfg = JaxConfig(**kw), TransformerConfig(**kw)
    if tdt != torch.int8:
        assert (DecodeBuffers.allocate(tcfg, tdt, CPU).nbytes
                == jax_buffers.DecodeBuffers.allocate(jcfg, jdt).nbytes)
    assert (BatchDecodeBuffers.allocate(tcfg, 8, CPU).nbytes
            == jax_buffers.BatchDecodeBuffers.allocate(jcfg, 8).nbytes)
    assert (PrefillBuffers.allocate(tcfg, 512, CPU).nbytes
            == jax_buffers.PrefillBuffers.allocate(jcfg, 512).nbytes)
    for batch in (1, 8):
        assert (kv_cache_nbytes(tcfg, 512, tdt, batch)
                == jax_buffers.kv_cache_nbytes(jcfg, 512, jdt, batch))


def test_decode_buffers_fields():
    b = DecodeBuffers.allocate(TransformerConfig(**CFG_TINY), torch.float32, CPU)
    assert [(t.shape, t.dtype) for t in (b.token, b.position, b.logits, b.sampled,
                                         b.hidden)] == [
        ((1,), torch.int32), ((1,), torch.int32), ((97,), torch.float32),
        ((1,), torch.int32), ((1, 48), torch.float32)]


# ---------------------------------------------------------------------------
# The device position against the int position
# ---------------------------------------------------------------------------

MAX = 40
DEV_CFG = dict(vocab_size=61, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
               intermediate_size=64, max_position_embeddings=64)
EXTRA = {"plain": {}, "window": dict(sliding_window=5), "softcap": dict(attn_logit_softcap=2.0)}
KV = {"f32": (torch.float32, None), "bf16": (torch.bfloat16, None),
      "fp8": (torch.float32, torch.float8_e4m3fn), "int8": (torch.float32, torch.int8)}
POSITIONS = (0, MAX // 2 + 1, MAX - 1)


def _dev_setup(kv: str, extra: str, backend: str, monkeypatch):
    monkeypatch.setenv("PYGPUKIT_FLASH_DECODING", backend)
    monkeypatch.setenv("PYGPUKIT_FLASH_DECODING_CHUNK", "8")
    cfg = TransformerConfig(**DEV_CFG, **EXTRA[extra])
    dtype, kv_dtype = KV[kv]
    params = port_model.CausalTransformerModel(
        cfg, init_params(cfg, 11, dtype, CPU), dtype=dtype).params
    shape = (cfg.num_layers, MAX, cfg.num_kv_heads, cfg.head_dim)
    g = torch.Generator().manual_seed(3)
    caches = []
    for _ in range(2):
        c = kv_cache_zeros(shape, kv_dtype or dtype, CPU, merged=False)
        rows = torch.randn(shape, generator=g) * 0.5
        port_model.kv_write(c, rows, (0, 0, 0, 0))      # every row live, so masks matter
        caches.append(c)
    return cfg, params, caches


def _clone_cache(c):
    return {k: v.clone() for k, v in c.items()} if isinstance(c, dict) else c.clone()


def _cache_bits(c):
    leaves = [c["q"], c["s"]] if isinstance(c, dict) else [c]
    return [t.view(torch.uint8) if t.element_size() == 1 else
            t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)
            for t in leaves]


def _same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_cache_bits(a), _cache_bits(b)))


def _both_ways(call, caches, pos: int):
    """(logits, k, v) of ``call`` at the int ``pos`` and at its tensor."""
    out = []
    for p in (pos, torch.tensor([pos], dtype=torch.int32)):
        kc, vc = (_clone_cache(c) for c in caches)
        out.append((call(kc, vc, p), kc, vc))
    return out


@pytest.mark.parametrize("backend", ["full", "chunked"])
@pytest.mark.parametrize("extra", list(EXTRA))
@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("t", [1, 3, 5])
def test_device_pos_window_is_the_int_pos_bitwise(kv, extra, backend, t, monkeypatch):
    cfg, params, caches = _dev_setup(kv, extra, backend, monkeypatch)
    toks = torch.tensor([7, 3, 50, 1, 22][:t])
    for pos in POSITIONS:
        (li, ki, vi), (lt, kt, vt) = _both_ways(
            lambda kc, vc, p: port_model.decode_window_fn(cfg, params, kc, vc, toks, p),
            caches, pos)
        assert li.shape == (t, 61) and torch.equal(li, lt), (kv, extra, backend, t, pos)
        assert _same_bits(ki, kt) and _same_bits(vi, vt)


@pytest.mark.parametrize("backend", ["full", "chunked"])
@pytest.mark.parametrize("extra", list(EXTRA))
@pytest.mark.parametrize("kv", list(KV))
def test_device_pos_step_is_the_int_pos_bitwise(kv, extra, backend, monkeypatch):
    cfg, params, caches = _dev_setup(kv, extra, backend, monkeypatch)
    for pos in POSITIONS:
        (li, ki, vi), (lt, kt, vt) = _both_ways(
            lambda kc, vc, p: port_model.decode_step_fn(cfg, params, kc, vc, 9, p),
            caches, pos)
        assert li.shape == (61,) and torch.equal(li, lt), (kv, extra, backend, pos)
        assert _same_bits(ki, kt) and _same_bits(vi, vt)


def test_chunked_device_ctx_walks_dead_chunks_without_change(monkeypatch):
    """Every chunk is read with a tensor ctx; the ones the host loop skips
    (wholly before the window, or past the context) leave the running
    state as it was: the result equals the int ctx's bitwise, also when
    the chunks the host loop never reads hold NaN."""
    from pygpukit_tpu_torch.ops.nn.attention import sdpa_fixed_cache_chunked_fn
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 4, 8, generator=g)
    k = torch.randn(64, 2, 8, generator=g)
    v = torch.randn(64, 2, 8, generator=g)
    for ctx, window in ((30, 6), (64, 5), (9, None), (1, 3)):
        kd, vd = k.clone(), v.clone()
        first = 0 if window is None else max(0, (ctx - 2 - window + 1) // 8)
        end = -(-ctx // 8) * 8
        for t in (kd, vd):
            t[:first * 8] = float("nan")
            t[end:] = float("nan")
        ref = sdpa_fixed_cache_chunked_fn(q, k, v, ctx, chunk=8, window=window)
        for kk, vv in ((k, v), (kd, vd)):
            got = sdpa_fixed_cache_chunked_fn(q, kk, vv, torch.tensor([ctx], dtype=torch.int32),
                                              chunk=8, window=window)
            assert torch.equal(got, ref), (ctx, window)


def test_fused_step_device_pos_is_the_int_pos_bitwise(monkeypatch):
    """The plain fused step (the fused kernel's CPU version) takes the
    device position as its pos tensor."""
    cfg = TransformerConfig(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
                            num_kv_heads=2, intermediate_size=128, max_position_embeddings=64)
    params = port_model.prepare_fused_decode_params(
        cfg, init_params(cfg, 2, torch.bfloat16, CPU))
    params["rope_cos"], params["rope_sin"] = port_model.rope_tables(64, 16, cfg.rope_theta,
                                                                    device=CPU)
    shape = (2, MAX, 2, 16)
    g = torch.Generator().manual_seed(4)
    caches = [(torch.randn(shape, generator=g) * 0.5).to(torch.bfloat16) for _ in range(2)]
    for pos in POSITIONS:
        (li, ki, vi), (lt, kt, vt) = _both_ways(
            lambda kc, vc, p: port_model.fused_decode_step_fn(cfg, params, kc, vc, 5, p),
            caches, pos)
        assert torch.equal(li, lt) and _same_bits(ki, kt) and _same_bits(vi, vt), pos
    with pytest.raises(ValueError, match="one int32 element"):
        port_model.fused_decode_step_fn(cfg, params, caches[0], caches[1], 5,
                                        torch.tensor([3], dtype=torch.int64))


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_captured_model_step_is_the_eager_step_bitwise(kv):
    """``decode_step`` (the captured executable over the model's caches,
    pos and token through ``decode_buffers``) against the eager
    ``decode_step_fn`` from the same cache state, step by step."""
    cfg = TransformerConfig(**DEV_CFG)
    dtype, kv_dtype = KV[kv]
    eager = CausalTransformerModel(cfg, init_params(cfg, 5, dtype, CPU), dtype=dtype,
                                   kv_dtype=kv_dtype)
    graph = CausalTransformerModel(cfg, eager.params, dtype=dtype, kv_dtype=kv_dtype)
    for m in (eager, graph):
        m.init_fixed_cache(MAX)
        m.prefill([4, 8, 15, 16, 23])
    exe = graph._ensure_decode_exe()
    assert exe.node_count > 0 and graph._ensure_decode_exe() is exe
    tok = 42
    for _ in range(4):
        le = port_model.decode_step_fn(cfg, eager.params, eager.k_cache, eager.v_cache, tok,
                                       eager.pos)
        eager.pos += 1
        lg = graph.decode_step(tok)
        assert torch.equal(le, lg) and eager.pos == graph.pos
        assert _same_bits(eager.k_cache, graph.k_cache)
        assert _same_bits(eager.v_cache, graph.v_cache)
        assert int(graph.decode_buffers.sampled) == int(torch.argmax(le))
        tok = int(torch.argmax(le))
    assert exe.stats.replays == 4 and graph.logits_finite()
    graph.init_fixed_cache(MAX)                     # new caches: the executable is released
    assert graph.graphs.executables() == {} and graph.decode_buffers is None
    with pytest.raises(RuntimeError, match="after reset"):
        exe.replay()


def test_kv_write_takes_one_tensor_start():
    c = torch.zeros(2, 8, 3)
    rows = torch.ones(1, 3, 3)
    port_model.kv_write(c, rows, (1, torch.tensor([7]), 0))     # clamped to 8 - 3
    assert torch.equal(c[1, 5:], torch.ones(3, 3)) and c.sum() == 9
    with pytest.raises(ValueError, match="one tensor start"):
        port_model.kv_write(c, rows, (torch.tensor([0]), torch.tensor([1]), 0))
    assert kv_leaf(c) is c
