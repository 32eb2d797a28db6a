"""The port's serving slice against the JAX package, end to end on tiny
models: the same numpy-seeded params go through both.

- f32 dense model (the tests/test_serving.py config): the JAX engine runs its
  batch-rows step with the Pallas row write and attention (interpret mode);
  greedy streams must be identical and prefill logits agree at rtol 1e-4.
- int4 model with an int8 head: JAX on the CPU takes its w4a16 dequant route
  while the port computes w4a8, so logits agree within the int8-activation
  envelope: 3e-2 of max |logit|.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygpukit_tpu.llm import CausalTransformerModel as JaxModel
from pygpukit_tpu.llm import TransformerConfig as JaxConfig
from pygpukit_tpu.llm import init_params as jax_init_params
from pygpukit_tpu.llm.model import fuse_params as jax_fuse_params
from pygpukit_tpu.llm.quant import quantize_model_params as jax_quantize_model
from pygpukit_tpu.llm.serving import ContinuousBatchingEngine as JaxEngine
from pygpukit_tpu_torch.llm import (CausalTransformerModel,
                                    ContinuousBatchingEngine, TransformerConfig,
                                    params_from_jax)

torch.set_num_threads(2)

F32_CFG = dict(vocab_size=97, hidden_size=48, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=96, head_dim_override=12,
               max_position_embeddings=256, tie_word_embeddings=True)
PROMPTS = [[5, 11, 42], [7, 3], [9, 9, 1, 4, 60, 2, 8], [1, 2]]
N_NEW = [8, 8, 6, 9]


def _pair(cfg_kw, quant=None, seed=5, dtype="f32"):
    """(JAX model, port model) over identical params."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = JaxConfig(**cfg_kw)
    params = jax_init_params(jcfg, seed, jdt)
    if quant:
        params = jax_quantize_model(params, quant)
    jm = JaxModel(jcfg, jax_fuse_params(params), dtype=jdt)
    tm = CausalTransformerModel(TransformerConfig(**cfg_kw),
                                params_from_jax(jax.tree.map(np.asarray, jm.params)),
                                dtype=tdt)
    return jm, tm


@pytest.fixture(scope="module")
def f32_pair():
    return _pair(F32_CFG)


def _jax_serve(jm, monkeypatch, steps):
    monkeypatch.setenv("PYGPUKIT_SERVING_STEP", "batch")
    monkeypatch.setenv("PYGPUKIT_KV_WRITE", "pallas")
    monkeypatch.setenv("PYGPUKIT_BATCH_ATTN", "pallas")
    eng = JaxEngine(jm, max_batch=3, max_seq_len=128, steps_per_dispatch=steps)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, N_NEW)]
    eng.run_until_complete()
    return [r.generated for r in reqs]


def _port_serve(tm, steps):
    eng = ContinuousBatchingEngine(tm, max_batch=3, max_seq_len=128,
                                   steps_per_dispatch=steps)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, N_NEW)]
    eng.run_until_complete()
    assert all(r.done for r in reqs) and eng.logits_finite()
    assert eng.stats.requests_completed == len(PROMPTS)
    return [r.generated for r in reqs]


@pytest.mark.parametrize("steps", [1, 4])
def test_engine_streams_match_jax(f32_pair, monkeypatch, steps):
    """Four requests through three slots (one waits for a free slot)."""
    jm, tm = f32_pair
    assert _port_serve(tm, steps) == _jax_serve(jm, monkeypatch, steps)


@pytest.mark.parametrize("extra", [dict(sliding_window=5),
                                   dict(attn_logit_softcap=2.0)])
def test_engine_window_and_softcap_match_jax(monkeypatch, extra):
    """Sliding-window (every layer) and attention-softcap configs through
    prefill, the row write and the batched attention of both engines."""
    jm, tm = _pair(dict(F32_CFG, **extra), seed=8)
    assert _port_serve(tm, 4) == _jax_serve(jm, monkeypatch, 4)
    jm.init_fixed_cache(128)
    tm.init_fixed_cache(128)
    np.testing.assert_allclose(tm.prefill(PROMPTS[2]).numpy(),
                               np.asarray(jm.prefill(PROMPTS[2])),
                               rtol=1e-4, atol=1e-5)


def test_generate_and_prefill_logits_match_jax(f32_pair):
    jm, tm = f32_pair
    for prompt, n in zip(PROMPTS, N_NEW):
        jm.init_fixed_cache(128)
        tm.init_fixed_cache(128)
        assert tm.generate(prompt, max_new_tokens=n) == \
            jm.generate(prompt, max_new_tokens=n)
        jm.init_fixed_cache(128)
        tm.init_fixed_cache(128)
        ref = np.asarray(jm.prefill(prompt))
        np.testing.assert_allclose(tm.prefill(prompt).numpy(), ref,
                                   rtol=1e-4, atol=1e-5)


def test_engine_matches_single_stream_generate(f32_pair):
    _, tm = f32_pair
    streams = _port_serve(tm, 4)
    for prompt, n, got in zip(PROMPTS, N_NEW, streams):
        tm.init_fixed_cache(128)
        assert tm.generate(prompt, max_new_tokens=n) == got


def test_int4_model_logits_within_int8_envelope(monkeypatch):
    """Prefill and two decode steps' logits against the JAX model with the
    int8 head on its w8a8 route (the port's only int8 route)."""
    monkeypatch.setenv("PYGPUKIT_INT8_MODE", "w8a8")
    cfg = dict(F32_CFG, tie_word_embeddings=False)
    jm, tm = _pair(cfg, quant="int4", seed=3, dtype="bf16")
    assert tm.params["lm_head"]["q"].dtype == torch.int8
    assert tm.params["layers"]["w_qkv"]["q_packed"].dtype == torch.uint8
    jm.init_fixed_cache(64)
    tm.init_fixed_cache(64)
    ref, got = np.asarray(jm.prefill(PROMPTS[2])), tm.prefill(PROMPTS[2]).numpy()
    for tok in (17, 40, None):
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 3e-2 * scale, np.abs(got - ref).max() / scale
        if tok is not None:
            ref = np.asarray(jm.decode_step(tok))
            got = tm.decode_step(tok).numpy()


def test_unported_options_raise(f32_pair):
    _, tm = f32_pair
    for kw in (dict(mesh=object()), dict(mesh=object(), paged=True)):
        with pytest.raises(NotImplementedError):
            ContinuousBatchingEngine(tm, max_batch=2, max_seq_len=64, **kw)
    with pytest.raises(NotImplementedError):      # an activation outside the set
        CausalTransformerModel(TransformerConfig(**dict(F32_CFG, activation="relu")),
                               tm.params)
    params = tm.params
    params["layers"] = dict(params["layers"], act_gamma=params["layers"]["attn_norm_w"])
    with pytest.raises(NotImplementedError, match="act_gamma"):
        CausalTransformerModel(TransformerConfig(**F32_CFG), params)


def test_sampled_engine_is_seeded(f32_pair):
    """temperature/top-k draws come from the engine's generator: the same
    seed replays the same streams."""
    _, tm = f32_pair
    runs = []
    for _ in range(2):
        eng = ContinuousBatchingEngine(tm, max_batch=2, max_seq_len=64,
                                       steps_per_dispatch=3, temperature=0.8,
                                       top_k=5, seed=11)
        reqs = [eng.submit(p, max_new_tokens=5) for p in PROMPTS[:3]]
        eng.run_until_complete()
        runs.append([r.generated for r in reqs])
    assert runs[0] == runs[1]
    assert all(len(s) == 5 for s in runs[0])


def test_import_leaves_jax_out():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, pygpukit_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('pygpukit_tpu.') or m == 'pygpukit_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
