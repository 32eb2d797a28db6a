"""The port's uncached forward and its generation routes against the JAX
package on tiny models, the same numpy-seeded params in both:

- ``get_logits`` (and ``model(ids)``) at rtol 1e-4, atol 1e-5 on the f32
  model, from S 3 up to S 600 (past the 512-key chunk of the plain
  attention route), with a sliding window and an attention softcap too;
- an int4 model (int8 head) through the quantized prefill routes, within
  the int8-activation envelope of ``test_torch_slice.py``: 3e-2 of max
  |logit|;
- greedy ``generate(use_cache=False)`` token for token;
- top-p: a seeded replay gives the same stream, and on fixed logits no
  draw leaves the reference's nucleus.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygpukit_tpu.llm import CausalTransformerModel as JaxModel
from pygpukit_tpu.llm import TransformerConfig as JaxConfig
from pygpukit_tpu.llm import init_params as jax_init_params
from pygpukit_tpu.llm.model import fuse_params as jax_fuse_params
from pygpukit_tpu.llm.quant import quantize_model_params as jax_quantize_model
from pygpukit_tpu.ops.sampling import sample_topp_fn as jax_sample_topp
from pygpukit_tpu_torch.kernels import LAUNCHES
from pygpukit_tpu_torch.llm import (CausalTransformerModel, TransformerConfig,
                                    forward_fn, params_from_jax, sample_logits)
from pygpukit_tpu_torch.ops.sampling import sample_topp_fn, topp_mask_fn

torch.set_num_threads(2)

LONG_CFG = dict(vocab_size=97, hidden_size=48, num_layers=2, num_heads=4,
                num_kv_heads=2, intermediate_size=96, head_dim_override=12,
                max_position_embeddings=1024, tie_word_embeddings=True)


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
def long_pair():
    return _pair(LONG_CFG)


def _ids(n, vocab=97, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, n).tolist()


@pytest.mark.parametrize("s", [1, 3, 77, 512, 513, 600])
def test_get_logits_matches_jax(long_pair, s):
    jm, tm = long_pair
    ids = _ids(s, seed=s)
    ref = jm.get_logits(ids)
    got = tm.get_logits(ids)
    assert got.dtype == np.float32 and got.shape == (s, 97)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("extra", [dict(sliding_window=100),
                                   dict(sliding_window=100,
                                        layer_types=["sliding_attention",
                                                     "full_attention"]),
                                   dict(attn_logit_softcap=2.0)])
@pytest.mark.parametrize("s", [40, 600])
def test_get_logits_window_and_softcap_match_jax(extra, s):
    jm, tm = _pair(dict(LONG_CFG, **extra), seed=8)
    ids = _ids(s, seed=1)
    np.testing.assert_allclose(tm.get_logits(ids), jm.get_logits(ids),
                               rtol=1e-4, atol=1e-5)


def test_call_is_the_forward(long_pair):
    _, tm = long_pair
    ids = _ids(20)
    out = tm(ids)
    assert out.dtype == torch.float32 and out.shape == (20, 97)
    ref = forward_fn(tm.config, tm.params, torch.tensor(ids))
    assert torch.equal(out, ref)
    assert not out.requires_grad


def test_forward_last_row_is_prefill(long_pair):
    """Cached prefill (full softmax) and the forward's last row agree."""
    _, tm = long_pair
    ids = _ids(600, seed=2)
    tm.init_fixed_cache(1024)
    np.testing.assert_allclose(tm.prefill(ids).numpy(), tm.get_logits(ids)[-1],
                               rtol=1e-4, atol=1e-5)


def test_int4_forward_within_int8_envelope(monkeypatch):
    monkeypatch.setenv("PYGPUKIT_INT8_MODE", "w8a8")
    jm, tm = _pair(dict(LONG_CFG, tie_word_embeddings=False), quant="int4", seed=3,
                   dtype="bf16")
    assert tm.params["layers"]["w_qkv"]["q_packed"].dtype == torch.uint8
    ids = _ids(40, seed=4)
    ref, got = jm.get_logits(ids), tm.get_logits(ids)
    assert np.abs(got - ref).max() <= 3e-2 * np.abs(ref).max()


@pytest.mark.parametrize("prompt,n", [([5, 11, 42], 8), ([9, 9, 1, 4, 60, 2, 8], 6)])
def test_uncached_greedy_generate_matches_jax(long_pair, prompt, n):
    jm, tm = long_pair
    before = LAUNCHES["flash_attention"]
    got = tm.generate(prompt, max_new_tokens=n, use_cache=False)
    assert got == jm.generate(prompt, max_new_tokens=n, use_cache=False)
    assert LAUNCHES["flash_attention"] == before          # CPU: the plain route
    tm.init_fixed_cache(128)
    assert got == tm.generate(prompt, max_new_tokens=n)   # the cached path too


def test_uncached_generate_stops_at_eos(long_pair):
    _, tm = long_pair
    stream = tm.generate([5, 11, 42], max_new_tokens=8, use_cache=False)
    eos = stream[2]
    first = stream.index(eos)
    assert tm.generate([5, 11, 42], max_new_tokens=8, use_cache=False,
                       eos_token_id=eos) == stream[:first + 1]


@pytest.mark.parametrize("use_cache", [True, False])
def test_top_p_generate_replays_under_its_seed(long_pair, use_cache):
    _, tm = long_pair
    runs = []
    for seed in (11, 11, 12):
        tm.init_fixed_cache(128)
        runs.append(tm.generate([5, 11, 42], max_new_tokens=10, temperature=0.9,
                                top_p=0.8, seed=seed, use_cache=use_cache))
    assert runs[0] == runs[1] and len(runs[0]) == 10
    assert runs[0] != runs[2]


def _nucleus(logits, p, temperature):
    """The reference's rule in numpy: sorted descending, keep a token while
    the cumulative probability before it is at most p."""
    lf = logits.astype(np.float64) / temperature
    order = np.argsort(-lf, kind="stable")
    probs = np.exp(lf[order] - lf[order].max())
    probs /= probs.sum()
    before = np.cumsum(probs) - probs
    return set(order[before <= p].tolist())


@pytest.mark.parametrize("p,temperature", [(0.5, 1.0), (0.9, 0.7), (0.05, 1.0)])
def test_top_p_never_draws_outside_the_nucleus(p, temperature):
    logits = np.random.default_rng(9).standard_normal(50).astype(np.float32) * 3
    keep = _nucleus(logits, p, temperature)
    assert 1 <= len(keep) < 50
    # the JAX sampler's draws fall inside this nucleus too
    keys = jax.random.split(jax.random.PRNGKey(0), 200)
    jax_draws = {int(jax_sample_topp(jnp.asarray(logits), k, p, temperature)) for k in keys}
    assert jax_draws <= keep
    masked = topp_mask_fn(torch.from_numpy(logits), p, temperature)
    assert set(torch.nonzero(masked > -1e29).flatten().tolist()) == keep
    gen = torch.Generator().manual_seed(1)
    draws = sample_topp_fn(torch.from_numpy(logits).expand(2000, 50), gen, p, temperature)
    assert set(draws.tolist()) <= keep
    one = sample_logits(torch.from_numpy(logits), temperature, 0,
                        torch.Generator().manual_seed(1), p)
    assert int(one) in keep


def test_top_k_takes_precedence_over_top_p():
    logits = torch.arange(10, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    draws = {int(sample_logits(logits, 1.0, 2, gen, 0.01)) for _ in range(100)}
    assert draws == {8, 9}
