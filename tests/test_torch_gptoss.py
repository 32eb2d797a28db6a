"""The port's gpt-oss family (``pygpukit_tpu_torch/llm/models/gptoss.py``)
against the JAX package's (``pygpukit_tpu/llm/models/gptoss.py``) on the
CPU, on the tiny transformers model of ``tests/test_llm_families.py``
(4 layers alternating sliding window 8 and full, yarn with truncate
False, 4 experts top-2), loaded by both packages in f32:

- ``_sink_softmax``, ``_attn_windowed`` at a window shorter than the keys
  (prefill and decode positions), ``_moe``: within rtol/atol 1e-5;
- logits within rtol/atol 1e-4 of the reference's and of transformers',
  the K/V caches after a prefill within rtol 1e-5, greedy ``generate``
  token-equal with chunks that split the run;
- the experts' gmm and gather formulations with the biases and the
  clamped activation between the products against the one-hot plain
  version; the config, the rope tables and ``params_from_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from pygpukit_tpu.llm.models import gptoss as jgo
from pygpukit_tpu_torch.llm import params_from_jax
from pygpukit_tpu_torch.llm.models import GptOssModel
from pygpukit_tpu_torch.llm.models import gptoss as tgo
from pygpukit_tpu_torch.ops import moe

torch.set_num_threads(2)

PROMPT = list(range(1, 21))      # past the window and past original_max / 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("gptoss")
    cfg = transformers.GptOssConfig(
        vocab_size=96, hidden_size=32, intermediate_size=48, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8, num_local_experts=4,
        num_experts_per_tok=2, sliding_window=8,
        layer_types=["sliding_attention", "full_attention"] * 2,
        rope_scaling={"rope_type": "yarn", "factor": 4.0,
                      "original_max_position_embeddings": 16, "beta_fast": 32.0,
                      "beta_slow": 1.0, "truncate": False},
        max_position_embeddings=64, tie_word_embeddings=False, pad_token_id=0,
        attn_implementation="eager")
    torch.manual_seed(14)
    hf = transformers.GptOssForCausalLM(cfg).eval()
    hf.save_pretrained(path, safe_serialization=True)
    jm = jgo.GptOssModel.from_safetensors(path, dtype=jnp.float32)
    tm = GptOssModel.from_safetensors(path, dtype=torch.float32, device="cpu")
    return hf, jm, tm


def _layer(jm, tm, i):
    return (jax.tree.map(lambda a: a[i], jm.params["layers"]),
            {k: v[i] for k, v in tm.params["layers"].items()})


def _rows(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_config_windows_and_rope_tables(pair):
    _, jm, tm = pair
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    assert tm.params["layers"]["attn_window"].tolist() == [8, 0, 8, 0]
    for name in ("rope_cos", "rope_sin"):
        np.testing.assert_allclose(tm.params[name].numpy(), np.asarray(jm.params[name]),
                                   rtol=1e-6, atol=1e-6)


def test_logits_match_the_reference_and_transformers(pair):
    hf, jm, tm = pair
    got = tm.get_logits(PROMPT)
    np.testing.assert_allclose(got, np.asarray(jm.get_logits(PROMPT)), rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        ref = hf(torch.tensor([PROMPT])).logits[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [3, 4])
def test_greedy_generate_matches_the_reference(pair, chunk):
    _, jm, tm = pair
    jm.k_cache = None
    tm.max_seq_len = None
    assert tm.generate(PROMPT, 8, chunk_size=chunk) == jm.generate(PROMPT, 8, chunk_size=chunk)


def test_kv_caches_after_prefill(pair):
    _, jm, tm = pair
    jm.init_fixed_cache(64)
    tm.init_fixed_cache(64)
    tokens = np.zeros(32, np.int32)
    tokens[:len(PROMPT)] = PROMPT
    jk, jv, jl = jgo.prefill_fn(jm.config, jm.params, jm.k_cache, jm.v_cache,
                                jnp.asarray(tokens), jnp.int32(len(PROMPT)))
    tl = tgo.prefill_fn(tm.config, tm.params, tm.k_cache, tm.v_cache,
                        torch.from_numpy(tokens), len(PROMPT))
    np.testing.assert_allclose(tm.k_cache.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.v_cache.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


def test_sink_softmax_matches_the_reference():
    scores = _rows(1, 4, 5, 9) * 3
    sinks = _rows(2, 4)
    mask = np.tril(np.ones((5, 9), bool), 4)[None]
    ref = jgo._sink_softmax(jnp.asarray(scores), jnp.asarray(sinks), jnp.asarray(mask))
    got = tgo._sink_softmax(torch.from_numpy(scores), torch.from_numpy(sinks),
                            torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert (got.sum(-1) < 1).all()           # the sink keeps some of the mass


@pytest.mark.parametrize("layer", [0, 1])    # window 8 (shorter than the 20 keys), full
@pytest.mark.parametrize("pos_q,t", [(0, 20), (19, 1), (12, 3)])
def test_windowed_attention_matches_the_reference(pair, layer, pos_q, t):
    _, jm, tm = pair
    jlp, tlp = _layer(jm, tm, layer)
    q, k, v = _rows(3, t, 4, 8), _rows(4, 20, 2, 8), _rows(5, 20, 2, 8)
    ref = jgo._attn_windowed(jm.config, jlp, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             pos_q, pos_q + t)
    got = tgo._attn_windowed(tm.config, tlp, torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), pos_q, pos_q + t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("layer", [0, 3])
def test_moe_matches_the_reference(pair, layer):
    _, jm, tm = pair
    jlp, tlp = _layer(jm, tm, layer)
    x = _rows(6, 9, 32) * 4                   # large enough that the clamps bite
    ref = jgo._moe(jm.config, jlp, jnp.asarray(x))
    got = tgo._moe(tm.config, tlp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("route", ["gmm", "gather"])
def test_expert_routes_match_the_one_hot_plain_version(pair, dtype, route):
    """``gmm_experts`` / ``gather_experts`` with the gate/up bias, the clamps
    and the gated product between the products and the down bias after,
    against ``_moe``'s plain version: f32 within 1e-5, bf16 within 2e-2
    of max |out| (the routes round the activation to bf16)."""
    _, _, tm = pair
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    lp = {k: (v.to(dt) if k.startswith(("w_experts", "b_experts")) else v)
          for k, v in tm.params["layers"].items()}
    lp = {k: v[1] for k, v in lp.items()}
    cfg = tm.config
    x = (torch.from_numpy(_rows(7, 70, 32)) * 4).to(dt)
    plain = tgo._moe(cfg, lp, x).to(torch.float32)     # CPU tensors: the plain version
    logits = torch.matmul(x.float(), lp["w_router"]) + lp["b_router"]
    topv, topi = moe.top_k_fn(logits, cfg.num_experts_per_tok)
    fn = moe.gmm_experts if route == "gmm" else moe.gather_experts
    got = fn(x, (lp["w_experts_gate_up"],), lp["w_experts_down"], torch.softmax(topv, -1),
             topi, tgo._expert_act(cfg, lp, x.dtype), down_bias=lp["b_experts_down"])
    tol = 1e-5 if dtype == "f32" else 2e-2
    assert (got - plain).abs().max() <= tol * plain.abs().max()


def test_params_from_jax_is_byte_exact(pair):
    """The reference's tree (``layers`` with the int32 ``attn_window``, the
    stacked expert parameters, the rope tables) carried across bit for
    bit; a model on it gives the reference's logits."""
    _, jm, tm = pair
    host = jax.tree.map(np.asarray, jm.params)
    got = params_from_jax(host)
    for path, leaf in jax.tree_util.tree_flatten_with_path(host)[0]:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.numpy().tobytes() == np.ascontiguousarray(leaf).tobytes()
    assert got["lm_head"] is not None and set(got["layers"]) == set(host["layers"])
    model = GptOssModel(tm.config, got, dtype=torch.float32)
    np.testing.assert_allclose(model.get_logits(PROMPT), np.asarray(jm.get_logits(PROMPT)),
                               **TOL)


def test_tied_head_is_a_none_leaf():
    """A tied head: ``lm_head`` None in both trees, the embedding's
    transpose in the logits."""
    cfg = tgo.GptOssConfig(vocab_size=40, hidden_size=16, num_layers=2, num_heads=2,
                           num_kv_heads=1, head_dim=8, intermediate_size=8, num_experts=2,
                           num_experts_per_tok=1, sliding_window=4,
                           layer_types=("sliding_attention", "full_attention"),
                           max_position_embeddings=32, tie_word_embeddings=True)
    p = tgo.init_params(cfg, 1, torch.float32, "cpu")
    assert p["lm_head"] is None and params_from_jax({"lm_head": None})["lm_head"] is None
    model = GptOssModel(cfg, p)
    logits = model.get_logits([1, 2, 3, 4, 5, 6])
    assert logits.shape == (6, 40) and np.isfinite(logits).all()
    assert len(model.generate([1, 2, 3], 5)) == 5
