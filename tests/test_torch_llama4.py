"""The port's Llama-4 text model (``pygpukit_tpu_torch/llm/models/llama4.py``)
and its ops (``ops/nn/llama4.py``, ``qk_l2norm_fn`` and ``groupnorm`` in
``ops/nn/norm.py``) against the JAX package on the CPU, on the tiny
transformers model of ``tests/test_llm_families.py::TestLlama4`` (4 layers,
layer 3 NoPE, seed 4), loaded by both packages in f32:

- logits within rtol/atol 1e-4 of the reference's and of transformers',
  greedy tokens equal to both;
- the config (``from_json``'s ``text_config`` and ``intermediate_size_mlp``
  rule), the rope flags, ``params_from_jax`` of the reference's
  ``init_random`` tree (byte-exact, then the same logits);
- op by op on seeded inputs: the QK norm, groupnorm, the iRoPE temperature
  and its SDPA (GQA, ``causal_offset``), the Array wrappers.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from pygpukit_tpu.llm.models import llama4 as jl4
from pygpukit_tpu.ops.nn import llama4 as jops
from pygpukit_tpu.ops.nn import norm as jnorm
from pygpukit_tpu_torch.core.array import Array
from pygpukit_tpu_torch.llm import params_from_jax
from pygpukit_tpu_torch.llm.models import Llama4Config, Llama4Model
from pygpukit_tpu_torch.llm.models import llama4 as tl4
from pygpukit_tpu_torch.ops import nn as tnn

torch.set_num_threads(2)

PROMPT = [1, 7, 23]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("llama4")
    cfg = transformers.Llama4TextConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64, intermediate_size_mlp=64,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        max_position_embeddings=64, tie_word_embeddings=False, interleave_moe_layer_step=0,
        moe_layers=[], no_rope_layer_interval=4, use_qk_norm=True,
        attn_temperature_tuning=True, rope_scaling=None, attention_chunk_size=64)
    torch.manual_seed(4)
    hf = transformers.Llama4ForCausalLM(cfg).eval()
    hf.save_pretrained(path, safe_serialization=True)
    jm = jl4.Llama4Model.from_safetensors(path, dtype=jnp.float32)
    tm = Llama4Model.from_safetensors(path, dtype=torch.float32, device="cpu")
    return hf, jm, tm


def _rows(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _shapes(tree, prefix=""):
    """{path: shape or None} of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + k + "."))
        else:
            out[prefix + k] = None if v is None else (tuple(v.shape), v.dtype)
    return out


def test_config_and_rope_flags(pair):
    _, jm, tm = pair
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    assert tm.params["layers"]["use_rope"].tolist() == [1, 1, 1, 0]
    for name in ("rope_cos", "rope_sin"):
        np.testing.assert_allclose(tm.params[name].numpy(), np.asarray(jm.params[name]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prompt", [PROMPT, list(range(1, 20))])
def test_logits_match_the_reference_and_transformers(pair, prompt):
    hf, jm, tm = pair
    got = tm.forward(prompt).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.forward(prompt)), rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        ref = hf(torch.tensor([prompt])).logits[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_greedy_tokens_match_the_reference_and_transformers(pair):
    hf, jm, tm = pair
    out = tm.generate(PROMPT, max_new_tokens=6)
    assert out == jm.generate(PROMPT, max_new_tokens=6)
    hf_out = hf.generate(torch.tensor([PROMPT]), max_new_tokens=6, do_sample=False,
                         pad_token_id=0)[0, 3:].tolist()
    assert out == hf_out
    eos = out[2]
    assert tm.generate(PROMPT, max_new_tokens=6, eos_token_id=eos) == out[:out.index(eos) + 1]


def test_from_json_reads_the_text_config(tmp_path):
    """A multimodal config's ``text_config``; the dense MLP width from
    ``intermediate_size_mlp``, ``intermediate_size`` without it; the
    position cap of 2^20."""
    text = {"hidden_size": 64, "intermediate_size": 96, "intermediate_size_mlp": 128,
            "num_hidden_layers": 3, "no_rope_layers": [1, 0, 1], "attn_scale": 0.2,
            "max_position_embeddings": 1 << 24}
    for data in ({"text_config": text}, {k: v for k, v in text.items()
                                         if k != "intermediate_size_mlp"}):
        (tmp_path / "config.json").write_text(json.dumps(data))
        got = Llama4Config.from_json(tmp_path / "config.json")
        assert dataclasses.asdict(got) == dataclasses.asdict(
            jl4.Llama4Config.from_json(tmp_path / "config.json"))
    assert got.intermediate_size == 96 and got.max_position_embeddings == 1 << 20
    assert got.rope_flags() == [1, 0, 1]


def test_params_from_jax_and_init_params():
    """The reference's ``init_random`` tree converts byte-exactly (stacked,
    and as a per-layer list with 0-d ``use_rope`` leaves) and gives the
    reference's logits; ``init_params`` builds the same tree shape; a
    ``use_rope`` leaf that disagrees with the config raises."""
    cfg = jl4.Llama4Config(vocab_size=64, hidden_size=32, intermediate_size=48,
                           num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
                           head_dim=8, max_position_embeddings=32, no_rope_layers=[1, 0, 1])
    jm = jl4.Llama4Model.init_random(cfg, seed=3)
    tree = jax.tree.map(np.asarray, {k: v for k, v in jm.params.items()
                                     if not k.startswith("rope")})
    tp = params_from_jax(tree)
    for k, v in tree["layers"].items():
        assert tp["layers"][k].numpy().tobytes() == v.tobytes()
        assert tp["layers"][k].dtype == torch.from_numpy(v.copy()).dtype
    assert tp["lm_head"] is None
    # the per-layer list before stacking: 0-d int32 use_rope leaves stay 0-d
    per_layer = params_from_jax([{k: v[i] for k, v in tree["layers"].items()}
                                 for i in range(3)])
    assert [lp["use_rope"].shape for lp in per_layer] == [()] * 3
    assert [int(lp["use_rope"]) for lp in per_layer] == [1, 0, 1]
    assert per_layer[1]["use_rope"].dtype == torch.int32
    assert per_layer[2]["w_q"].numpy().tobytes() == tree["layers"]["w_q"][2].tobytes()
    tcfg = Llama4Config(**dataclasses.asdict(cfg))
    tm = Llama4Model(tcfg, tp)
    ids = list(range(3, 19))
    np.testing.assert_allclose(tm.forward(ids).numpy(), np.asarray(jm.forward(ids)),
                               rtol=1e-4, atol=1e-4)
    mine = tl4.init_params(tcfg, seed=0, device="cpu")
    assert _shapes(mine) == {k: v for k, v in _shapes(tp).items() if not k.startswith("rope")}
    bad = dict(mine, layers=dict(mine["layers"], use_rope=torch.ones(3, dtype=torch.int32)))
    with pytest.raises(ValueError, match="use_rope"):
        Llama4Model(tcfg, bad)


@pytest.mark.parametrize("shape, eps", [((5, 4, 8), 1e-6), ((3, 16), 1e-5), ((2, 3, 2, 64), 1e-6)])
def test_qk_l2norm_fn(shape, eps):
    x = _rows(1, *shape) * 3
    got = tnn.qk_l2norm_fn(torch.from_numpy(x), eps).numpy()
    np.testing.assert_allclose(got, np.asarray(jnorm.qk_l2norm_fn(jnp.asarray(x), eps)), **TOL)
    # the mean, not the sum: unit RMS rows
    np.testing.assert_allclose(np.sqrt(np.mean(got * got, -1)), 1.0, rtol=1e-4)
    # the true L2 norm keeps its own name and module
    l2 = tnn.l2norm_fn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.linalg.norm(l2, axis=-1), 1.0, rtol=1e-4)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_groupnorm_fn(groups):
    x = _rows(2, 2, 3, 5, 8) * 2 + 1
    w, b = _rows(3, 8), _rows(4, 8)
    got = tnn.groupnorm_fn(*map(torch.from_numpy, (x, w, b)), groups).numpy()
    want = jnorm.groupnorm_fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    arr = tnn.groupnorm(*map(torch.from_numpy, (x, w, b)), groups)
    assert isinstance(arr, Array)
    np.testing.assert_allclose(arr.to_numpy(), got, rtol=0, atol=0)


def test_irope_scale_fns():
    pos = np.arange(0, 40, 3, dtype=np.int32)
    got = tnn.irope_scale_fn(torch.from_numpy(pos), 0.3, 8.0).numpy()
    want = np.asarray(jops.irope_scale_fn(jnp.asarray(pos), 0.3, 8.0))
    np.testing.assert_allclose(got, want, **TOL)
    assert got[0] == 1.0 and got[-1] > 1.0
    q = _rows(5, len(pos), 3, 8)
    got = tnn.irope_scale_q_fn(torch.from_numpy(q), torch.from_numpy(pos), 0.3, 8.0).numpy()
    want = np.asarray(jops.irope_scale_q_fn(jnp.asarray(q), jnp.asarray(pos), 0.3, 8.0))
    np.testing.assert_allclose(got, want, **TOL)
    arr = tnn.irope_scale_q(torch.from_numpy(q), torch.from_numpy(pos), 0.3, 8.0)
    np.testing.assert_allclose(arr.to_numpy(), got, rtol=0, atol=0)


@pytest.mark.parametrize("hq, hk, s, sk, offset, attn_scale", [
    (4, 4, 6, 6, 0, 0.1), (4, 2, 6, 6, 0, 0.0), (8, 2, 5, 9, 4, 0.2), (6, 3, 7, 7, 0, 0.5)])
def test_sdpa_irope_fn(hq, hk, s, sk, offset, attn_scale):
    """Against the reference's formula: GQA by repeat, the temperature at
    a floor_scale of 4 (so it grows within the sequence), queries offset
    into a longer key run."""
    q, k, v = _rows(6, s, hq, 8), _rows(7, sk, hk, 8), _rows(8, sk, hk, 8)
    pos = np.arange(offset, offset + s, dtype=np.int32)
    got = tnn.sdpa_irope_fn(*map(torch.from_numpy, (q, k, v, pos)), attn_scale, 4.0,
                            offset).numpy()
    want = jops.sdpa_irope_fn(*map(jnp.asarray, (q, k, v, pos)), attn_scale, 4.0, offset)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    arr = tnn.sdpa_irope(*map(torch.from_numpy, (q, k, v, pos)), attn_scale, 4.0, offset)
    np.testing.assert_allclose(arr.to_numpy(), got, rtol=0, atol=0)


def test_llama4_l2norm_wrapper_is_the_qk_norm():
    from pygpukit_tpu_torch.ops.nn import llama4 as tops
    x = _rows(9, 4, 16) * 5
    got = tops.l2norm(torch.from_numpy(x)).to_numpy()
    np.testing.assert_allclose(got, np.asarray(jops.l2norm(x).to_numpy()), **TOL)
    np.testing.assert_allclose(got, tnn.qk_l2norm_fn(torch.from_numpy(x), 1e-6).numpy(),
                               rtol=0, atol=0)
