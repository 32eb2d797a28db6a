"""The port's LFM2 (``pygpukit_tpu_torch/llm/models/lfm2.py``) against the
JAX package on the CPU, on the tiny transformers model of
``tests/test_llm_families.py::TestLfm2`` (4 layers: conv, attention, conv,
attention; L_cache 3; seed 30), loaded by both packages in f32:

- logits within rtol/atol 1e-4 of the reference's and of transformers',
  greedy tokens equal to both;
- the hybrid caches' shapes and dtypes exact (``init_caches``), the
  prefill's K/V rows and conv states and one decode step against the
  reference's functions, prompts shorter and longer than L_cache;
- ``Lfm2Config.from_hf`` (the ``block_auto_adjust_ff_dim`` rule with its
  multiplier and ``multiple_of``), ``params_from_jax`` of the reference's
  tree (byte-exact), ``init_params``'s tree;
- on the CPU the decode attention takes the plain route; at LFM2-1.2B's
  shape with bf16 caches on the card the route is the flash_decode kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from pygpukit_tpu.llm.models import lfm2 as jlf
from pygpukit_tpu_torch.llm import params_from_jax
from pygpukit_tpu_torch.llm.models import Lfm2Config, Lfm2Model
from pygpukit_tpu_torch.llm.models import lfm2 as tlf
from pygpukit_tpu_torch.ops.nn.attention import fixed_cache_route

torch.set_num_threads(2)

PROMPT = [1, 7, 23, 5, 9]
TYPES = ["conv", "full_attention", "conv", "full_attention"]


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    path = tmp_path_factory.mktemp("lfm2")
    cfg = transformers.Lfm2Config(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, layer_types=TYPES, conv_L_cache=3,
        block_auto_adjust_ff_dim=False, max_position_embeddings=64, tie_word_embeddings=True,
        pad_token_id=0)
    torch.manual_seed(30)
    hf = transformers.Lfm2ForCausalLM(cfg).eval()
    hf.save_pretrained(path, safe_serialization=True)
    return (hf, jlf.Lfm2Model.from_safetensors(path, dtype=jnp.float32),
            Lfm2Model.from_safetensors(path, dtype=torch.float32, device="cpu"))


def test_config_and_rope_tables(trio):
    _, jm, tm = trio
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    assert tm.config.layer_types[0] == "conv" and tm.config.is_attn(1)
    for name in ("rope_cos", "rope_sin"):
        np.testing.assert_allclose(tm.params[name].numpy(), np.asarray(jm.params[name]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hf", [
    {"block_auto_adjust_ff_dim": True, "intermediate_size": 12288,
     "block_ffn_dim_multiplier": 1.0, "block_multiple_of": 256},
    {"block_auto_adjust_ff_dim": True, "intermediate_size": 1000, "block_multiple_of": 64},
    {"block_auto_adjust_ff_dim": True, "intermediate_size": 4608,
     "block_ffn_dim_multiplier": 1.5},
    {"intermediate_size": 300, "num_attention_heads": 8, "hidden_size": 256,
     "layer_types": ["conv", "full_attention"], "num_hidden_layers": 2}])
def test_from_hf(hf):
    got = Lfm2Config.from_hf(hf)
    assert dataclasses.asdict(got) == dataclasses.asdict(jlf.Lfm2Config.from_hf(hf))
    if hf.get("intermediate_size") == 12288:
        assert got.intermediate_size == 8192         # LFM2-1.2B's MLP


@pytest.mark.parametrize("prompt", [PROMPT, [4], list(range(3, 40))])
def test_logits_match_the_reference_and_transformers(trio, prompt):
    hf, jm, tm = trio
    got = tm.get_logits(prompt)
    np.testing.assert_allclose(got, np.asarray(jm.get_logits(prompt)), rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        ref = hf(torch.tensor([prompt])).logits[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_greedy_tokens_match_the_reference_and_transformers(trio):
    hf, jm, tm = trio
    out = tm.generate(PROMPT, max_new_tokens=8)
    assert out == [int(t) for t in jm.generate(PROMPT, max_new_tokens=8)]
    hf_out = hf.generate(torch.tensor([PROMPT]), max_new_tokens=8, do_sample=False,
                         pad_token_id=0)[0, 5:].tolist()
    assert out == hf_out


def test_conv_cache_shape():
    cfg = Lfm2Config(hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
                     layer_types=("conv", "full_attention"), conv_l_cache=3)
    caches = tlf.init_caches(cfg, 64, torch.bfloat16, "cpu")
    ref = jlf.init_caches(jlf.Lfm2Config(**dataclasses.asdict(cfg)), 64, jnp.float32)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in caches] == \
        [{k: tuple(v.shape) for k, v in c.items()} for c in ref]
    assert caches[0]["conv"].shape == (32, 3) and caches[1]["k"].shape == (64, 2, 8)
    assert all(v.dtype == torch.bfloat16 for c in caches for v in c.values())


@pytest.mark.parametrize("n", [1, 2, 3, 6])
def test_prefill_caches_and_decode_step_match_the_reference(trio, n):
    """A padded prefill of n tokens (conv states zero-filled below L_cache),
    then two decode steps: K/V rows, conv states and logits against the
    reference's functions."""
    _, jm, tm = trio
    cfg, jcfg = tm.config, jm.config
    tc = tlf.init_caches(cfg, 32, torch.float32, "cpu")
    jc = jlf.init_caches(jcfg, 32, jnp.float32)
    toks = np.zeros(16, np.int32)
    toks[:n] = [3, 17, 29, 41, 8, 60][:n]
    tc, tl = tlf.prefill_fn(cfg, tm.params, tc, torch.from_numpy(toks), n)
    jc, jl = jlf.prefill_fn(jcfg, jm.params, jc, jnp.asarray(toks), jnp.int32(n))
    for step, tok in enumerate((None, 11, 40)):
        if tok is not None:
            pos = n + step - 1
            tc, tl = tlf.decode_step_fn(cfg, tm.params, tc, tok, pos)
            jc, jl = jlf.decode_step_fn(jcfg, jm.params, jc, jnp.int32(tok), jnp.int32(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        for a, b in zip(tc, jc):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), rtol=1e-4, atol=1e-5)


def test_decode_step_with_a_device_position_is_the_int_path(trio):
    """``pos`` as a one-element int32 tensor (what a captured step reads)
    gives the int path's bits."""
    _, _, tm = trio
    cfg = tm.config
    out = []
    for pos in (7, torch.tensor([7], dtype=torch.int32)):
        caches = tlf.init_caches(cfg, 32, torch.float32, "cpu")
        toks = torch.tensor(list(range(1, 8)) + [0] * 9, dtype=torch.int32)
        tlf.prefill_fn(cfg, tm.params, caches, toks, 7)
        _, logits = tlf.decode_step_fn(cfg, tm.params, caches, 12, pos)
        out.append((logits, caches))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_params_from_jax_converts_the_list_tree(trio):
    _, jm, tm = trio
    tree = jax.tree.map(np.asarray, {k: v for k, v in jm.params.items()
                                     if not k.startswith("rope")})
    tp = params_from_jax(tree)
    assert isinstance(tp["layers"], list) and tp["lm_head"] is None
    for lt, lj in zip(tp["layers"], tree["layers"]):
        assert set(lt) == set(lj)
        for k, v in lj.items():
            assert lt[k].numpy().tobytes() == v.tobytes() and tuple(lt[k].shape) == v.shape
    mine = tlf.init_params(tm.config, seed=0, dtype=torch.float32, device="cpu")
    assert [{k: tuple(v.shape) for k, v in lp.items()} for lp in mine["layers"]] == \
        [{k: tuple(v.shape) for k, v in lp.items()} for lp in tp["layers"]]
    model = Lfm2Model(tm.config, tp)
    np.testing.assert_allclose(model.get_logits(PROMPT), np.asarray(jm.get_logits(PROMPT)),
                               rtol=1e-4, atol=1e-4)


def test_decode_attention_routes():
    """LFM2-1.2B's decode attention (one query row, 32/8 heads, D 64,
    bf16 caches, a device ctx_len) is the flash_decode kernel on the card;
    every CPU tensor takes the plain route."""
    assert fixed_cache_route("cuda", 1, 32, 8, 64, torch.bfloat16, torch.bfloat16,
                             torch.bfloat16) == "kernel"
    assert fixed_cache_route("cpu", 1, 32, 8, 64, torch.bfloat16, torch.bfloat16,
                             torch.bfloat16) == "plain"
