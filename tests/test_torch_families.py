"""The Qwen2, Qwen3, Qwen3-MoE, GPT-2, Gemma-2 and Gemma-3 families (and
Mistral's and Qwen2's sliding-window configs, and StarCoder2 and Seed-OSS,
whose features are all among theirs), the families the rope variants
bring (Llama-3.1's llama3 tables, Phi-3's longrope in both regimes, Qwen3
with yarn, GLM-4's interleaved partial rotary, Ernie 4.5's interleaved
pairs, SmolLM3's NoPE layers, Gemma-3 with linear scaling), and OLMo-2,
Cohere (with and without q/k norms), Granite, Nemotron, Apertus and Phi,
in the port against the JAX package and ``transformers`` on the CPU.

Every checkpoint is a tiny random ``transformers`` model written by
``save_pretrained`` (the configs of ``tests/test_llm_families.py``), its
matrices scaled up fourfold so that greedy streams vary. The port and the
JAX package load the same files at f32:

- logits within rtol 1e-4, atol 1e-4 of the JAX package's and of
  ``transformers``', six greedy tokens equal to both, and the leaves each
  family must load;
- int4 leaves of ``quantize_model_params`` bitwise the reference's;
- the reference's ``init_params`` for each family config, through
  ``params_from_jax``, gives the reference's forward, and the port's
  ``init_params`` builds the same leaves;
- every rope leaf (scaled, long, local, partial-width tables, the long
  threshold) within atol 1e-5 of the reference's;
- the block, norm, activation and head conventions (OLMo-2's
  post-norm-only blocks and whole-width q/k norms, Cohere's and Phi's
  parallel blocks, Granite's residual multiplier, the logit scale,
  Nemotron's relu2, Apertus's xIELU, Phi's lm-head bias): each family's
  config states them, and each alone on a Llama block gives the
  reference's forward;
- the fused decode step refuses every family here but the split-half
  ones with plain blocks (Llama-3.1, Phi-3), which it takes with their
  scaled tables;
- the four attention kernels take the plain version at head_dim 256, 96
  and 80 on CPU tensors, and learned positions and the embedding scale
  keep the reference's bits.

Cached steps and both engines: ``tests/test_torch_families_serving.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors
import safetensors.numpy as stnp
import torch
import transformers

import pygpukit_tpu.llm as rl
from pygpukit_tpu.llm import config as ref_config
from pygpukit_tpu.llm import model as ref_model
from pygpukit_tpu.llm import quant as ref_quant
import pygpukit_tpu_torch.llm as pl
from pygpukit_tpu_torch import kernels
from pygpukit_tpu_torch.kernels import _build
from pygpukit_tpu_torch.llm import config as port_config
from pygpukit_tpu_torch.llm import model as port_model

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
#: HF config class, its arguments, the spec the loader detects, the prompt
FAMILIES = {
    "qwen2": ("Qwen2Config", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        tie_word_embeddings=False), "qwen2", (1, 7, 23)),
    "qwen2_sliding": ("Qwen2Config", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, use_sliding_window=True,
        sliding_window=8, max_window_layers=2, max_position_embeddings=64,
        tie_word_embeddings=False, attn_implementation="eager"), "qwen2",
        tuple(range(1, 14))),
    "qwen3": ("Qwen3Config", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        max_position_embeddings=64, tie_word_embeddings=False), "qwen3", (1, 7, 23)),
    "qwen3_moe": ("Qwen3MoeConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8, num_experts=4,
        num_experts_per_tok=2, moe_intermediate_size=32, decoder_sparse_step=1,
        norm_topk_prob=True, max_position_embeddings=64, tie_word_embeddings=False),
        "qwen3_moe", (1, 7, 23)),
    "gpt2": ("GPT2Config", dict(vocab_size=96, n_positions=64, n_embd=32, n_layer=2,
                                n_head=4), "gpt2", (5, 23, 50, 7)),
    "gemma2": ("Gemma2Config", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        query_pre_attn_scalar=16, sliding_window=8, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, max_position_embeddings=64,
        attn_implementation="eager"), "gemma2", tuple(range(1, 13))),
    "gemma3": ("Gemma3TextConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=6,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        query_pre_attn_scalar=16, sliding_window=8, rope_theta=1000000.0,
        rope_local_base_freq=10000.0, max_position_embeddings=64,
        attn_implementation="eager"), "gemma3", tuple(range(1, 13))),
    # two families whose features are all among the above: GPT-2-style
    # blocks under rope (StarCoder2), biases on all four projections
    # (Seed-OSS)
    "starcoder2": ("Starcoder2Config", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        use_bias=True), "starcoder2", (1, 7, 23)),
    "seed_oss": ("SeedOssConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8, attention_bias=True,
        attention_out_bias=True, max_position_embeddings=64, tie_word_embeddings=False,
        pad_token_id=0), "seed_oss", (1, 7, 23)),
    "mistral_sliding": ("MistralConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, sliding_window=8,
        max_position_embeddings=64, tie_word_embeddings=False,
        attn_implementation="eager"), "llama", tuple(range(1, 14))),
    # the rope variants (tests/test_llm_families.py's configs): prompts past
    # original_max / 4 so that the scaled frequencies move the logits
    "llama31": ("LlamaConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        rope_theta=10000.0, rope_scaling={"rope_type": "llama3", "factor": 4.0,
                                          "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                          "original_max_position_embeddings": 16},
        tie_word_embeddings=False, eos_token_id=None), "llama", tuple(range(1, 25))),
    # longrope: the short regime (19 + 6 tokens under original_max 32); the
    # long one, a 39-token prompt, is phi3_long's
    "phi3": ("Phi3Config", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        tie_word_embeddings=False, pad_token_id=0, bos_token_id=1, eos_token_id=2,
        original_max_position_embeddings=32,
        rope_scaling={"type": "longrope", "short_factor": [1.0 + 0.05 * i for i in range(4)],
                      "long_factor": [1.5 + 0.3 * i for i in range(4)]}),
        "phi3", tuple(range(1, 20))),
    "qwen3_yarn": ("Qwen3Config", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        max_position_embeddings=128, rope_theta=10000.0,
        rope_scaling={"rope_type": "yarn", "factor": 4.0,
                      "original_max_position_embeddings": 32},
        tie_word_embeddings=False), "qwen3", tuple(range(1, 40))),
    "glm4": ("Glm4Config", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        partial_rotary_factor=0.5, attention_bias=True, head_dim=8,
        tie_word_embeddings=False, pad_token_id=0, eos_token_id=1), "glm4",
        tuple(range(1, 10))),
    "ernie45": ("Ernie4_5Config", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        head_dim=8, tie_word_embeddings=True, pad_token_id=0), "llama",
        tuple(range(1, 10))),
    "smollm3": ("SmolLM3Config", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        no_rope_layers=[1, 1, 1, 0], tie_word_embeddings=True, pad_token_id=0,
        eos_token_id=1, bos_token_id=2), "llama", tuple(range(1, 10))),
    "gemma3_linear": ("Gemma3TextConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=6,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        query_pre_attn_scalar=16, sliding_window=8, rope_theta=1000000.0,
        rope_local_base_freq=10000.0, rope_scaling={"rope_type": "linear", "factor": 8.0},
        max_position_embeddings=64, attn_implementation="eager"), "gemma3",
        tuple(range(1, 13))),
}
FAMILIES["phi3_long"] = FAMILIES["phi3"][:3] + (tuple(range(1, 40)),)
FAMILIES.update({
    # the block, norm, activation and head conventions (the reference's
    # tests/test_llm_families.py configs)
    "olmo2": ("Olmo2Config", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        tie_word_embeddings=False), "olmo2", (1, 7, 23)),
    "cohere": ("CohereConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        logit_scale=0.0625), "cohere", (1, 7, 23)),
    "cohere_qk": ("CohereConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        logit_scale=0.0625, use_qk_norm=True), "cohere", (1, 7, 23)),
    "granite": ("GraniteConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        embedding_multiplier=12.0, residual_multiplier=0.22,
        attention_multiplier=0.015625, logits_scaling=8.0, tie_word_embeddings=False),
        "llama", (1, 7, 23)),
    "nemotron": ("NemotronConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        partial_rotary_factor=0.5, tie_word_embeddings=False), "nemotron",
        tuple(range(1, 10))),
    "apertus": ("ApertusConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        tie_word_embeddings=False, pad_token_id=0, eos_token_id=None), "apertus",
        tuple(range(1, 10))),
    "phi": ("PhiConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        partial_rotary_factor=0.5, tie_word_embeddings=False), "phi",
        tuple(range(1, 10))),
})
#: leaves each family's loaded (fused) tree must hold, and the values of
#: the per-layer integer leaves
LEAVES = {
    "qwen2": dict(layers={"b_qkv"}),
    "qwen2_sliding": dict(layers={"b_qkv"}, attn_window=[0, 0, 8, 8]),
    "qwen3": dict(layers={"w_q_norm", "w_k_norm"}),
    "qwen3_moe": dict(layers={"w_q_norm", "w_k_norm", "w_experts_gate", "w_router"}),
    "gpt2": dict(layers={"b_qkv", "b_o", "w_fc1", "w_fc2", "b_fc1", "b_fc2", "attn_norm_b",
                         "mlp_norm_b"}, top={"pos_embed", "final_norm_b"}),
    "gemma2": dict(layers={"post_attn_norm_w", "post_mlp_norm_w"}, attn_window=[8, 0, 8, 0]),
    "gemma3": dict(layers={"w_q_norm", "post_mlp_norm_w"}, top={"rope_cos_local"},
                   attn_window=[8] * 5 + [0], use_local_rope=[1, 1, 1, 1, 1, 0]),
    "starcoder2": dict(layers={"b_fc1", "b_fc2", "attn_norm_b", "b_qkv", "b_o"},
                       top={"final_norm_b"}),
    "seed_oss": dict(layers={"b_qkv", "b_o"}),
    "mistral_sliding": dict(layers=set(), attn_window=[8, 8]),
    "llama31": dict(layers=set()),
    "phi3": dict(layers=set(), top={"rope_cos_long", "rope_sin_long", "rope_long_threshold"}),
    "phi3_long": dict(layers=set(),
                      top={"rope_cos_long", "rope_sin_long", "rope_long_threshold"}),
    "qwen3_yarn": dict(layers={"w_q_norm", "w_k_norm"}),
    "glm4": dict(layers={"b_qkv", "post_attn_norm_w", "post_mlp_norm_w"}),
    "ernie45": dict(layers=set()),
    "smollm3": dict(layers=set(), use_rope_layer=[1, 1, 1, 0]),
    "gemma3_linear": dict(layers={"w_q_norm", "post_mlp_norm_w"}, top={"rope_cos_local"},
                          attn_window=[8] * 5 + [0], use_local_rope=[1, 1, 1, 1, 1, 0]),
    "olmo2": dict(layers={"w_q_norm", "w_k_norm", "post_attn_norm_w", "post_mlp_norm_w"},
                  absent={"attn_norm_w", "mlp_norm_w"}),
    "cohere": dict(layers={"attn_norm_w"}, absent={"mlp_norm_w", "w_q_norm"}),
    "cohere_qk": dict(layers={"w_q_norm", "w_k_norm"}, absent={"mlp_norm_w"}),
    "granite": dict(layers={"attn_norm_w", "mlp_norm_w"}),
    "nemotron": dict(layers={"w_fc1", "w_fc2", "attn_norm_b", "mlp_norm_b"},
                     top={"final_norm_b"}),
    "apertus": dict(layers={"w_fc1", "w_fc2", "w_q_norm", "w_k_norm", "act_alpha_p",
                            "act_alpha_n", "act_beta", "act_eps"}),
    "phi": dict(layers={"b_qkv", "b_o", "w_fc1", "b_fc1", "attn_norm_b"},
                top={"lm_head_b", "final_norm_b"}, absent={"mlp_norm_w"}),
}
#: the families the fused decode step takes (split-half rope over plain
#: pre-norm blocks, scaled tables included)
FUSED_FAMILIES = ("llama31", "phi3", "phi3_long")
#: the conventions each family brings, as its config states them
#: (``check_supported`` refused these five families until they were ported)
CONVENTIONS = {
    "cohere": dict(parallel_block=True, logit_scale=0.0625, rope_interleaved=True,
                   norm_type="layernorm"),
    "olmo2": dict(pre_norms=False, use_post_norms=True, use_qk_norm=True, qk_norm_wide=True),
    "granite": dict(residual_multiplier=0.22, logit_scale=0.125, embed_scale=12.0,
                    query_scale=0.015625),
    "nemotron": dict(activation="relu2", rope_dim=4, rope_interleaved=False,
                     norm_type="layernorm"),
    "apertus": dict(activation="xielu", use_qk_norm=True, qk_norm_wide=False),
}


def _hf_config(cls_name: str, kw: dict):
    return getattr(transformers, cls_name)(**kw)


def _strip_gpt2_prefix(d) -> None:
    """GPT2LMHeadModel saves its names under ``transformer.``; the spec
    reads the raw GPT-2 names (as the reference's GPT-2 tests re-save)."""
    f = d / "model.safetensors"
    with safetensors.safe_open(str(f), framework="np") as sf:
        data = {n.replace("transformer.", ""): sf.get_tensor(n) for n in sf.keys()}
    stnp.save_file(data, str(f))


def save_family(tmp_path_factory, fam: str, seed: int = 0):
    """(checkpoint dir, the transformers model) of a tiny family model,
    every matrix scaled fourfold."""
    cls_name, kw, _, _ = FAMILIES[fam]
    cfg = _hf_config(cls_name, kw)
    torch.manual_seed(seed)
    m = transformers.AutoModelForCausalLM.from_config(cfg).eval()
    with torch.no_grad():
        for p in m.parameters():
            if p.dim() >= 2:
                p.mul_(4.0)
    d = tmp_path_factory.mktemp(fam)
    m.save_pretrained(d, safe_serialization=True)
    if fam == "gpt2":
        _strip_gpt2_prefix(d)
    # Apertus's xIELU parameters are bf16 in an f32 model, and transformers'
    # Python path rounds softplus(alpha) to bf16; the checkpoint keeps those
    # bf16 values, and the comparison runs in f32 throughout, as both
    # packages compute it (ROADMAP.md, C.6)
    return d, m.float()


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request, tmp_path_factory):
    """(family, checkpoint dir, transformers model, JAX model, port model)."""
    fam = request.param
    d, m = save_family(tmp_path_factory, fam, seed=list(FAMILIES).index(fam))
    jm = rl.load_model_from_safetensors(d, dtype="float32")
    tm = pl.load_model_from_safetensors(d, dtype="float32", device="cpu")
    return fam, d, m, jm, tm


def test_logits_and_greedy_tokens_match_jax_and_transformers(family):
    fam, _, m, jm, tm = family
    prompt = list(FAMILIES[fam][3])
    ours = tm.get_logits(prompt)
    np.testing.assert_allclose(ours, np.asarray(jm.get_logits(prompt)), **TOL)
    with torch.no_grad():
        hf = m(torch.tensor([prompt])).logits[0].numpy()
    np.testing.assert_allclose(ours, hf, **TOL)
    got = tm.generate(prompt, max_new_tokens=6)
    want = m.generate(torch.tensor([prompt]), max_new_tokens=6, do_sample=False,
                      pad_token_id=0)[0, len(prompt):].tolist()
    assert got == want == list(jm.generate(prompt, max_new_tokens=6))


def test_the_family_loads_its_leaves(family):
    fam, d, _, jm, tm = family
    st = pl.load_safetensors(d)
    assert pl.detect_model_spec(st.keys()).name == FAMILIES[fam][2]
    st.close()
    want = LEAVES[fam]
    layers, top = tm.params["layers"], tm.params
    assert want["layers"] <= set(layers)
    assert want.get("top", set()) <= set(top)
    assert not want.get("absent", set()) & set(layers)
    for leaf in ("attn_window", "use_local_rope", "use_rope_layer"):
        if leaf in want:
            assert layers[leaf].tolist() == want[leaf]
        else:
            assert leaf not in layers
    # the reference's loaded tree, leaf for leaf
    assert set(layers) == set(jm.params["layers"])
    assert set(top) == set(jm.params)


def test_rope_leaves_match_the_references(family):
    """Every rope leaf the reference makes (scaled tables, LongRoPE's long
    pair and threshold, Gemma-3's local tables, GLM-4's at rope_dim), of
    its shape, within atol 1e-5; NoPE switches and partial width follow the
    config."""
    fam, _, _, jm, tm = family
    names = {k for k in jm.params if k.startswith("rope_")}
    assert names == {k for k in tm.params if k.startswith("rope_")}
    for k in names:
        want = np.asarray(jm.params[k])
        got = tm.params[k].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if k == "rope_long_threshold":
            assert got == want == tm.config.rope_scaling["original_max_position_embeddings"]
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=k)
    if "rope_cos" in names:
        assert tm.params["rope_cos"].shape[-1] == tm.config.rope_dim
    if fam == "glm4":
        assert tm.config.rope_dim == 4 and tm.config.rope_interleaved


def test_int4_leaves_are_the_references_bitwise(family):
    fam, _, _, jm, tm = family
    jq = ref_quant.quantize_model_params(jm.params, "int4")
    tq = pl.quantize_model_params(tm.params, "int4")
    n = 0
    for name, leaf in tq["layers"].items():
        if isinstance(leaf, dict) and "q_packed" in leaf:
            for k in ("q_packed", "scale"):
                np.testing.assert_array_equal(leaf[k].numpy(), np.asarray(jq["layers"][name][k]))
            n += 1
    assert n >= 2


def _ref_cfg(fam: str):
    cls_name, kw, _, _ = FAMILIES[fam]
    return _hf_config(cls_name, kw).to_dict()


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_reference_init_params_give_the_reference_forward(fam):
    hf = _ref_cfg(fam)
    jcfg = ref_config.TransformerConfig.from_hf_config(hf)
    tcfg = port_config.TransformerConfig.from_hf_config(hf)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = jax.tree.map(lambda a: a * 4.0 if a.ndim >= 2 and a.dtype == jnp.float32 else a,
                          ref_model.init_params(jcfg, 3, jnp.float32))
    jm = rl.CausalTransformerModel(jcfg, params, dtype=jnp.float32)
    tm = pl.CausalTransformerModel(tcfg, pl.params_from_jax(jax.tree.map(np.asarray,
                                                                         jm.params)),
                                   dtype=torch.float32)
    ids = [3, 17, 42, 9, 60, 2, 11, 5, 30, 1, 8, 70]
    np.testing.assert_allclose(tm.get_logits(ids), np.asarray(jm.get_logits(ids)), **TOL)
    # the port's own init builds the reference's leaves, shapes and dtypes
    mine = port_model.init_params(tcfg, 3, torch.float32, device="cpu")
    ref = ref_model.init_params(jcfg, 3, jnp.float32)

    def layout(tree):
        return {k: (layout(v) if isinstance(v, dict) else
                    None if v is None else (tuple(v.shape), str(v.dtype).split(".")[-1]))
                for k, v in tree.items()}
    assert layout(mine) == layout(ref)


@pytest.mark.parametrize("fam", list(CONVENTIONS))
def test_the_families_once_refused_carry_their_conventions(fam):
    """The config states each family's conventions, the model takes it,
    and its leaves load (parity: the family's cases above)."""
    cls_name, kw, _, _ = FAMILIES[fam]
    cfg = port_config.TransformerConfig.from_hf_config(_hf_config(cls_name, kw).to_dict())
    for name, want in CONVENTIONS[fam].items():
        assert getattr(cfg, name) == want, name
    port_model.check_supported(cfg)


#: one convention at a time on a plain Llama block (Phi-2's parallel block
#: among them), the config's own fields
CONVENTION_KW = [dict(residual_multiplier=0.5), dict(logit_scale=0.0625),
                 dict(use_qk_norm=True, qk_norm_wide=True), dict(activation="relu2"),
                 dict(activation="xielu"), dict(parallel_block=True),
                 dict(pre_norms=False, use_post_norms=True)]


def _init_pair(jcfg, tcfg, seed: int = 5):
    """(JAX model, port model) of the reference's f32 ``init_params``,
    matrices scaled fourfold and the xIELU leaves moved off their initial
    values, carried across by ``params_from_jax``."""
    params = jax.tree.map(lambda a: a * 4.0 if a.ndim >= 2 and a.shape[-1] > 1
                          and a.dtype == jnp.float32 else a,
                          ref_model.init_params(jcfg, seed, jnp.float32))
    for i, leaf in enumerate(("act_alpha_p", "act_alpha_n", "act_beta")):
        if leaf in params["layers"]:
            params["layers"][leaf] = params["layers"][leaf] + 0.1 * (i + 1)
    jm = rl.CausalTransformerModel(jcfg, params, dtype=jnp.float32)
    tm = pl.CausalTransformerModel(tcfg, pl.params_from_jax(jax.tree.map(np.asarray,
                                                                         jm.params)),
                                   dtype=torch.float32)
    return jm, tm


@pytest.mark.parametrize("cfg_kw", CONVENTION_KW,
                         ids=["residual_multiplier", "logit_scale", "wide_qk_norm", "relu2",
                              "xielu", "parallel_block", "post_norm_only"])
def test_each_convention_alone_matches_the_reference(cfg_kw):
    """Each convention that ``check_supported`` once refused, alone on a
    Llama block: the port's forward within rtol 1e-4 of the reference's,
    and the port's ``init_params`` builds the reference's leaves."""
    kw = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
              intermediate_size=64, max_position_embeddings=64, **cfg_kw)
    jcfg = ref_config.TransformerConfig(**kw)
    tcfg = port_config.TransformerConfig(**kw)
    jm, tm = _init_pair(jcfg, tcfg)
    ids = [3, 17, 42, 9, 60, 2, 11, 5, 30, 1]
    np.testing.assert_allclose(tm.get_logits(ids), np.asarray(jm.get_logits(ids)), **TOL)
    mine = port_model.init_params(tcfg, 0, torch.float32, device="cpu")
    ref = ref_model.init_params(jcfg, 0, jnp.float32)
    assert {k: tuple(v.shape) for k, v in mine["layers"].items()} == \
        {k: tuple(v.shape) for k, v in ref["layers"].items()}


def test_an_lm_head_bias_is_added_before_the_scale_and_the_softcap():
    """Phi's lm-head bias: added in f32, then the logit scale, then the
    final softcap, in the reference's order; the model takes the leaf,
    carried across from the reference's tree."""
    kw = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, logit_scale=0.5, final_logit_softcap=3.0)
    jcfg = ref_config.TransformerConfig(**kw)
    tcfg = port_config.TransformerConfig(**kw)
    rng = np.random.default_rng(4)
    head = rng.standard_normal((32, 96)).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32) * 4
    h = rng.standard_normal((5, 32)).astype(np.float32)
    want = ref_model._logits(jcfg, {"lm_head": jnp.asarray(head),
                                    "lm_head_b": jnp.asarray(bias)}, jnp.asarray(h))
    got = port_model._logits(tcfg, {"lm_head": torch.from_numpy(head),
                                    "lm_head_b": torch.from_numpy(bias)}, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the leaf crosses by params_from_jax, and the two models agree
    jparams = ref_model.init_params(jcfg, 0, jnp.float32)
    jparams["lm_head_b"] = jnp.asarray(bias)
    jm = rl.CausalTransformerModel(jcfg, jparams, dtype=jnp.float32)
    tm = pl.CausalTransformerModel(tcfg, pl.params_from_jax(jax.tree.map(np.asarray,
                                                                         jm.params)),
                                   dtype=torch.float32)
    np.testing.assert_array_equal(tm.params["lm_head_b"].numpy(), bias)
    ids = [3, 17, 42, 9, 60, 2]
    np.testing.assert_allclose(tm.get_logits(ids), np.asarray(jm.get_logits(ids)), **TOL)


@pytest.mark.parametrize("fam", [f for f in FAMILIES if f not in FUSED_FAMILIES])
def test_fused_decode_refuses_every_family(fam, monkeypatch):
    """As the reference does (its ``fused_decode_eligible``): on the
    port's own init (separate dense bf16 leaves) and on fused leaves.
    SmolLM3's NoPE layers are refused by the port's own check (the
    reference's architecture checks let them through, though its kernel
    rotates every layer; its kernel's tile gates refuse these widths)."""
    monkeypatch.setenv("PYGPUKIT_DECODE", "fused")
    hf = _ref_cfg(fam)
    tcfg = port_config.TransformerConfig.from_hf_config(hf)
    jcfg = ref_config.TransformerConfig.from_hf_config(hf)
    params = port_model.init_params(tcfg, 0, torch.bfloat16, device="cpu")
    if fam.startswith("qwen2") or fam == "seed_oss":     # a checkpoint's biases
        for n, w in (("b_q", "w_q"), ("b_k", "w_k"), ("b_v", "w_v")):
            params["layers"][n] = torch.zeros(params["layers"][w].shape[::2],
                                              dtype=torch.bfloat16)
    assert not port_model.fused_decode_eligible(tcfg, params, 64)
    assert not port_model.use_fused_decode(tcfg, params, 64)
    ref_params = ref_model.init_params(jcfg, 0, jnp.bfloat16)
    if fam.startswith("qwen2") or fam == "seed_oss":
        ref_params["layers"]["b_q"] = jnp.zeros((jcfg.num_layers, jcfg.num_heads * 8))
    assert not ref_model.fused_decode_eligible(jcfg, ref_params, 64)
    model = pl.CausalTransformerModel(tcfg, params)
    model.init_fixed_cache(64)
    assert "w_qkv_cat" not in model.params["layers"]


@pytest.mark.parametrize("fam", FUSED_FAMILIES)
def test_fused_decode_takes_split_half_scaled_rope(fam, monkeypatch):
    """Scaled tables stay on the fused route (the kernel rotates with the
    rows it is given): Llama-3.1's and Phi-3's configs are eligible on the
    port's own init, as in the reference."""
    monkeypatch.setenv("PYGPUKIT_DECODE", "fused")
    tcfg = port_config.TransformerConfig.from_hf_config(_ref_cfg(fam))
    assert tcfg.rope_scaling
    params = port_model.init_params(tcfg, 0, torch.bfloat16, device="cpu")
    assert port_model.fused_decode_eligible(tcfg, params, 64)
    model = pl.CausalTransformerModel(tcfg, params)
    model.init_fixed_cache(64)
    assert "w_qkv_cat" in model.params["layers"]


@pytest.mark.parametrize("activation", ["xielu", "relu2", "gelu"])
def test_fused_decode_supports_rejects_the_gateless_activations(activation):
    """Apertus passes the architecture checks of ``fused_decode_eligible``
    but for its leaves (fc1/fc2, no gate): the kernel's own check refuses
    its activation too, in both packages, at Apertus-8B's widths (head_dim
    128, 32/8 heads) where a SwiGLU model is taken."""
    from pygpukit_tpu.kernels.fused_decode import supports as ref_supports
    from pygpukit_tpu_torch.kernels.fused_decode import supports
    kw = dict(hidden=4096, intermediate=21504, n_heads=32, n_kv_heads=8, head_dim=128,
              max_seq=64, norm_type="rmsnorm", use_rope=True, has_bias=False,
              use_qk_norm=False, is_moe=False)
    assert supports(activation="silu", **kw)
    assert not supports(activation=activation, **kw)
    assert not ref_supports(activation=activation, **kw)


def test_qwen3_projection_width_is_not_hidden():
    """Qwen3-0.6B's q projection is 16 x 128 = 2048 wide at hidden 1024:
    the fused kernel's check refuses it even without the q/k norm."""
    from pygpukit_tpu_torch.kernels.fused_decode import supports
    assert not supports(hidden=1024, intermediate=3072, n_heads=16, n_kv_heads=8,
                        head_dim=128, max_seq=64, norm_type="rmsnorm", activation="silu",
                        use_rope=True, has_bias=False, use_qk_norm=False, is_moe=False)


# ---------------------------------------------------------------------------
# head_dim 256 on CPU tensors: the plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def no_launch(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a kernel launch")
    monkeypatch.setattr(_build, "launch", refuse)
    for mod in ("batch_decode_attention", "paged_attention", "flash_attention",
                "kv_row_write"):
        m = getattr(kernels, mod)
        if hasattr(m, "launch"):
            monkeypatch.setattr(m, "launch", refuse)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int16).numpy()


@pytest.mark.parametrize("hq, hk", [(8, 4), (4, 1)])
def test_d256_on_the_cpu_takes_the_plain_versions(no_launch, hq, hk):
    """Gemma-2-2B's and Gemma-3-1B's heads at D 256 on CPU tensors: each
    wrapper returns its plain version's bits and launches nothing."""
    _plain_versions_on_the_cpu(hq, hk, 256)


@pytest.mark.parametrize("hq, hk", [(32, 32), (32, 8)])
def test_d80_on_the_cpu_takes_the_plain_versions(no_launch, hq, hk):
    """Phi-2's heads (and G 4) at D 80 on CPU tensors: each wrapper returns
    its plain version's bits and launches nothing."""
    _plain_versions_on_the_cpu(hq, hk, 80)


@pytest.mark.parametrize("hq, hk", [(32, 32), (32, 8)])
def test_d96_on_the_cpu_takes_the_plain_versions(no_launch, hq, hk):
    """Phi-3.5-mini's heads (and G 4) at D 96 on CPU tensors: each wrapper
    returns its plain version's bits and launches nothing."""
    _plain_versions_on_the_cpu(hq, hk, 96)


def _plain_versions_on_the_cpu(hq: int, hk: int, d: int) -> None:
    g = torch.Generator().manual_seed(hq + hk)
    b, n_layers, max_len = 3, 2, 80

    def rnd(*shape, dt=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(dt)
    q = rnd(b, 1, hq, d)
    kp, vp = rnd(b, n_layers, max_len, hk * d), rnd(b, n_layers, max_len, hk * d)
    lens = torch.tensor([5, 70, 80], dtype=torch.int32)
    for softcap, window in ((None, None), (50.0, 16)):
        got = kernels.batch_decode_attention(q, kp, vp, 1, lens, 0.0625, softcap, window)
        want = kernels.batch_decode_attention_plain(q, kp, vp, 1, lens, 0.0625, softcap,
                                                    window)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    nb, bs = 12, 16
    kpool, vpool = rnd(nb, hk, bs, d), rnd(nb, hk, bs, d)
    tables = torch.tensor([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10], [11, 1, 2, 3, 4]],
                          dtype=torch.int32)
    got = kernels.paged_attention(q[:, 0], kpool, vpool, tables, lens, 0.0625, 50.0, 16)
    want = kernels.paged_attention_plain(q[:, 0], kpool, vpool, tables, lens, 0.0625, 50.0,
                                         16)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    s = 40
    qs, ks, vs = rnd(s, hq, d), rnd(s, hk, d), rnd(s, hk, d)
    np.testing.assert_array_equal(_bits(kernels.flash_attention(qs, ks, vs)),
                                  _bits(kernels.flash_attention_plain(qs, ks, vs)))
    kc, vc = rnd(max_len, hk, d), rnd(max_len, hk, d)
    np.testing.assert_array_equal(
        _bits(kernels.flash_decode(qs[:1], kc, vc, 33)),
        _bits(kernels.flash_decode_plain(qs[:1], kc, vc, 33)))


# ---------------------------------------------------------------------------
# Exact points
# ---------------------------------------------------------------------------

def test_learned_positions_follow_the_references_take_and_slice():
    """Batch-rows step: ``jnp.take`` (negative rows count from the end,
    rows outside [-n, n) NaN); single-stream window: ``dynamic_slice``
    clamps the start."""
    table = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    idx = np.array([0, 3, 15, 16, 40, -1, -16, -17], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    got = port_model._take_rows(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    for pos, t in ((0, 3), (13, 3), (14, 3), (40, 2)):
        want = np.asarray(jax.lax.dynamic_slice_in_dim(jnp.asarray(table), pos, t, axis=0))
        for p in (pos, torch.tensor([pos], dtype=torch.int32)):
            got = port_model._table_rows(torch.from_numpy(table), p, t).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embedding_scale_is_the_references_bitwise(dtype):
    """Gemma's normalizer is rounded to the activation dtype before the
    multiply, in both packages."""
    hf = _ref_cfg("gemma2")
    jcfg = ref_config.TransformerConfig.from_hf_config(hf)
    tcfg = port_config.TransformerConfig.from_hf_config(hf)
    emb = np.random.default_rng(1).standard_normal((96, 32)).astype(np.float32) * 3
    ids = np.arange(0, 96, 5, dtype=np.int32)
    jemb = jnp.asarray(emb, getattr(jnp, dtype))
    want = np.asarray(ref_model._embed_tokens(jcfg, {"embed": jemb}, jnp.asarray(ids)))
    temb = pl.params_from_jax(np.asarray(jemb))
    got = port_model._embed_tokens(tcfg, {"embed": temb}, torch.from_numpy(ids))
    np.testing.assert_array_equal(_bits(got), want.view(np.int16 if dtype == "bfloat16"
                                                        else np.int32))


@pytest.mark.parametrize("softcap, window", [(None, None), (50.0, 5)])
def test_prefill_attention_in_head_groups_matches_one_pass(monkeypatch, softcap, window):
    """Past PREFILL_SCORE_BYTES the cached prefill attends a group of heads
    at a time (Phi-3.5's 32 heads at a bucket of 8192 rows): the same
    values as one pass over every head, softcap and window included."""
    g = torch.Generator().manual_seed(7)
    s, hq, hk, d = 24, 8, 2, 16
    q = torch.randn(s, hq, d, generator=g)
    k = torch.randn(s, hk, d, generator=g)
    v = torch.randn(s, hk, d, generator=g)
    whole = port_model._prefill_attn(q, k, v, 20, 0.3, softcap, window)
    monkeypatch.setattr(port_model, "PREFILL_SCORE_BYTES", 3 * s * s * 4)
    grouped = port_model._prefill_attn(q, k, v, 20, 0.3, softcap, window)
    np.testing.assert_allclose(grouped.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)
    # the reference's one pass
    want = ref_model._prefill_attn(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                   jnp.asarray(v.numpy()), 20, 0.3, softcap, window)
    np.testing.assert_allclose(grouped.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_a_window_no_shorter_than_the_keys_counts_as_none():
    """Phi-3.5's 262144 window over a forward or a cache masks nothing: the
    routes drop it (so the card takes the kernels) and the plain results
    keep their bits."""
    from pygpukit_tpu_torch.ops.nn.attention import (effective_window, flash_attention_fn,
                                                     sdpa_fixed_cache_fn)
    assert effective_window(262144, 2048) is None and effective_window(None, 8) is None
    assert effective_window(512, 2048) == 512 and effective_window(8, 8) is None
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(40, h, 16, generator=g) for h in (4, 2, 2))
    np.testing.assert_array_equal(flash_attention_fn(q, k, v, window=40).numpy(),
                                  flash_attention_fn(q, k, v).numpy())
    kc, vc = torch.randn(64, 2, 16, generator=g), torch.randn(64, 2, 16, generator=g)
    np.testing.assert_array_equal(sdpa_fixed_cache_fn(q[:1], kc, vc, 30, window=64).numpy(),
                                  sdpa_fixed_cache_fn(q[:1], kc, vc, 30).numpy())
