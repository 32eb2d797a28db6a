"""The port's ``HybridServingEngine`` (``pygpukit_tpu_torch/llm/
serving_hybrid.py``) on the CPU, over the tiny gpt-oss, DeepSeek-V3, Mamba,
LFM2 and Qwen3-Next models of ``tests/test_serving_hybrid.py`` (same
configs and seeds, loaded through ``from_safetensors`` in f32):

- 3 requests, one queued behind a 2-slot table: each stream equal to the
  family's own greedy ``generate`` and to the reference engine's stream;
- one new token finishes at admission, an EOS cuts a stream;
- a model class without the hooks raises TypeError, ``mesh=`` raises;
- the admission and chunk programs are captured once each and replayed;
- the cache trees (a dict, a list of per-layer dicts) stacked leaf by
  leaf, each slot's admission copied into its row only;
- Mamba: a slot reused after a long request starts from zero state, and a
  sampled run replays under its seed.
"""

import jax.numpy as jnp
import pytest
import torch
import transformers

from torch.utils import _pytree as pytree

from pygpukit_tpu.llm.serving_hybrid import HybridServingEngine as JaxEngine
from pygpukit_tpu_torch.llm.models import (DeepseekV3Model, GptOssModel, Lfm2Model, MambaModel,
                                          Qwen3NextModel)
from pygpukit_tpu_torch.llm.serving_hybrid import HybridServingEngine

torch.set_num_threads(2)

PROMPTS = [[1, 7, 23, 5, 9, 2], [4, 11], [3, 8, 30, 17, 6, 12, 25, 40, 2]]


def _gptoss(path):
    cfg = transformers.GptOssConfig(
        vocab_size=96, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8, num_local_experts=4,
        num_experts_per_tok=2, sliding_window=8,
        layer_types=["sliding_attention", "full_attention"], max_position_embeddings=64,
        tie_word_embeddings=False, pad_token_id=0, attn_implementation="eager")
    torch.manual_seed(54)
    transformers.GptOssForCausalLM(cfg).eval().save_pretrained(path, safe_serialization=True)
    from pygpukit_tpu.llm.models.gptoss import GptOssModel as Ref
    return GptOssModel, Ref


def _deepseek(path):
    cfg = transformers.DeepseekV3Config(
        vocab_size=96, hidden_size=48, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=2, q_lora_rank=24, kv_lora_rank=16, qk_rope_head_dim=4,
        qk_nope_head_dim=8, v_head_dim=8, intermediate_size=64, moe_intermediate_size=32,
        n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2, n_group=2,
        topk_group=1, norm_topk_prob=True, routed_scaling_factor=2.5,
        first_k_dense_replace=1, max_position_embeddings=64, tie_word_embeddings=False,
        pad_token_id=0)
    torch.manual_seed(55)
    transformers.DeepseekV3ForCausalLM(cfg).eval().save_pretrained(path,
                                                                    safe_serialization=True)
    from pygpukit_tpu.llm.models.deepseek import DeepseekV3Model as Ref
    return DeepseekV3Model, Ref


def _mamba(path):
    cfg = transformers.MambaConfig(
        vocab_size=96, hidden_size=32, state_size=8, num_hidden_layers=2, conv_kernel=4,
        intermediate_size=64, time_step_rank=4, use_conv_bias=True, use_bias=False,
        pad_token_id=0)
    torch.manual_seed(51)
    transformers.MambaForCausalLM(cfg).eval().save_pretrained(path, safe_serialization=True)
    from pygpukit_tpu.llm.models.mamba import MambaModel as Ref
    return MambaModel, Ref


def _lfm2(path):
    cfg = transformers.Lfm2Config(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2,
        layer_types=["conv", "full_attention", "conv", "full_attention"], conv_L_cache=3,
        block_auto_adjust_ff_dim=False, max_position_embeddings=64, tie_word_embeddings=True,
        pad_token_id=0)
    torch.manual_seed(52)
    transformers.Lfm2ForCausalLM(cfg).eval().save_pretrained(path, safe_serialization=True)
    from pygpukit_tpu.llm.models.lfm2 import Lfm2Model as Ref
    return Lfm2Model, Ref


def _qwen3next(path):
    cfg = transformers.Qwen3NextConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        layer_types=["linear_attention", "full_attention", "linear_attention",
                     "full_attention"],
        linear_num_value_heads=4, linear_num_key_heads=2, linear_key_head_dim=8,
        linear_value_head_dim=8, linear_conv_kernel_dim=4, partial_rotary_factor=0.25,
        max_position_embeddings=64, tie_word_embeddings=False, pad_token_id=0, num_experts=0)
    torch.manual_seed(53)
    transformers.Qwen3NextForCausalLM(cfg).eval().save_pretrained(path,
                                                                   safe_serialization=True)
    from pygpukit_tpu.llm.models.qwen3next import Qwen3NextModel as Ref
    return Qwen3NextModel, Ref


BUILDERS = {"gptoss": _gptoss, "deepseek": _deepseek, "mamba": _mamba, "lfm2": _lfm2,
            "qwen3next": _qwen3next}


@pytest.fixture(scope="module", params=list(BUILDERS))
def family(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(request.param)
    cls, ref_cls = BUILDERS[request.param](path)
    model = cls.from_safetensors(path, dtype=torch.float32, device="cpu")
    ref = ref_cls.from_safetensors(path, dtype=jnp.float32)
    want = [model.generate(p, max_new_tokens=8) for p in PROMPTS]
    return request.param, model, ref, want


def test_engine_matches_generate(family):
    """3 concurrent requests (one queued behind a 2-slot table) give the
    tokens of the family's own greedy generate and of the reference
    engine."""
    name, model, ref, want = family
    eng = HybridServingEngine(model, max_batch=2, max_seq_len=64, steps_per_dispatch=4)
    reqs = [eng.submit(p, max_new_tokens=8) for p in PROMPTS]
    eng.run_until_complete()
    for req, w in zip(reqs, want):
        assert req.done and req.generated == w, (name, req.generated, w)
    assert eng.stats.requests_completed == 3 and eng.stats.prefills == 3
    jeng = JaxEngine(ref, max_batch=2, max_seq_len=64, steps_per_dispatch=4)
    jreqs = [jeng.submit(p, max_new_tokens=8) for p in PROMPTS]
    jeng.run_until_complete()
    assert [r.generated for r in jreqs] == [r.generated for r in reqs]


def test_programs_are_captured_once_and_replayed(family):
    _, model, _, want = family
    eng = HybridServingEngine(model, max_batch=2, max_seq_len=64, steps_per_dispatch=3)
    for _ in range(2):
        reqs = [eng.submit(p, max_new_tokens=8) for p in PROMPTS]
        eng.run_until_complete()
        assert [r.generated for r in reqs] == want
    exes = eng.graphs.executables()
    assert set(exes) == {("prefill", 32), ("chunk", 3)}
    assert exes[("prefill", 32)].stats.replays == 6
    assert exes[("chunk", 3)].stats.replays == eng.stats.steps


def test_single_token_and_eos(family):
    """max_new_tokens=1 finishes at admission; eos_token_id cuts a stream
    at that token."""
    _, model, _, want = family
    eng = HybridServingEngine(model, max_batch=2, max_seq_len=64, steps_per_dispatch=4)
    r1 = eng.submit(PROMPTS[0], max_new_tokens=1)
    eos = want[1][2]
    r2 = eng.submit(PROMPTS[1], max_new_tokens=8, eos_token_id=eos)
    eng.run_until_complete()
    assert r1.generated == want[0][:1]
    assert r2.generated == want[1][:want[1].index(eos) + 1]


def test_a_model_without_the_hooks_raises_type_error(family):
    _, model, _, _ = family

    class Bare:
        config, dtype, params, device = model.config, model.dtype, model.params, model.device
    with pytest.raises(TypeError, match="_prefill_fn"):
        HybridServingEngine(Bare())

    class NoStep(type(model)):
        _decode_step_fn = None
    plain = NoStep.__new__(NoStep)
    with pytest.raises(TypeError, match="_decode_step_fn"):
        HybridServingEngine(plain)


def test_mesh_raises(family):
    _, model, _, _ = family
    with pytest.raises(NotImplementedError, match="mesh"):
        HybridServingEngine(model, mesh=object())


def test_a_prompt_at_the_capacity_is_refused(family):
    _, model, _, _ = family
    eng = HybridServingEngine(model, max_batch=1, max_seq_len=16)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(list(range(1, 17)))


def test_cache_trees_are_stacked_leaf_by_leaf(family):
    """Every leaf of the family's cache tree (a dict, or a list of
    per-layer dicts) gets a leading slot axis in the tree's structure; an
    admission writes its slot's rows of every leaf and no other slot's."""
    name, model, _, _ = family
    eng = HybridServingEngine(model, max_batch=3, max_seq_len=64, steps_per_dispatch=4)
    single, spec = pytree.tree_flatten(eng._single)
    stacked, spec_b = pytree.tree_flatten(eng._caches)
    assert spec == spec_b and len(single) == len(stacked)
    assert isinstance(eng._caches, list if name in ("mamba", "lfm2", "qwen3next") else dict)
    for a, b in zip(single, stacked):
        assert tuple(b.shape) == (3,) + tuple(a.shape) and b.dtype == a.dtype
    eng.submit(PROMPTS[0], max_new_tokens=1)
    eng._admit()
    for a, b in zip(pytree.tree_leaves(eng._single), pytree.tree_leaves(eng._caches)):
        assert torch.equal(b[0], a.to(b.dtype))
        assert not b[1:].any()


def test_slot_reuse_isolation(tmp_path):
    """Mamba on one slot: a prompt served before and after an unrelated
    longer request gives the same stream (the admission zeroes the scratch
    state its stateful prefill continues from)."""
    _mamba(tmp_path)
    model = MambaModel.from_safetensors(tmp_path, dtype=torch.float32, device="cpu")
    eng = HybridServingEngine(model, max_batch=1, max_seq_len=64, steps_per_dispatch=4)
    a1 = eng.submit(PROMPTS[0], max_new_tokens=6)
    b = eng.submit(PROMPTS[2], max_new_tokens=10)
    a2 = eng.submit(PROMPTS[0], max_new_tokens=6)
    eng.run_until_complete()
    assert a1.generated == a2.generated == model.generate(PROMPTS[0], max_new_tokens=6)
    assert b.done and len(b.generated) == 10


def test_sampled_run_replays_under_its_seed(tmp_path):
    """temperature 0.8, top-k 10 on Mamba: two engines with the same seed
    give the same streams (torch generators: not the reference's draws),
    tokens in the vocabulary; another seed draws other streams."""
    _mamba(tmp_path)
    model = MambaModel.from_safetensors(tmp_path, dtype=torch.float32, device="cpu")
    outs = []
    for seed in (7, 7, 8):
        eng = HybridServingEngine(model, max_batch=2, max_seq_len=64, steps_per_dispatch=4,
                                  temperature=0.8, top_k=10, seed=seed)
        reqs = [eng.submit(p, max_new_tokens=6) for p in PROMPTS[:2]]
        eng.run_until_complete()
        assert all(len(r.generated) == 6 and all(0 <= t < 96 for t in r.generated)
                   for r in reqs)
        outs.append([r.generated for r in reqs])
    assert outs[0] == outs[1] != outs[2]
