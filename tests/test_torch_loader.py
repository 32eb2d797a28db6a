"""Checkpoint loading and the model API of the port (``pygpukit_tpu_torch.
llm``: safetensors, config, quant metadata, loader, streaming, the params
setter, ``resolve_kv_dtype``) against the JAX package on the CPU.

Every checkpoint is written here: by either package's ``save_safetensors``,
or by ``transformers``' ``save_pretrained`` of a tiny random model to
``tmp_path``. Files read back bitwise across the packages for every
safetensors dtype; loaded params equal ``params_from_jax`` of the
reference's loaded params bitwise (f32 and bf16, Llama and Mixtral); f32
logits are within rtol 1e-4, atol 1e-4 of the reference's and of
``transformers``', and greedy tokens equal ``transformers``'.
"""

import ast
import dataclasses
import json
import shutil
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import transformers

import pygpukit_tpu.llm as rl
from pygpukit_tpu.llm import config as ref_config
from pygpukit_tpu.llm import loader as ref_loader
from pygpukit_tpu.llm import model as ref_model
from pygpukit_tpu.llm import quant as ref_quant
from pygpukit_tpu.llm import safetensors as ref_st
import pygpukit_tpu_torch.llm as pl
from pygpukit_tpu_torch.llm import config as port_config
from pygpukit_tpu_torch.llm import loader as port_loader
from pygpukit_tpu_torch.llm import model as port_model
from pygpukit_tpu_torch.llm import safetensors as port_st

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)

# every safetensors dtype: numpy dtype for the reference's writer
ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
             "BF16": ml_dtypes.bfloat16, "F8_E4M3": ml_dtypes.float8_e4m3fn,
             "F8_E5M2": ml_dtypes.float8_e5m2, "I64": np.int64, "I32": np.int32,
             "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def _np_array(st_dtype: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if st_dtype == "BOOL":
        return rng.integers(0, 2, shape).astype(np.bool_)
    if st_dtype[0] in "IU":
        info = np.iinfo(ST_DTYPES[st_dtype])
        return rng.integers(max(info.min, -1000), min(info.max, 1000), shape,
                            dtype=np.int64).astype(ST_DTYPES[st_dtype])
    return (rng.standard_normal(shape) * 3).astype(np.float32).astype(ST_DTYPES[st_dtype])


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _tensors(seed: int = 0) -> dict:
    return {f"t.{name}": _np_array(name, (3, 5) if i % 2 else (7,), seed + i)
            for i, name in enumerate(ST_DTYPES)}


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("st_dtype", list(ST_DTYPES))
def test_reference_file_reads_back_bitwise_in_the_port(tmp_path, st_dtype):
    a = _np_array(st_dtype, (4, 6), 3)
    ref_st.save_safetensors(tmp_path / "r.safetensors", {"x": a, "empty": a[:0]})
    with port_st.SafeTensorsFile(tmp_path / "r.safetensors") as st:
        t = st.tensor("x")
        assert st.tensor_dtype("x") == st_dtype and tuple(t.shape) == a.shape
        assert st.info("x").torch_dtype == t.dtype
        assert _bytes(t) == a.tobytes()
        assert _bytes(st.tensor("empty")) == b""
        assert st.tensor_numpy("x").tobytes() == a.tobytes()


@pytest.mark.parametrize("st_dtype", list(ST_DTYPES))
def test_port_file_reads_back_bitwise_in_the_reference(tmp_path, st_dtype):
    a = _np_array(st_dtype, (4, 6), 4)
    tensor = pl.tensor_from_numpy(a)
    assert tensor.dtype == port_st._DTYPE_MAP[st_dtype]
    port_st.save_safetensors(tmp_path / "p.safetensors", {"x": tensor})
    st = ref_st.SafeTensorsFile(tmp_path / "p.safetensors")
    assert st.tensor_dtype("x") == st_dtype
    got = st.tensor_numpy("x")
    assert got.dtype == a.dtype and got.tobytes() == a.tobytes()
    st.close()
    # numpy input to the port's writer: the reference's file, byte for byte
    port_st.save_safetensors(tmp_path / "pn.safetensors", {"x": a})
    ref_st.save_safetensors(tmp_path / "rn.safetensors", {"x": a})
    assert (tmp_path / "pn.safetensors").read_bytes() == (tmp_path / "rn.safetensors").read_bytes()


def test_every_dtype_in_one_file_both_ways(tmp_path):
    data = _tensors(9)
    ref_st.save_safetensors(tmp_path / "r.safetensors", data)
    port_st.save_safetensors(tmp_path / "p.safetensors", data)
    assert (tmp_path / "r.safetensors").read_bytes() == (tmp_path / "p.safetensors").read_bytes()
    st = port_st.load_safetensors(tmp_path / "r.safetensors")
    assert st.keys() == list(data)
    for name, a in data.items():
        assert _bytes(st.tensor(name)) == a.tobytes()
        assert _bytes(st.tensor_raw(name)) == a.tobytes()
    st.close()


def _write_sharded(tmp_path: Path, save) -> dict:
    data = _tensors(5)
    names = list(data)
    shards = {"model-00001-of-00002.safetensors": names[:5],
              "model-00002-of-00002.safetensors": names[5:]}
    weight_map = {}
    for shard, keys in shards.items():
        save(tmp_path / shard, {k: data[k] for k in keys})
        weight_map.update({k: shard for k in keys})
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": 0}, "weight_map": weight_map}))
    return data


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_sharded_index_reads_the_same_in_both(tmp_path, writer):
    save = ref_st.save_safetensors if writer == "reference" else port_st.save_safetensors
    data = _write_sharded(tmp_path, save)
    for path in (tmp_path, tmp_path / "model.safetensors.index.json"):
        rs, ps = ref_st.load_safetensors(path), port_st.load_safetensors(path)
        assert isinstance(ps, port_st.ShardedSafeTensorsFile)
        assert sorted(ps.keys()) == sorted(rs.keys()) == sorted(data)
        for name, a in data.items():
            assert ps.tensor_dtype(name) == rs.tensor_dtype(name)
            assert ps.tensor_shape(name) == rs.tensor_shape(name) == a.shape
            assert _bytes(ps.tensor(name)) == rs.tensor_numpy(name).tobytes() == a.tobytes()
        rs.close()
        ps.close()


def test_load_safetensors_finds_a_lone_file_and_refuses_an_empty_dir(tmp_path):
    port_st.save_safetensors(tmp_path / "weights.safetensors", {"a": np.ones(3, np.float32)})
    assert port_st.load_safetensors(tmp_path).keys() == ["a"]
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        port_st.load_safetensors(tmp_path / "empty")


def test_a_misaligned_tensor_is_copied_with_its_values(tmp_path):
    """A header whose length is not a multiple of 8 puts an f32 tensor off
    its alignment: the port copies it out instead of viewing it."""
    a = np.arange(12, dtype=np.float32) * 0.5
    b = np.arange(5, dtype=np.int64) - 2
    header = {"a": {"dtype": "F32", "shape": [3, 4], "data_offsets": [0, 48]},
              "b": {"dtype": "I64", "shape": [5], "data_offsets": [48, 88]}}
    hjson = json.dumps(header).encode()
    hjson += b" " * (((8 - len(hjson) % 8) % 8) + 3)           # 3 bytes off
    path = tmp_path / "odd.safetensors"
    path.write_bytes(struct.pack("<Q", len(hjson)) + hjson + a.tobytes() + b.tobytes())
    with port_st.SafeTensorsFile(path) as st:
        ta, tb = st.tensor("a"), st.tensor("b")
        assert ta.data_ptr() % 4 == 0 and tb.data_ptr() % 8 == 0
        np.testing.assert_array_equal(ta.numpy(), a.reshape(3, 4))
        np.testing.assert_array_equal(tb.numpy(), b)
        ref = ref_st.SafeTensorsFile(path)
        np.testing.assert_array_equal(ref.tensor_numpy("a"), a.reshape(3, 4))
        ref.close()


def _quant_tree(mode: str):
    """A built reference model's params quantized with ``mode`` (int4_block
    ones carry scale_lo / scale_hi), as numpy leaves."""
    jcfg = ref_config.TransformerConfig(vocab_size=64, hidden_size=64, num_layers=2,
                                        num_heads=4, num_kv_heads=2, intermediate_size=128,
                                        max_position_embeddings=32,
                                        tie_word_embeddings=False)
    params = ref_quant.quantize_model_params(
        ref_model.init_params(jcfg, 3, jnp.bfloat16), mode)
    jm = ref_model.CausalTransformerModel(jcfg, ref_model.fuse_params(params),
                                          dtype=jnp.bfloat16)
    return jm.params


def _tree_equal(a, b, path="") -> None:
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _tree_equal(a[k], b[k], f"{path}.{k}")
        return
    if a is None:
        assert b is None, path
        return
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
    assert _bytes(a) == _bytes(b), path


@pytest.mark.parametrize("mode", ["int4", "int4_block", "int8", "fp8"])
def test_reference_saved_params_load_as_params_from_jax(tmp_path, mode):
    tree = _quant_tree(mode)
    ref_st.save_model_params(tmp_path / "p.safetensors", tree)
    got = port_st.load_model_params(tmp_path / "p.safetensors", device="cpu")
    _tree_equal(pl.params_from_jax(jax.tree.map(np.asarray, tree)), got)


@pytest.mark.parametrize("mode", ["int4", "int4_block"])
def test_port_saved_params_load_in_the_reference(tmp_path, mode):
    port_tree = pl.params_from_jax(jax.tree.map(np.asarray, _quant_tree(mode)))
    port_st.save_model_params(tmp_path / "p.safetensors", port_tree)
    back = ref_st.load_model_params(tmp_path / "p.safetensors")
    _tree_equal(port_tree, pl.params_from_jax(jax.tree.map(np.asarray, back)))


# ---------------------------------------------------------------------------
# LazyModelLoader and streaming (the reference's tests/test_core.py:206-245)
# ---------------------------------------------------------------------------

def _layer_ckpt(tmp_path, n: int = 6) -> Path:
    path = tmp_path / "model.safetensors"
    ref_st.save_safetensors(path, {f"layer.{i}.w": np.full((8, 8), i, np.float32)
                                   for i in range(n)})
    return path


ACCESSES = {
    "lru": [0, 1, 2, 1, 3, 0, 4, 4, 5, 1, 2, 0],
    "hits": [0, 0, 1, 0, 1, 2, 0, 3, 1],
    "scan": [0, 1, 2, 3, 4, 5, 0, 1, 2, 3, 4, 5],
}


@pytest.mark.parametrize("budget", [600, 256, 1000, None])
@pytest.mark.parametrize("pattern", list(ACCESSES))
def test_lazy_loader_stats_and_eviction_order_match_the_reference(tmp_path, budget, pattern):
    path = _layer_ckpt(tmp_path)
    ref = ref_st.LazyModelLoader(str(path), max_device_bytes=budget)
    port = port_st.LazyModelLoader(str(path), max_device_bytes=budget, device="cpu")
    for i in ACCESSES[pattern]:
        name = f"layer.{i}.w"
        a, b = ref.get(name), port.get(name)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert port.stats == ref.stats
        assert list(port._device) == list(ref._device)
        assert port.state(name) == ref.state(name) == pl.TensorState.LOADED
    port.evict("layer.0.w")
    ref.evict("layer.0.w")
    port.evict_all()
    ref.evict_all()
    assert port.stats == ref.stats and not port._device


def test_lazy_loader_casts_to_its_dtype(tmp_path):
    path = _layer_ckpt(tmp_path, 2)
    port = port_st.LazyModelLoader(str(path), dtype="bfloat16", device="cpu")
    assert port.get("layer.1.w").dtype == torch.bfloat16
    assert port._device_bytes == 8 * 8 * 2


@pytest.mark.parametrize("strategy", ["SIMPLE", "SLIDING_WINDOW", "AUTO_LRU", "EAGER"])
@pytest.mark.parametrize("budget", [None, 600])
def test_streaming_context_matches_the_reference(tmp_path, strategy, budget):
    if strategy == "SLIDING_WINDOW" and budget is not None:
        budget = None     # the reference prefetches on a thread: order only without a budget
    path = _layer_ckpt(tmp_path)
    layer_names = [[f"layer.{i}.w"] for i in range(5)]
    runs = {}
    for pkg, mod, kw in (("ref", rl, {}), ("port", pl, {"device": "cpu"})):
        seen = []
        with mod.create_streaming_context(str(path), layer_names,
                                          strategy=getattr(mod.LoadingStrategy, strategy),
                                          max_device_bytes=budget, **kw) as ctx:
            for i, tensors in ctx:
                seen.append((i, sorted(tensors),
                             [float(np.asarray(t)[0, 0]) for t in tensors.values()]))
                if strategy != "SLIDING_WINDOW":
                    seen.append((dict(ctx.loader.stats), list(ctx.loader._device)))
        runs[pkg] = (seen, dict(ctx.loader.stats), list(ctx.loader._device))
    assert runs["port"] == runs["ref"]


def test_streaming_aliases():
    assert pl.SimpleStreaming is pl.LoadingStrategy.SIMPLE
    assert pl.SlidingWindow is pl.LoadingStrategy.SLIDING_WINDOW
    assert pl.AutoLRU is pl.LoadingStrategy.AUTO_LRU
    assert pl.StreamingConfig().window == rl.StreamingConfig().window


# ---------------------------------------------------------------------------
# Config: specs, from_hf_config, _infer_config
# ---------------------------------------------------------------------------

# the transformers configs of tests/test_llm_families.py that build offline
HF_CONFIGS = {
    "llama": ("LlamaConfig", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                  num_hidden_layers=2, num_attention_heads=4,
                                  num_key_value_heads=2, tie_word_embeddings=False)),
    "llama_rope_scaling": ("LlamaConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2,
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 16})),
    "qwen2": ("Qwen2Config", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                  num_hidden_layers=2, num_attention_heads=4,
                                  num_key_value_heads=2, tie_word_embeddings=False)),
    "qwen2_sliding": ("Qwen2Config", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                          num_hidden_layers=4, num_attention_heads=4,
                                          num_key_value_heads=2, use_sliding_window=True,
                                          sliding_window=8, max_window_layers=2)),
    "qwen3": ("Qwen3Config", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                  num_hidden_layers=2, num_attention_heads=4,
                                  num_key_value_heads=2, head_dim=8)),
    "mixtral": ("MixtralConfig", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                      num_hidden_layers=2, num_attention_heads=4,
                                      num_key_value_heads=2, num_local_experts=4,
                                      num_experts_per_tok=2)),
    "qwen3_moe": ("Qwen3MoeConfig", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                         moe_intermediate_size=16, num_hidden_layers=2,
                                         num_attention_heads=4, num_key_value_heads=2,
                                         head_dim=8, num_experts=4, num_experts_per_tok=2)),
    "gemma2": ("Gemma2Config", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                    num_hidden_layers=2, num_attention_heads=4,
                                    num_key_value_heads=2, head_dim=8,
                                    query_pre_attn_scalar=8, sliding_window=8)),
    "gemma3": ("Gemma3TextConfig", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                        num_hidden_layers=6, num_attention_heads=4,
                                        num_key_value_heads=2, head_dim=8,
                                        query_pre_attn_scalar=8, sliding_window=8)),
    "phi3": ("Phi3Config", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=2, pad_token_id=0, sliding_window=16)),
    "olmo2": ("Olmo2Config", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                  num_hidden_layers=2, num_attention_heads=4,
                                  num_key_value_heads=2)),
    "cohere": ("CohereConfig", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                    num_hidden_layers=2, num_attention_heads=4,
                                    num_key_value_heads=2, use_qk_norm=True)),
    "starcoder2": ("Starcoder2Config", dict(vocab_size=96, hidden_size=32,
                                            intermediate_size=64, num_hidden_layers=2,
                                            num_attention_heads=4, num_key_value_heads=2)),
    "glm4": ("Glm4Config", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=2, head_dim=8, pad_token_id=0)),
    "granite": ("GraniteConfig", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                      num_hidden_layers=2, num_attention_heads=4,
                                      num_key_value_heads=2, embedding_multiplier=2.0,
                                      attention_multiplier=0.5, residual_multiplier=0.7,
                                      logits_scaling=4.0)),
    "smollm3": ("SmolLM3Config", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                      num_hidden_layers=4, num_attention_heads=4,
                                      num_key_value_heads=2, pad_token_id=0)),
    "mistral": ("MistralConfig", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                      num_hidden_layers=2, num_attention_heads=4,
                                      num_key_value_heads=2, sliding_window=8)),
    "nemotron": ("NemotronConfig", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                        num_hidden_layers=2, num_attention_heads=4,
                                        num_key_value_heads=2)),
    "ernie4_5": ("Ernie4_5Config", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                        num_hidden_layers=2, num_attention_heads=4,
                                        num_key_value_heads=2)),
    "phi": ("PhiConfig", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                              num_hidden_layers=2, num_attention_heads=4)),
    "seed_oss": ("SeedOssConfig", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                       num_hidden_layers=2, num_attention_heads=4,
                                       num_key_value_heads=2, head_dim=8)),
    "apertus": ("ApertusConfig", dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                                      num_hidden_layers=2, num_attention_heads=4,
                                      num_key_value_heads=2)),
    "gpt2": ("GPT2Config", dict(vocab_size=96, n_positions=64, n_embd=32, n_layer=2,
                                n_head=4)),
    # families served by the reference's llm/models/ (not ModelSpec ones):
    # the two packages' spec detection and config still agree on them
    "llama4_text": ("Llama4TextConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, intermediate_size_mlp=64,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        tie_word_embeddings=False, interleave_moe_layer_step=0, moe_layers=[],
        no_rope_layer_interval=4, use_qk_norm=True, rope_scaling=None)),
    "deepseek_v3": ("DeepseekV3Config", dict(
        vocab_size=96, hidden_size=48, num_hidden_layers=3, num_attention_heads=2,
        num_key_value_heads=2, q_lora_rank=24, kv_lora_rank=16, qk_rope_head_dim=4,
        qk_nope_head_dim=8, v_head_dim=8, intermediate_size=64, moe_intermediate_size=32,
        n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2, n_group=4,
        topk_group=2, first_k_dense_replace=1, pad_token_id=0)),
    "deepseek_v2": ("DeepseekV2Config", dict(
        vocab_size=96, hidden_size=48, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=2, kv_lora_rank=16, qk_rope_head_dim=4, qk_nope_head_dim=8,
        v_head_dim=8, intermediate_size=64, moe_intermediate_size=32, n_routed_experts=8,
        n_shared_experts=1, num_experts_per_tok=2, first_k_dense_replace=0,
        pad_token_id=0)),
    "gpt_oss": ("GptOssConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=48, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8, num_local_experts=4,
        num_experts_per_tok=2, sliding_window=8,
        layer_types=["sliding_attention", "full_attention"] * 2, pad_token_id=0)),
    "lfm2": ("Lfm2Config", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2,
        layer_types=["conv", "full_attention", "conv", "full_attention"],
        conv_L_cache=3, block_auto_adjust_ff_dim=False, pad_token_id=0)),
    "qwen3_next": ("Qwen3NextConfig", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        layer_types=["linear_attention", "full_attention"] * 2, linear_num_value_heads=4,
        linear_num_key_heads=2, linear_key_head_dim=8, linear_value_head_dim=8,
        linear_conv_kernel_dim=4, partial_rotary_factor=0.25, pad_token_id=0)),
    "mamba": ("MambaConfig", dict(vocab_size=96, hidden_size=32, state_size=8,
                                  num_hidden_layers=2, conv_kernel=4, intermediate_size=64,
                                  time_step_rank=4, pad_token_id=0)),
}


def _hf_config(key: str):
    cls_name, kw = HF_CONFIGS[key]
    cls = getattr(transformers, cls_name, None)
    if cls is None:
        pytest.skip(f"transformers {transformers.__version__} has no {cls_name}")
    return cls(**kw)


def _hf_names(cfg) -> list[str]:
    """The state-dict names of the config's tiny causal LM; GPT-2's without
    its ``transformer.`` prefix."""
    m = transformers.AutoModelForCausalLM.from_config(cfg)
    return [n.replace("transformer.", "") for n in m.state_dict()]


def _spec_name(mod, names):
    try:
        return mod.detect_model_spec(names).name
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("key", list(HF_CONFIGS))
def test_detect_spec_and_from_hf_config_match_the_reference(key):
    cfg = _hf_config(key)
    names = _hf_names(cfg)
    assert _spec_name(port_config, names) == _spec_name(ref_config, names)
    hf = cfg.to_dict()
    for spec_arg in (None, "detected"):
        rspec = pspec = None
        if spec_arg == "detected" and isinstance(_spec_name(ref_config, names), str):
            rspec = ref_config.detect_model_spec(names)
            pspec = port_config.detect_model_spec(names)
        want = dataclasses.asdict(ref_config.TransformerConfig.from_hf_config(hf, rspec))
        got = dataclasses.asdict(port_config.TransformerConfig.from_hf_config(hf, pspec))
        assert got == want


def test_specs_and_legacy_configs_are_the_references():
    assert set(port_config.MODEL_SPECS) == set(ref_config.MODEL_SPECS)
    assert len(port_config.MODEL_SPECS) == 17
    for name, spec in port_config.MODEL_SPECS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(ref_config.MODEL_SPECS[name])
    for cls in ("GPT2Config", "LlamaConfig", "Qwen3Config"):
        want = getattr(ref_config, cls)().to_transformer_config()
        got = getattr(port_config, cls)().to_transformer_config()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    hf = {"rope_scaling": {"type": "longrope"}, "original_max_position_embeddings": 64}
    assert port_config._merge_rope_scaling(hf) == ref_config._merge_rope_scaling(hf)


# ---------------------------------------------------------------------------
# KV dtype: kv_dtype_from_quant_config, resolve_kv_dtype
# ---------------------------------------------------------------------------

ALGOS = [None, "FP8", "fp8", "FP8_E5M2", "e4m3", "INT8", "int8_sq", "w4a16"]


@pytest.mark.parametrize("algo", ALGOS)
def test_kv_dtype_from_quant_config_matches_the_reference(algo, recwarn):
    qc = None if algo is None else {"kv_cache_quant_algo": algo}
    want = ref_quant.kv_dtype_from_quant_config(qc)
    n_ref = len(recwarn)
    got = pl.kv_dtype_from_quant_config(qc)
    assert got == want
    assert len(recwarn) == 2 * n_ref          # the unknown algo warns in both
    assert pl.kv_dtype_from_quant_config({}) is None


KV_NAMES = ["fp8", "fp8_e4m3", "e4m3", "fp8_e5m2", "e5m2", "int8", "bf16", "bfloat16",
            "f32", "float32"]


def _jax_name(d) -> str:
    return jnp.dtype(d).name


@pytest.mark.parametrize("name", KV_NAMES)
@pytest.mark.parametrize("via", ["arg", "env"])
def test_resolve_kv_dtype_matches_the_reference(monkeypatch, name, via):
    if via == "env":
        monkeypatch.setenv("PYGPUKIT_KV_DTYPE", name)
        arg = None
    else:
        monkeypatch.delenv("PYGPUKIT_KV_DTYPE", raising=False)
        arg = name
    want = _jax_name(ref_model.resolve_kv_dtype(arg, jnp.float32))
    got = port_model.resolve_kv_dtype(arg, torch.float32)
    assert str(got).removeprefix("torch.") == want


@pytest.mark.parametrize("name", ["int4", "uint8", "int32", "fp16", "INT8", "e4m3fn"])
@pytest.mark.parametrize("via", ["arg", "env"])
def test_unknown_kv_dtype_raises_in_both(monkeypatch, name, via):
    if via == "env":
        monkeypatch.setenv("PYGPUKIT_KV_DTYPE", name)
    arg = None if via == "env" else name
    with pytest.raises(ValueError):
        ref_model.resolve_kv_dtype(arg, jnp.float32)
    with pytest.raises(ValueError):
        port_model.resolve_kv_dtype(arg, torch.float32)


def test_resolve_kv_dtype_order(monkeypatch):
    monkeypatch.setenv("PYGPUKIT_KV_DTYPE", "int8")
    assert port_model.resolve_kv_dtype("fp8", torch.bfloat16) == torch.float8_e4m3fn
    assert port_model.resolve_kv_dtype(torch.float32, torch.bfloat16) == torch.float32
    monkeypatch.setenv("PYGPUKIT_KV_DTYPE", "")
    assert port_model.resolve_kv_dtype(None, torch.bfloat16) == torch.bfloat16


TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=64, max_position_embeddings=64, tie_word_embeddings=False)


def test_env_selects_int8_pools_in_both_packages(monkeypatch):
    monkeypatch.setenv("PYGPUKIT_KV_DTYPE", "int8")
    jcfg = ref_config.TransformerConfig(**TINY)
    jp = ref_model.init_params(jcfg, 0, jnp.float32)
    jm = ref_model.CausalTransformerModel(jcfg, jp, dtype=jnp.float32)
    tm = port_model.CausalTransformerModel(port_config.TransformerConfig(**TINY),
                                           pl.params_from_jax(jax.tree.map(np.asarray, jp)),
                                           dtype=torch.float32)
    assert _jax_name(jm.kv_dtype) == "int8" and tm.kv_dtype == torch.int8
    jm.init_fixed_cache(16)
    tm.init_fixed_cache(16)
    for jc, tc in ((jm.k_cache, tm.k_cache), (jm.v_cache, tm.v_cache)):
        assert isinstance(jc, dict) and isinstance(tc, dict)
        assert str(np.asarray(jc["q"]).dtype) == "int8" and tc["q"].dtype == torch.int8
        assert tuple(tc["q"].shape) == tuple(np.asarray(jc["q"]).shape)
    eng = pl.ContinuousBatchingEngine(tm, max_batch=2, max_seq_len=32)
    assert isinstance(eng.k_cache, dict) and eng.k_cache["q"].dtype == torch.int8


# ---------------------------------------------------------------------------
# Loader: tiny checkpoints written by transformers
# ---------------------------------------------------------------------------

def _save(tmp_path_factory, name, cfg, seed):
    d = tmp_path_factory.mktemp(name)
    torch.manual_seed(seed)
    m = transformers.AutoModelForCausalLM.from_config(cfg).eval()
    m.save_pretrained(d, safe_serialization=True)
    return d, m


@pytest.fixture(scope="module")
def llama_ckpt(tmp_path_factory):
    cfg = transformers.LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=64,
                                   tie_word_embeddings=False)
    return _save(tmp_path_factory, "llama", cfg, 1)


@pytest.fixture(scope="module")
def mixtral_ckpt(tmp_path_factory):
    cfg = transformers.MixtralConfig(vocab_size=96, hidden_size=32, intermediate_size=64,
                                     num_hidden_layers=2, num_attention_heads=4,
                                     num_key_value_heads=2, num_local_experts=4,
                                     num_experts_per_tok=2, max_position_embeddings=64,
                                     tie_word_embeddings=False)
    return _save(tmp_path_factory, "mixtral", cfg, 2)


@pytest.fixture(scope="module")
def tied_ckpt(tmp_path_factory):
    cfg = transformers.LlamaConfig(vocab_size=96, hidden_size=32, intermediate_size=64,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=4, max_position_embeddings=64,
                                   tie_word_embeddings=True)
    return _save(tmp_path_factory, "tied", cfg, 3)


@pytest.fixture(params=["llama", "mixtral", "tied"])
def ckpt(request):
    return request.getfixturevalue(f"{request.param}_ckpt")


def _without_rope(tree: dict) -> dict:
    return {k: v for k, v in tree.items() if not k.startswith("rope_")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse", [True, False])
def test_loaded_params_equal_the_references_bitwise(ckpt, dtype, fuse):
    d, _ = ckpt
    jm = rl.load_model_from_safetensors(d, dtype=dtype, fuse=fuse)
    tm = pl.load_model_from_safetensors(d, dtype=dtype, fuse=fuse, device="cpu")
    want = pl.params_from_jax(jax.tree.map(np.asarray, jm.params))
    _tree_equal(_without_rope(want), _without_rope(tm.params))
    assert tm.spec.name == jm.spec.name
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    assert tm.params["layers"]["attn_norm_w"].dtype == torch.float32
    if tm.config.is_moe:
        assert tm.params["layers"]["w_router"].dtype == torch.float32
    head = tm.params["lm_head"]
    if tm.config.tie_word_embeddings:
        assert head is None
    else:
        assert tuple(head.shape) == (tm.config.hidden_size, tm.config.vocab_size)


@pytest.mark.parametrize("fuse", [True, False])
def test_f32_logits_match_the_reference_and_transformers(ckpt, fuse):
    d, m = ckpt
    ids = [1, 8, 60, 33, 7]
    tm = pl.load_model_from_safetensors(d, dtype="float32", fuse=fuse, device="cpu")
    jm = rl.load_model_from_safetensors(d, dtype="float32", fuse=fuse)
    ours = tm.get_logits(ids)
    with torch.no_grad():
        hf = m(torch.tensor([ids])).logits[0].numpy()
    np.testing.assert_allclose(ours, jm.get_logits(ids), **TOL)
    np.testing.assert_allclose(ours, hf, **TOL)


def test_greedy_tokens_equal_transformers(ckpt):
    d, m = ckpt
    tm = pl.load_model_from_safetensors(d, dtype="float32", max_seq_len=64, device="cpu")
    prompt = [1, 45, 70]
    ours = tm.generate(prompt, max_new_tokens=8, temperature=0.0)
    ref = m.generate(torch.tensor([prompt]), max_new_tokens=8, do_sample=False,
                     pad_token_id=0)[0, len(prompt):].tolist()
    assert ours == ref
    assert tm.max_seq_len == 64


def test_per_architecture_loaders_and_a_single_file_path(llama_ckpt, mixtral_ckpt):
    d, _ = llama_ckpt
    m = pl.load_llama_from_safetensors(d / "model.safetensors", device="cpu")
    assert m.dtype == torch.bfloat16 and m.spec.name == "llama"
    m = pl.load_mixtral_from_safetensors(mixtral_ckpt[0], dtype=torch.float32, device="cpu")
    assert m.config.is_moe and m.params["layers"]["w_experts_gate"].shape[1] == 4


def test_sharded_checkpoint_loads_as_the_single_file(llama_ckpt, tmp_path):
    d, _ = llama_ckpt
    shutil.copy(d / "config.json", tmp_path / "config.json")
    with port_st.SafeTensorsFile(d / "model.safetensors") as st:
        names = st.keys()
        half = len(names) // 2
        wm = {}
        for i, part in enumerate((names[:half], names[half:])):
            shard = f"model-0000{i + 1}-of-00002.safetensors"
            port_st.save_safetensors(tmp_path / shard, {n: st.tensor(n) for n in part})
            wm.update({n: shard for n in part})
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": wm}))
    a = pl.load_model_from_safetensors(d, dtype="float32", device="cpu")
    b = pl.load_model_from_safetensors(tmp_path, dtype="float32", device="cpu")
    _tree_equal(a.params, b.params)


def test_kv_dtype_comes_from_the_quantization_config(llama_ckpt, tmp_path, monkeypatch):
    monkeypatch.delenv("PYGPUKIT_KV_DTYPE", raising=False)
    d, _ = llama_ckpt
    shutil.copy(d / "model.safetensors", tmp_path / "model.safetensors")
    hf = json.loads((d / "config.json").read_text())
    hf["quantization_config"] = {"quant_algo": "FP8", "kv_cache_quant_algo": "FP8"}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    tm = pl.load_model_from_safetensors(tmp_path, dtype="float32", device="cpu")
    jm = rl.load_model_from_safetensors(tmp_path, dtype="float32")
    assert tm.kv_dtype == torch.float8_e4m3fn and _jax_name(jm.kv_dtype) == "float8_e4m3fn"
    tm = pl.load_model_from_safetensors(tmp_path, dtype="float32", kv_dtype="int8",
                                        device="cpu")
    assert tm.kv_dtype == torch.int8


@pytest.mark.parametrize("which", ["llama", "mixtral", "qwen3"])
def test_infer_config_without_config_json_matches_the_reference(tmp_path_factory, which):
    if which == "qwen3":
        cfg = transformers.Qwen3Config(vocab_size=96, hidden_size=32, intermediate_size=64,
                                       num_hidden_layers=2, num_attention_heads=4,
                                       num_key_value_heads=2, head_dim=8)
    elif which == "mixtral":
        cfg = transformers.MixtralConfig(vocab_size=96, hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=3, num_attention_heads=4,
                                         num_key_value_heads=2, num_local_experts=4)
    else:
        cfg = transformers.LlamaConfig(vocab_size=96, hidden_size=128, intermediate_size=64,
                                       num_hidden_layers=3, num_attention_heads=2,
                                       num_key_value_heads=1)
    d, _ = _save(tmp_path_factory, f"bare_{which}", cfg, 4)
    (d / "config.json").unlink()
    rs, ps = ref_st.load_safetensors(d), port_st.load_safetensors(d)
    rspec = ref_config.detect_model_spec(rs.keys())
    pspec = port_config.detect_model_spec(ps.keys())
    assert pspec.name == rspec.name
    assert port_loader._find_config_json(d) is None
    want = ref_loader._infer_config(rs, rspec, None)
    got = port_loader._infer_config(ps, pspec, None)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    rs.close()
    ps.close()


def test_a_qwen2_checkpoint_is_refused_at_load(tmp_path_factory):
    """Qwen2 and OLMo-2 load now (tests/test_torch_families.py): an OLMo-2
    checkpoint loads fused or not, its leaves bitwise the reference's (no
    input norms, whole-width q/k norms); a config naming an activation
    outside the config's set is refused at load, fused or not."""
    cfg = transformers.Olmo2Config(vocab_size=96, hidden_size=32, intermediate_size=64,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, tie_word_embeddings=False)
    d, _ = _save(tmp_path_factory, "olmo2", cfg, 0)
    for fuse in (True, False):
        jm = rl.load_model_from_safetensors(d, dtype="float32", fuse=fuse)
        tm = pl.load_model_from_safetensors(d, dtype="float32", fuse=fuse, device="cpu")
        want = pl.params_from_jax(jax.tree.map(np.asarray, jm.params))
        _tree_equal(_without_rope(want), _without_rope(tm.params))
        assert "attn_norm_w" not in tm.params["layers"]
        assert tuple(tm.params["layers"]["w_k_norm"].shape) == (2, 16)
        bad = dataclasses.replace(tm.config, activation="relu")
        with pytest.raises(NotImplementedError, match="relu"):
            pl.load_model_from_safetensors(d, dtype="float32", fuse=fuse, config=bad,
                                           device="cpu")


def test_a_qk_norm_checkpoint_is_refused_before_its_weights_load(tmp_path_factory, monkeypatch):
    """Qwen3's and Cohere's q/k norms load now: a Cohere checkpoint with
    them (parallel blocks, interleaved rope, a logit scale, per-head norm
    weights [L, H, D]) loads bitwise the reference's leaves; a config the
    model refuses is refused before any weight is read."""
    cfg = transformers.CohereConfig(vocab_size=96, hidden_size=32, intermediate_size=64,
                                    num_hidden_layers=2, num_attention_heads=4,
                                    num_key_value_heads=2, use_qk_norm=True)
    d, _ = _save(tmp_path_factory, "cohere", cfg, 0)
    jm = rl.load_model_from_safetensors(d, dtype="float32")
    tm = pl.load_model_from_safetensors(d, dtype="float32", device="cpu")
    want = pl.params_from_jax(jax.tree.map(np.asarray, jm.params))
    _tree_equal(_without_rope(want), _without_rope(tm.params))
    assert tuple(tm.params["layers"]["w_q_norm"].shape) == (2, 4, 8)

    def no_weights(*a, **k):
        raise AssertionError("a weight was read")
    monkeypatch.setattr(port_loader, "_build_params", no_weights)
    with pytest.raises(NotImplementedError, match="relu"):
        pl.load_model_from_safetensors(d, dtype="float32", device="cpu",
                                       config=dataclasses.replace(tm.config,
                                                                  activation="relu"))


# ---------------------------------------------------------------------------
# The params setter
# ---------------------------------------------------------------------------

def test_params_setter_after_a_capture_releases_the_programs():
    """``model.params = tree`` after the decode step was captured: the next
    step equals a fresh model's on that tree from the same cache state,
    and the old weight tensors are unchanged (a stale program would have
    raised, bound to them by address, or copied into them)."""
    cfg = port_config.TransformerConfig(**TINY)
    params = port_model.init_params(cfg, 5, torch.float32, device="cpu")
    model = port_model.CausalTransformerModel(cfg, params, dtype=torch.float32)
    model.init_fixed_cache(32)
    logits = model.prefill([3, 9, 27, 5])
    tok = int(torch.argmax(logits))
    model.decode_step(tok)
    assert model.graphs.get(("decode", False)) is not None
    old = {k: v.clone() for k, v in model.params["layers"].items()}
    old_refs = dict(model.params["layers"])
    snap = model.snapshot_kv_cache()

    int8_tree = pl.quantize_model_params(model.params, "int8")
    model.params = int8_tree
    assert model.graphs.get(("decode", False)) is None
    assert model.decode_buffers is None and model.prefill_buffers is None
    assert isinstance(model.params["layers"]["w_q"], dict)
    got = model.decode_step(7).clone()

    fresh = port_model.CausalTransformerModel(cfg, int8_tree, dtype=torch.float32)
    fresh.init_fixed_cache(32)
    fresh.restore_kv_cache(snap)
    want = fresh.decode_step(7)
    assert torch.equal(got, want)
    for k, v in old.items():
        assert torch.equal(old_refs[k], v), k
    assert model.pos == fresh.pos == snap.pos + 1


def test_params_setter_keeps_the_reference_idiom_working():
    cfg = port_config.TransformerConfig(**TINY)
    model = port_model.CausalTransformerModel(
        cfg, port_model.init_params(cfg, 1, torch.float32, device="cpu"), dtype=torch.float32)
    before = set(dict(model.named_buffers()))
    model.params = pl.quantize_model_params(model.params, "int4")
    after = set(dict(model.named_buffers()))
    assert "layers__w_q__q_packed" in after and "layers__w_q" not in after
    assert before - after == {"layers__" + k for k in ("w_q", "w_k", "w_v", "w_o", "w_gate",
                                                       "w_up", "w_down")} | {"lm_head"}
    out = model.generate([1, 2, 3], max_new_tokens=3)
    assert len(out) == 3
    with pytest.raises(NotImplementedError):     # a leaf the model does not know
        model.params = dict(model.params, layers=dict(model.params["layers"],
                                                      act_gamma=torch.ones(2)))


# ---------------------------------------------------------------------------
# Quant metadata and helpers
# ---------------------------------------------------------------------------

def test_quant_metadata_matches_the_reference():
    for cls in ("FP8QuantConfig", "QATConfig", "PruningConfig", "SparsityConfig",
                "ModelOptimizationInfo", "QuantizationMetadata"):
        assert dataclasses.asdict(getattr(pl, cls)()) == dataclasses.asdict(getattr(ref_quant, cls)())
    assert pl.QATQuantConfig is pl.QATConfig


@pytest.mark.parametrize("mode", ["int4", "int8", "fp8", "int4_block"])
def test_dequantize_model_params_and_quant_bytes_match_the_reference(mode):
    jcfg = ref_config.TransformerConfig(**TINY)
    jp = ref_quant.quantize_model_params(ref_model.init_params(jcfg, 2, jnp.float32), mode)
    tp = pl.params_from_jax(jax.tree.map(np.asarray, jp))
    assert pl.model_quant_bytes(tp) == ref_quant.model_quant_bytes(jp)
    want = pl.params_from_jax(jax.tree.map(
        np.asarray, ref_quant.dequantize_model_params(jp, jnp.float32)))
    _tree_equal(want, pl.dequantize_model_params(tp, torch.float32))


# ---------------------------------------------------------------------------
# The package boundary
# ---------------------------------------------------------------------------

#: reference names outside this slice (XLA-only workarounds, later items)
NOT_PORTED = {"repack_model_weights", "repack_linear", "repack_norm", "repack_weight",
              "PoolStats", "Dtype", "sample_token"}


def test_every_reference_llm_name_of_the_slice_is_exported():
    missing = sorted(n for n in set(rl.__all__) - NOT_PORTED if not hasattr(pl, n))
    assert not missing
    assert pl.GPT2Model is pl.LlamaModel is pl.QwenModel is pl.CausalTransformerModel
    q = np.arange(24, dtype=np.float32).reshape(3, 2, 4) / 10
    k = np.ones((3, 1, 4), np.float32)
    cos, sin = np.cos(np.arange(12).reshape(3, 4)), np.sin(np.arange(12).reshape(3, 4))
    for a, b in zip(pl.apply_rotary_pos_emb_numpy(q, k, cos, sin),
                    rl.apply_rotary_pos_emb_numpy(q, k, cos, sin)):
        np.testing.assert_array_equal(a, b)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted((ROOT / "pygpukit_tpu_torch").rglob("*.py"))
                         + [ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_module_imports_jax_or_the_reference(path):
    assert not _imports(path) & {"jax", "jaxlib", "pygpukit_tpu"}
