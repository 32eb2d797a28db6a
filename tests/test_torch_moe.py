"""The port's MoE path (``ops.moe``, ``kernels.gmm`` and the routed expert
MLP in ``llm.model``) against the JAX package on the CPU, seeded numpy
inputs through both:

- ``topk_route_fn``: ids equal (ties included), weights within rtol 1e-6;
- ``gmm_plain`` against megablox ``gmm`` in interpret mode (M 256, K 128,
  N 256, G 4, empty groups and uneven boundaries): within 1e-5 of max
  |out| (the same exact bf16 products summed in f32 in another order);
- ``moe_gmm_fn`` against the reference's with megablox ``gmm`` patched to
  interpret mode: f32 within 1e-5 of max |out|, bf16 within one bf16 ulp
  (2^-7) of max |out|; ``moe_gather_fn`` and ``moe_dense_fn`` at f32
  (rtol 1e-5) and bf16 (the reference compiled without XLA's excess
  precision), dense and fp8/int8 expert stacks;
- ``quantize_model_params``: expert leaves byte-equal for fp8 and int8,
  dense for the packed 4-bit modes;
- the route rule, and the reference's fault at T * k = 200 (megablox
  needs 128-row multiples; the port computes);
- a tiny Mixtral (2 layers, hidden 64, 4/2 heads, 4 experts, top-2 and
  top-4) at f32: forward, prefill and decode steps, the batch-rows step at
  rtol 1e-4, the batch engine's greedy streams on a peaked model;
- a transformers ``MixtralForCausalLM`` loaded by the reference loader and
  carried across: logits within rtol 1e-4 of HF's, greedy tokens equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import megablox

from pygpukit_tpu.llm import CausalTransformerModel as JaxModel
from pygpukit_tpu.llm import TransformerConfig as JaxConfig
from pygpukit_tpu.llm import init_params as jax_init_params
from pygpukit_tpu.llm import model as jax_model
from pygpukit_tpu.llm.model import fuse_params as jax_fuse_params
from pygpukit_tpu.llm.quant import quantize_model_params as jax_quantize_model
from pygpukit_tpu.llm.quant import quantize_weight as jax_quantize_weight
from pygpukit_tpu.llm.serving import ContinuousBatchingEngine as JaxEngine
from pygpukit_tpu.ops import moe as jax_moe
from pygpukit_tpu_torch.kernels import LAUNCHES, gmm, gmm_plain
from pygpukit_tpu_torch.llm import (CausalTransformerModel, ContinuousBatchingEngine,
                                    TransformerConfig, batch_decode_step_fn,
                                    check_supported, fused_decode_eligible,
                                    params_from_jax, quantize_model_params)
from pygpukit_tpu_torch.ops import moe

torch.set_num_threads(2)

ULP = 2.0 ** -7
MOE_CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
               intermediate_size=96, num_experts=4, num_experts_per_tok=2,
               max_position_embeddings=256, tie_word_embeddings=False)
PROMPTS = [[5, 11, 42], [7, 3], [9, 9, 1, 4, 60, 2, 8], [1, 2], [33, 8, 15, 2, 71]]
N_NEW = [8, 8, 6, 9, 7]


def _t(a):
    return params_from_jax(np.asarray(a))


def _tree(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _bf16_exact(fn, *args):
    """``jax.jit(fn)(*args)`` compiled with ``xla_allow_excess_precision``
    off, so XLA keeps every bf16 rounding the reference writes."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})(*args)


@pytest.fixture
def interpret_gmm(monkeypatch):
    """megablox gmm in interpret mode, as the reference's moe_gmm_fn
    imports it at call time (the JAX package is not edited)."""
    monkeypatch.setattr(megablox, "gmm", functools.partial(megablox.gmm, interpret=True))


def _moe_inputs(t, e=4, h=64, inter=96, dtype="f32", quant=None, seed=0):
    """(jax args, port args) of one MoE call: y [T, H], the three expert
    stacks (dense or quantized by the reference's quantize_weight) and f32
    router logits [T, E]."""
    rng = np.random.default_rng(seed)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    y = jnp.asarray(rng.standard_normal((t, h)), jdt)
    ws = [jnp.asarray(rng.standard_normal(shape) * 0.1, jdt)
          for shape in ((e, h, inter), (e, h, inter), (e, inter, h))]
    if quant:
        ws = [jax_quantize_weight(w, quant) for w in ws]
    router = jnp.asarray(rng.standard_normal((t, e)), jnp.float32)
    jargs = (y, *ws, router)
    return jargs, tuple(_tree(a) for a in jargs)


# ---------------------------------------------------------------------------
# Routing and gmm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
def test_topk_route_matches_reference(k):
    rng = np.random.default_rng(k)
    logits = np.round(rng.standard_normal((64, 8)), 1).astype(np.float32)  # ties
    wj, ij = jax_moe.topk_route_fn(jnp.asarray(logits), k)
    wt, it = moe.topk_route_fn(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6)


@pytest.mark.parametrize("sizes", [[100, 0, 56, 100], [1, 127, 0, 128]])
def test_gmm_plain_matches_megablox(sizes):
    rng = np.random.default_rng(len(sizes) + sizes[0])
    lhs = jnp.asarray(rng.standard_normal((256, 128)), jnp.bfloat16)
    rhs = jnp.asarray(rng.standard_normal((4, 128, 256)), jnp.bfloat16)
    gs = jnp.asarray(sizes, jnp.int32)
    ref = np.asarray(megablox.gmm(lhs, rhs, gs, interpret=True))
    before = LAUNCHES["gmm"]
    got = gmm(_t(lhs), _t(rhs), _t(gs))
    assert LAUNCHES["gmm"] == before and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_array_equal(gmm_plain(_t(lhs), _t(rhs), sizes).numpy(), got.numpy())


def test_gmm_plain_zeroes_rows_past_the_sum():
    lhs = torch.ones((10, 8), dtype=torch.bfloat16)
    rhs = torch.ones((2, 8, 16), dtype=torch.bfloat16)
    out = gmm(lhs, rhs, torch.tensor([3, 4], dtype=torch.int32))
    assert torch.equal(out[:7], torch.full((7, 16), 8.0))
    assert torch.equal(out[7:], torch.zeros((3, 16)))
    with pytest.raises(ValueError):
        gmm(lhs, rhs, torch.tensor([3, 4, 3], dtype=torch.int32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t,k", [(128, 2), (64, 4)])
def test_moe_gmm_matches_reference(interpret_gmm, t, k, dtype):
    jargs, targs = _moe_inputs(t, dtype=dtype, seed=t + k)
    ref = np.asarray(jax_moe.moe_gmm_fn(*jargs, k))
    got = moe.moe_gmm_fn(*targs, k)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    tol = 1e-5 if dtype == "f32" else ULP
    assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()


def test_reference_gmm_needs_128_row_multiples_and_the_port_does_not(interpret_gmm):
    """megablox tiles rows by 128: the reference's moe_gmm_fn raises at T * k
    = 200 (a 100-token Mixtral prompt on its gmm route); the port computes,
    equal to the reference's dense formulation at f32."""
    jargs, targs = _moe_inputs(100, seed=7)
    with pytest.raises(ValueError, match="divisible"):
        jax_moe.moe_gmm_fn(*jargs, 2)
    got = moe.moe_gmm_fn(*targs, 2).numpy()
    ref = np.asarray(jax_moe.moe_dense_fn(*jargs, 2))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("quant", [None, "fp8", "int8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,t", [("moe_gather_fn", 3), ("moe_dense_fn", 12)])
def test_gather_and_dense_match_reference(name, t, dtype, quant):
    jargs, targs = _moe_inputs(t, dtype=dtype, quant=quant, seed=t)
    jfn = functools.partial(getattr(jax_moe, name), k=2)
    got = getattr(moe, name)(*targs, 2).numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, np.asarray(jfn(*jargs)), rtol=1e-5, atol=1e-6)
    else:
        ref = np.asarray(_bf16_exact(jfn, *jargs))
        assert np.abs(got - ref).max() <= ULP * np.abs(ref).max()


@pytest.mark.parametrize("mode", ["fp8", "int8", "int4", "int4_block"])
def test_quantize_model_params_expert_stacks(mode):
    """fp8/int8 expert leaves byte-equal to the reference's; the packed
    4-bit modes leave the experts dense, as the reference does."""
    jcfg = JaxConfig(**MOE_CFG)
    params = jax_init_params(jcfg, 2, jnp.bfloat16)
    ref = jax.tree.map(np.asarray, jax_quantize_model(params, mode))
    got = quantize_model_params(_tree(params), mode)
    for name in ("w_experts_gate", "w_experts_up", "w_experts_down"):
        r, g = ref["layers"][name], got["layers"][name]
        if mode in ("fp8", "int8"):
            assert set(g) == {"q", "scale"}
            for key in ("q", "scale"):
                assert g[key].dtype == _t(r[key]).dtype
                assert torch.equal(g[key].view(torch.uint8), _t(r[key]).view(torch.uint8))
        else:
            assert isinstance(g, torch.Tensor) and not isinstance(r, dict)


def test_route_rule(monkeypatch):
    """CPU: gather to T 4, dense above (the reference's off-TPU rule);
    CUDA: gmm from T * k >= 128, gather to T 4, dense between;
    PYGPUKIT_MOE=dense forces dense everywhere."""
    def names(device):
        return [moe.select_moe_fn(t, k, device).__name__
                for t, k in ((1, 2), (4, 2), (5, 2), (8, 2), (63, 2), (64, 2), (16, 8))]
    monkeypatch.delenv("PYGPUKIT_MOE", raising=False)
    cpu = ["moe_gather_fn"] * 2 + ["moe_dense_fn"] * 5
    assert names("cpu") == cpu
    assert names("cpu") == [jax_moe.select_moe_fn(t, k).__name__
                            for t, k in ((1, 2), (4, 2), (5, 2), (8, 2), (63, 2), (64, 2), (16, 8))]
    assert names("cuda") == ["moe_gather_fn"] * 2 + ["moe_dense_fn"] * 3 + ["moe_gmm_fn"] * 2
    assert moe.use_gmm("cuda") and not moe.use_gmm("cpu")
    monkeypatch.setenv("PYGPUKIT_MOE", "dense")
    assert set(names("cpu")) == set(names("cuda")) == {"moe_dense_fn"}
    assert not moe.use_gmm("cuda")


# ---------------------------------------------------------------------------
# A tiny Mixtral through every model path
# ---------------------------------------------------------------------------

def _pair(k=2, seed=5, peaked=False):
    """(JAX model, port model) over identical f32 params (q/k/v fused)."""
    cfg_kw = dict(MOE_CFG, num_experts_per_tok=k)
    jcfg = JaxConfig(**cfg_kw)
    params = jax_fuse_params(jax_init_params(jcfg, seed, jnp.float32))
    if peaked:                            # well-separated greedy choices
        params = dict(params, lm_head=params["lm_head"] * 20.0)
    jm = JaxModel(jcfg, params, dtype=jnp.float32)
    tm = CausalTransformerModel(TransformerConfig(**cfg_kw), _tree(jm.params),
                                dtype=torch.float32)
    return jm, tm


@pytest.fixture(scope="module", params=[2, 4], ids=["top2", "top4"])
def moe_pair(request):
    return _pair(k=request.param)


def test_check_supported_accepts_moe_and_fused_decode_refuses_it(moe_pair):
    _, tm = moe_pair
    check_supported(tm.config)
    assert tm.config.is_moe and "w_gate" not in tm.params["layers"]
    assert not fused_decode_eligible(tm.config, tm.params, 128)


@pytest.mark.parametrize("s", [3, 40])
def test_forward_matches_reference(moe_pair, s):
    jm, tm = moe_pair
    ids = np.random.default_rng(s).integers(1, 97, s).tolist()
    np.testing.assert_allclose(tm.get_logits(ids), jm.get_logits(ids), rtol=1e-4, atol=1e-5)


def test_prefill_and_decode_steps_match_reference(moe_pair):
    jm, tm = moe_pair
    jm.init_fixed_cache(128)
    tm.init_fixed_cache(128)
    prompt = PROMPTS[2]
    ref, got = np.asarray(jm.prefill(prompt)), tm.prefill(prompt).numpy()
    for step in range(5):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5, err_msg=f"step {step}")
        tok = int(np.argmax(ref))
        ref, got = np.asarray(jm.decode_step(tok)), tm.decode_step(tok).numpy()


@pytest.mark.parametrize("b", [3, 8])
def test_batch_decode_step_matches_reference(moe_pair, b):
    """The batch-rows step over seeded pools: B 3 takes the gather route, B
    8 the dense one, in both packages; logits and written rows."""
    jm, tm = moe_pair
    cfg = tm.config
    rng = np.random.default_rng(b)
    shape = (b, cfg.num_layers, 64, cfg.num_kv_heads * cfg.head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    toks = rng.integers(1, 97, b).astype(np.int32)
    poss = rng.integers(0, 60, b).astype(np.int32)
    jk, jv, ref = jax_model.batch_decode_step_fn(jm.config, jm.params, jnp.asarray(kp),
                                                 jnp.asarray(vp), jnp.asarray(toks),
                                                 jnp.asarray(poss))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = batch_decode_step_fn(cfg, tm.params, tk, tv, torch.from_numpy(toks),
                               torch.from_numpy(poss))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


def test_engine_streams_match_reference(monkeypatch):
    """Five requests through the batch engine (three slots), greedy, on a
    peaked top-2 model: prefills on the dense route, decode steps on the
    gather route."""
    jm, tm = _pair(seed=9, peaked=True)
    monkeypatch.setenv("PYGPUKIT_SERVING_STEP", "batch")
    jeng = JaxEngine(jm, max_batch=3, max_seq_len=128, steps_per_dispatch=4)
    jreqs = [jeng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, N_NEW)]
    jeng.run_until_complete()
    eng = ContinuousBatchingEngine(tm, max_batch=3, max_seq_len=128, steps_per_dispatch=4)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, N_NEW)]
    eng.run_until_complete()
    assert all(r.done for r in reqs) and eng.logits_finite()
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]


def test_mixtral_matches_transformers(tmp_path):
    """The recipe of tests/test_llm_families.py:63-76: a MixtralForCausalLM
    saved as safetensors, loaded by the reference loader (f32) and carried
    across; the port's logits within rtol 1e-4 of HF's, greedy tokens
    equal."""
    transformers = pytest.importorskip("transformers")
    import pygpukit_tpu.llm as llm
    cfg = transformers.MixtralConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=64, tie_word_embeddings=False)
    torch.manual_seed(2)
    hf = transformers.MixtralForCausalLM(cfg).eval()
    hf.save_pretrained(tmp_path, safe_serialization=True)
    jm = llm.load_model_from_safetensors(tmp_path, dtype="float32")
    fields = {f.name for f in dataclasses.fields(TransformerConfig)}
    tcfg = TransformerConfig(**{k: v for k, v in dataclasses.asdict(jm.config).items()
                                if k in fields})
    tm = CausalTransformerModel(tcfg, _tree(jm.params), dtype=torch.float32)
    prompt = [1, 7, 23, 5, 60]
    with torch.no_grad():
        ref = hf(torch.tensor([prompt])).logits[0].numpy()
        hf_out = hf.generate(torch.tensor([prompt]), max_new_tokens=6, do_sample=False,
                             pad_token_id=0)[0, len(prompt):].tolist()
    np.testing.assert_allclose(tm.get_logits(prompt), ref, rtol=1e-4, atol=1e-4)
    assert tm.generate(prompt, max_new_tokens=6) == hf_out
