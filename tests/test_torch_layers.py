"""The port's layer classes (``pygpukit_tpu_torch.llm.layers``) against the
JAX package's (``pygpukit_tpu.llm.layers``) on the same numpy weights and
inputs, f32 on the CPU, within rtol 1e-4 (atol 1e-5): Linear (dense with a
bias, and the int8, fp8, int4 and int4_block leaves above 8 rows; at the
GEMV rows, where the port computes the TPU kernels' function and the
reference's CPU route the dequantized product, within GEMV_TOL of max |y|),
LinearFP8, RMSNorm,
LayerNorm, Norm, Attention (prefill and the fixed-cache decode steps),
MLP (SwiGLU and GELU), MoELayer on the gather and dense routes, and a
TransformerBlock built from them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygpukit_tpu.llm import layers as ref_layers
from pygpukit_tpu.llm import quant as ref_quant
import pygpukit_tpu_torch.llm as pl
from pygpukit_tpu_torch.llm import layers as port_layers

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
E, HQ, HK, D, FF, N_EXP = 32, 4, 2, 8, 48, 4


def _w(rng, *shape, scale=0.2):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(ours, ref) -> None:
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **TOL)


def _pair_linear(w, b=None, mode=None):
    """(reference Linear, port Linear) over the same weight, quantized the
    reference's way when ``mode`` names a format."""
    if mode is None:
        return (ref_layers.Linear(w, b),
                port_layers.Linear(_t(w), None if b is None else _t(b)))
    q = ref_quant.quantize_weight(jnp.asarray(w), mode)
    return ref_layers.Linear(q, b), port_layers.Linear(
        pl.params_from_jax(jax.tree.map(np.asarray, q)), None if b is None else _t(b))


def test_precompute_freqs_cis():
    rc, rs = ref_layers.precompute_freqs_cis(16, D, 500.0)
    pc, ps = port_layers.precompute_freqs_cis(16, D, 500.0, device="cpu")
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rows", [1, 5, 12])
@pytest.mark.parametrize("bias", [False, True])
def test_linear_dense(rows, bias):
    rng = np.random.default_rng(rows)
    x, w, b = _w(rng, rows, E, scale=1.0), _w(rng, E, FF), _w(rng, FF)
    ref, port = _pair_linear(w, b if bias else None)
    _close(port(_t(x)), ref(x))
    assert not port.quantized and port.out_features == FF


@pytest.mark.parametrize("mode", ["int8", "fp8", "int4", "int4_block"])
@pytest.mark.parametrize("rows", [9, 12])
def test_linear_quantized(monkeypatch, mode, rows):
    """Above the GEMVs' 8 rows the port's routes are the reference's CPU
    routes (dequantize or convert, then the product; int8 as w8a8 in both,
    the TPU's default, which the port takes everywhere)."""
    monkeypatch.setenv("PYGPUKIT_INT8_MODE", "w8a8")
    rng = np.random.default_rng(7)
    x, w = _w(rng, rows, 64, scale=1.0), _w(rng, 64, FF)
    ref, port = _pair_linear(w, mode=mode)
    assert port.quantized and port.out_features == FF
    _close(port(_t(x)), ref(jnp.asarray(x)))


#: the GEMV routes (rows <= 8) compute the TPU kernels' function, the
#: reference's CPU route the dequantized product: int4 and int4_block take
#: int8 activations (w4a8) and fp8 a bf16 result, so they are held within a
#: share of max |y|, as tests/test_torch_formats.py holds the models
GEMV_TOL = {"int8": 1e-5, "fp8": 1e-2, "int4": 3e-2, "int4_block": 3e-2}


@pytest.mark.parametrize("mode", ["int8", "fp8", "int4", "int4_block"])
@pytest.mark.parametrize("rows", [1, 8])
def test_linear_quantized_gemv_rows(monkeypatch, mode, rows):
    monkeypatch.setenv("PYGPUKIT_INT8_MODE", "w8a8")
    rng = np.random.default_rng(8)
    x, w = _w(rng, rows, 64, scale=1.0), _w(rng, 64, FF)
    ref, port = _pair_linear(w, mode=mode)
    want = np.asarray(ref(jnp.asarray(x)))
    got = port(_t(x)).to(torch.float32).numpy()
    assert np.abs(got - want).max() <= GEMV_TOL[mode] * np.abs(want).max()


def test_linear_fp8_quantizes_a_dense_weight():
    rng = np.random.default_rng(3)
    x, w, b = _w(rng, 9, E, scale=1.0), _w(rng, E, FF), _w(rng, FF)
    ref, port = ref_layers.LinearFP8(w, b), port_layers.LinearFP8(_t(w), _t(b))
    assert port.w["q"].dtype == torch.float8_e4m3fn
    assert port.w["q"].view(torch.uint8).numpy().tobytes() == \
        np.asarray(ref.w["q"]).tobytes()
    _close(port(_t(x)), ref(x))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "layernorm_bias"])
def test_norms(kind):
    rng = np.random.default_rng(11)
    x, w, b = _w(rng, 6, E, scale=2.0), 1 + _w(rng, E), _w(rng, E)
    if kind == "rmsnorm":
        ref, port = ref_layers.RMSNorm(w, 1e-6), port_layers.RMSNorm(_t(w), 1e-6)
        alt = port_layers.Norm("rmsnorm", _t(w), eps=1e-6)
    elif kind == "layernorm":
        ref, port = ref_layers.LayerNorm(w), port_layers.LayerNorm(_t(w))
        alt = port_layers.Norm("layernorm", _t(w))
    else:
        ref, port = ref_layers.LayerNorm(w, b), port_layers.LayerNorm(_t(w), _t(b))
        alt = port_layers.Norm("layernorm", _t(w), _t(b))
    _close(port(_t(x)), ref(x))
    _close(alt(_t(x)), ref(x))
    assert type(alt) is type(port)


def _attention_pair(rng, rope: bool = True):
    ws = [_w(rng, E, HQ * D), _w(rng, E, HK * D), _w(rng, E, HK * D), _w(rng, HQ * D, E)]
    rc = rs = pc = ps = None
    if rope:
        rc, rs = ref_layers.precompute_freqs_cis(32, D)
        pc, ps = port_layers.precompute_freqs_cis(32, D, device="cpu")
    ref = ref_layers.Attention(*[ref_layers.Linear(w) for w in ws], HQ, HK, rc, rs)
    port = port_layers.Attention(*[port_layers.Linear(_t(w)) for w in ws], HQ, HK, pc, ps)
    return ref, port


@pytest.mark.parametrize("seq", [1, 7, 20])
@pytest.mark.parametrize("rope", [True, False])
def test_attention_prefill(seq, rope):
    rng = np.random.default_rng(seq)
    ref, port = _attention_pair(rng, rope)
    x = _w(rng, seq, E, scale=1.0)
    _close(port(_t(x)), ref(x))


def test_attention_fixed_cache_steps():
    rng = np.random.default_rng(5)
    ref, port = _attention_pair(rng)
    ref.init_fixed_cache(16, jnp.float32)
    port.init_fixed_cache(16, torch.float32)
    assert tuple(port.k_cache.shape) == (16, HK, D)
    for step in range(6):
        x = _w(rng, 1, E, scale=1.0)
        _close(port.forward_fixed_cache(_t(x)), ref.forward_fixed_cache(x))
        assert port.pos == ref.pos == step + 1
    _close(port.k_cache, ref.k_cache)
    x = _w(rng, 1, E, scale=1.0)                # an explicit position rewrites row 2
    _close(port.forward_fixed_cache(_t(x), 2), ref.forward_fixed_cache(x, 2))
    _close(port.v_cache, ref.v_cache)


def test_attention_fixed_cache_on_quantized_projections():
    rng = np.random.default_rng(6)
    ws = [_w(rng, E, HQ * D), _w(rng, E, HK * D), _w(rng, E, HK * D), _w(rng, HQ * D, E)]
    port = port_layers.Attention(*[_pair_linear(w, mode="int4")[1] for w in ws], HQ, HK)
    port.init_fixed_cache(8, torch.float32)
    assert tuple(port.v_cache.shape) == (8, HK, D)
    assert port.forward_fixed_cache(_t(_w(rng, 1, E))).shape == (1, E)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp(gated):
    rng = np.random.default_rng(9)
    x = _w(rng, 5, E, scale=1.0)
    wu, wd, wg = _w(rng, E, FF), _w(rng, FF, E), _w(rng, E, FF)
    ref = ref_layers.MLP(ref_layers.Linear(wu), ref_layers.Linear(wd),
                         ref_layers.Linear(wg) if gated else None)
    port = port_layers.MLP(port_layers.Linear(_t(wu)), port_layers.Linear(_t(wd)),
                           port_layers.Linear(_t(wg)) if gated else None)
    _close(port(_t(x)), ref(x))


@pytest.mark.parametrize("tokens", [2, 4, 9])
def test_moe_layer(tokens):
    rng = np.random.default_rng(tokens)
    x = _w(rng, tokens, E, scale=1.0)
    router = _w(rng, E, N_EXP, scale=1.0)
    wg, wu, wd = _w(rng, N_EXP, E, FF), _w(rng, N_EXP, E, FF), _w(rng, N_EXP, FF, E)
    ref = ref_layers.MoELayer(ref_layers.Linear(router), jnp.asarray(wg), jnp.asarray(wu),
                              jnp.asarray(wd), top_k=2)
    port = port_layers.MoELayer(port_layers.Linear(_t(router)), _t(wg), _t(wu), _t(wd),
                                top_k=2)
    _close(port(_t(x)), ref(x))


def test_transformer_block():
    rng = np.random.default_rng(12)
    ref_attn, port_attn = _attention_pair(rng)
    wu, wd, wg = _w(rng, E, FF), _w(rng, FF, E), _w(rng, E, FF)
    n1, n2 = 1 + _w(rng, E), 1 + _w(rng, E)
    ref = ref_layers.TransformerBlock(
        ref_attn, ref_layers.MLP(ref_layers.Linear(wu), ref_layers.Linear(wd),
                                 ref_layers.Linear(wg)),
        ref_layers.RMSNorm(n1), ref_layers.RMSNorm(n2))
    port = port_layers.LlamaBlock(
        port_attn, port_layers.LlamaMLP(port_layers.Linear(_t(wu)),
                                        port_layers.Linear(_t(wd)),
                                        port_layers.Linear(_t(wg))),
        port_layers.RMSNorm(_t(n1)), port_layers.RMSNorm(_t(n2)))
    h = _w(rng, 9, E, scale=1.0)
    _close(port(_t(h)), ref(h))
    assert {n for n, _ in port.named_buffers()} >= {"attn.q.weight", "mlp.gate.weight",
                                                    "attn_norm.w", "attn.rope_cos"}


def test_aliases():
    assert port_layers.LinearBF16 is port_layers.Linear
    assert port_layers.CausalSelfAttention is port_layers.LlamaAttention is port_layers.Attention
