"""The port's fused decode step (``kernels.fused_decode`` and
``fused_decode_step_fn``) against the JAX package's whole-model Pallas
kernel in interpret mode, at the shapes of tests/test_fused_decode.py (bf16,
hidden 256, 2 layers, 4/2 heads, intermediate 512, cache 128), and against
the port's own unfused step:

- ``fused_decode_plain`` against ``fused_decode_step(..., interpret=True)``
  at pos 5 and 100, the JAX side compiled with XLA's excess precision off
  (``_bf16_exact``): h_out, k_new and v_new within atol/rtol 1e-2 (the
  same roundings, sums in another order: one bf16 ulp moves a value by up
  to 4e-3 of itself); the logits of ``fused_decode_step_fn`` within
  atol/rtol 1e-2 with the same argmax, the written rows likewise, all
  others untouched;
- fused against unfused in the port within the reference's own 0.05
  (tests/test_fused_decode.py:78), and 3 chained greedy steps equal;
- the consolidated leaves equal the reference's tile arenas, un-tiled,
  bitwise;
- eligibility equal to the reference's on layernorm, MoE, quantized and
  fused leaves, biases and a window; it differs at ``max_seq > 2048``,
  the TPU's VMEM gate, which the port does not have;
- ``PYGPUKIT_DECODE=fused`` routing on the model (read per call; leaves
  registered as buffers once); CPU tensors never count a launch.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygpukit_tpu.kernels.fused_decode import fused_decode_step as jax_fused_kernel
from pygpukit_tpu.llm import model as jax_model
from pygpukit_tpu.llm.config import TransformerConfig as JaxConfig
from pygpukit_tpu.llm.quant import quantize_model_params as jax_quantize_model
from pygpukit_tpu_torch.kernels import LAUNCHES, fused_decode
from pygpukit_tpu_torch.kernels.fused_decode import supports as fused_supports
from pygpukit_tpu_torch.llm import (CausalTransformerModel, TransformerConfig,
                                    params_from_jax)
from pygpukit_tpu_torch.llm import model as port_model

torch.set_num_threads(2)

TINY = dict(vocab_size=128, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=512, max_position_embeddings=128)
MAX = 128
CLOSE = dict(atol=1e-2, rtol=1e-2)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return params_from_jax(np.asarray(a))


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, JAX params with tile arenas, port config, port params
    with consolidated leaves, port model) over the reference's seed-3
    bf16 params."""
    jcfg = JaxConfig(**TINY)
    jm = jax_model.CausalTransformerModel(jcfg, jax_model.init_params(jcfg, 3, jnp.bfloat16),
                                          dtype=jnp.bfloat16)
    jparams = jax_model.prepare_fused_decode_params(jcfg, jm.params)
    tcfg = TransformerConfig(**TINY)
    tm = CausalTransformerModel(tcfg, params_from_jax(_host(jm.params)), dtype=torch.bfloat16)
    return jcfg, jparams, tcfg, port_model.prepare_fused_decode_params(tcfg, tm.params), tm


@functools.lru_cache(maxsize=None)
def _prefilled(n: int):
    """JAX caches [L, MAX, Hk, D] after prefilling n seeded tokens, and the
    greedy next token."""
    jcfg = JaxConfig(**TINY)
    jm = jax_model.CausalTransformerModel(jcfg, jax_model.init_params(jcfg, 3, jnp.bfloat16),
                                          dtype=jnp.bfloat16)
    shape = (jcfg.num_layers, MAX, jcfg.num_kv_heads, jcfg.head_dim)
    prompt = np.random.default_rng(n).integers(1, 128, n)
    padded = np.zeros(jax_model._bucket(n, 8), np.int32)
    padded[:n] = prompt
    kc, vc, logits = jax.jit(functools.partial(jax_model.prefill_fn, jcfg))(
        jm.params, jnp.zeros(shape, jnp.bfloat16), jnp.zeros(shape, jnp.bfloat16),
        jnp.asarray(padded), jnp.int32(n))
    return kc, vc, int(jnp.argmax(logits))


def _merged(c):
    return c.reshape(c.shape[0], c.shape[1], -1)


def _bf16_exact(fn, *args):
    """``jax.jit(fn)(*args)`` compiled with ``xla_allow_excess_precision``
    off. XLA on the CPU otherwise drops the bf16 round trip of the residual
    stream (``x_s``) before the next rmsnorm, which the TPU kernel keeps in
    a bf16 buffer; held to bf16 it computes what the kernel does."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})(*args)


@pytest.mark.parametrize("pos", [5, 100])
def test_plain_fused_step_matches_jax_kernel(tiny, pos):
    jcfg, jparams, tcfg, tparams, _ = tiny
    kc, vc, tok = _prefilled(pos)
    jl, tl = jparams["layers"], tparams["layers"]
    h = jnp.take(jparams["embed"], jnp.asarray([tok]), axis=0).astype(jnp.bfloat16)
    cos = jparams["rope_cos"][pos:pos + 1].astype(jnp.float32)
    sin = jparams["rope_sin"][pos:pos + 1].astype(jnp.float32)
    args = (h, cos, sin, jnp.asarray([pos], jnp.int32))
    norms = (jl["attn_norm_w"].astype(jnp.float32), jl["mlp_norm_w"].astype(jnp.float32),
             jparams["final_norm_w"].astype(jnp.float32).reshape(1, -1))
    heads = dict(n_heads=4, n_kv_heads=2, head_dim=64, eps=jcfg.norm_eps)
    ref = _bf16_exact(functools.partial(jax_fused_kernel, interpret=True, **heads),
                      *args, jl["w_qkv_t"], jl["w_o_t"], jl["w_gu_t"], jl["w_down_t"], *norms,
                      _merged(kc), _merged(vc))
    before = dict(LAUNCHES)
    got = fused_decode(*(_t(a) for a in args), tl["w_qkv_cat"], tl["w_o"], tl["w_gu_cat"],
                       tl["w_down"], *(_t(a) for a in norms), _t(_merged(kc)),
                       _t(_merged(vc)), **heads)
    assert LAUNCHES == before
    for name, g, r in zip(("h_out", "k_new", "v_new"), got, ref):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32), **CLOSE,
                                   err_msg=name)

    kc2, vc2, jlog = _bf16_exact(functools.partial(jax_model.fused_decode_step_fn, jcfg,
                                                   interpret=True),
                                 jparams, kc, vc, jnp.int32(tok), jnp.int32(pos))
    tk, tv = _t(kc), _t(vc)
    tlog = port_model.fused_decode_step_fn(tcfg, tparams, tk, tv, tok, pos)
    jlog = np.asarray(jlog, np.float32)
    np.testing.assert_allclose(tlog.numpy(), jlog, **CLOSE)
    assert int(tlog.argmax()) == int(jlog.argmax())
    for got_c, ref_c, old in ((tk, kc2, kc), (tv, vc2, vc)):
        np.testing.assert_allclose(got_c[:, pos].float().numpy(),
                                   np.asarray(ref_c[:, pos], np.float32), **CLOSE)
        keep = np.ones(MAX, bool)
        keep[pos] = False
        assert np.array_equal(got_c[:, keep].view(torch.int16).numpy(),
                              np.asarray(old)[:, keep].view(np.int16))


def _port_prefill(tcfg, tparams, prompt):
    shape = (tcfg.num_layers, MAX, tcfg.num_kv_heads, tcfg.head_dim)
    kc = torch.zeros(shape, dtype=torch.bfloat16)
    vc = torch.zeros(shape, dtype=torch.bfloat16)
    padded = torch.zeros(8, dtype=torch.long)
    padded[:len(prompt)] = torch.tensor(prompt)
    logits = port_model.prefill_fn(tcfg, tparams, port_model._merged(kc),
                                   port_model._merged(vc), padded, len(prompt))
    return kc, vc, int(logits.argmax())


def test_fused_matches_unfused_in_the_port(tiny):
    _, _, tcfg, tparams, _ = tiny
    kc, vc, tok = _port_prefill(tcfg, tparams, [3, 17, 42, 7, 99])
    ku, vu = kc.clone(), vc.clone()
    lu = port_model.decode_step_fn(tcfg, tparams, ku, vu, tok, 5, allow_fused=False)
    lf = port_model.fused_decode_step_fn(tcfg, tparams, kc, vc, tok, 5)
    assert int(lu.argmax()) == int(lf.argmax())
    np.testing.assert_allclose(lf.numpy(), lu.numpy(), rtol=0.05, atol=0.05)
    np.testing.assert_allclose(kc[:, 5].float().numpy(), ku[:, 5].float().numpy(),
                               rtol=0.05, atol=0.02)
    assert torch.equal(kc[:, :5], ku[:, :5])


def test_chained_fused_greedy_steps_match_unfused(tiny):
    """Three chained steps give the same greedy tokens (as
    tests/test_fused_decode.py:91-118)."""
    _, _, tcfg, tparams, _ = tiny
    kc, vc, tok = _port_prefill(tcfg, tparams, [5, 9, 23])
    ku, vu = kc.clone(), vc.clone()
    tf = tu = tok
    toks_f, toks_u = [], []
    for i in range(3):
        tf = int(port_model.fused_decode_step_fn(tcfg, tparams, kc, vc, tf, 3 + i).argmax())
        tu = int(port_model.decode_step_fn(tcfg, tparams, ku, vu, tu, 3 + i,
                                           allow_fused=False).argmax())
        toks_f.append(tf)
        toks_u.append(tu)
    assert toks_f == toks_u


def test_consolidated_leaves_are_the_reference_arenas_untiled(tiny):
    _, jparams, _, tparams, _ = tiny
    for jname, tname in (("w_qkv_t", "w_qkv_cat"), ("w_gu_t", "w_gu_cat")):
        arena = np.asarray(jparams["layers"][jname])             # [L, NT, K, C]
        n_layers, n_tiles, k, c = arena.shape
        untiled = arena.transpose(0, 2, 1, 3).reshape(n_layers, k, n_tiles * c)
        got = tparams["layers"][tname]
        assert tuple(got.shape) == untiled.shape
        assert np.array_equal(got.view(torch.int16).numpy(), untiled.view(np.int16))


def _both_eligible(jcfg, jparams, tcfg, tparams, max_seq=MAX):
    return (jax_model.fused_decode_eligible(jcfg, jparams, max_seq),
            port_model.fused_decode_eligible(tcfg, tparams, max_seq))


@pytest.mark.parametrize("case", ["base", "layernorm", "moe", "window", "softcap",
                                  "quantized", "fused", "bias", "qk_norm"])
def test_eligibility_matches_the_reference(tiny, case):
    jcfg, jparams, tcfg, tparams, _ = tiny
    cfg_change = {"layernorm": dict(norm_type="layernorm"), "moe": dict(num_experts=4),
                  "window": dict(sliding_window=16), "softcap": dict(attn_logit_softcap=5.0),
                  "qk_norm": dict(use_qk_norm=True)}.get(case, {})
    jcfg, tcfg = dataclasses.replace(jcfg, **cfg_change), dataclasses.replace(tcfg, **cfg_change)
    if case == "quantized":
        jparams = jax_quantize_model(jparams, "int8")
        tparams = params_from_jax(_host(jparams))
    elif case == "fused":
        jparams = jax_model.fuse_params(jparams)
        tparams = port_model.fuse_params(tparams)
    elif case == "bias":
        jparams = dict(jparams, layers=dict(jparams["layers"],
                                            b_q=jnp.zeros((2, 256), jnp.bfloat16)))
        tparams = dict(tparams, layers=dict(tparams["layers"],
                                            b_q=torch.zeros(2, 256, dtype=torch.bfloat16)))
    ref, got = _both_eligible(jcfg, jparams, tcfg, tparams)
    assert got == ref == (case == "base")


def test_eligibility_has_no_cache_length_gate(tiny):
    """The reference's kernel holds a layer's K/V in VMEM, so it refuses
    caches past 2048 rows (and lengths off a multiple of 128); the CUDA
    kernel reads rows [0, pos) of any cache."""
    jcfg, jparams, tcfg, tparams, _ = tiny
    assert _both_eligible(jcfg, jparams, tcfg, tparams, 4096) == (False, True)
    assert _both_eligible(jcfg, jparams, tcfg, tparams, 200) == (False, True)
    assert port_model.fused_decode_eligible(tcfg, dict(
        tparams, layers=dict(tparams["layers"], attn_window=torch.zeros(2))), MAX) is False


def test_supports_states_the_kernel_limits():
    kw = dict(hidden=2048, intermediate=5632, n_heads=32, n_kv_heads=4, head_dim=64,
              max_seq=1 << 20, norm_type="rmsnorm", activation="silu", use_rope=True,
              has_bias=False, use_qk_norm=False, is_moe=False)
    assert fused_supports(**kw)
    for bad in (dict(head_dim=60, hidden=1920), dict(head_dim=256, hidden=8192),
                dict(intermediate=5630), dict(n_kv_heads=1, n_heads=64, hidden=4096),
                dict(activation="gelu"), dict(use_rope=False), dict(hidden=2040)):
        assert not fused_supports(**dict(kw, **bad)), bad


def test_model_routes_through_the_fused_step(tiny, monkeypatch):
    """PYGPUKIT_DECODE=fused is read per call; init_fixed_cache registers
    the consolidated leaves as buffers once; fuse_params output, an int8
    cache and allow_fused=False keep the unfused step."""
    _, _, _, _, tm = tiny
    calls = []
    real = port_model.fused_decode_step_fn
    monkeypatch.setattr(port_model, "fused_decode_step_fn",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tm.init_fixed_cache(MAX)
    assert "layers__w_qkv_cat" not in dict(tm.named_buffers())
    tm.generate([5, 9, 23], max_new_tokens=4)
    assert calls == []
    monkeypatch.setenv("PYGPUKIT_DECODE", "fused")
    tm.init_fixed_cache(MAX)
    buffers = dict(tm.named_buffers())
    assert {"layers__w_qkv_cat", "layers__w_gu_cat"} <= set(buffers)
    n_buffers = len(buffers)
    tm.init_fixed_cache(MAX)
    assert len(dict(tm.named_buffers())) == n_buffers
    fused = tm.generate([5, 9, 23], max_new_tokens=4)
    # the 3-step chunk is a captured program; a CPU capture runs nothing,
    # so only its replay calls the chunk
    assert len(calls) == 3 and len(fused) == 4
    port_model.decode_step_fn(tm.config, tm.params, tm.k_cache, tm.v_cache, 1, tm.pos,
                              allow_fused=False)
    assert len(calls) == 3
    monkeypatch.delenv("PYGPUKIT_DECODE")
    tm.init_fixed_cache(MAX)
    assert tm.generate([5, 9, 23], max_new_tokens=4)[:2] == fused[:2]
    assert len(calls) == 3


def test_fused_step_without_leaves_raises(tiny):
    _, _, tcfg, _, tm = tiny
    shape = (2, MAX, 2, 64)
    with pytest.raises(ValueError, match="prepare_fused_decode_params"):
        port_model.fused_decode_step_fn(tcfg, {"layers": {}}, torch.zeros(shape), None, 1, 0)


# ---------------------------------------------------------------------------
# LongRoPE past its threshold (a fault of the reference's fused step)
# ---------------------------------------------------------------------------

PHI3 = dict(TINY, max_position_embeddings=128, rope_theta=10000.0,
            rope_scaling={"type": "longrope", "original_max_position_embeddings": 32,
                          "short_factor": [1.0 + 0.02 * i for i in range(32)],
                          "long_factor": [2.0 + 0.5 * i for i in range(32)]})


def test_fused_step_takes_longrope_long_rows_past_the_threshold():
    """A tiny Phi-3 (longrope, original_max 32) decoding at position 40:
    the port's fused step (``fused_decode_plain`` on the CPU) equals its
    unfused step, which rotates with the long factors there. The
    reference's ``fused_decode_step_fn`` (interpret mode) reads the short
    tables alone: its logits are bitwise those of the same params without
    the long tables, and the port's fused step agrees with it only once its
    short tables are replaced by the long ones (ROADMAP.md, section C)."""
    jcfg = JaxConfig(**PHI3)
    jm = jax_model.CausalTransformerModel(jcfg, jax_model.init_params(jcfg, 3, jnp.bfloat16),
                                          dtype=jnp.bfloat16)
    assert "rope_cos_long" in jm.params
    tcfg = TransformerConfig(**PHI3)
    tm = CausalTransformerModel(tcfg, params_from_jax(_host(jm.params)), dtype=torch.bfloat16)
    tparams = port_model.prepare_fused_decode_params(tcfg, tm.params)
    assert port_model.fused_decode_eligible(tcfg, tparams, MAX)
    pos = 40
    prompt = np.random.default_rng(pos).integers(1, 128, pos)
    shape = (tcfg.num_layers, MAX, tcfg.num_kv_heads, tcfg.head_dim)
    kc = torch.zeros(shape, dtype=torch.bfloat16)
    vc = torch.zeros(shape, dtype=torch.bfloat16)
    padded = torch.zeros(64, dtype=torch.long)
    padded[:pos] = torch.from_numpy(prompt)
    tok = int(port_model.prefill_fn(tcfg, tparams, port_model._merged(kc),
                                    port_model._merged(vc), padded, pos).argmax())
    jk, jv = jnp.asarray(kc.float().numpy(), jnp.bfloat16), jnp.asarray(vc.float().numpy(),
                                                                         jnp.bfloat16)
    ku, vu = kc.clone(), vc.clone()
    lu = port_model.decode_step_fn(tcfg, tparams, ku, vu, tok, pos, allow_fused=False)
    lf = port_model.fused_decode_step_fn(tcfg, tparams, kc, vc, tok, pos)
    assert int(lu.argmax()) == int(lf.argmax())
    np.testing.assert_allclose(lf.numpy(), lu.numpy(), rtol=0.05, atol=0.05)

    def jax_fused(params):
        fp = jax_model.prepare_fused_decode_params(jcfg, params)
        return np.asarray(_bf16_exact(functools.partial(jax_model.fused_decode_step_fn, jcfg,
                                                        interpret=True),
                                      fp, jk, jv, jnp.int32(tok), jnp.int32(pos))[2],
                          np.float32)
    short_only = {k: v for k, v in jm.params.items() if not k.startswith("rope_") or
                  k in ("rope_cos", "rope_sin")}
    as_is = jax_fused(jm.params)
    assert np.array_equal(as_is, jax_fused(short_only))
    long_rows = dict(short_only, rope_cos=jm.params["rope_cos_long"],
                     rope_sin=jm.params["rope_sin_long"])
    np.testing.assert_allclose(lf.numpy(), jax_fused(long_rows), **CLOSE)
    assert not np.allclose(lf.numpy(), as_is, **CLOSE)
