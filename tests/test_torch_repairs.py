"""Repairs of the port against the reference, and the CPU int8 product's
exact route, on the CPU.

- The int8 head's switches: ``PYGPUKIT_INT8_HEAD`` (the head's mode,
  ``PYGPUKIT_INT8_MODE``'s when unset) and ``PYGPUKIT_ACT_QUANT=bf16``
  (w8a8's lean activation chain): the port's ``_logits`` on an int8 head
  against the reference's ``_logits`` under every combination, f32 and
  bf16 rows, as the cases of one parametrised test.
- The attention routes read the shape: a head dim the kernels are not
  built for (32, 112), or more query heads a kv head than a kernel takes
  (17-32 for the batch and paged kernels, 33 for ``flash_decode``), takes
  the plain version on CUDA tensors too; the built shapes keep the
  kernels; CPU tensors always take the plain version.
- ``ops.matmul.int8_dot`` on the CPU: the int32 product's bits.
- The public defaults are the reference's: ``quantize_weight`` and
  ``quantize_model_params`` with the mode omitted (fp8) and
  ``kv_cache_zeros`` with ``merged`` omitted (the ``[..., Hk, D]`` layout,
  a scale a row of both minor dims), each leaf bitwise the reference's.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygpukit_tpu.llm import TransformerConfig as JaxConfig
from pygpukit_tpu.llm import model as jax_model
from pygpukit_tpu.llm import quant as jax_quant
from pygpukit_tpu.llm.quant import quantize_weight as jax_quantize_weight
from pygpukit_tpu.ops import embedding as jax_embedding
from pygpukit_tpu_torch.llm import TransformerConfig, params_from_jax
from pygpukit_tpu_torch.llm import model as port_model
from pygpukit_tpu_torch.llm import quant as port_quant
from pygpukit_tpu_torch.llm.model import batch_attention_route
from pygpukit_tpu_torch.llm.serving_paged import paged_attention_route
from pygpukit_tpu_torch.ops import embedding as port_embedding
from pygpukit_tpu_torch.ops.nn.attention import fixed_cache_route, flash_attention_route

CFG = dict(vocab_size=256, hidden_size=64, num_layers=1, num_heads=4, num_kv_heads=2,
           intermediate_size=96, max_position_embeddings=64, tie_word_embeddings=False)
BF16 = torch.bfloat16


def _head(seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((64, 256)).astype(np.float32) * 0.1
    leaf = jax.tree.map(np.asarray, jax_quantize_weight(jnp.asarray(w), "int8"))
    return leaf, params_from_jax(leaf)


@pytest.mark.parametrize("head,mode,act,dtype", list(itertools.product(
    [None, "w8a8", "w8a16"], ["w8a8", "w8a16"], ["f32", "bf16"], ["f32", "bf16"])))
def test_int8_head_follows_int8_head_then_int8_mode(monkeypatch, head, mode, act, dtype):
    """The head's logits equal the reference's (f32 sums of exact int or
    bf16 products: within 1e-6 of max |logit|) under every combination of
    the three switches; the head's mode changes the numbers (w8a8 and
    w8a16 differ by more than that)."""
    if head is None:
        monkeypatch.delenv("PYGPUKIT_INT8_HEAD", raising=False)
    else:
        monkeypatch.setenv("PYGPUKIT_INT8_HEAD", head)
    monkeypatch.setenv("PYGPUKIT_INT8_MODE", mode)
    monkeypatch.setenv("PYGPUKIT_ACT_QUANT", act)
    jleaf, tleaf = _head(1)
    h = np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, BF16)}[dtype]
    ref = np.asarray(jax_model._logits(JaxConfig(**CFG), {"lm_head": jleaf},
                                       jnp.asarray(h, jdt)))
    got = port_model._logits(TransformerConfig(**CFG), {"lm_head": tleaf},
                             torch.from_numpy(h).to(tdt)).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-6 * scale
    # the same rows through the other head mode: another result
    monkeypatch.setenv("PYGPUKIT_INT8_HEAD",
                       "w8a16" if (head or mode) == "w8a8" else "w8a8")
    other = port_model._logits(TransformerConfig(**CFG), {"lm_head": tleaf},
                               torch.from_numpy(h).to(tdt)).numpy()
    assert np.abs(other - got).max() > 1e-4 * scale


def test_an_unknown_switch_value_raises(monkeypatch):
    monkeypatch.setenv("PYGPUKIT_INT8_HEAD", "w4a16")
    _, tleaf = _head(1)
    with pytest.raises(ValueError, match="PYGPUKIT_INT8_HEAD"):
        port_model._logits(TransformerConfig(**CFG), {"lm_head": tleaf}, torch.zeros(1, 64))


def test_act_quant_bf16_only_moves_w8a8_layers(monkeypatch):
    """A w8a8 layer operand under ``PYGPUKIT_ACT_QUANT=bf16`` against the
    reference's ``_mm`` (bitwise: the same bf16 roundings, exact int32
    sums), and its f32 chain differs from it."""
    monkeypatch.setenv("PYGPUKIT_INT8_MODE", "w8a8")
    jleaf, tleaf = _head(3)
    x = np.random.default_rng(4).standard_normal((5, 64)).astype(np.float32)
    outs = {}
    for act in ("bf16", "f32"):
        monkeypatch.setenv("PYGPUKIT_ACT_QUANT", act)
        ref = np.asarray(jax_model._mm(jnp.asarray(x, jnp.bfloat16), jleaf, jnp.float32))
        got = port_model._mm(torch.from_numpy(x).to(BF16), tleaf, torch.float32).numpy()
        np.testing.assert_array_equal(got, ref)
        outs[act] = got
    assert not np.array_equal(outs["bf16"], outs["f32"])


SCALE = {d: d ** -0.5 for d in (32, 64, 80, 96, 112, 128, 256)}


@pytest.mark.parametrize("d", [32, 112])
def test_unbuilt_head_dims_take_the_plain_routes(d):
    s = SCALE[d]
    assert flash_attention_route("cuda", s, d, n_heads=8, n_kv_heads=2) == "plain"
    assert flash_attention_route("cuda", s, d) == "plain"
    assert fixed_cache_route("cuda", 1, 8, 2, d, BF16, BF16, BF16) == "plain"
    assert batch_attention_route("cuda", 8, 2, d) == "plain"
    assert paged_attention_route("cuda", 8, 2, d) == "plain"


@pytest.mark.parametrize("g", list(range(17, 33)))
def test_groups_past_sixteen_leave_the_engines_kernels(g):
    """G 17-32: the batch and paged kernels take at most 16 query heads a
    kv head, so both engines' steps take their plain versions;
    ``flash_attention`` and ``flash_decode`` (its CUDA-core body) keep
    theirs."""
    for d in (64, 128):
        assert batch_attention_route("cuda", 2 * g, 2, d) == "plain"
        assert paged_attention_route("cuda", 2 * g, 2, d) == "plain"
        assert fixed_cache_route("cuda", 1, 2 * g, 2, d, BF16, BF16, BF16) == "kernel"
        assert flash_attention_route("cuda", SCALE[d], d, n_heads=2 * g,
                                     n_kv_heads=2) == "kernel"


@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("g", [1, 8, 16])
def test_built_shapes_keep_the_kernels(d, g):
    assert flash_attention_route("cuda", SCALE[d], d, n_heads=4 * g, n_kv_heads=4) == "kernel"
    assert fixed_cache_route("cuda", 1, 4 * g, 4, d, BF16, BF16, BF16) == "kernel"
    assert batch_attention_route("cuda", 4 * g, 4, d) == "kernel"
    assert paged_attention_route("cuda", 4 * g, 4, d) == "kernel"
    for route in (batch_attention_route, paged_attention_route):
        assert route("cpu", 4 * g, 4, d) == "plain"
    assert fixed_cache_route("cpu", 1, 4 * g, 4, d, BF16, BF16, BF16) == "plain"


def test_flash_decode_takes_at_most_32_query_heads_a_kv_head():
    assert fixed_cache_route("cuda", 1, 33, 1, 64, BF16, BF16, BF16) == "plain"
    assert fixed_cache_route("cuda", 1, 32, 1, 64, BF16, BF16, BF16) == "kernel"
    # the rest of the rule is unchanged: a window, an int8 dict, T > 1
    assert fixed_cache_route("cuda", 1, 8, 2, 64, BF16, BF16, BF16, window=16) == "plain"
    assert fixed_cache_route("cuda", 1, 8, 2, 64, BF16, None, None) == "plain"
    assert fixed_cache_route("cuda", 2, 8, 2, 64, BF16, BF16, BF16) == "plain"


@pytest.mark.parametrize("d,heads", [(32, (4, 2)), (112, (4, 2)), (64, (48, 2))])
def test_unbuilt_shapes_run_every_path_on_the_cpu(d, heads):
    """A model at an unbuilt head dim or group computes every path on the
    CPU (the plain versions the card now takes for it): the forward's last
    row against the cached prefill's logits, and the dense and paged
    engines' streams against single-stream generate."""
    from pygpukit_tpu_torch.llm import (CausalTransformerModel, ContinuousBatchingEngine,
                                        init_params)
    hq, hk = heads
    cfg = TransformerConfig(vocab_size=64, hidden_size=hq * d, num_layers=2, num_heads=hq,
                            num_kv_heads=hk, intermediate_size=64,
                            max_position_embeddings=128, tie_word_embeddings=False)
    model = CausalTransformerModel(cfg, init_params(cfg, 0, torch.float32, device="cpu"),
                                   dtype=torch.float32)
    prompt = [3, 1, 4, 1, 5, 9, 2]
    fwd = model.get_logits(prompt)
    model.init_fixed_cache(64)
    np.testing.assert_allclose(model.prefill(prompt).numpy(), fwd[-1], rtol=1e-4, atol=1e-4)
    want = model.generate(prompt, 6)
    for paged in (False, True):
        eng = ContinuousBatchingEngine(model, max_batch=2, max_seq_len=64,
                                       steps_per_dispatch=3, paged=paged)
        req = eng.submit(prompt, max_new_tokens=6)
        eng.run_until_complete()
        assert req.generated == want


@pytest.mark.parametrize("m,k,n", [(1, 2304, 300), (5, 1025, 64), (33, 4096, 17), (2, 3, 5)])
def test_int8_dot_on_the_cpu_is_the_int32_product(m, k, n):
    """``int8_dot``'s CPU route (f32 products over 1024-row chunks of K)
    gives the int32 product's bits, at the extremes (every product
    -128 x -128 = 2^14, a chunk's sum 2^24) and on random codes."""
    from pygpukit_tpu_torch.ops.matmul import int8_dot
    g = torch.Generator().manual_seed(m * k + n)
    for xi, q in ((torch.full((m, k), -128, dtype=torch.int8),
                   torch.full((k, n), -128, dtype=torch.int8)),
                  (torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8),
                   torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8))):
        want = torch.matmul(xi.to(torch.int32), q.to(torch.int32))
        got = int8_dot(xi, q)
        assert got.dtype == torch.int32 and torch.equal(got, want)


# -- the public defaults (the reference's, argument omitted) ----------------

def _leaf_bytes(a) -> tuple:
    """(shape, item size, raw bytes) of a numpy array (ml_dtypes too) or a
    tensor."""
    if isinstance(a, torch.Tensor):
        t = a.contiguous()
        return tuple(t.shape), t.element_size(), t.reshape(-1).view(torch.uint8).numpy()
    a = np.ascontiguousarray(a)
    return a.shape, a.dtype.itemsize, a.reshape(-1).view(np.uint8)


def _assert_leaves_bitwise(ref, got, path="") -> None:
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(ref) == set(got), (path, set(ref), set(got))
        for k in ref:
            _assert_leaves_bitwise(ref[k], got[k], f"{path}/{k}")
        return
    if ref is None:
        assert got is None, path
        return
    (rs, ri, rb), (gs, gi, gb) = _leaf_bytes(np.asarray(ref)), _leaf_bytes(got)
    assert (rs, ri) == (gs, gi), (path, rs, ri, gs, gi)
    assert np.array_equal(rb, gb), path


def test_quantize_weight_defaults_to_the_references_fp8():
    """A [64, 32] f32 weight quantized with the mode omitted: fp8 e4m3
    ``{"q", "scale"}`` in both packages, bit for bit."""
    w = np.random.default_rng(14).standard_normal((64, 32)).astype(np.float32) * 0.05
    ref = jax.tree.map(np.asarray, jax_quant.quantize_weight(jnp.asarray(w)))
    got = port_quant.quantize_weight(torch.from_numpy(w))
    assert set(got) == {"q", "scale"} and got["q"].dtype == torch.float8_e4m3fn
    assert tuple(got["q"].shape) == (64, 32)
    _assert_leaves_bitwise(ref, got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_model_params_defaults_to_the_references_fp8(dtype):
    """A small model's param tree quantized with the mode omitted: every
    leaf (the fp8 projections and head, the dense rest) bitwise the
    reference's."""
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    jcfg = JaxConfig(**dict(CFG, num_layers=2))
    host = jax.tree.map(np.asarray, jax_model.init_params(jcfg, 3, jdt))
    ref = jax.tree.map(np.asarray, jax_quant.quantize_model_params(
        jax.tree.map(jnp.asarray, host)))
    got = port_quant.quantize_model_params(params_from_jax(host))
    assert got["layers"]["w_q"]["q"].dtype == torch.float8_e4m3fn
    _assert_leaves_bitwise(ref, got)


@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32"])
def test_kv_cache_zeros_defaults_to_the_references_layout(dtype):
    """``kv_cache_zeros`` with ``merged`` omitted: int8 at (2, 3, 8, 4, 16)
    keeps a scale a row of the two minor dims, rows (2, 3, 8), in both
    packages; every leaf bitwise the reference's."""
    jdt, tdt = {"int8": (jnp.int8, torch.int8), "bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[dtype]
    shape = (2, 3, 8, 4, 16)
    ref = jax.tree.map(np.asarray, jax_embedding.kv_cache_zeros(shape, jdt))
    got = port_embedding.kv_cache_zeros(shape, tdt, device="cpu")
    if dtype == "int8":
        assert tuple(got["s"].shape) == (2, 3, 8) == ref["s"].shape
    _assert_leaves_bitwise(ref, got)
