"""The PyTorch port's weight formats against the JAX package, byte for byte:
quantize_weight (int4, int8), unpack_int4, quantize_model_params,
fuse_params and params_from_jax. Inputs are made with numpy from a seed and
fed to both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygpukit_tpu.llm.config import TransformerConfig as JaxConfig
from pygpukit_tpu.llm.model import CausalTransformerModel as JaxModel
from pygpukit_tpu.llm.model import fuse_params as jax_fuse_params
from pygpukit_tpu.llm.model import init_params as jax_init_params
from pygpukit_tpu.llm.quant import quantize_model_params as jax_quantize_model
from pygpukit_tpu.llm.quant import quantize_weight as jax_quantize_weight
from pygpukit_tpu.llm.quant import unpack_int4 as jax_unpack_int4
from pygpukit_tpu_torch.llm import (fuse_params, params_from_jax,
                                    quantize_model_params, quantize_weight,
                                    unpack_int4)

torch.set_num_threads(2)

TINY = dict(vocab_size=97, hidden_size=48, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=96, head_dim_override=12,
            max_position_embeddings=64, tie_word_embeddings=False)


def _bits(a):
    """Raw bytes of a numpy (incl. ml_dtypes) array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_tree_bitwise(jtree, ttree, path=""):
    if isinstance(jtree, dict):
        assert isinstance(ttree, dict) and set(jtree) == set(ttree), path
        for k in jtree:
            _assert_tree_bitwise(jtree[k], ttree[k], f"{path}/{k}")
        return
    if jtree is None:
        assert ttree is None, path
        return
    a, b = _bits(jtree), _bits(ttree)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize, path
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("mode", ["int4", "int8"])
@pytest.mark.parametrize("shape", [(2, 48, 40), (64, 96), (3, 33, 16)])
def test_quantize_weight_bitwise(mode, shape):
    rng = np.random.default_rng(11)
    w = (rng.standard_normal(shape, dtype=np.float32) * 0.02)
    wj = jnp.asarray(w, jnp.bfloat16)
    ref = _host(jax_quantize_weight(wj, mode))
    got = quantize_weight(params_from_jax(np.asarray(wj)), mode)
    _assert_tree_bitwise(ref, got)


def test_unpack_int4_bitwise():
    rng = np.random.default_rng(3)
    packed = rng.integers(0, 256, (2, 16, 24), dtype=np.uint8)
    ref = np.asarray(jax_unpack_int4(jnp.asarray(packed)))
    np.testing.assert_array_equal(unpack_int4(torch.from_numpy(packed)).numpy(), ref)


@pytest.mark.parametrize("mode", [None, "int4", "int8"])
def test_quantize_and_fuse_model_bitwise(mode):
    cfg = JaxConfig(**TINY)
    params = jax_init_params(cfg, 1, jnp.bfloat16)
    if mode is not None:
        params = jax_quantize_model(params, mode)
    tparams = params_from_jax(_host(jax_init_params(cfg, 1, jnp.bfloat16)))
    if mode is not None:
        tparams = quantize_model_params(tparams, mode)
    _assert_tree_bitwise(_host(params), tparams)
    _assert_tree_bitwise(_host(jax_fuse_params(params)), fuse_params(tparams))


def test_params_from_jax_model_tree_bitwise():
    """Every leaf of a built model (stacked layers, int4 and int8 dicts,
    f32 rope tables, a tied head's None) carries across unchanged."""
    cfg = JaxConfig(**dict(TINY, tie_word_embeddings=True))
    params = jax_fuse_params(jax_quantize_model(
        jax_init_params(cfg, 2, jnp.bfloat16), "int4"))
    model = JaxModel(cfg, params, dtype=jnp.bfloat16)
    host = _host(model.params)
    got = params_from_jax(host)
    _assert_tree_bitwise(host, got)
    assert got["layers"]["w_qkv"]["q_packed"].dtype == torch.uint8
    assert got["rope_cos"].dtype == torch.float32
