"""The port's decode weight-format ladder (fp8, int8 w8a16, int4 w4a16,
int4_block w4a8 and w4a16) against the JAX package. Inputs are made with
numpy from a seed and fed to both packages.

- quantizers, dequantizers, fuse_params and params_from_jax: bitwise;
- the four GEMVs' plain versions against the Pallas kernels in interpret
  mode, at the tile sizes of tests/test_kernels_interpret.py: within one
  bf16 ulp of the kernel's output (the same f32 math, summed in another
  order; the block w4a8 product is integer-exact per block);
- a block straddling K/2 against the JAX dequantization;
- tiny bf16 models: logits against the JAX model, whose CPU route is the
  XLA dequant dot: within 3e-2 of max |logit| for the w4a8 rung (int8
  activations, as tests/test_torch_slice.py holds the int4 rung), 1e-2 for
  the w4a16 and fp8 rungs (bf16 activations rounded after sums taken in
  another order);
- which wrapper each leaf kind and switch reaches.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygpukit_tpu.kernels import gemv_quant as jgq
from pygpukit_tpu.llm import CausalTransformerModel as JaxModel
from pygpukit_tpu.llm import TransformerConfig as JaxConfig
from pygpukit_tpu.llm import init_params as jax_init_params
from pygpukit_tpu.llm.model import fuse_params as jax_fuse_params
from pygpukit_tpu.llm.quant import dequantize_weight as jax_dequantize
from pygpukit_tpu.llm.quant import quantize_model_params as jax_quantize_model
from pygpukit_tpu.llm.quant import quantize_weight as jax_quantize_weight
from pygpukit_tpu.llm.quant import unpack_int4 as jax_unpack_int4
from pygpukit_tpu_torch.kernels import (block_w4a8_matmul, block_w4a16_matmul,
                                        conv_matmul, w4a16_matmul)
from pygpukit_tpu_torch.kernels.gemv_quant import quantize_acts
from pygpukit_tpu_torch.llm import (CausalTransformerModel,
                                    ContinuousBatchingEngine, TransformerConfig,
                                    dequantize_weight, fuse_params,
                                    params_from_jax, quantize_model_params,
                                    quantize_weight, unpack_int4)
from pygpukit_tpu_torch.llm import model as port_model

torch.set_num_threads(2)

TINY = dict(vocab_size=97, hidden_size=48, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=96, head_dim_override=12,
            max_position_embeddings=256, tie_word_embeddings=False)
PROMPT = [9, 9, 1, 4, 60, 2, 8]


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _raw(a):
    """Raw bytes of a numpy (incl. ml_dtypes) array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view(torch.uint8).numpy() if a.element_size() == 1 \
            else a.view(torch.int16).numpy().view(np.uint8) if a.element_size() == 2 \
            else a.numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _assert_tree_bitwise(jtree, ttree, path=""):
    if isinstance(jtree, dict):
        assert isinstance(ttree, dict) and set(jtree) == set(ttree), path
        for k in jtree:
            _assert_tree_bitwise(jtree[k], ttree[k], f"{path}/{k}")
        return
    if jtree is None:
        assert ttree is None, path
        return
    assert tuple(np.shape(jtree)) == tuple(ttree.shape), path
    assert np.array_equal(_raw(jtree), _raw(ttree)), path


def _bf16_ulp(ref):
    """One bf16 ulp at each value of ``ref`` (f32 numpy)."""
    mag = np.maximum(np.abs(ref), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _assert_within_ulp(got: torch.Tensor, ref):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref) / _bf16_ulp(ref)
    assert err.max() <= 1.0, (err.max(), np.argwhere(err > 1.0)[:5])


# ---------------------------------------------------------------------------
# Formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block,shape", [(32, (2, 96, 40)), (32, (70, 24)),
                                         (16, (2, 88, 16)), (16, (45, 32))])
def test_int4_block_quantize_bitwise(block, shape):
    """Block sizes 32 and 16, with in-dims that need block padding (70, 45)."""
    rng = np.random.default_rng(block + shape[-2])
    wj = jnp.asarray(rng.standard_normal(shape, dtype=np.float32) * 0.02, jnp.bfloat16)
    ref = _host(jax_quantize_weight(wj, "int4_block", block_size=block))
    got = quantize_weight(params_from_jax(np.asarray(wj)), "int4_block", block)
    _assert_tree_bitwise(ref, got)
    assert got["scale_block"].dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(2, 48, 40), (64, 96)])
def test_fp8_quantize_bitwise_with_extremes_at_448(shape):
    """Columns whose extreme maps exactly to +-448 (torch's cast saturates
    where the reference's gives NaN; at amax/448 the two agree)."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal(shape, dtype=np.float32) * 0.02
    w[..., 3, 0] = 0.75
    w[..., 7, 1] = -0.5
    w[..., :, 2] = 0.0                          # an all-zero column: scale 1e-12
    wj = jnp.asarray(w)
    ref = _host(jax_quantize_weight(wj, "fp8"))
    got = quantize_weight(torch.from_numpy(w), "fp8")
    _assert_tree_bitwise(ref, got)
    q = got["q"].float()
    assert q[..., 3, 0].eq(448).all() and q[..., 7, 1].eq(-448).all()


def test_unpack_int4_k_major_bitwise():
    packed = np.random.default_rng(3).integers(0, 256, (2, 24, 16), dtype=np.uint8)
    ref = np.asarray(jax_unpack_int4(jnp.asarray(packed), axis=-2))
    np.testing.assert_array_equal(unpack_int4(torch.from_numpy(packed), axis=-2).numpy(),
                                  ref)


@pytest.mark.parametrize("mode", ["int4", "int8", "fp8", "int4_block"])
def test_dequantize_weight_bitwise(mode):
    rng = np.random.default_rng(9)
    w = rng.standard_normal((2, 70, 24), dtype=np.float32) * 0.02
    jq = jax_quantize_weight(jnp.asarray(w), mode)
    for dt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jax_dequantize(jq, dt))
        got = dequantize_weight(params_from_jax(_host(jq)), tdt)
        assert np.array_equal(_raw(ref), _raw(got)), dt


@pytest.mark.parametrize("mode", ["int4_block", "fp8"])
def test_quantize_and_fuse_model_bitwise(mode):
    cfg = JaxConfig(**TINY)
    params = jax_quantize_model(jax_init_params(cfg, 1, jnp.bfloat16), mode)
    tparams = quantize_model_params(
        params_from_jax(_host(jax_init_params(cfg, 1, jnp.bfloat16))), mode)
    _assert_tree_bitwise(_host(params), tparams)
    fused = fuse_params(tparams)
    _assert_tree_bitwise(_host(jax_fuse_params(params)), fused)
    assert {"w_qkv", "w_gate_up"} <= set(fused["layers"])


def test_params_from_jax_drops_split_block_scales():
    """A built reference int4_block model carries scale_lo/scale_hi; the
    port checks them against scale_block and keeps scale_block alone."""
    cfg = JaxConfig(**TINY)
    jm = JaxModel(cfg, jax_fuse_params(jax_quantize_model(
        jax_init_params(cfg, 2, jnp.bfloat16), "int4_block")), dtype=jnp.bfloat16)
    host = _host(jm.params)
    assert "scale_lo" in host["layers"]["w_qkv"]
    got = params_from_jax(host)
    for name in ("w_qkv", "w_o", "w_gate_up", "w_down"):
        assert set(got["layers"][name]) == {"q_packed", "scale_block"}
    bad = dict(host["layers"]["w_o"])
    bad["scale_hi"] = bad["scale_lo"]
    with pytest.raises(ValueError, match="scale_hi"):
        params_from_jax(bad)


# ---------------------------------------------------------------------------
# Plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

L, K, N, BLK = 2, 256, 256, 32


@pytest.fixture(scope="module")
def block_weight():
    w = np.random.default_rng(21).standard_normal((L, K, N)).astype(np.float32)
    jq = jax_quantize_weight(jnp.asarray(w), "int4_block", block_size=BLK)
    return jq, params_from_jax(_host(jq))


def _acts(rows, seed):
    x = np.random.default_rng(seed).standard_normal((rows, K)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, params_from_jax(np.asarray(xj))


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_block_w4a8_plain_matches_pallas(block_weight, monkeypatch, rows):
    """Against _gemv_block_w4a8_stacked_pallas (activation quant outside
    the kernel, the port's order of operations) for each layer of the
    stack; the port's 2-D weight is the layer's view."""
    monkeypatch.setenv("PYGPUKIT_W4A8_QUANT", "xla")
    jq, tq = block_weight
    xj, xt = _acts(rows, rows)
    for i in range(L):
        ref = jgq.gemv_int4_block_w4a8_stacked(jq["q_packed"], jnp.int32(i), xj,
                                               jq["scale_block"], bn=128, bk_half=128)
        _assert_within_ulp(block_w4a8_matmul(xt, tq["q_packed"][i],
                                             tq["scale_block"][i]), ref)


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_block_w4a16_plain_matches_pallas(block_weight, rows):
    """Stacked (_gemv_block_stacked_pallas) and 2-D (_gemv_block_pallas)."""
    jq, tq = block_weight
    xj, xt = _acts(rows, 10 + rows)
    for i in range(L):
        got = block_w4a16_matmul(xt, tq["q_packed"][i], tq["scale_block"][i])
        ref = jgq.gemv_int4_block_stacked(jq["q_packed"], jnp.int32(i), xj,
                                          jq["scale_block"], bn=128, bk_half=128)
        _assert_within_ulp(got, ref)
        ref2 = jgq.gemv_int4_block(jq["q_packed"][i], xj, jq["scale_block"][i],
                                   bn=128, bk_half=128)
        _assert_within_ulp(got, ref2)


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("xdt", ["f32", "bf16"])
def test_w4a16_plain_matches_pallas(rows, xdt):
    """Stacked (_gemv_packed_stacked_pallas) and 2-D (_gemv_packed_pallas)."""
    rng = np.random.default_rng(30 + rows)
    w = rng.standard_normal((L, K, N)).astype(np.float32)
    jq = jax_quantize_weight(jnp.asarray(w), "int4")            # [L, N, K/2]
    tq = params_from_jax(_host(jq))
    x = rng.standard_normal((rows, K)).astype(np.float32)
    xj = jnp.asarray(x) if xdt == "f32" else jnp.asarray(x, jnp.bfloat16)
    xt = params_from_jax(np.asarray(xj))
    for i in range(L):
        got = w4a16_matmul(xt, tq["q_packed"][i], tq["scale"][i])
        ref = jgq.gemv_int4_packed_stacked(jq["q_packed"], jnp.int32(i), xj,
                                           jq["scale"], bn=128, bk_half=128)
        _assert_within_ulp(got, ref)
        ref2 = jgq.gemv_int4_packed(jq["q_packed"][i], xj, jq["scale"][i].ravel(),
                                    bn=128, bk_half=128)
        _assert_within_ulp(got, ref2)


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("kind", ["float8_e4m3fn", "float8_e5m2", "int8", "bfloat16"])
def test_conv_plain_matches_pallas(rows, kind):
    """_gemv_conv_stacked_pallas on [L, K, N] weights of each storage type
    it converts, per layer."""
    rng = np.random.default_rng(40 + rows)
    w = rng.standard_normal((L, K, N)).astype(np.float32)
    if kind == "int8":
        jw = jnp.asarray(np.clip(np.round(w * 40), -127, 127), jnp.int8)
    else:
        jw = jnp.asarray(w * 8, getattr(jnp, kind))
    scale = (rng.random((L, 1, N)) * 1e-2 + 1e-3).astype(np.float32)
    x = rng.standard_normal((rows, K)).astype(np.float32)
    tw, ts = params_from_jax(np.asarray(jw)), torch.from_numpy(scale)
    for i in range(L):
        ref = jgq.gemv_conv_stacked(jw, jnp.int32(i), jnp.asarray(x), jnp.asarray(scale),
                                    bn=128, bk=128)
        _assert_within_ulp(conv_matmul(torch.from_numpy(x), tw[i], ts[i]), ref)


@pytest.mark.parametrize("k_in,block", [(80, 32), (96, 32), (48, 16)])
def test_block_straddling_half_k_matches_dequant(k_in, block):
    """B does not divide K/2 (after padding 80 -> 96: K/2 = 48, B = 32), so
    one block straddles the halves; the reference's kernels refuse such a
    shape and its model falls back to the dequant dot. Both port products
    index each k's block as k // B and equal that dot within one bf16 ulp
    (w4a8: of the integer-exact product with int8 activations)."""
    rng = np.random.default_rng(k_in)
    w = rng.standard_normal((k_in, 64)).astype(np.float32)
    jq = jax_quantize_weight(jnp.asarray(w), "int4_block", block_size=block)
    tq = params_from_jax(_host(jq))
    wd = np.asarray(jax_dequantize(jq, jnp.float32), np.float64)     # [Kpad, N]
    x = rng.standard_normal((3, k_in)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = params_from_jax(np.asarray(xj))
    xpad = np.pad(np.asarray(xj, np.float64), ((0, 0), (0, wd.shape[0] - k_in)))
    wb = np.asarray(jax_dequantize(jq, jnp.bfloat16), np.float64)
    _assert_within_ulp(block_w4a16_matmul(xt, tq["q_packed"], tq["scale_block"]),
                       (xpad @ wb).astype(np.float32))
    xq, sx = quantize_acts(torch.from_numpy(xpad.astype(np.float32)))
    exact = (xq.double().numpy() @ wd) * sx.double().numpy()
    _assert_within_ulp(block_w4a8_matmul(xt, tq["q_packed"], tq["scale_block"]),
                       exact.astype(np.float32))


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

def _pair(quant, dtype, seed=3, cfg_kw=TINY):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    params = jax_quantize_model(jax_init_params(JaxConfig(**cfg_kw), seed, jdt), quant)
    jm = JaxModel(JaxConfig(**cfg_kw), jax_fuse_params(params), dtype=jdt)
    tm = CausalTransformerModel(TransformerConfig(**cfg_kw),
                                params_from_jax(_host(jm.params)), dtype=tdt)
    return jm, tm


@pytest.mark.parametrize("quant,switch,tol", [
    ("int4_block", {}, 3e-2),
    ("int4_block", {"PYGPUKIT_INT4_BLOCK": "w4a16"}, 1e-2),
    ("fp8", {}, 1e-2),
    ("int4", {"PYGPUKIT_INT4_MODE": "w4a16"}, 1e-2),
])
def test_model_logits_match_jax(monkeypatch, quant, switch, tol):
    """Prefill and two decode steps' logits of a tiny bf16 model; both
    heads on the plain int8 convert (w8a16) or fp8 convert route."""
    monkeypatch.setenv("PYGPUKIT_INT8_MODE", "w8a16")
    for k, v in switch.items():
        monkeypatch.setenv(k, v)
    jm, tm = _pair(quant, "bf16")
    jm.init_fixed_cache(64)
    tm.init_fixed_cache(64)
    ref, got = np.asarray(jm.prefill(PROMPT)), tm.prefill(PROMPT).numpy()
    for tok in (17, 40, None):
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= tol * scale, np.abs(got - ref).max() / scale
        if tok is not None:
            ref = np.asarray(jm.decode_step(tok))
            got = tm.decode_step(tok).numpy()


@pytest.mark.parametrize("switch", ["w4a8", "w4a16"])
def test_int4_block_engine_matches_single_stream_generate(monkeypatch, switch):
    monkeypatch.setenv("PYGPUKIT_INT4_BLOCK", switch)
    _, tm = _pair("int4_block", "f32", seed=5, cfg_kw=dict(TINY, num_layers=1))
    prompts, n_new = [[5, 11, 42], [7, 3], [9, 9, 1, 4, 60, 2, 8], [1, 2]], [8, 8, 6, 9]
    eng = ContinuousBatchingEngine(tm, max_batch=3, max_seq_len=128, steps_per_dispatch=4)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, n_new)]
    eng.run_until_complete()
    assert all(r.done for r in reqs) and eng.logits_finite()
    for prompt, n, r in zip(prompts, n_new, reqs):
        tm.init_fixed_cache(128)
        assert tm.generate(prompt, max_new_tokens=n) == r.generated


@pytest.mark.parametrize("where", ["prefill", "decode_chunk", "decode_step"])
def test_model_logits_finite_sees_a_non_finite_step(where):
    """A NaN head weight, set before the step named, makes logits_finite()
    false until the next init_fixed_cache."""
    cfg = TransformerConfig(**TINY)
    tm = CausalTransformerModel(cfg, port_model.init_params(cfg, 0, torch.float32, "cpu"),
                                dtype=torch.float32)
    tm.generate(PROMPT, max_new_tokens=4)
    assert tm.logits_finite()
    tm.init_fixed_cache(64)
    if where != "prefill":
        tm.prefill(PROMPT)
        assert tm.logits_finite()
    tm.lm_head[0, 0] = float("nan")
    {"prefill": lambda: tm.prefill(PROMPT), "decode_chunk": lambda: tm.decode_chunk(3, 2),
     "decode_step": lambda: tm.decode_step(3)}[where]()
    assert not tm.logits_finite()
    tm.init_fixed_cache(64)
    assert tm.logits_finite()


LEAVES = {
    "int4": lambda w: quantize_weight(w, "int4"),
    "int4_block": lambda w: quantize_weight(w, "int4_block"),
    "fp8": lambda w: quantize_weight(w, "fp8"),
    "int8": lambda w: quantize_weight(w, "int8"),
}


@pytest.mark.parametrize("leaf,switch,gemv,big", [
    ("int4", {}, "w4a8_matmul", "w4a8_matmul"),
    ("int4", {"PYGPUKIT_INT4_MODE": "w4a16"}, "w4a16_matmul", "w4a16_matmul_plain"),
    ("int4_block", {}, "block_w4a8_matmul", "block_w4a16_matmul_plain"),
    ("int4_block", {"PYGPUKIT_INT4_BLOCK": "w4a16"}, "block_w4a16_matmul",
     "block_w4a16_matmul_plain"),
    ("fp8", {}, "conv_matmul", "conv_matmul_plain"),
    ("int8", {}, "_w8a8", "_w8a8"),
    ("int8", {"PYGPUKIT_INT8_MODE": "w8a16"}, "conv_matmul", "conv_matmul_plain"),
])
def test_route_reaches_the_wrapper(monkeypatch, leaf, switch, gemv, big):
    """Rows <= 8 reach the GEMV wrapper, more rows and the f32 head the
    plain route; every switch is read per call. An int4 layer leaf under
    the default w4a8 switch takes the reference's TPU route: the dequant
    matmul (no activation quant) for 9 <= rows < 256, the w4a8 GEMM wrapper
    from 256 rows; its head takes w4a8 at every row count."""
    for k, v in switch.items():
        monkeypatch.setenv(k, v)
    calls = []
    for name in ("w4a8_matmul", "w4a16_matmul", "w4a16_matmul_plain",
                 "block_w4a8_matmul", "block_w4a16_matmul", "block_w4a16_matmul_plain",
                 "conv_matmul", "conv_matmul_plain", "_w8a8"):
        fn = getattr(port_model, name)
        monkeypatch.setattr(port_model, name,
                            lambda *a, _n=name, _f=fn, **kw: calls.append(_n) or _f(*a, **kw))
    w = LEAVES[leaf](torch.randn(64, 32) * 0.02)
    x = torch.randn(256, 64).to(torch.bfloat16)
    mid = "w4a16_matmul_plain" if leaf == "int4" and not switch else big
    for rows, out_dtype, want in ((1, None, gemv), (8, None, gemv), (9, None, mid),
                                  (255, None, mid), (256, None, big)):
        calls.clear()
        y = port_model._mm(x[:rows], w, out_dtype)
        assert calls == [want] and y.shape == (rows, 32) and y.dtype == torch.bfloat16
    calls.clear()
    head = port_model._mm(x[:1], w, torch.float32)
    assert head.dtype == torch.float32
    assert calls == [big if gemv != "w4a8_matmul" else gemv]
    calls.clear()
    port_model._mm(x[:9], w, torch.float32)
    assert calls == [big]


def test_unknown_switch_value_raises(monkeypatch):
    monkeypatch.setenv("PYGPUKIT_INT4_BLOCK", "w4a4")
    w = quantize_weight(torch.randn(64, 32) * 0.02, "int4_block")
    with pytest.raises(ValueError, match="PYGPUKIT_INT4_BLOCK"):
        port_model._mm(torch.randn(1, 64), w)


def test_unported_leaf_kinds_raise():
    params = quantize_model_params(port_model.init_params(
        TransformerConfig(**TINY), 0, torch.float32, "cpu"), "int4_block")
    layers = dict(params["layers"])
    layers["w_o"] = dict(layers["w_o"], scale=torch.ones(1))
    with pytest.raises(NotImplementedError, match="w_o"):
        CausalTransformerModel(TransformerConfig(**TINY), dict(params, layers=layers))
    layers["w_o"] = {"q": torch.zeros(2, 48, 48, dtype=torch.int16),
                     "scale": torch.ones(2, 1, 48)}
    with pytest.raises(NotImplementedError, match="w_o"):
        CausalTransformerModel(TransformerConfig(**TINY), dict(params, layers=layers))
