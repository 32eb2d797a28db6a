"""The port's Array API against the JAX package on the CPU.

Every op the port exports under the reference's names runs on the same
seeded numpy inputs through ``pygpukit_tpu.<op>`` and
``pygpukit_tpu_torch.<op>`` (``device="cpu"``): result dtypes equal (JAX
with 64-bit types off), integer, copy and layout results bitwise, float math
within rtol 1e-5 at f32 and one ulp at bf16 (the same math rounded once,
its f32 intermediates summed in another order), the quantizers byte for
byte. Also: ``sdpa_causal_fixed_cache`` on bf16 and int8 ``{"q", "s"}``
caches, full and chunked; the ``out=`` rebind (views taken earlier never
change); a tiny layer written in the Array API in both packages; the
factory; the default device (the card, or RuntimeError without one).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pygpukit_tpu as jg
import pygpukit_tpu_torch as tg
from pygpukit_tpu.ops import embedding as jemb
from pygpukit_tpu.ops.nn import attention as jattn
from pygpukit_tpu_torch.llm import params_from_jax
from pygpukit_tpu_torch.ops.nn import attention as tattn

torch.set_num_threads(2)

BF16 = jnp.bfloat16
#: the matmul modules (``<package>.ops.matmul`` is the function of that name)
MATMUL_MODULE = {g: importlib.import_module(g.__name__ + ".ops.matmul") for g in (jg, tg)}


def _np(x):
    if isinstance(x, jg.Array):
        return np.asarray(x.to_numpy())
    if isinstance(x, tg.Array):
        return x.to_numpy()
    if isinstance(x, torch.Tensor):
        return tg.Array(x).to_numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, (jg.Array, tg.Array)):
        return x.dtype.name
    return tg.Array(x).dtype.name if isinstance(x, torch.Tensor) else \
        jg.core.dtypes.to_dtype(np.asarray(x).dtype).name


def assert_same(got, ref, kind: str = "exact") -> None:
    """dtype and shape equal; values bitwise ("exact") or within rtol 1e-5
    at f32 and one ulp at bf16/f16 ("float")."""
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_same(g, r, kind)
        return
    assert _dtype_name(got) == _dtype_name(ref), (_dtype_name(got), _dtype_name(ref))
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape, (g.shape, r.shape)
    if kind == "exact" or not np.issubdtype(r.dtype.type, np.inexact) and r.dtype.kind != "V":
        if r.dtype.kind in "fV" or r.dtype.name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
            assert g.tobytes() == r.tobytes(), np.abs(g.astype(np.float32) - r.astype(np.float32)).max()
        else:
            np.testing.assert_array_equal(g, r)
        return
    gf, rf = g.astype(np.float32), r.astype(np.float32)
    assert np.array_equal(np.isnan(gf), np.isnan(rf))
    gf, rf = np.nan_to_num(gf), np.nan_to_num(rf)
    big = np.abs(rf).max() if rf.size else 0.0
    if r.dtype == np.float32:
        np.testing.assert_allclose(gf, rf, rtol=1e-5, atol=1e-6 * big + 1e-30)
    else:
        mant = 7 if r.dtype.name == "bfloat16" else 10
        tol = np.abs(rf) * 2.0 ** -mant + 1e-6 * big
        assert (np.abs(gf - rf) <= tol).all(), np.abs(gf - rf).max()


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((4, 6)).astype(np.float32)
    return {
        "f32": f, "f32b": rng.standard_normal((4, 6)).astype(np.float32),
        "bf16": f.astype(BF16), "bf16b": rng.standard_normal((4, 6)).astype(BF16),
        "pos": (np.abs(f) + 0.5).astype(np.float32),
        "i32": rng.integers(-50, 50, (4, 6)).astype(np.int32),
        "i32b": rng.integers(1, 9, (4, 6)).astype(np.int32),
        "u8": rng.integers(0, 255, (4, 6)).astype(np.uint8),
        "i8": rng.integers(-100, 100, (4, 6)).astype(np.int8),
        "bool": rng.random((4, 6)) > 0.5,
    }


def _pair(name, inp):
    """(reference Array, port Array) of input ``name``."""
    x = inp[name]
    return jg.from_numpy(x), tg.from_numpy(x, device="cpu")


# ---------------------------------------------------------------------------
# Elementwise, unary, reduction: every exported op over dtypes
# ---------------------------------------------------------------------------

UNARY = ["exp", "log", "sin", "cos", "tanh", "sqrt", "rsqrt", "sigmoid", "neg", "abs"]


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i32"])
@pytest.mark.parametrize("op", UNARY)
def test_unary_ops_match(op, dtype):
    inp = _inputs(1)
    if op in ("log", "sqrt", "rsqrt") and dtype != "i32":
        inp = {k: (np.abs(v) + 0.25).astype(v.dtype) for k, v in inp.items()}
    if op in ("log", "sqrt", "rsqrt") and dtype == "i32":
        inp["i32"] = np.abs(inp["i32"]) + 1
    a_j, a_t = _pair(dtype, inp)
    assert_same(getattr(tg, op)(a_t), getattr(jg, op)(a_j), "float")


BINARY = ["add", "sub", "mul", "div", "maximum", "minimum"]
PAIRS = [("f32", "f32b"), ("bf16", "bf16b"), ("bf16", "f32"), ("i32", "i32b"),
         ("u8", "i8"), ("i32", "f32"), ("bool", "i8")]


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "-".join(p))
@pytest.mark.parametrize("op", BINARY)
def test_binary_ops_match(op, pair):
    inp = _inputs(2)
    (aj, at), (bj, bt) = _pair(pair[0], inp), _pair(pair[1], inp)
    assert_same(getattr(tg, op)(at, bt), getattr(jg, op)(aj, bj), "float")


SCALARS = [("i8", 2), ("bf16", 2.0), ("i32", 2.5), ("bool", 2), ("u8", 3), ("f32", True),
           ("bool", 1.5)]


@pytest.mark.parametrize("case", SCALARS, ids=lambda c: f"{c[0]}-{c[1]!r}")
@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_python_scalars_are_weak(op, case):
    """A Python scalar keeps the array's type within its kind, on either
    side, through the ops and the operators."""
    name, s = case
    aj, at = _pair(name, _inputs(3))
    assert_same(getattr(tg, op)(at, s), getattr(jg, op)(aj, s), "float")
    sym = {"add": "__add__", "sub": "__sub__", "mul": "__mul__", "div": "__truediv__"}[op]
    assert_same(getattr(at, sym)(s), getattr(aj, sym)(s), "float")
    rsym = sym.replace("__", "__r", 1)
    assert_same(getattr(at, rsym)(s), getattr(aj, rsym)(s), "float")


DTYPE_RULES = [
    # (description, function of (package, Array maker of an input name or array))
    ("from_numpy int64", lambda g, mk: mk(np.arange(6, dtype=np.int64))),
    ("from_numpy float64", lambda g, mk: mk(np.linspace(0, 1, 5))),
    ("sum int32", lambda g, mk: g.sum(mk("i32"))),
    ("sum uint8", lambda g, mk: g.sum(mk("u8"))),
    ("sum bool", lambda g, mk: g.sum(mk("bool"))),
    ("sum int8 axis", lambda g, mk: g.sum(mk("i8"), axis=0)),
    ("mean int32", lambda g, mk: g.mean(mk("i32"))),
    ("mean bool", lambda g, mk: g.mean(mk("bool"), axis=1)),
    ("argmax", lambda g, mk: g.argmax(mk("f32"))),
    ("argmin axis", lambda g, mk: g.argmin(mk("i32"), axis=1)),
    ("div int/int", lambda g, mk: g.div(mk("i32"), mk("i32b"))),
    ("bf16 + f32", lambda g, mk: g.add(mk("bf16"), mk("f32"))),
    ("bf16 + 2.0", lambda g, mk: g.add(mk("bf16"), 2.0)),
    ("0-d f32 + bf16", lambda g, mk: g.add(g.sum(mk("f32")), mk("bf16"))),
    ("0-d int32 + uint8", lambda g, mk: g.add(g.sum(mk("i32")), mk("u8"))),
    ("uint8 + int8", lambda g, mk: g.add(mk("u8"), mk("i8"))),
    ("2.0 - int32", lambda g, mk: 2.0 - mk("i32")),
    ("int32 == 3", lambda g, mk: mk("i32") == 3),
    ("f32 > int32", lambda g, mk: mk("f32") > mk("i32")),
    ("matmul int32", lambda g, mk: g.matmul(mk("i32"), mk("i32b").T)),
    ("cumsum uint8", lambda g, mk: g.cumsum(mk("u8"), axis=0)),
    ("cumsum bool", lambda g, mk: g.cumsum(mk("bool"))),
    ("softmax int32", lambda g, mk: g.softmax(mk("i32b"))),
    ("where scalars", lambda g, mk: g.where(mk("bool"), 1, 2.5)),
    ("clamp int float bounds", lambda g, mk: g.clamp(mk("i32"), -0.5, 10.5)),
    ("clamp int", lambda g, mk: g.clamp(mk("i32"), 0, None)),
    ("max bool", lambda g, mk: g.max(mk("bool"), axis=0)),
    ("concat int8 uint8", lambda g, mk: g.concat([mk("i8"), mk("u8")], axis=1)),
    ("cast f32 -> int8", lambda g, mk: g.cast(mk("f32") * 40, "int8")),
    ("astype bf16", lambda g, mk: mk("f32").astype("bf16")),
    ("relu int32", lambda g, mk: g.relu(mk("i32"))),
]


@pytest.mark.parametrize("rule", DTYPE_RULES, ids=lambda r: r[0])
def test_result_dtypes_follow_the_reference(rule):
    inp = _inputs(4)
    _, fn = rule
    def arrays(make):
        return lambda x: make(inp[x] if isinstance(x, str) else x)
    ref = fn(jg, arrays(jg.from_numpy))
    got = fn(tg, arrays(lambda a: tg.from_numpy(a, device="cpu")))
    assert_same(got, ref, "float")


REDUCTIONS = ["sum", "mean", "max", "min", "argmax", "argmin", "softmax", "log_softmax",
              "cumsum"]


@pytest.mark.parametrize("op,dtype", [(op, dt) for op in REDUCTIONS
                                      for dt in ("f32", "bf16", "i32", "u8")
                                      if (op, dt) != ("cumsum", "bf16")])
def test_reductions_match(op, dtype):
    inp = _inputs(5)
    aj, at = _pair(dtype, inp)
    axes = [None, 0, 1] if op in ("sum", "mean", "max", "min", "argmax", "argmin") else [0, -1]
    for axis in axes:
        assert_same(getattr(tg, op)(at, axis=axis), getattr(jg, op)(aj, axis=axis), "float")
    if op in ("sum", "mean", "max", "min"):
        assert_same(getattr(tg, op)(at, axis=1, keepdims=True),
                    getattr(jg, op)(aj, axis=1, keepdims=True), "float")
        assert_same(getattr(tg, op)(at, keepdims=True), getattr(jg, op)(aj, keepdims=True),
                    "float")
        assert_same(getattr(at, op)(axis=0), getattr(aj, op)(axis=0), "float")
    assert_same(tg.sum_axis(at, 1), jg.sum_axis(aj, 1), "float")


def test_bf16_cumsum_sums_in_f32():
    """A bf16 cumsum is the f32 running sum of the bf16 values, rounded once
    (the reference's XLA scan rounds its partial sums instead: a recorded
    divergence)."""
    x = _inputs(5)["bf16"]
    got = tg.cumsum(tg.from_numpy(x, device="cpu"), axis=0)
    want = np.cumsum(x.astype(np.float32), axis=0).astype(BF16)
    assert got.dtype.name == "bfloat16"
    assert got.to_numpy().tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# Layout, copies, casts, indexing
# ---------------------------------------------------------------------------

LAYOUT = [
    ("transpose", lambda g, a: g.transpose(a)),
    ("T", lambda g, a: a.T),
    ("transpose axes", lambda g, a: a.reshape(2, 2, 6).transpose(2, 0, 1)),
    ("reshape", lambda g, a: a.reshape(3, 8)),
    ("ravel", lambda g, a: a.ravel()),
    ("narrow", lambda g, a: a.narrow(1, 2, 3)),
    ("slice_rows", lambda g, a: a.slice_rows(1, 3)),
    ("getitem", lambda g, a: a[1:3, ::2]),
    ("squeeze", lambda g, a: a.reshape(1, 4, 1, 6).squeeze()),
    ("squeeze axis", lambda g, a: a.reshape(1, 24).squeeze(0)),
    ("copy", lambda g, a: a.copy()),
    ("concat", lambda g, a: g.concat([a, a], axis=0)),
    ("concat axis1", lambda g, a: g.ops.concat_axis0([a, a])),
    ("repeat", lambda g, a: g.ops.repeat(a, 2, axis=1)),
    ("pad", lambda g, a: g.ops.pad(a, ((1, 0), (0, 2)), value=3)),
    ("pad int", lambda g, a: g.ops.pad(a, 1)),
    ("transpose_3d_021", lambda g, a: g.ops.transpose_3d_021(a.reshape(2, 3, 4))),
    ("transpose_3d_102", lambda g, a: g.ops.transpose_3d_102(a.reshape(2, 3, 4))),
    ("transpose_4d_0213", lambda g, a: g.ops.transpose_4d_0213(a.reshape(2, 3, 2, 2))),
    ("transpose_4d_0231", lambda g, a: g.ops.transpose_4d_0231(a.reshape(2, 3, 2, 2))),
    ("reshape_copy", lambda g, a: g.ops.reshape_copy(a, (6, 4))),
    ("cast bf16", lambda g, a: g.cast(a, "bfloat16")),
    ("cast_f32_to_bf16", lambda g, a: g.ops.cast_f32_to_bf16(a)),
    ("cast_bf16_to_f32", lambda g, a: g.ops.cast_bf16_to_f32(a.astype("bf16"))),
    ("cast int8", lambda g, a: g.cast(a, "int8")),
    ("fill_", lambda g, a: a.copy().fill_(2.7)),
    ("split_qkv_batch", lambda g, a: g.ops.split_qkv_batch(a, 2, 1, 1)),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i32"])
@pytest.mark.parametrize("case", LAYOUT, ids=lambda c: c[0])
def test_layout_and_copy_ops_bitwise(case, dtype):
    _, fn = case
    aj, at = _pair(dtype, _inputs(6))
    assert_same(fn(tg, at), fn(jg, aj), "exact")


def test_repeat_interleave_axis1():
    """GQA head expansion (the reference's own raises a NameError, so this
    holds the port against jnp.repeat)."""
    x = _inputs(6)["i32"].reshape(2, 3, 4)
    got = tg.ops.repeat_interleave_axis1(tg.from_numpy(x, device="cpu"), 2)
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(jnp.repeat(x, 2, axis=1)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_array_surface(dtype):
    aj, at = _pair(dtype, _inputs(7))
    for attr in ("shape", "ndim", "size", "itemsize", "nbytes"):
        assert getattr(at, attr) == getattr(aj, attr), attr
    assert at.dtype.name == aj.dtype.name and str(at.dtype) == str(aj.dtype)
    assert len(at) == len(aj) and repr(at) == repr(aj)
    assert at.sum().item() == pytest.approx(aj.sum().item(), rel=1e-2)
    assert isinstance(tg.sum(tg.from_numpy(np.arange(5, dtype=np.int32), device="cpu")).item(),
                      int)
    assert at.block_until_ready() is at
    assert tg.GPUArray is tg.Array
    assert isinstance(at.torch, torch.Tensor) and tg.Array.from_torch(at.torch).shape == at.shape
    idx = tg.from_numpy(np.array([2, 0], np.int32), device="cpu")
    assert_same(at[idx], aj[jg.from_numpy(np.array([2, 0], np.int32)).jax], "exact")


def test_dtype_registry():
    for name in ("float32", "bf16", "fp8", "fp8_e5m2", "int4", "uint8", "bool", "f16"):
        assert tg.to_dtype(name).name == jg.to_dtype(name).name
        assert tg.to_dtype(name).itemsize == jg.to_dtype(name).itemsize
        assert tg.to_dtype(name).kind.value == jg.to_dtype(name).kind.value
    for d in (np.float32, np.int64, BF16, jnp.float8_e4m3fn, np.bool_):
        assert tg.to_dtype(d).name == jg.to_dtype(d).name
    assert tg.to_dtype(torch.bfloat16) is tg.bfloat16 and tg.fp8 is tg.float8_e4m3
    assert tg.int4.torch_dtype == torch.int8       # int4 codes ride int8 (divergence)
    assert [d.name for d in tg.dtypes.all_dtypes()] == [d.name for d in jg.dtypes.all_dtypes()]
    with pytest.raises(ValueError):
        tg.to_dtype("complex-ish")


# ---------------------------------------------------------------------------
# Matmul family and quantizers
# ---------------------------------------------------------------------------

def _mats(seed, dtype="f32"):
    rng = np.random.default_rng(seed)
    out = {"a": rng.standard_normal((5, 8)), "b": rng.standard_normal((8, 3)),
           "bt": rng.standard_normal((3, 8)), "x": rng.standard_normal(8),
           "w": rng.standard_normal((3, 8)), "ab": rng.standard_normal((2, 5, 8)),
           "bb": rng.standard_normal((2, 8, 3)), "big_a": rng.standard_normal((64, 160)),
           "big_b": rng.standard_normal((160, 136)), "e": rng.standard_normal((3, 8, 4))}
    cast = np.float32 if dtype == "f32" else BF16
    return {k: v.astype(np.float32).astype(cast) for k, v in out.items()}


MATMUL = [
    ("matmul", lambda g, m: g.matmul(m["a"], m["b"])),
    ("operator", lambda g, m: m["a"] @ m["b"]),
    ("matmul kernel route", lambda g, m: g.ops.matmul(m["big_a"], m["big_b"])),
    ("matmul batched", lambda g, m: g.matmul(m["ab"], m["bb"])),
    ("matmul_nt", lambda g, m: g.matmul_nt(m["a"], m["bt"])),
    ("batched_matmul", lambda g, m: g.batched_matmul(m["ab"], m["bb"])),
    ("gemv", lambda g, m: g.gemv(m["w"], m["x"])),
    ("gemv_bf16", lambda g, m: g.ops.gemv_bf16(m["w"], m["x"])),
    ("grouped_matmul", lambda g, m: g.grouped_matmul(m["a"], m["e"], m["gid"])),
]


@pytest.mark.parametrize("gemm_mode", ["", "pallas"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", MATMUL, ids=lambda c: c[0])
def test_matmul_family_matches(case, dtype, gemm_mode, monkeypatch):
    monkeypatch.setenv("PYGPUKIT_GEMM", gemm_mode)
    mats = _mats(8, dtype)
    gid = np.array([0, 2, 1, 2, 5], np.int32)      # 5: outside [0, E) -> a zero row
    jm = {k: jg.from_numpy(v) for k, v in mats.items()} | {"gid": jg.from_numpy(gid)}
    tm = {k: tg.from_numpy(v, device="cpu") for k, v in mats.items()} | {
        "gid": tg.from_numpy(gid, device="cpu")}
    _, fn = case
    assert_same(fn(tg, tm), fn(jg, jm), "float")


def test_matmul_inner_dims_mismatch_raises():
    a = tg.zeros((2, 3), device="cpu")
    with pytest.raises(ValueError, match="inner dims"):
        tg.matmul(a, tg.zeros((4, 2), device="cpu"))


@pytest.mark.parametrize("axis", [-1, 0])
def test_quantizers_byte_exact(axis):
    rng = np.random.default_rng(9)
    w = (rng.standard_normal((12, 20)) * 3).astype(np.float32)
    wj, wt = jg.from_numpy(w), tg.from_numpy(w, device="cpu")
    assert_same(tg.ops.quantize_int8(wt, axis=axis), jg.ops.quantize_int8(wj, axis=axis))
    (q4, s4), (rq4, rs4) = tg.ops.quantize_int4(wt, axis=axis), jg.ops.quantize_int4(wj,
                                                                                    axis=axis)
    assert q4.dtype.name == "int8" and rq4.dtype.name == "int4"       # recorded divergence
    np.testing.assert_array_equal(q4.to_numpy(), np.asarray(rq4.to_numpy(), np.int8))
    assert_same(s4, rs4)
    assert_same(tg.ops.quantize_fp8(wt), jg.ops.quantize_fp8(wj))
    assert_same(tg.ops.quantize_fp8(wt, out_dtype=torch.float8_e5m2),
                jg.ops.quantize_fp8(wj, out_dtype=jnp.float8_e5m2))
    assert_same(MATMUL_MODULE[tg].quantize_fp8_block(wt, block=8),
                MATMUL_MODULE[jg].quantize_fp8_block(wj, block=8))


def test_quantized_matmuls_match():
    rng = np.random.default_rng(10)
    a = rng.standard_normal((6, 32)).astype(np.float32)
    b = rng.standard_normal((32, 10)).astype(np.float32)
    x = rng.standard_normal(32).astype(np.float32)
    res = {}
    for g, mk in ((jg, jg.from_numpy), (tg, lambda v: tg.from_numpy(v, device="cpu"))):
        ops = g.ops
        aq, sa = ops.quantize_fp8(mk(a))
        bq, sb = ops.quantize_fp8(mk(b))
        ai, sai = ops.quantize_int8(mk(a), axis=-1)
        bi, sbi = ops.quantize_int8(mk(b), axis=0)
        wn, swn = ops.quantize_int8(mk(b.T.copy()), axis=-1)
        w4, sw4 = ops.quantize_int4(mk(b.T.copy()), axis=-1)
        wb, swb = MATMUL_MODULE[g].quantize_fp8_block(mk(b), block=8)
        res[g.__name__] = (
            g.matmul_fp8(aq, bq, sa, sb),
            g.matmul_fp8(aq, bq, sa, sb, out_dtype=jnp.float32 if g is jg else torch.float32),
            g.matmul_int8(ai, bi, sai, sbi),
            g.matmul_w8a16(mk(a).astype("bf16"), bq, sb),
            ops.gemv_w8a16(mk(x), ops.quantize_fp8(mk(b.T.copy()))[0], sb),
            ops.gemv_int4(mk(x), w4 if g is tg else w4.astype("int8"), sw4),
            ops.gemv_w8a16(mk(x), wn, swn),
            MATMUL_MODULE[g].matmul_fp8_block(mk(a), wb, swb, block=8))
    assert_same(res["pygpukit_tpu_torch"], res["pygpukit_tpu"], "float")
    mm = MATMUL_MODULE[tg]
    assert mm.fp8_available() and mm.int8_available() and mm.int4_available()
    assert mm.w8a16_available() and mm.grouped_gemm_available() and not mm.nvf4_available()


# ---------------------------------------------------------------------------
# Neural ops, rope, attention, embedding, sampling
# ---------------------------------------------------------------------------

NN = [
    ("rmsnorm", lambda g, a, w, b: g.rmsnorm(a, w, 1e-5)),
    ("layernorm", lambda g, a, w, b: g.layernorm(a, w, b)),
    ("layernorm no bias", lambda g, a, w, b: g.layernorm(a, w)),
    ("l2norm", lambda g, a, w, b: g.l2norm(a)),
    ("gelu", lambda g, a, w, b: g.gelu(a)),
    ("gelu erf", lambda g, a, w, b: g.gelu(a, approximate=False)),
    ("silu", lambda g, a, w, b: g.silu(a)),
    ("relu", lambda g, a, w, b: g.relu(a)),
    ("relu2", lambda g, a, w, b: g.relu2(a)),
    ("swiglu", lambda g, a, w, b: g.swiglu(a, a * 0.5)),
    ("geglu", lambda g, a, w, b: g.geglu(a, a * 0.5)),
    ("softmax", lambda g, a, w, b: g.softmax(a)),
    ("log_softmax", lambda g, a, w, b: g.log_softmax(a, axis=0)),
    ("add_scaled", lambda g, a, w, b: g.add_scaled(a, a, 0.25)),
    ("where", lambda g, a, w, b: g.where(a > 0, a, 0.5)),
    ("clamp", lambda g, a, w, b: g.clamp(a, -0.5, 0.5)),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", NN, ids=lambda c: c[0])
def test_nn_ops_match(case, dtype):
    inp = _inputs(11)
    rng = np.random.default_rng(12)
    w, b = rng.standard_normal(6).astype(np.float32), rng.standard_normal(6).astype(np.float32)
    aj, at = _pair(dtype, inp)
    _, fn = case
    got = fn(tg, at, tg.from_numpy(w, device="cpu"), tg.from_numpy(b, device="cpu"))
    assert_same(got, fn(jg, aj, jg.from_numpy(w), jg.from_numpy(b)), "float")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_init_and_inplace(dtype):
    rng = np.random.default_rng(13)
    cos_t, sin_t = tg.rope_init(32, 8, 10000.0, device="cpu")
    cos_j, sin_j = jg.rope_init(32, 8, 10000.0)
    assert_same(cos_t, cos_j, "float")
    assert_same(sin_t, sin_j, "float")
    q = rng.standard_normal((5, 4, 8)).astype(np.float32)
    k = rng.standard_normal((5, 2, 8)).astype(np.float32)
    if dtype == "bf16":
        q, k = q.astype(BF16), k.astype(BF16)
    qj, kj = jg.from_numpy(q), jg.from_numpy(k)
    qt, kt = tg.from_numpy(q, device="cpu"), tg.from_numpy(k, device="cpu")
    q_view = qt.reshape(5, 32)
    jg.rope_inplace(qj, kj, cos_j, sin_j)
    tg.rope_inplace(qt, kt, cos_t, sin_t)
    assert_same(qt, qj, "float")
    assert_same(kt, kj, "float")
    assert q_view.to_numpy().tobytes() == q.reshape(5, 32).tobytes()   # rebound, not written
    tg.ops.rope_inplace_f32table(qt, kt, cos_t.torch, sin_t.torch)     # tensor tables too


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s_len", [12, 40])
def test_attention_wrappers_match(s_len, dtype):
    rng = np.random.default_rng(14)
    shapes = {"q": (s_len, 4, 16), "k": (s_len, 2, 16), "v": (s_len, 2, 16)}
    arrs = {n: rng.standard_normal(sh).astype(np.float32) for n, sh in shapes.items()}
    if dtype == "bf16":
        arrs = {n: a.astype(BF16) for n, a in arrs.items()}
    j = {n: jg.from_numpy(a) for n, a in arrs.items()}
    t = {n: tg.from_numpy(a, device="cpu") for n, a in arrs.items()}
    assert_same(tg.sdpa_causal(t["q"], t["k"], t["v"]), jg.sdpa_causal(j["q"], j["k"], j["v"]),
                "float")
    assert_same(tg.flash_attention(t["q"], t["k"], t["v"], chunk_size=16),
                jg.flash_attention(j["q"], j["k"], j["v"], chunk_size=16), "float")


def _caches(rng, max_len, hk, d, kind):
    """(reference, port) K and V caches [MAX, Hk, D]: bf16 tensors, or int8
    {"q", "s"} dicts quantized per row by the reference's kv_quant_rows."""
    out = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((max_len, hk, d)).astype(np.float32), BF16)
        if kind == "int8":
            q, s = jemb.kv_quant_rows(x, 2)
            ref = {"q": q, "s": s}
            out.append((ref, {"q": params_from_jax(np.asarray(q)),
                              "s": params_from_jax(np.asarray(s))}))
        else:
            out.append((x, params_from_jax(np.asarray(x))))
    return out


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("route", ["full", "chunked"])
@pytest.mark.parametrize("variant", ["plain", "lookahead", "softcap-window"])
def test_sdpa_fixed_cache_matches(route, kind, variant, monkeypatch):
    """Both routes, forced by PYGPUKIT_FLASH_DECODING (chunk 16 over a
    64-row cache: a partial last live chunk, dead chunks never read), on a
    bf16 cache and an int8 {"q","s"} cache."""
    monkeypatch.setenv("PYGPUKIT_FLASH_DECODING", route)
    monkeypatch.setenv("PYGPUKIT_FLASH_DECODING_CHUNK", "16")
    rng = np.random.default_rng(15)
    t = 3 if variant == "lookahead" else 1
    kw = {"softcap": 20.0, "window": 9} if variant == "softcap-window" else {}
    q = jnp.asarray(rng.standard_normal((t, 4, 16)).astype(np.float32), BF16)
    (kj, kt), (vj, vt) = _caches(rng, 64, 2, 16, kind)
    for ctx in (1, 37, 64):
        ref = jattn.sdpa_fixed_cache_fn(q, kj, vj, jnp.int32(ctx), **kw)
        got = tattn.sdpa_fixed_cache_fn(params_from_jax(np.asarray(q)), kt, vt, ctx, **kw)
        assert_same(got, ref, "float")
    if kind == "bf16" and not kw:
        qa = jg.from_numpy(np.asarray(q))
        ref = jg.sdpa_causal_fixed_cache(qa, jg.from_numpy(np.asarray(kj)),
                                         jg.from_numpy(np.asarray(vj)), 37)
        got = tg.sdpa_causal_fixed_cache(tg.from_numpy(np.asarray(q), device="cpu"),
                                         tg.Array(kt), tg.Array(vt), 37)
        assert_same(got, ref, "float")


def test_decode_pref_chooses_the_route(monkeypatch):
    monkeypatch.delenv("PYGPUKIT_FLASH_DECODING", raising=False)
    monkeypatch.delenv("PYGPUKIT_FLASH_DECODING_CHUNK", raising=False)
    assert tattn._decode_backend(100) == jattn._decode_backend(100) == "full"
    assert tattn._decode_backend(8192) == jattn._decode_backend(8192) == "chunked"
    with tattn.decode_pref("chunked", 64), jattn.decode_pref("chunked", 64):
        assert tattn._decode_backend(100) == jattn._decode_backend(100) == "chunked"
        assert tattn._flash_chunk() == jattn._flash_chunk() == 64
    assert tattn._flash_chunk() == jattn._flash_chunk() == 2048


def test_embedding_lookup_and_sampling():
    rng = np.random.default_rng(16)
    table = rng.standard_normal((10, 4)).astype(np.float32)
    ids = np.array([[3, 0], [9, 3]], np.int32)
    assert_same(tg.embedding_lookup(tg.from_numpy(table, device="cpu"),
                                    tg.from_numpy(ids, device="cpu")),
                jg.embedding_lookup(jg.from_numpy(table), jg.from_numpy(ids)))
    logits = rng.standard_normal((2, 50)).astype(np.float32)
    lt, lj = tg.from_numpy(logits, device="cpu"), jg.from_numpy(logits)
    assert_same(tg.sample_token_gpu(lt), jg.sample_token_gpu(lj))
    assert_same(tg.ops.sample_greedy(lt), jg.ops.sample_greedy(lj))
    out = tg.zeros((), "int32", device="cpu")
    assert tg.sample_token_gpu(lt, out=out) is out and out.item() == int(logits[-1].argmax())
    draws = []
    for _ in range(2):
        tg.set_sampling_seed(7)
        draws.append([tg.sample_token_gpu(lt, temperature=1.0).item(),
                      tg.ops.sample_topk(lt, 5).item(), tg.ops.sample_topp(lt, 0.5).item(),
                      tg.ops.sample_multinomial(tg.softmax(lt)).to_numpy().tolist()])
    assert draws[0] == draws[1]                          # replay under the seed
    top5 = set(np.argsort(logits[-1])[-5:].tolist())
    assert draws[0][1] in top5 and tg.sample_token_gpu(lt, 1.0).dtype.name == "int32"


# ---------------------------------------------------------------------------
# out= rebinding, a tiny layer, the factory and the default device
# ---------------------------------------------------------------------------

def test_out_rebinds_and_views_never_change():
    """``out=`` rebinds the handle as the reference's _set_buffer does: a
    view taken earlier keeps the old values (the old tensor is not
    written)."""
    x = _inputs(17)["f32"]
    a = tg.from_numpy(x, device="cpu")
    views = [a.reshape(24), a.T, a.narrow(0, 1, 2), a[1], a.slice_rows(0, 2)]
    before = [v.to_numpy().copy() for v in views]
    old = a.torch
    assert tg.add(a, a, out=a) is a
    tg.ops.mul_inplace(a, 3.0)
    tg.ops.bias_add_inplace(a, tg.from_numpy(np.ones(6, np.float32), device="cpu"))
    tg.exp(a, out=a)
    a.fill_(1.5)
    tg.ops.copy_to(tg.from_numpy(x * 2, device="cpu"), a)
    np.testing.assert_array_equal(a.to_numpy(), x * 2)
    for v, b in zip(views, before):
        np.testing.assert_array_equal(v.to_numpy(), b)
    assert a.torch is not old and np.array_equal(old.numpy(), x)
    r = jg.from_numpy(x)
    jg.add(r, r, out=r)
    assert_same(tg.add(tg.from_numpy(x, device="cpu"), tg.from_numpy(x, device="cpu"),
                       out=tg.zeros((4, 6), device="cpu")), r)
    i = tg.zeros((4, 6), "int32", device="cpu")
    tg.add(a, a, out=i)
    assert i.dtype.name == "int32"                       # cast to out's dtype
    with pytest.raises(ValueError):
        tg.add(a, a, out=tg.zeros((3, 6), device="cpu"))
    with pytest.raises(TypeError):
        tg.add(a, a, out=a.torch)


def _tiny_layer(g, mk, x, w):
    """A pre-norm decoder layer in the Array API: hidden 64, 4 query and 2
    kv heads of 16, S 16."""
    s, hq, hk, d = x.shape[0], 4, 2, 16
    h = mk(x)
    cos, sin = (g.rope_init(32, d) if g is jg else g.rope_init(32, d, device="cpu"))
    y = g.rmsnorm(h, mk(w["n1"]))
    q = g.matmul(y, mk(w["wq"])).reshape(s, hq, d)
    k = g.matmul(y, mk(w["wk"])).reshape(s, hk, d)
    v = g.matmul(y, mk(w["wv"])).reshape(s, hk, d)
    g.rope_inplace(q, k, cos, sin)
    attn = g.flash_attention(q, k, v).reshape(s, hq * d)
    h = g.add(h, g.matmul(attn, mk(w["wo"])))
    y = g.rmsnorm(h, mk(w["n2"]))
    return g.add(h, g.matmul(g.swiglu(g.matmul(y, mk(w["wg"])), g.matmul(y, mk(w["wu"]))),
                             mk(w["wd"])))


@pytest.mark.parametrize("gemm_mode", ["", "pallas"])
def test_tiny_layer_matches(gemm_mode, monkeypatch):
    monkeypatch.setenv("PYGPUKIT_GEMM", gemm_mode)
    rng = np.random.default_rng(18)
    e, inter = 64, 160
    shapes = {"wq": (e, 64), "wk": (e, 32), "wv": (e, 32), "wo": (64, e),
              "wg": (e, inter), "wu": (e, inter), "wd": (inter, e)}
    w = {n: (rng.standard_normal(sh) * 0.1).astype(np.float32) for n, sh in shapes.items()}
    w["n1"], w["n2"] = (rng.random(e) + 0.5).astype(np.float32), np.ones(e, np.float32)
    x = rng.standard_normal((16, e)).astype(np.float32)
    ref = _tiny_layer(jg, jg.from_numpy, x, w)
    got = _tiny_layer(tg, lambda a: tg.from_numpy(a, device="cpu"), x, w)
    assert got.dtype.name == ref.dtype.name == "float32"
    np.testing.assert_allclose(got.to_numpy(), ref.to_numpy(), rtol=1e-4,
                               atol=1e-4 * np.abs(ref.to_numpy()).max())


FACTORY = [
    ("zeros", lambda g, dev: g.zeros((2, 3), **dev)),
    ("zeros bf16", lambda g, dev: g.zeros((2,), "bf16", **dev)),
    ("ones int8", lambda g, dev: g.ones((3,), "int8", **dev)),
    ("full", lambda g, dev: g.full((2, 2), 3.7, **dev)),
    ("full int", lambda g, dev: g.full((2,), 3.7, "int32", **dev)),
    ("empty", lambda g, dev: g.empty((4,), **dev)),
    ("arange", lambda g, dev: g.arange(5, **dev)),
    ("arange float bounds", lambda g, dev: g.arange(0.0, 2.0, 0.5, **dev)),
    ("arange f32", lambda g, dev: g.arange(1, 7, 2, dtype="float32", **dev)),
    ("from_numpy bf16", lambda g, dev: g.from_numpy(np.linspace(-2, 2, 7), "bf16", **dev)),
    ("from_numpy fp8", lambda g, dev: g.from_numpy(np.linspace(-2, 2, 7), "fp8", **dev)),
    ("from_numpy bf16 array", lambda g, dev: g.from_numpy(np.linspace(-2, 2, 7).astype(BF16),
                                                          **dev)),
    ("zeros_like", lambda g, dev: g.zeros_like(g.ones((2, 3), "int16", **dev))),
    ("ones_like", lambda g, dev: g.ones_like(g.zeros((2,), "bf16", **dev))),
]


@pytest.mark.parametrize("case", FACTORY, ids=lambda c: c[0])
def test_factory_matches(case):
    _, fn = case
    assert_same(fn(tg, {"device": "cpu"}), fn(jg, {}), "exact")


def test_randn_shape_dtype_replay_and_moments():
    a = tg.randn(100, 100, seed=3, device="cpu")
    b = tg.randn(100, 100, seed=3, device="cpu")
    c = tg.randn(100, 100, seed=4, device="cpu")
    assert a.shape == (100, 100) and a.dtype.name == "float32"
    assert np.array_equal(a.to_numpy(), b.to_numpy()) and not np.array_equal(a.to_numpy(),
                                                                             c.to_numpy())
    x = a.to_numpy()
    assert abs(x.mean()) < 0.05 and abs(x.std() - 1.0) < 0.05
    assert tg.randn(3, 4, dtype="bf16", seed=1, device="cpu").dtype.name == "bfloat16"


def _constructors():
    from pygpukit_tpu_torch.llm import TransformerConfig, init_params
    from pygpukit_tpu_torch.ops.embedding import kv_cache_zeros
    from pygpukit_tpu_torch.ops.nn import rope_tables
    from pygpukit_tpu_torch.ops.paged import PagedKVCache
    cfg = TransformerConfig(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2,
                            num_kv_heads=1, intermediate_size=32,
                            max_position_embeddings=16)
    return {
        "init_params": lambda **kw: init_params(cfg, 0, torch.float32, **kw)["embed"],
        "PagedKVCache": lambda **kw: PagedKVCache(4, 4, 1, 8, **kw).k_pool,
        "kv_cache_zeros": lambda **kw: kv_cache_zeros((1, 2, 4, 8), torch.int8, **kw)["q"],
        "rope_init": lambda **kw: tg.rope_init(8, 4, **kw)[0].torch,
        "rope_tables": lambda **kw: rope_tables(8, 4, **kw)[0],
        "zeros": lambda **kw: tg.zeros((2,), **kw).torch,
        "ones": lambda **kw: tg.ones((2,), **kw).torch,
        "full": lambda **kw: tg.full((2,), 1.0, **kw).torch,
        "empty": lambda **kw: tg.empty((2,), **kw).torch,
        "arange": lambda **kw: tg.arange(3, **kw).torch,
        "from_numpy": lambda **kw: tg.from_numpy(np.ones(2), **kw).torch,
        "randn": lambda **kw: tg.randn(2, **kw).torch,
    }


@pytest.mark.parametrize("name", sorted(_constructors()))
def test_constructors_default_to_the_card(name):
    """No device: the card, or RuntimeError when none is visible (never a
    quiet CPU fallback); device="cpu" works."""
    make = _constructors()[name]
    assert make(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make().device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_params_from_jax_leaves_tensors_where_numpy_had_them():
    tree = {"a": np.ones((2, 2), np.float32), "b": np.zeros(3, BF16), "c": None}
    out = params_from_jax(tree)
    assert out["a"].device.type == "cpu" and out["b"].dtype == torch.bfloat16
    assert out["c"] is None
