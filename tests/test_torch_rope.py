"""Every function of ``pygpukit_tpu_torch.ops.nn.rope`` against the JAX
package's ``ops/nn/rope.py`` on the same numpy inputs, on the CPU.

- Tables (standard, NTK-aware, YaRN with and without mscale, attention
  factor and truncation, Llama-3, LongRoPE with either factor list,
  linear): within atol 1e-5 on positions below 8192. f32 ``pow``, ``cos``
  and ``sin`` of the two libraries may differ by an ulp, and an ulp of
  the angle grows with the position, so the full-length tables are held
  to the bound ``_ulp_bound`` gives.
- Split-half, interleaved and partial application at f32: rtol 1e-6.
- PoPE and ALiBi, the Array forms in place: rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygpukit_tpu.core.array import Array as JArray
from pygpukit_tpu.ops.nn import rope as ref
from pygpukit_tpu_torch.core.array import Array as TArray
from pygpukit_tpu_torch.ops.nn import rope as port

CPU = "cpu"
ATOL = 1e-5
#: (head_dim, base) of the tables
SHAPES = [(64, 500000.0), (96, 10000.0), (128, 1000000.0), (8, 10000.0)]


def _np(x) -> np.ndarray:
    if isinstance(x, JArray):
        return np.asarray(x.jax)
    if isinstance(x, TArray):
        return x.torch.numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _pair(a, b):
    return [_np(x) for x in a], [_np(x) for x in b]


def _ulp_bound(n: int, scale: float = 1.0) -> float:
    """A few f32 ulps of the largest angle (n radians at frequency 1), the
    difference two libraries' f32 ``cos`` can show there."""
    return 4 * float(np.spacing(np.float32(n))) * scale + ATOL


def _check_tables(got, want, n: int, scale: float = 1.0):
    for g, w in zip(*_pair(got, want)):
        assert g.shape == w.shape and g.dtype == np.float32
        head = min(n, 8192)
        np.testing.assert_allclose(g[:head], w[:head], rtol=0, atol=ATOL)
        np.testing.assert_allclose(g, w, rtol=0, atol=_ulp_bound(n, scale))


@pytest.mark.parametrize("d,base", SHAPES)
def test_standard_tables(d, base):
    _check_tables(port.rope_init(9000, d, base, device=CPU), ref.rope_init(9000, d, base), 9000)
    cos, sin = port.rope_tables(300, d, base, device=CPU)
    w = ref.rope_init(300, d, base)
    _check_tables((cos, sin), w, 300)


@pytest.mark.parametrize("scale", [1.0, 2.0, 8.0])
@pytest.mark.parametrize("d,base", SHAPES)
def test_ntk_aware_tables(d, base, scale):
    _check_tables(port.rope_init_ntk_aware(9000, d, base, scale, device=CPU),
                  ref.rope_init_ntk_aware(9000, d, base, scale), 9000)


YARN_CASES = {
    "plain": dict(scale=4.0, original_max_len=2048),
    "mscale": dict(scale=40.0, original_max_len=4096, mscale=1.0, mscale_all_dim=0.707),
    "mscale both one": dict(scale=4.0, original_max_len=4096, mscale=1.0, mscale_all_dim=1.0),
    "attention factor": dict(scale=4.0, original_max_len=32768, attention_factor=0.8),
    "no truncate": dict(scale=16.0, original_max_len=4096, truncate=False),
    "betas": dict(scale=2.0, original_max_len=1024, beta_fast=16.0, beta_slow=2.0),
    "scale one": dict(scale=1.0, original_max_len=4096),
}


@pytest.mark.parametrize("case", list(YARN_CASES))
@pytest.mark.parametrize("d,base", SHAPES)
def test_yarn_tables(d, base, case):
    kw = YARN_CASES[case]
    got = port.rope_init_yarn(9000, d, base, device=CPU, **kw)
    want = ref.rope_init_yarn(9000, d, base, **kw)
    _check_tables(got, want, 9000, scale=2.0)


@pytest.mark.parametrize("kw", [dict(scale=32.0, original_max_len=8192),
                                dict(scale=8.0, original_max_len=8192, low_freq_factor=2.0,
                                     high_freq_factor=8.0),
                                dict(scale=4.0, original_max_len=16)])
@pytest.mark.parametrize("d,base", SHAPES)
def test_llama3_tables(d, base, kw):
    _check_tables(port.rope_init_llama3(9000, d, base, device=CPU, **kw),
                  ref.rope_init_llama3(9000, d, base, **kw), 9000)


def test_llama3_tables_at_llama_3_2_s_full_length():
    """Llama-3.2-1B's tables (D 64, theta 500000, factor 32) at its 131072
    positions: within atol 1e-5 below 8192, a few ulps of the angle
    beyond; the largest difference is reported."""
    n = 131072
    got = port.rope_tables_llama3(n, 64, 500000.0, 32.0, 8192, 1.0, 4.0, device=CPU)
    want = ref.rope_init_llama3(n, 64, 500000.0, 32.0, 8192, 1.0, 4.0)
    _check_tables(got, want, n)


@pytest.mark.parametrize("which", ["short", "long"])
@pytest.mark.parametrize("attn", [1.0, 1.1902380714238083])
@pytest.mark.parametrize("d,base", SHAPES)
def test_longrope_tables(d, base, attn, which):
    rng = np.random.default_rng(d)
    half = d // 2
    factors = (np.sort(rng.uniform(1.0, 1.2 if which == "short" else 40.0, half))
               .astype(np.float64).tolist())
    _check_tables(port.rope_init_longrope(9000, d, base, factors, attn, device=CPU),
                  ref.rope_init_longrope(9000, d, base, factors, attn), 9000, scale=attn)


@pytest.mark.parametrize("scale", [1.0, 8.0, 0.5])
@pytest.mark.parametrize("d,base", SHAPES)
def test_linear_tables(d, base, scale):
    _check_tables(port.rope_init_linear(9000, d, base, scale, device=CPU),
                  ref.rope_init_linear(9000, d, base, scale), 9000)


def test_tables_land_on_the_named_device():
    for fn, args in ((port.rope_tables_ntk_aware, (16, 8)), (port.rope_tables_yarn, (16, 8)),
                     (port.rope_tables_llama3, (16, 8)), (port.rope_tables_linear, (16, 8)),
                     (port.rope_tables_longrope, (16, 8, 10000.0, [1.0] * 4))):
        cos, sin = fn(*args, device=CPU)
        assert cos.device.type == sin.device.type == "cpu" and cos.shape == (16, 8)


# ---------------------------------------------------------------------------
# Application
# ---------------------------------------------------------------------------

def _xs(seed: int, s: int, h: int, d: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((s, h, d)).astype(np.float32)


@pytest.mark.parametrize("d", [8, 64, 96, 128])
def test_interleaved_and_split_half_application(d):
    s = 40
    x = _xs(d, s, 3, d)
    cos_j, sin_j = ref.rope_init_llama3(s, d, 10000.0, 4.0, 16)
    cos, sin = port.rope_tables_llama3(s, d, 10000.0, 4.0, 16, device=CPU)
    for rf, pf in ((ref.apply_rope_fn, port.apply_rope_fn),
                   (ref.apply_rope_interleaved_fn, port.apply_rope_interleaved_fn)):
        want = np.asarray(rf(jnp.asarray(x), cos_j.jax, sin_j.jax))
        got = pf(torch.from_numpy(x), cos, sin).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("d,rd", [(8, 4), (128, 64), (96, 48)])
def test_partial_rotary_application(d, rd, interleaved):
    """The model's ``_rope``: the first ``rope_dim`` dims rotate by tables
    of that width, the tail passes through (GLM-4's partial 0.5)."""
    import dataclasses
    from pygpukit_tpu.llm import config as ref_config
    from pygpukit_tpu.llm import model as ref_model
    from pygpukit_tpu_torch.llm import config as port_config
    from pygpukit_tpu_torch.llm import model as port_model
    kw = dict(vocab_size=96, hidden_size=4 * d, num_layers=1, num_heads=4,
              head_dim_override=d, rope_partial_factor=rd / d, rope_interleaved=interleaved)
    jcfg = ref_config.TransformerConfig(**kw)
    tcfg = port_config.TransformerConfig(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg) and tcfg.rope_dim == rd
    s = 33
    x = _xs(rd, s, 4, d)
    cos_j, sin_j = ref.rope_init(s, rd, 10000.0)
    cos, sin = port.rope_tables(s, rd, 10000.0, device=CPU)
    want = np.asarray(ref_model._rope(jcfg, jnp.asarray(x), cos_j.jax, sin_j.jax))
    got = port_model._rope(tcfg, torch.from_numpy(x), cos, sin).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[..., rd:], x[..., rd:])


@pytest.mark.parametrize("fn", ["rope_inplace", "rope_inplace_interleaved",
                                "rope_inplace_f32table"])
def test_inplace_forms_on_arrays(fn):
    s, d = 12, 16
    q, k = _xs(1, s, 4, d), _xs(2, s, 2, d)
    cos_j, sin_j = ref.rope_init_linear(64, d, 10000.0, 2.0)
    cos, sin = port.rope_init_linear(64, d, 10000.0, 2.0, device=CPU)
    jq, jk = JArray(jnp.asarray(q)), JArray(jnp.asarray(k))
    tq, tk = TArray(torch.from_numpy(q.copy())), TArray(torch.from_numpy(k.copy()))
    extra = (5,) if fn == "rope_inplace_f32table" else ()
    getattr(ref, fn)(jq, jk, cos_j, sin_j, *extra)
    getattr(port, fn)(tq, tk, cos, sin, *extra)
    for g, w in ((tq, jq), (tk, jk)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# PoPE and ALiBi
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,base", SHAPES)
def test_pope_encoding_and_inplace(d, base):
    enc = port.pope_init_encoding(200, d, base, device=CPU)
    want = ref.pope_init_encoding(200, d, base)
    np.testing.assert_allclose(_np(enc), _np(want), rtol=1e-6, atol=ATOL)
    q, k = _xs(3, 10, 4, d), _xs(4, 10, 2, d)
    jq, jk = JArray(jnp.asarray(q)), JArray(jnp.asarray(k))
    tq, tk = TArray(torch.from_numpy(q.copy())), TArray(torch.from_numpy(k.copy()))
    ref.pope_inplace(jq, jk, want, start_pos=7)
    port.pope_inplace(tq, tk, TArray(torch.from_numpy(_np(want).copy())), start_pos=7)
    for g, w in ((tq, jq), (tk, jk)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("heads", [1, 8, 12, 32])
def test_alibi_slopes_bias_and_add(heads):
    slopes = port.alibi_init_slopes(heads, device=CPU)
    want = ref.alibi_init_slopes(heads)
    np.testing.assert_allclose(_np(slopes), _np(want), rtol=1e-6)
    s = 17
    for causal in (True, False):
        np.testing.assert_allclose(
            _np(port.alibi_compute_bias(s, heads, slopes, causal)),
            _np(ref.alibi_compute_bias(s, heads, want, causal)), rtol=1e-6)
    scores = np.random.default_rng(heads).standard_normal((heads, s, s)).astype(np.float32)
    js = JArray(jnp.asarray(scores))
    ts = TArray(torch.from_numpy(scores.copy()))
    assert ref.alibi_add_bias(js, want) is js
    assert port.alibi_add_bias(ts, slopes) is ts
    np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-6, atol=1e-6)
