"""The port's single-stream fixed-cache decode against the JAX package on
tiny f32 models, the same numpy-seeded params in both:

- ``decode_step`` (``decode_step_fn`` over ``[L, MAX, Hk, D]`` caches):
  logits and the rows written at ``pos`` at rtol 1e-4, atol 1e-5, every
  other row untouched; with a sliding window, an attention softcap, an
  untied head, and int8 KV;
- ``decode_chunk`` / ``decode_chunk_device`` and cached greedy ``generate``
  token for token (chunked and not, with EOS); sampled generation replays
  under its seed;
- ``decode_window`` logits at rtol 1e-4, and a step after a partly
  accepted window;
- ``snapshot_kv_cache`` against the reference's snapshot at rtol 1e-4; a
  restore then continue gives the uninterrupted run's tokens; a structure
  mismatch raises TypeError; storage dtypes survive the host copy;
- the int4 repair: an int4 layer leaf at 9 <= rows < 256 against the
  reference's ``_mm`` on the CPU (its bf16 dequant dot, no activation
  quant) within one bf16 ulp plus 1e-4 of max |y|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygpukit_tpu.llm import CausalTransformerModel as JaxModel
from pygpukit_tpu.llm import TransformerConfig as JaxConfig
from pygpukit_tpu.llm import init_params as jax_init_params
from pygpukit_tpu.llm import model as jax_model
from pygpukit_tpu.llm.model import fuse_params as jax_fuse_params
from pygpukit_tpu.llm.quant import quantize_weight as jax_quantize_weight
from pygpukit_tpu_torch.kernels import LAUNCHES
from pygpukit_tpu_torch.llm import (CausalTransformerModel, KVSnapshot,
                                    TransformerConfig, params_from_jax)
from pygpukit_tpu_torch.llm import model as port_model

torch.set_num_threads(2)

F32_CFG = dict(vocab_size=97, hidden_size=48, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=96, head_dim_override=12,
               max_position_embeddings=256, tie_word_embeddings=True)
PROMPTS = [[5, 11, 42], [7, 3], [9, 9, 1, 4, 60, 2, 8], [1, 2]]
N_NEW = [8, 8, 6, 9]
TOL = dict(rtol=1e-4, atol=1e-5)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(cfg_kw, seed=5, dtype="f32", kv_dtype=None):
    """(JAX model, port model) over identical params."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = JaxConfig(**cfg_kw)
    jm = JaxModel(jcfg, jax_fuse_params(jax_init_params(jcfg, seed, jdt)), dtype=jdt,
                  kv_dtype=kv_dtype)
    tm = CausalTransformerModel(TransformerConfig(**cfg_kw), params_from_jax(_host(jm.params)),
                                dtype=tdt, kv_dtype=kv_dtype)
    return jm, tm


@pytest.fixture(scope="module")
def f32_pair():
    return _pair(F32_CFG)


@pytest.mark.parametrize("extra", [{}, dict(sliding_window=5), dict(attn_logit_softcap=2.0),
                                   dict(tie_word_embeddings=False)])
def test_decode_step_matches_jax(extra):
    jm, tm = _pair(dict(F32_CFG, **extra), seed=8)
    jm.init_fixed_cache(64)
    tm.init_fixed_cache(64)
    assert tuple(tm.k_cache.shape) == (2, 64, 2, 12) == tuple(jm.k_cache.shape)
    np.testing.assert_allclose(tm.prefill(PROMPTS[2]).numpy(),
                               np.asarray(jm.prefill(PROMPTS[2])), **TOL)
    for tok in (17, 40, 3, 96):
        pos = tm.pos
        before = (tm.k_cache.clone(), tm.v_cache.clone())
        got = tm.decode_step(tok)
        assert got.dtype == torch.float32 and got.shape == (97,)
        np.testing.assert_allclose(got.numpy(), np.asarray(jm.decode_step(tok)), **TOL)
        assert tm.pos == jm.pos == pos + 1
        for new, old, ref in ((tm.k_cache, before[0], jm.k_cache),
                              (tm.v_cache, before[1], jm.v_cache)):
            np.testing.assert_allclose(new[:, pos].numpy(), np.asarray(ref[:, pos]), **TOL)
            assert torch.equal(new[:, :pos], old[:, :pos])
            assert torch.equal(new[:, pos + 1:], old[:, pos + 1:])


def test_decode_step_int8_kv_matches_jax():
    """int8 {"q", "s"} caches with one scale per row over [Hk, D]: the
    written rows' codes and scales bitwise, the logits at rtol 1e-4."""
    jm, tm = _pair(F32_CFG, seed=8, kv_dtype="int8")
    jm.init_fixed_cache(64)
    tm.init_fixed_cache(64)
    assert tuple(tm.k_cache["s"].shape) == (2, 64) == tuple(jm.k_cache["s"].shape)
    tm.prefill(PROMPTS[0])
    jm.prefill(PROMPTS[0])
    for tok in (17, 40):
        pos = tm.pos
        np.testing.assert_allclose(tm.decode_step(tok).numpy(),
                                   np.asarray(jm.decode_step(tok)), **TOL)
        for name in ("q", "s"):
            got = tm.k_cache[name][:, pos]
            ref = np.asarray(jm.k_cache[name][:, pos])
            if name == "s":
                got = got.view(torch.int16).numpy()
                ref = ref.view(np.int16)
            else:
                got = got.numpy()
            np.testing.assert_array_equal(got, ref)


def test_decode_step_fn_bounds_layers_by_the_cache(f32_pair):
    """A one-layer slice of the caches runs one layer (the reference bounds
    its loop by the cache's layer dim)."""
    _, tm = f32_pair
    tm.init_fixed_cache(32)
    tm.prefill(PROMPTS[0])
    k1, v1 = tm.k_cache[:1].clone(), tm.v_cache[:1].clone()
    port_model.decode_step_fn(tm.config, tm.params, k1, v1, 5, tm.pos)
    assert not torch.equal(k1[0, tm.pos], tm.k_cache[0, tm.pos])
    assert torch.equal(k1[0, :tm.pos], tm.k_cache[0, :tm.pos])


@pytest.mark.parametrize("prompt,n", list(zip(PROMPTS, N_NEW)))
def test_greedy_generate_matches_jax(f32_pair, prompt, n):
    jm, tm = f32_pair
    jm.init_fixed_cache(128)
    tm.init_fixed_cache(128)
    got = tm.generate(prompt, max_new_tokens=n)
    assert got == jm.generate(prompt, max_new_tokens=n)
    tm.init_fixed_cache(128)
    assert tm.generate(prompt, max_new_tokens=n, chunk_size=3) == got


def test_decode_chunk_matches_jax(f32_pair):
    jm, tm = f32_pair
    jm.init_fixed_cache(64)
    tm.init_fixed_cache(64)
    tok = int(np.argmax(np.asarray(jm.prefill(PROMPTS[2]))))
    assert tok == int(tm.prefill(PROMPTS[2]).argmax())
    ref = np.asarray(jm.decode_chunk(tok, 6))
    got = tm.decode_chunk(tok, 6)
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    dev = tm.decode_chunk_device(torch.tensor(int(got[-1]), dtype=torch.int32), 4)
    assert dev.dtype == torch.int32 and dev.shape == (4,)
    np.testing.assert_array_equal(dev.numpy(), np.asarray(jm.decode_chunk(int(ref[-1]), 4)))
    assert tm.pos == jm.pos == len(PROMPTS[2]) + 10


def test_generate_stops_at_eos_and_a_full_cache(f32_pair):
    jm, tm = f32_pair
    tm.init_fixed_cache(128)
    stream = tm.generate(PROMPTS[0], max_new_tokens=8)
    eos = stream[3]
    tm.init_fixed_cache(128)
    got = tm.generate(PROMPTS[0], max_new_tokens=8, eos_token_id=eos)
    assert got == stream[:stream.index(eos) + 1]
    jm.init_fixed_cache(128)
    assert got == jm.generate(PROMPTS[0], max_new_tokens=8, eos_token_id=eos)
    tm.init_fixed_cache(8)
    jm.init_fixed_cache(8)
    assert tm.generate(PROMPTS[0], max_new_tokens=20) == \
        jm.generate(PROMPTS[0], max_new_tokens=20)


@pytest.mark.parametrize("top_k", [0, 5])
def test_sampled_generate_replays_under_its_seed(f32_pair, top_k):
    _, tm = f32_pair
    runs = []
    for seed in (3, 3, 4):
        tm.init_fixed_cache(128)
        runs.append(tm.generate(PROMPTS[0], max_new_tokens=12, temperature=0.9,
                                top_k=top_k, seed=seed, chunk_size=4))
    assert runs[0] == runs[1] and len(runs[0]) == 12
    assert runs[0] != runs[2]


def test_scan_top1_draw_is_greedy(f32_pair):
    """A tempered top-1 draw in the scan keeps only the largest logit, so
    it gives the greedy tokens."""
    _, tm = f32_pair
    tm.init_fixed_cache(64)
    tok = int(tm.prefill(PROMPTS[2]).argmax())
    greedy = tm.decode_chunk(tok, 6)
    tm.init_fixed_cache(64)
    tm.prefill(PROMPTS[2])
    np.testing.assert_array_equal(tm.decode_chunk(tok, 6, temperature=2.0, top_k=1, seed=9),
                                  greedy)


def test_decode_window_matches_jax(f32_pair):
    jm, tm = f32_pair
    jm.init_fixed_cache(64)
    tm.init_fixed_cache(64)
    jm.prefill(PROMPTS[2])
    tm.prefill(PROMPTS[2])
    window = [5, 6, 7]
    ref = np.asarray(jm.decode_window(window, advance=2))
    got = tm.decode_window(window, advance=2)
    assert got.shape == (3, 97)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert tm.pos == jm.pos == len(PROMPTS[2]) + 2
    # the rejected third row is overwritten by the next step
    np.testing.assert_allclose(tm.decode_step(40).numpy(), np.asarray(jm.decode_step(40)),
                               **TOL)
    np.testing.assert_allclose(tm.decode_window([8]).numpy(),
                               np.asarray(jm.decode_window([8])), **TOL)


def test_snapshot_matches_jax_and_restore_continues(f32_pair):
    jm, tm = f32_pair
    jm.init_fixed_cache(64)
    tm.init_fixed_cache(64)
    jm.prefill(PROMPTS[0])
    tm.prefill(PROMPTS[0])
    for tok in (17, 40, 3):
        jm.decode_step(tok)
        tm.decode_step(tok)
    js, ts = jm.snapshot_kv_cache(), tm.snapshot_kv_cache()
    assert isinstance(ts, KVSnapshot) and ts.pos == js.pos == len(PROMPTS[0]) + 3
    for got, ref in ((ts.k, js.k), (ts.v, js.v)):
        assert isinstance(got, np.ndarray) and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, **TOL)
    straight = tm.decode_chunk(5, 6).tolist()
    assert not np.array_equal(tm.k_cache.numpy(), ts.k)      # a copy, not a view
    tm.restore_kv_cache(ts)
    assert tm.pos == ts.pos
    assert tm.decode_chunk(5, 6).tolist() == straight
    tm.restore_kv_cache(ts)            # the snapshot was not written through
    assert tm.decode_chunk(5, 6).tolist() == straight
    np.testing.assert_array_equal(np.asarray(jm.decode_chunk(5, 6)), straight)


def test_restore_structure_mismatch_raises(f32_pair):
    _, tm = f32_pair
    _, t8 = _pair(F32_CFG, kv_dtype="int8")
    t8.init_fixed_cache(32)
    t8.prefill(PROMPTS[0])
    snap8 = t8.snapshot_kv_cache()
    assert set(snap8.k) == {"q", "s"} and snap8.k["q"].dtype == np.int8
    assert snap8.k["s"].dtype.name == "bfloat16"
    tm.init_fixed_cache(32)
    with pytest.raises(TypeError, match="does not match model kv_dtype"):
        tm.restore_kv_cache(snap8)
    tm.prefill(PROMPTS[0])
    with pytest.raises(TypeError, match="does not match model kv_dtype"):
        t8.restore_kv_cache(tm.snapshot_kv_cache())
    t8.restore_kv_cache(snap8)
    assert torch.equal(t8.k_cache["q"], torch.from_numpy(snap8.k["q"]))


def test_bf16_snapshot_keeps_its_bits():
    _, tm = _pair(F32_CFG, dtype="bf16")
    tm.init_fixed_cache(32)
    tm.prefill(PROMPTS[2])
    snap = tm.snapshot_kv_cache()
    assert snap.k.dtype.name == "bfloat16"
    before = tm.k_cache.clone()
    tm.decode_step(4)
    tm.restore_kv_cache(snap)
    assert tm.k_cache.dtype == torch.bfloat16 and torch.equal(tm.k_cache, before)


@pytest.mark.parametrize("rows", [9, 32, 200])
def test_int4_layer_rows_9_to_255_match_the_reference_dequant_dot(rows):
    """The reference takes a layer-sliced int4 operand at these rows to its
    bf16 dequant dot (its CPU route at every row count); the port's route
    is that function, not the w4a8 GEMM."""
    rng = np.random.default_rng(rows)
    w = rng.standard_normal((256, 160)).astype(np.float32) * 0.02
    jq = jax_quantize_weight(jnp.asarray(w), "int4")
    xj = jnp.asarray(rng.standard_normal((rows, 256)).astype(np.float32), jnp.bfloat16)
    ref = np.asarray(jax_model._mm(xj, jq), np.float32)
    before = dict(LAUNCHES)
    got = port_model._mm(params_from_jax(np.asarray(xj)), params_from_jax(_host(jq)))
    assert got.dtype == torch.bfloat16 and LAUNCHES == before
    diff = np.abs(got.float().numpy() - ref)
    tol = np.abs(ref) * 2.0 ** -7 + 1e-4 * np.abs(ref).max()
    assert (diff <= tol).all(), diff.max()
