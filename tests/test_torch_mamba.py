"""The port's Mamba and FalconMamba (``pygpukit_tpu_torch/llm/models/
mamba.py``) and the single-tree base (``llm/models/_base.py``) against the
JAX package on the CPU, on the tiny transformers models of
``tests/test_llm_families.py::TestMamba`` (2 layers, state 8, conv 4;
seeds 36, 37 and 38), loaded by both packages in f32:

- logits within rtol/atol 1e-4 of the reference's and of transformers',
  greedy tokens equal to both, the O(1) cache shapes exact;
- the blocked prefill: ``generate(prefill_block=4)`` gives the one-shot
  tokens, and two stateful prefills give the forward's last row within
  1e-5;
- the parallel scan against a sequential f32 recurrence, the depthwise
  conv and its decode state at true lengths below and above K, the mixer
  continuing from a carried state, against the reference's;
- ``params_from_jax`` of the reference's list tree (byte-exact), the
  configs, the captured prefill buckets and chunks, and each ``generate``
  starting from zero state (the reference's continues the last run's:
  ROADMAP C.9).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from pygpukit_tpu.llm.models import _base as jbase
from pygpukit_tpu.llm.models import mamba as jmb
from pygpukit_tpu_torch.llm import params_from_jax
from pygpukit_tpu_torch.llm.models import MambaConfig, MambaModel
from pygpukit_tpu_torch.llm.models import _base as tbase
from pygpukit_tpu_torch.llm.models import mamba as tmb

torch.set_num_threads(2)

PROMPT = [1, 7, 23, 5, 9, 2]
LONG = [1, 7, 23, 5, 9, 2, 40, 11, 3, 8, 30]
TOL = dict(rtol=1e-5, atol=1e-5)
HF = dict(vocab_size=96, hidden_size=32, state_size=8, num_hidden_layers=2, conv_kernel=4,
          intermediate_size=64, time_step_rank=4, use_conv_bias=True, use_bias=False,
          pad_token_id=0)


def _build(path, falcon: bool, seed: int):
    torch.manual_seed(seed)
    if falcon:
        hf = transformers.FalconMambaForCausalLM(
            transformers.FalconMambaConfig(mixer_rms_eps=1e-6, **HF)).eval()
    else:
        hf = transformers.MambaForCausalLM(transformers.MambaConfig(**HF)).eval()
    hf.save_pretrained(path, safe_serialization=True)
    return (hf, jmb.MambaModel.from_safetensors(path, dtype=jnp.float32),
            MambaModel.from_safetensors(path, dtype=torch.float32, device="cpu"))


@pytest.fixture(scope="module", params=["mamba", "falcon_mamba"])
def trio(request, tmp_path_factory):
    falcon = request.param == "falcon_mamba"
    return _build(tmp_path_factory.mktemp(request.param), falcon, 37 if falcon else 36)


@pytest.fixture(scope="module")
def blocked(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("blocked"), False, 38)


def _rows(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_config_matches_the_reference(trio):
    _, jm, tm = trio
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    assert (tm.config.mixer_rms_eps is not None) == (type(trio[0]).__name__.startswith("Falcon"))


@pytest.mark.parametrize("hf", [{"hidden_size": 100, "time_step_rank": "auto"},
                                {"model_type": "falcon_mamba", "hidden_size": 64},
                                {"model_type": "falcon_mamba", "mixer_rms_eps": 1e-5},
                                {"use_bias": True, "tie_word_embeddings": False}])
def test_from_hf(hf):
    assert dataclasses.asdict(MambaConfig.from_hf(hf)) == dataclasses.asdict(
        jmb.MambaConfig.from_hf(hf))


def test_logits_match_the_reference_and_transformers(trio):
    hf, jm, tm = trio
    got = tm.get_logits(PROMPT)
    np.testing.assert_allclose(got, np.asarray(jm.get_logits(PROMPT)), rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        ref = hf(torch.tensor([PROMPT])).logits[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_greedy_tokens_and_cache_shapes(trio):
    hf, jm, tm = trio
    out = tm.generate(PROMPT, max_new_tokens=8)
    jm.caches = None
    assert out == [int(t) for t in jm.generate(PROMPT, max_new_tokens=8)]
    hf_out = hf.generate(torch.tensor([PROMPT]), max_new_tokens=8, do_sample=False,
                         pad_token_id=0)[0, 6:].tolist()
    assert out == hf_out
    assert [tuple(c["ssm"].shape) for c in tm.caches] == [(64, 8)] * 2
    assert [tuple(c["conv"].shape) for c in tm.caches] == [(64, 4)] * 2
    assert tm.caches[0]["ssm"].dtype == torch.float32


def test_prefill_caches_and_decode_step_match_the_reference(trio):
    """One prefill of a padded bucket, then one decode step: the conv and
    SSM states and the logits against the reference's functions."""
    _, jm, tm = trio
    cfg, jcfg = tm.config, jm.config
    tc = tmb.init_caches(cfg, 16, torch.float32, "cpu")
    jc = jmb.init_caches(jcfg, 16, jnp.float32)
    toks = np.zeros(16, np.int32)
    toks[:6] = PROMPT
    tc, tl = tmb.prefill_fn(cfg, tm.params, tc, torch.from_numpy(toks), 6)
    jc, jl = jmb.prefill_fn(jcfg, jm.params, jc, jnp.asarray(toks), jnp.int32(6))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for a, b in zip(tc, jc):
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), rtol=1e-4, atol=1e-5)
    tc, tl = tmb.decode_step_fn(cfg, tm.params, tc, 11, 6)
    jc, jl = jmb.decode_step_fn(jcfg, jm.params, jc, jnp.int32(11), jnp.int32(6))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for a, b in zip(tc, jc):
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), rtol=1e-4, atol=1e-5)


def test_blocked_prefill_matches(blocked):
    """Blocks of 4 (full blocks and a 3-token remainder, a block shorter
    than the conv's history) give the one-shot tokens; two stateful
    prefills give the forward's last row within 1e-5."""
    _, jm, tm = blocked
    ref = tm.generate(LONG, max_new_tokens=6)
    tm.caches = None
    assert tm.generate(LONG, max_new_tokens=6, prefill_block=4) == ref
    jm.caches = None
    assert [int(t) for t in jm.generate(LONG, max_new_tokens=6)] == ref
    cfg = tm.config
    caches = tmb.init_caches(cfg, 16, torch.float32, "cpu")
    toks = torch.tensor(LONG, dtype=torch.int32)
    caches, _ = tmb.prefill_fn(cfg, tm.params, caches, toks[:6], 6)
    caches, logits = tmb.prefill_fn(cfg, tm.params, caches,
                                    torch.nn.functional.pad(toks[6:], (0, 1)), 5)
    full = tmb.forward_fn(cfg, tm.params, toks)
    np.testing.assert_allclose(logits.numpy(), full[-1].numpy(), **TOL)


def test_generate_captures_each_bucket_and_chunk_once(blocked):
    """The prefill's buckets (blocks of 4 and the remainder: bucket 16)
    and each chunk length are captured once and then replayed."""
    _, _, tm = blocked
    tm.init_fixed_cache(64)
    first = tm.generate(LONG, max_new_tokens=7, chunk_size=3, prefill_block=4)
    assert tm.generate(LONG, max_new_tokens=7, chunk_size=3, prefill_block=4) == first
    exes = tm.graphs.executables()
    assert set(exes) == {("prefill", 16), ("generate", 3)}
    assert exes[("prefill", 16)].stats.captures == 1
    assert exes[("prefill", 16)].stats.replays == 6
    assert exes[("generate", 3)].stats.replays == 4


def test_generate_starts_from_zero_state(blocked):
    """A generate after another on the same caches prefills from zeros:
    its caches are a fresh model's. The reference's prefill continues the
    last run's state (ROADMAP C.9): the port's prefill replayed on the
    state a run left gives the reference's logits there, not the fresh
    ones."""
    _, jm, tm = blocked
    other = [4, 11, 9, 30]
    tm.init_fixed_cache(64)
    tm.generate(other, max_new_tokens=8)
    tm.generate(PROMPT, max_new_tokens=4)
    caches = [{k: v.clone() for k, v in c.items()} for c in tm.caches]
    tm.init_fixed_cache(64)
    fresh = tm._replay_prefill(np.asarray(PROMPT)).clone()
    tm.init_fixed_cache(64)
    tm.generate(PROMPT, max_new_tokens=4)
    for a, b in zip(caches, tm.caches):
        assert all(torch.equal(a[k], b[k]) for k in a)
    tm.init_fixed_cache(64)
    tm.generate(other, max_new_tokens=8)
    after = tm._replay_prefill(np.asarray(PROMPT)).clone()     # continues the state
    assert not torch.allclose(after, fresh, rtol=1e-3, atol=1e-3)
    jm.caches = None
    jm.generate(other, max_new_tokens=8)
    jl = np.asarray(jm._replay_prefill(np.asarray(PROMPT, np.int32)))
    np.testing.assert_allclose(jl, after.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s", [1, 2, 5, 16, 33])
def test_linear_scan_matches_the_sequential_recurrence(s):
    """h_t = a_t h_{t-1} + b_t over [S, 6, 3] f32 and the cumulative
    coefficient, against the step-by-step recurrence and the reference's
    ``lax.associative_scan``."""
    a = np.exp(-np.abs(_rows(s, s, 6, 3)))
    b = _rows(s + 1, s, 6, 3)
    acc, h = tmb.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    want_h, want_a = np.zeros_like(b), np.zeros_like(a)
    hh, aa = np.zeros(b.shape[1:], np.float32), np.ones(a.shape[1:], np.float32)
    for t in range(s):
        hh, aa = a[t] * hh + b[t], a[t] * aa
        want_h[t], want_a[t] = hh, aa
    np.testing.assert_allclose(h.numpy(), want_h, **TOL)
    np.testing.assert_allclose(acc.numpy(), want_a, **TOL)

    def combine(e1, e2):
        return e2[0] * e1[0], e2[0] * e1[1] + e2[1]
    ja, jh = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ja), **TOL)


@pytest.mark.parametrize("true_len", [1, 2, 3, 4, 7, 10])
@pytest.mark.parametrize("k", [3, 4])
def test_causal_depthwise_conv_and_state_tail(true_len, k):
    x, w, bias = _rows(1, 10, 6), _rows(2, 6, k), _rows(3, 6)
    for b in (None, bias):
        got = tbase.causal_depthwise_conv(torch.from_numpy(x), torch.from_numpy(w),
                                          None if b is None else torch.from_numpy(b))
        want = jbase.causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w),
                                           None if b is None else jnp.asarray(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for tl in (true_len, torch.tensor([true_len], dtype=torch.int32)):
        tail = tbase.conv_state_tail(torch.from_numpy(x), tl, k, torch.float32)
        want = jbase.conv_state_tail(jnp.asarray(x), jnp.int32(true_len), k, jnp.float32)
        np.testing.assert_array_equal(tail.numpy(), np.asarray(want))
    assert tail.shape == (6, k)


@pytest.mark.parametrize("true_len", [3, 8])
def test_mixer_continues_from_a_carried_state(trio, true_len):
    """``_mixer_full`` from nonzero conv and SSM states over a padded
    block: the output and both new states against the reference's."""
    _, jm, tm = trio
    cfg, jcfg = tm.config, jm.config
    x, conv, ssm = _rows(11, 8, 32), _rows(12, 64, 4), _rows(13, 64, 8)
    got = tmb._mixer_full(cfg, tm.params["layers"][1], torch.from_numpy(x), true_len,
                          torch.from_numpy(conv), torch.from_numpy(ssm))
    want = jmb._mixer_full(jcfg, jm.params["layers"][1], jnp.asarray(x), jnp.int32(true_len),
                           jnp.asarray(conv), jnp.asarray(ssm))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_params_from_jax_converts_the_list_tree(trio):
    """The reference's params (a list of per-layer dicts, a None head)
    convert byte-exactly, and a port model on them gives the reference's
    logits; ``init_params`` builds the same tree."""
    _, jm, tm = trio
    tree = jax.tree.map(np.asarray, jm.params)
    tp = params_from_jax(tree)
    assert isinstance(tp["layers"], list) and tp["lm_head"] is None
    for lt, lj in zip(tp["layers"], tree["layers"]):
        assert set(lt) == set(lj)
        for k, v in lj.items():
            assert lt[k].numpy().tobytes() == v.tobytes() and tuple(lt[k].shape) == v.shape
    model = MambaModel(tm.config, tp)
    np.testing.assert_allclose(model.get_logits(PROMPT), np.asarray(jm.get_logits(PROMPT)),
                               rtol=1e-4, atol=1e-4)
    mine = tmb.init_params(tm.config, seed=0, dtype=torch.float32, device="cpu")
    assert [{k: tuple(v.shape) for k, v in lp.items()} for lp in mine["layers"]] == \
        [{k: tuple(v.shape) for k, v in lp.items()} for lp in tp["layers"]]
    assert mine["lm_head"] is None and mine["embed"].shape == tp["embed"].shape
