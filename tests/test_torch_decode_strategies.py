"""The port's decode strategies (``pygpukit_tpu_torch.llm.decode``) against
the JAX package's own strategies on the same f32 weights: the cross-strategy
greedy token match (SURVEY §4) and each ``DecodeStats``.

Two models, the reference's tiny config (``tests/test_decode_strategies.py``,
seed 3, whose greedy stream repeats one token) and a four-layer untied one
(seed 3) whose speculative rounds accept 0 to 4 proposals, carry each of
the reference's ten cases: M1Graph with ``node_count > 0``, speculative
self and full acceptance, the worst-case guard, the separate draft, the
vocabulary mismatch, Jacobi, Batch with slot independence, the uncached
forward and the sliced draft's depth. ``decode_spec_chunk``'s tokens,
counts and final position equal the JAX function's at n_draft 1 and 3 and
gamma 2 and 4; ``slice_layers`` gives views.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygpukit_tpu.llm import decode as jax_decode
from pygpukit_tpu.llm.config import TransformerConfig as JaxConfig
from pygpukit_tpu.llm.model import CausalTransformerModel as JaxModel
from pygpukit_tpu.llm.model import init_params as jax_init_params
from pygpukit_tpu_torch.llm import (CausalTransformerModel, TransformerConfig,
                                    params_from_jax, slice_layers)
from pygpukit_tpu_torch.llm import decode as port_decode
from pygpukit_tpu_torch.llm import model as port_model
from pygpukit_tpu_torch.ops.embedding import kv_cache_zeros

torch.set_num_threads(2)

REF_CFG = dict(vocab_size=97, hidden_size=48, num_layers=3, num_heads=4, num_kv_heads=2,
               intermediate_size=96, head_dim_override=12, norm_type="rmsnorm",
               activation="silu", use_rope=True, max_position_embeddings=128,
               norm_eps=1e-6, tie_word_embeddings=True)
VARIED_CFG = dict(vocab_size=97, hidden_size=48, num_layers=4, num_heads=4,
                  num_kv_heads=2, intermediate_size=96, head_dim_override=12,
                  max_position_embeddings=128, tie_word_embeddings=False)
DRAFT_CFG = dict(vocab_size=97, hidden_size=32, num_layers=1, num_heads=2, num_kv_heads=1,
                 intermediate_size=64, head_dim_override=16, norm_type="rmsnorm",
                 activation="silu", use_rope=True, max_position_embeddings=128,
                 norm_eps=1e-6, tie_word_embeddings=True)
PROMPT = [5, 11, 42]
N_NEW = 10
MAX = 64


def _pair(kw: dict, seed: int):
    """(JAX model, port model) over the same f32 params."""
    jcfg = JaxConfig(**kw)
    jparams = jax_init_params(jcfg, seed=seed, dtype=jnp.float32)
    jm = JaxModel(jcfg, jparams, dtype=jnp.float32)
    tm = CausalTransformerModel(TransformerConfig(**kw),
                                params_from_jax(jax.tree.map(np.asarray, jparams)),
                                dtype=torch.float32)
    return jm, tm


@pytest.fixture(scope="module", params=["reference", "varied"])
def models(request):
    kw = REF_CFG if request.param == "reference" else VARIED_CFG
    return _pair(kw, 3)


@pytest.fixture(scope="module")
def reference_tokens(models):
    jm, tm = models
    jm.init_fixed_cache(MAX)
    ref = jax_decode.DecodeM1().bind(jm).generate(PROMPT, N_NEW)
    tm.init_fixed_cache(MAX)
    m1 = port_decode.DecodeM1().bind(tm)
    assert m1.generate(PROMPT, N_NEW) == ref
    return ref


def _run(models, make, *args, fresh: bool = True):
    """The same strategy on both models: (port tokens, port stats, JAX
    tokens, JAX stats)."""
    jm, tm = models
    out = []
    for m, lib in ((tm, port_decode), (jm, jax_decode)):
        if fresh:
            m.init_fixed_cache(MAX)
        strat = make(lib).bind(m)
        out += [strat.generate(*args), strat]
    return out


def _stats(strat) -> tuple:
    s = strat.stats
    return s.tokens_generated, s.steps, s.accepted, s.rejected


def test_registry_matches_the_reference():
    assert list(port_decode.STRATEGIES) == list(jax_decode.STRATEGIES)
    assert all(issubclass(c, port_decode.DecodeStrategy)
               for c in port_decode.STRATEGIES.values())


def test_m1_stats_match(models, reference_tokens):
    got, gs, ref, rs = _run(models, lambda lib: lib.DecodeM1(), PROMPT, N_NEW)
    assert got == ref == reference_tokens and _stats(gs) == _stats(rs)


def test_m1_graph_matches(models, reference_tokens):
    jm, tm = models
    outs = []
    for m, lib in ((tm, port_decode), (jm, jax_decode)):
        m.init_fixed_cache(MAX)
        strat = lib.DecodeM1Graph().bind(m)
        strat.init_graph(MAX)
        assert strat.node_count > 0
        outs += [strat.generate(PROMPT, N_NEW), strat]
    assert outs[0] == outs[2] == reference_tokens
    assert _stats(outs[1]) == _stats(outs[3])
    assert tm._ensure_decode_exe().stats.replays == N_NEW      # a step after each token


def test_speculative_matches(models, reference_tokens):
    got, gs, ref, rs = _run(
        models, lambda lib: lib.DecodeSpeculative(n_draft_layers=2, gamma=3), PROMPT, N_NEW)
    assert got == ref == reference_tokens
    assert _stats(gs) == _stats(rs) and gs.stats.tokens_generated >= N_NEW


def test_speculative_device_loop_full_acceptance(models, reference_tokens):
    """The draft is the whole target: every round accepts all gamma
    proposals and the bonus token."""
    _, tm = models
    got, gs, ref, rs = _run(
        models, lambda lib: lib.DecodeSpeculative(n_draft_layers=tm.config.num_layers,
                                                  gamma=3), PROMPT, N_NEW)
    assert got == ref == reference_tokens and _stats(gs) == _stats(rs)
    assert gs.stats.rejected == 0
    assert gs.stats.accepted >= gs.stats.steps - 1


def test_spec_chunk_worst_case_guard(models):
    _, tm = models
    tm.init_fixed_cache(MAX)
    tm.prefill(PROMPT)
    with pytest.raises(ValueError, match="worst case"):
        tm.decode_spec_chunk(1, n_rounds=64, gamma=3, n_draft=2)


def _draft_pair(kw: dict):
    return _pair(kw, 9)


def test_speculative_separate_draft_matches(models, reference_tokens):
    """A separate, differently shaped draft leaves the target's greedy
    stream unchanged: the verification is exact."""
    jd, td = _draft_pair(DRAFT_CFG)
    got, gs, ref, rs = _run(
        models, lambda lib: lib.DecodeSpeculative(
            gamma=3, draft_model=td if lib is port_decode else jd), PROMPT, N_NEW)
    assert got == ref == reference_tokens and _stats(gs) == _stats(rs)
    assert gs.stats.tokens_generated >= N_NEW


def test_speculative_draft_vocab_mismatch_rejected(models):
    _, tm = models
    _, td = _draft_pair(dict(DRAFT_CFG, vocab_size=50))
    with pytest.raises(ValueError, match="vocabulary"):
        port_decode.DecodeSpeculative(draft_model=td).bind(tm)


@pytest.mark.parametrize("window", [4, 6])
def test_jacobi_matches(models, reference_tokens, window):
    got, gs, ref, rs = _run(models, lambda lib: lib.DecodeJacobi(window=window),
                            PROMPT, N_NEW)
    assert got == ref == reference_tokens and _stats(gs) == _stats(rs)


def test_batch_matches_and_is_independent(models, reference_tokens):
    prompts = [PROMPT, [7, 3], PROMPT]
    got, gs, ref, rs = _run(models, lambda lib: lib.DecodeBatch(), prompts, N_NEW,
                            fresh=False)
    assert got == ref and _stats(gs) == _stats(rs)
    assert got[0] == got[2] == reference_tokens
    assert len(got[1]) == N_NEW
    assert tuple(gs.k_cache.shape) == (3, models[1].config.num_layers, 256,
                                       models[1].config.num_kv_heads
                                       * models[1].config.head_dim)


def test_uncached_forward_matches(models, reference_tokens):
    _, tm = models
    assert tm.generate(PROMPT, N_NEW, temperature=0.0, use_cache=False) == reference_tokens


def test_sliced_draft_runs_sliced_depth(models):
    """decode_step_fn bounds its layer loop by the cache's layer dim: a
    one-layer slice of a deeper model runs one layer, as the same stack
    under a one-layer config does."""
    _, tm = models
    cfg = tm.config
    draft = slice_layers(tm.params, 1)
    shape = (1, 16, cfg.num_kv_heads, cfg.head_dim)
    kc, vc = (kv_cache_zeros(shape, torch.float32, "cpu", merged=False) for _ in range(2))
    sliced = port_model.decode_step_fn(cfg, draft, kc, vc, 5, 0, allow_fused=False)
    kc.zero_(), vc.zero_()
    ref = port_model.decode_step_fn(dataclasses.replace(cfg, num_layers=1), draft, kc, vc,
                                    5, 0, allow_fused=False)
    np.testing.assert_allclose(sliced.numpy(), ref.numpy(), rtol=1e-6)


def test_slice_layers_gives_views(models):
    _, tm = models
    params = tm.params
    sliced = slice_layers(params, 2)
    for name, leaf in params["layers"].items():
        part = sliced["layers"][name]
        assert part.shape[0] == 2 and part.data_ptr() == leaf.data_ptr()
        assert part._base is not None or part.shape == leaf.shape
    assert sliced["embed"] is params["embed"]


@pytest.mark.parametrize("n_draft", [1, 3])
@pytest.mark.parametrize("gamma", [2, 4])
def test_spec_chunk_matches_the_jax_function(n_draft, gamma):
    """decode_spec_chunk's toks (-1 padded), counts and final position
    against the reference's on the varied model, three chunks in a row."""
    jm, tm = _pair(VARIED_CFG, 3)
    for m in (jm, tm):
        m.init_fixed_cache(MAX)
    cur_j = int(np.argmax(np.asarray(jm.prefill(PROMPT + [7]))))
    cur_t = int(torch.argmax(tm.prefill(PROMPT + [7])))
    assert cur_j == cur_t
    for _ in range(3):
        jt, jc = jm.decode_spec_chunk(cur_j, 3, gamma, n_draft)
        tt, tc = tm.decode_spec_chunk(cur_t, 3, gamma, n_draft)
        np.testing.assert_array_equal(tt, np.asarray(jt))
        np.testing.assert_array_equal(tc, np.asarray(jc))
        assert tt.dtype == np.int32 and tt.shape == (3, gamma + 1)
        assert tm.pos == jm.pos
        cur_j = cur_t = int(tt[-1, tc[-1] - 1])
