"""The families of ``tests/test_torch_families.py`` (OLMo-2, Cohere,
Granite, Nemotron, Apertus and Phi among them) through the cached steps
and both serving engines, against the JAX package on the CPU: the same
tiny ``transformers`` checkpoints loaded at f32 by both packages.

- Prefill, three decode steps and a three-token lookahead window: logits
  within rtol 1e-4, atol 1e-4 of the JAX package's; cached ``generate``
  tokens equal.
- The dense engine, the paged engine and the pipelined paged engine: greedy
  streams equal to the JAX package's dense engine; for Phi-3 also on a
  batch whose rows sit on both sides of LongRoPE's threshold (original_max
  32), each row switching on its own length. (The reference's paged
  step leaves GPT-2's learned positions out, so its paged engine is not
  the reference for GPT-2; its dense engine is for every family.)
"""

import numpy as np
import pytest
import torch

import pygpukit_tpu.llm as rl
from pygpukit_tpu.llm.serving import ContinuousBatchingEngine as JaxEngine
import pygpukit_tpu_torch.llm as pl
from test_torch_families import FAMILIES, save_family

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
#: the third prompt passes the 8-row windows of the sliding configs
PROMPTS = [[5, 11, 42], [7, 3], [9, 9, 1, 4, 60, 2, 8, 13, 17, 21, 30], [1, 2]]
N_NEW = [8, 8, 6, 9]


@pytest.fixture(scope="module", params=list(FAMILIES))
def pair(request, tmp_path_factory):
    fam = request.param
    d, _ = save_family(tmp_path_factory, fam, seed=list(FAMILIES).index(fam))
    return (fam, rl.load_model_from_safetensors(d, dtype="float32"),
            pl.load_model_from_safetensors(d, dtype="float32", device="cpu"), {})


def test_prefill_decode_and_window_match_jax(pair):
    fam, jm, tm, _ = pair
    prompt = list(FAMILIES[fam][3])
    jm.init_fixed_cache(64)
    tm.init_fixed_cache(64)
    want = np.asarray(jm.prefill(prompt))
    np.testing.assert_allclose(tm.prefill(prompt).numpy(), want, **TOL)
    for _ in range(3):
        tok = int(np.argmax(want))
        want = np.asarray(jm.decode_step(tok))
        np.testing.assert_allclose(tm.decode_step(tok).numpy(), want, **TOL)
    window = [int(np.argmax(want)), 5, 9]
    np.testing.assert_allclose(tm.decode_window(window).numpy(),
                               np.asarray(jm.decode_window(window)), **TOL)
    assert tm.pos == jm.pos
    jm.init_fixed_cache(64)
    tm.init_fixed_cache(64)
    assert tm.generate(prompt, max_new_tokens=8) == list(jm.generate(prompt,
                                                                     max_new_tokens=8))


def _serve(engine_cls, model, **kw):
    eng = engine_cls(model, **dict(dict(max_batch=3, max_seq_len=64, steps_per_dispatch=4),
                                   **kw))
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, N_NEW)]
    eng.run_until_complete()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs], eng


@pytest.mark.parametrize("kw", [dict(), dict(paged=True, block_size=8),
                                dict(paged=True, block_size=8, pipelined=True)],
                         ids=["dense", "paged", "paged_pipelined"])
def test_engines_match_the_jax_dense_engine(pair, kw):
    fam, jm, tm, seen = pair
    if "jax" not in seen:                    # the JAX engine's streams, once a family
        seen["jax"] = _serve(JaxEngine, jm)[0]
    want = seen["jax"]
    got, eng = _serve(pl.ContinuousBatchingEngine, tm, **kw)
    assert got == want
    assert eng.logits_finite()


#: prompts around Phi-3's original_max 32: one starts past it, two cross it
#: while they decode, one stays under it
STRADDLE = [list(range(1, 41)), list(range(3, 31)), [5, 11, 42], list(range(9, 38))]
STRADDLE_NEW = [6, 9, 8, 4]


@pytest.mark.parametrize("kw", [dict(), dict(paged=True, block_size=8),
                                dict(paged=True, block_size=8, pipelined=True)],
                         ids=["dense", "paged", "paged_pipelined"])
def test_longrope_rows_straddling_the_threshold(tmp_path_factory, kw):
    """One batch holds rows on both sides of Phi-3's threshold: the port's
    engines give the JAX dense engine's streams, and each stream is the
    single-stream generate of its prompt."""
    d, _ = save_family(tmp_path_factory, "phi3", seed=list(FAMILIES).index("phi3"))
    jm = rl.load_model_from_safetensors(d, dtype="float32")
    tm = pl.load_model_from_safetensors(d, dtype="float32", device="cpu")

    def serve(engine_cls, model, **extra):
        eng = engine_cls(model, max_batch=4, max_seq_len=64, steps_per_dispatch=4, **extra)
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(STRADDLE, STRADDLE_NEW)]
        eng.run_until_complete()
        assert all(r.done for r in reqs)
        return [list(r.generated) for r in reqs]
    want = serve(JaxEngine, jm)
    assert serve(pl.ContinuousBatchingEngine, tm, **kw) == want
    for p, n, stream in zip(STRADDLE, STRADDLE_NEW, want):
        tm.init_fixed_cache(64)
        assert tm.generate(p, max_new_tokens=n) == stream
