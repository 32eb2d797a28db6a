"""The port's DeepSeek family (``pygpukit_tpu_torch/llm/models/deepseek.py``)
against the JAX package's (``pygpukit_tpu/llm/models/deepseek.py``) on the
CPU, on the tiny transformers models of ``tests/test_llm_families.py``
(DeepSeek-V3 with the ``noaux_tc`` router, V2-Lite's ``greedy`` router
without a q-lora, V2's ``group_limited_greedy``), each loaded by both
packages' ``from_safetensors`` in f32:

- ``_mla_qkv``, the naive attention and the absorbed attention (the
  absorbed form also against the naive one at each position), the router
  in its three modes (ids equal, weights within rtol 1e-5; a tie case),
  ``_moe_mlp``: within rtol/atol 1e-5;
- logits within rtol/atol 1e-4 of the reference's and of transformers',
  the compressed caches after a prefill within rtol 1e-5, greedy
  ``generate`` token-equal with chunks that split the run;
- the routed experts' gmm and gather formulations (``ops.moe``, through
  ``gmm_plain`` on the CPU) against the one-hot plain version, f32 and
  bf16; the config and ``params_from_jax`` on the reference's tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from pygpukit_tpu.llm.models import deepseek as jds
from pygpukit_tpu_torch.llm import params_from_jax
from pygpukit_tpu_torch.llm.models import DeepseekV3Model
from pygpukit_tpu_torch.llm.models import deepseek as tds
from pygpukit_tpu_torch.ops import moe

torch.set_num_threads(2)

PROMPT = [1, 7, 23, 40, 4]
TOL = dict(rtol=1e-5, atol=1e-5)
# (transformers config class, seed, config keys): the reference's own tests
CASES = {
    "v3": (transformers.DeepseekV3Config, 9, dict(
        num_hidden_layers=3, q_lora_rank=24, n_routed_experts=8, n_group=4, topk_group=2,
        norm_topk_prob=True, routed_scaling_factor=2.5, first_k_dense_replace=1)),
    "v2_greedy": (transformers.DeepseekV2Config, 11, dict(
        num_hidden_layers=2, q_lora_rank=None, n_routed_experts=8, topk_method="greedy",
        norm_topk_prob=False, routed_scaling_factor=1.0, first_k_dense_replace=0)),
    "v2_group": (transformers.DeepseekV2Config, 12, dict(
        num_hidden_layers=2, q_lora_rank=24, n_routed_experts=8,
        topk_method="group_limited_greedy", n_group=4, topk_group=2, norm_topk_prob=True,
        routed_scaling_factor=1.0, first_k_dense_replace=0)),
}
MODES = {"v3": "noaux_tc", "v2_greedy": "greedy", "v2_group": "group_limited_greedy"}


def _save(path, name):
    cls, seed, kw = CASES[name]
    cfg = cls(vocab_size=96, hidden_size=48, num_attention_heads=2, num_key_value_heads=2,
              kv_lora_rank=16, qk_rope_head_dim=4, qk_nope_head_dim=8, v_head_dim=8,
              intermediate_size=64, moe_intermediate_size=32, n_shared_experts=1,
              num_experts_per_tok=2, max_position_embeddings=64, tie_word_embeddings=False,
              pad_token_id=0, **kw)
    torch.manual_seed(seed)
    hf = cls.__name__.replace("Config", "ForCausalLM")
    m = getattr(transformers, hf)(cfg).eval()
    m.save_pretrained(path, safe_serialization=True)
    return m


@pytest.fixture(scope="module", params=list(CASES))
def pair(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(request.param)
    hf = _save(path, request.param)
    jm = jds.DeepseekV3Model.from_safetensors(path, dtype=jnp.float32)
    tm = DeepseekV3Model.from_safetensors(path, dtype=torch.float32, device="cpu")
    return request.param, hf, jm, tm


def _jlayer(group, i):
    return jax.tree.map(lambda a: a[i], group)


def _tlayer(group, i):
    return {k: v[i] for k, v in group.items()}


def _moe_layer(jm, tm):
    return _jlayer(jm.params["moe_layers"], 0), _tlayer(tm.params["moe_layers"], 0)


def _rows(seed, t, e):
    return np.random.default_rng(seed).standard_normal((t, e)).astype(np.float32)


def test_config_matches_the_reference(pair):
    name, _, jm, tm = pair
    for f in ("hidden_size", "num_layers", "q_lora_rank", "kv_lora_rank", "n_group",
              "topk_group", "norm_topk_prob", "routed_scaling_factor", "first_k_dense",
              "router_mode", "rope_interleave", "qk_head_dim"):
        assert getattr(tm.config, f) == getattr(jm.config, f), f
    assert tm.config.router_mode == MODES[name]
    assert np.float32(tm.config.attn_scale) == np.float32(jm.config.attn_scale)


def test_logits_match_the_reference_and_transformers(pair):
    _, hf, jm, tm = pair
    got = tm.get_logits(PROMPT)
    np.testing.assert_allclose(got, np.asarray(jm.get_logits(PROMPT)), rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        ref = hf(torch.tensor([PROMPT])).logits[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [3, 4])
def test_greedy_generate_matches_the_reference(pair, chunk):
    _, _, jm, tm = pair
    jm.ckv_cache = None
    tm.max_seq_len = None
    assert tm.generate(PROMPT, 8, chunk_size=chunk) == jm.generate(PROMPT, 8, chunk_size=chunk)


def test_compressed_caches_after_prefill(pair):
    _, _, jm, tm = pair
    jm.init_fixed_cache(64)
    tm.init_fixed_cache(64)
    tokens = np.zeros(16, np.int32)
    tokens[:len(PROMPT)] = PROMPT
    jc, jk, jl = jds.prefill_fn(jm.config, jm.params, jm.ckv_cache, jm.kpe_cache,
                                jnp.asarray(tokens), jnp.int32(len(PROMPT)))
    tl = tds.prefill_fn(tm.config, tm.params, tm.ckv_cache, tm.kpe_cache,
                        torch.from_numpy(tokens), len(PROMPT))
    np.testing.assert_allclose(tm.ckv_cache.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.kpe_cache.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


def _qkv_both(jm, tm, t=6, seed=1):
    jlp, tlp = _jlayer(jm.params["moe_layers"], 0), _tlayer(tm.params["moe_layers"], 0)
    x = _rows(seed, t, jm.config.hidden_size)
    j = jds._mla_qkv(jm.config, jlp, jnp.asarray(x), jm.params["rope_cos"][:t],
                     jm.params["rope_sin"][:t])
    p = tds._mla_qkv(tm.config, tlp, torch.from_numpy(x), tm.params["rope_cos"][:t],
                     tm.params["rope_sin"][:t])
    return jlp, tlp, j, p


def test_mla_qkv_matches_the_reference(pair):
    _, _, jm, tm = pair
    _, _, j, p = _qkv_both(jm, tm)
    for a, b in zip(j, p):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_naive_attention_matches_the_reference(pair):
    _, _, jm, tm = pair
    jlp, tlp, j, p = _qkv_both(jm, tm)
    for true_len in (6, 4):
        a = jds._mla_attn_naive(jm.config, jlp, *j, jnp.int32(true_len))
        b = tds._mla_attn_naive(tm.config, tlp, *p, true_len)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_absorbed_attention_matches_the_reference_and_the_naive_form(pair):
    """The absorbed decode off a [MAX, c] + [MAX, dr] cache holding the
    six rows, for the query of each position: equal to the reference's,
    and to the naive attention's row at that position."""
    _, _, jm, tm = pair
    jlp, tlp, j, p = _qkv_both(jm, tm)
    qn, qp, ckv, kpe = p
    naive = tds._mla_attn_naive(tm.config, tlp, *p, 6)
    ckc = torch.zeros((16, ckv.shape[1]))
    kpc = torch.zeros((16, kpe.shape[1]))
    ckc[:6], kpc[:6] = ckv, kpe
    for t in range(6):
        got = tds._mla_attn_absorbed(tm.config, tlp, qn[t:t + 1], qp[t:t + 1], ckc, kpc,
                                     t + 1)
        ref = jds._mla_attn_absorbed(jm.config, jlp, j[0][t:t + 1], j[1][t:t + 1],
                                     jnp.asarray(ckc.numpy()), jnp.asarray(kpc.numpy()),
                                     jnp.int32(t + 1))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        np.testing.assert_allclose(got[0].numpy(), naive[t].numpy(), **TOL)


def _routers(jm, tm, x, jlp=None, tlp=None):
    jl, tl = _moe_layer(jm, tm)
    jlp, tlp = jlp or jl, tlp or tl
    ref = np.asarray(jds._router(jm.config, jlp, jnp.asarray(x)))
    w, ids = tds._router(tm.config, tlp, torch.from_numpy(x))
    return ref, w.numpy(), ids.numpy()


def _check_route(ref, w, ids):
    k = ids.shape[1]
    for row in range(ref.shape[0]):
        want = np.sort(np.nonzero(ref[row])[0])
        assert len(want) == k and np.array_equal(np.sort(ids[row]), want), (row, ids[row], want)
        np.testing.assert_allclose(w[row], ref[row][ids[row]], rtol=1e-5)


def test_router_matches_the_reference(pair):
    _, _, jm, tm = pair
    _check_route(*_routers(jm, tm, _rows(3, 24, jm.config.hidden_size)))


def test_router_ties_take_the_lower_index(pair):
    """A zero router (every logit equal, every group tied): the ids are the
    reference's, which ``lax.top_k`` breaks by the lower index."""
    _, _, jm, tm = pair
    jl, tl = _moe_layer(jm, tm)
    jl = dict(jl, w_router=jnp.zeros_like(jl["w_router"]))
    tl = dict(tl, w_router=torch.zeros_like(tl["w_router"]))
    ref, w, ids = _routers(jm, tm, _rows(4, 3, jm.config.hidden_size), jl, tl)
    _check_route(ref, w, ids)
    want = {"noaux_tc": [0, 1], "greedy": [0, 1], "group_limited_greedy": [0, 1]}
    assert all(list(r) == want[tm.config.router_mode] for r in ids)


def test_moe_mlp_matches_the_reference(pair):
    _, _, jm, tm = pair
    jlp, tlp = _moe_layer(jm, tm)
    x = _rows(5, 7, jm.config.hidden_size)
    ref = jds._moe_mlp(jm.config, jlp, jnp.asarray(x))
    got = tds._moe_mlp(tm.config, tlp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("route", ["gmm", "gather"])
def test_expert_routes_match_the_one_hot_plain_version(pair, dtype, route):
    """``gmm_experts`` and ``gather_experts`` (gmm_plain and the slab
    gather on the CPU) with the family's router and SiLU product, against
    ``_experts_plain``: f32 within 1e-5, bf16 within 2e-2 of max |out|
    (the gmm and gather routes round the SiLU product to bf16 before the
    down product; the plain version keeps f32)."""
    _, _, jm, tm = pair
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    lp = {k: (v.to(dt) if k.startswith("w_experts") else v)
          for k, v in _tlayer(tm.params["moe_layers"], 0).items()}
    x = torch.from_numpy(_rows(6, 80, jm.config.hidden_size)).to(dt)
    w, ids = tds._router(tm.config, lp, x)
    plain = tds._experts_plain(lp, x, w, ids)
    fn = moe.gmm_experts if route == "gmm" else moe.gather_experts
    got = fn(x, (lp["w_experts_gate"], lp["w_experts_up"]), lp["w_experts_down"], w, ids,
             lambda outs, _: tds._silu(outs[0]).mul_(outs[1]).to(x.dtype))
    tol = 1e-5 if dtype == "f32" else 2e-2
    assert (got - plain).abs().max() <= tol * plain.abs().max()


def test_params_from_jax_is_byte_exact(pair):
    """The reference's tree (``dense_layers``/``moe_layers``, a None or
    array head, the rope tables) carried across bit for bit, and a model
    built on it computes the reference's logits (its own rope tables
    differ from the port's in the last bits)."""
    _, _, jm, tm = pair
    host = jax.tree.map(np.asarray, jm.params)
    got = params_from_jax(host)
    flat = jax.tree_util.tree_flatten_with_path(host)[0]
    assert flat
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.numpy().tobytes() == np.ascontiguousarray(leaf).tobytes()
    assert set(got) == set(host)
    model = DeepseekV3Model(tm.config, got, dtype=torch.float32)
    np.testing.assert_allclose(model.get_logits(PROMPT), np.asarray(jm.get_logits(PROMPT)),
                               **TOL)


def test_init_params_serves_a_random_model():
    cfg = tds.DeepseekV3Config(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                               q_lora_rank=16, kv_lora_rank=8, qk_nope_head_dim=8,
                               qk_rope_head_dim=4, v_head_dim=8, intermediate_size=48,
                               moe_intermediate_size=16, n_routed_experts=4, n_group=2,
                               topk_group=1, num_experts_per_tok=2, first_k_dense=1,
                               max_position_embeddings=64)
    model = DeepseekV3Model(cfg, tds.init_params(cfg, 0, torch.float32, "cpu"))
    logits = model.get_logits([3, 1, 4, 1, 5])
    assert logits.shape == (5, 64) and np.isfinite(logits).all()
    out = model.generate([3, 1, 4], 6, chunk_size=4)
    model.init_fixed_cache(64)
    assert model.generate([3, 1, 4], 6, chunk_size=2) == out
