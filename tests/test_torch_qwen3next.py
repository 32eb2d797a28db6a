"""The port's Qwen3-Next (``pygpukit_tpu_torch/llm/models/qwen3next.py``)
against the JAX package on the CPU, on the tiny transformers models of
``tests/test_llm_families.py::TestQwen3Next`` (4 layers: DeltaNet,
attention, DeltaNet, attention; dense at seed 31, MoE at seed 32 with 4
experts top-2 and layer 0 dense), loaded by both packages in f32:

- logits within rtol/atol 1e-4 of the reference's and of transformers',
  greedy tokens equal to both;
- the chunked delta rule against the recurrent one within rtol 1e-4 /
  atol 1e-5 (the reference test's), padded identity rows included, and
  each against the reference's function;
- ``_gdn_project``'s packing, the gated norm, the router and the MoE
  block, the prefill's K/V rows, conv and recurrent states and two decode
  steps against the reference's functions;
- ``Qwen3NextConfig.from_hf`` with and without ``layer_types`` (without:
  transformers' derivation from ``full_attention_interval``, where the
  reference makes every layer full attention: ROADMAP C.10);
- ``params_from_jax`` of the reference's list tree, ``init_params``'s tree,
  the decode attention's route, captured buckets and chunks replayed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from pygpukit_tpu.llm.models import qwen3next as jq
from pygpukit_tpu_torch.llm import params_from_jax
from pygpukit_tpu_torch.llm.models import Qwen3NextConfig, Qwen3NextModel
from pygpukit_tpu_torch.llm.models import qwen3next as tq
from pygpukit_tpu_torch.ops import moe
from pygpukit_tpu_torch.ops.nn.attention import fixed_cache_route

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
DELTA_TOL = dict(rtol=1e-4, atol=1e-5)
TYPES = ["linear_attention", "full_attention", "linear_attention", "full_attention"]
PROMPTS = {"dense": [1, 7, 23, 5, 9, 2], "moe": [1, 7, 23, 5, 9]}
MOE = dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
           shared_expert_intermediate_size=32, decoder_sparse_step=1, norm_topk_prob=True,
           mlp_only_layers=[0])


def _hf_config(**kw):
    return transformers.Qwen3NextConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8, layer_types=TYPES,
        linear_num_value_heads=4, linear_num_key_heads=2, linear_key_head_dim=8,
        linear_value_head_dim=8, linear_conv_kernel_dim=4, partial_rotary_factor=0.25,
        max_position_embeddings=64, tie_word_embeddings=False, pad_token_id=0, **kw)


@pytest.fixture(scope="module", params=["dense", "moe"])
def trio(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("qwen3next_" + request.param)
    moe_kw = MOE if request.param == "moe" else dict(num_experts=0)
    torch.manual_seed(32 if request.param == "moe" else 31)
    hf = transformers.Qwen3NextForCausalLM(_hf_config(**moe_kw)).eval()
    hf.save_pretrained(path, safe_serialization=True)
    return (request.param, hf, jq.Qwen3NextModel.from_safetensors(path, dtype=jnp.float32),
            Qwen3NextModel.from_safetensors(path, dtype=torch.float32, device="cpu"))


def _np(x):
    return np.asarray(x, np.float32)


def test_config_and_rope_tables(trio):
    name, _, jm, tm = trio
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    assert tm.config.rope_dim == 2 and tm.config.conv_dim == 64
    assert tm.config.is_moe_layer(1) == (name == "moe") and not tm.config.is_moe_layer(0)
    for key in ("rope_cos", "rope_sin"):
        np.testing.assert_allclose(tm.params[key].numpy(), _np(jm.params[key]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hf", [
    dict(num_hidden_layers=4, layer_types=TYPES, num_experts=512, hidden_size=2048),
    dict(num_hidden_layers=2, layer_types=["full_attention", "linear_attention"],
         mlp_only_layers=[1], rms_norm_eps=1e-5, head_dim=128),
    dict(num_hidden_layers=2, layer_types=["linear_attention", "full_attention"],
         num_attention_heads=8, hidden_size=256, tie_word_embeddings=True)])
def test_from_hf_with_layer_types_is_the_references(hf):
    got = Qwen3NextConfig.from_hf(hf)
    assert dataclasses.asdict(got) == dataclasses.asdict(jq.Qwen3NextConfig.from_hf(hf))


@pytest.mark.parametrize("n_layers, every", [(48, None), (8, 4), (6, 3), (4, 1)])
def test_from_hf_without_layer_types_follows_transformers(n_layers, every):
    """A config.json with no ``layer_types`` (the key only
    ``save_pretrained`` writes): the port derives them from
    ``full_attention_interval`` (4 unless given) as transformers does; the
    reference makes every layer full attention (ROADMAP C.10). Every other
    field is the reference's."""
    hf = {"num_hidden_layers": n_layers}
    kw = {}
    if every is not None:
        hf["full_attention_interval"] = kw["full_attention_interval"] = every
    got = Qwen3NextConfig.from_hf(hf)
    want = transformers.Qwen3NextConfig(num_hidden_layers=n_layers, **kw).layer_types
    assert list(got.layer_types) == list(want)
    ref = jq.Qwen3NextConfig.from_hf(hf)
    assert ref.layer_types == ("full_attention",) * n_layers
    if every != 1:
        assert got.layer_types != ref.layer_types
    assert dataclasses.asdict(dataclasses.replace(got, layer_types=ref.layer_types)) == \
        dataclasses.asdict(ref)


@pytest.mark.parametrize("prompt", ["own", [4], list(range(3, 40))])
def test_logits_match_the_reference_and_transformers(trio, prompt):
    name, hf, jm, tm = trio
    prompt = PROMPTS[name] if prompt == "own" else prompt
    got = tm.get_logits(prompt)
    np.testing.assert_allclose(got, _np(jm.get_logits(prompt)), **TOL)
    with torch.no_grad():
        ref = hf(torch.tensor([prompt])).logits[0].numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_greedy_tokens_match_the_reference_and_transformers(trio):
    name, hf, jm, tm = trio
    prompt = PROMPTS[name]
    n = 8 if name == "dense" else 6
    out = tm.generate(prompt, max_new_tokens=n)
    assert out == [int(t) for t in jm.generate(prompt, max_new_tokens=n)]
    hf_out = hf.generate(torch.tensor([prompt]), max_new_tokens=n, do_sample=False,
                         pad_token_id=0)[0, len(prompt):].tolist()
    assert out == hf_out


def _delta_inputs(s: int, h: int, dk: int, dv: int, seed: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((s, h, dk), dtype=np.float32)
    k = rng.standard_normal((s, h, dk), dtype=np.float32)
    v = rng.standard_normal((s, h, dv), dtype=np.float32)
    g = -np.abs(rng.standard_normal((s, h), dtype=np.float32))
    beta = (1 / (1 + np.exp(-rng.standard_normal((s, h))))).astype(np.float32)
    return q, k, v, g, beta


@pytest.mark.parametrize("s, chunk", [(100, 16), (64, 64), (37, 16), (130, 64)])
def test_chunked_delta_rule_equals_the_recurrent_one(s, chunk):
    """``_delta_chunked`` against ``_delta_scan`` (outputs and final
    states), each against the reference's function on the same inputs
    (rtol 1e-4 / atol 1e-5, the reference test's)."""
    q, k, v, g, beta = _delta_inputs(s, 4, 8, 8, seed=s)
    t = [torch.from_numpy(a) for a in (q, k, v, g, beta)]
    s0 = np.zeros((4, 8, 8), np.float32)
    o1, s1 = tq._delta_scan(*t, torch.from_numpy(s0))
    o2, s2 = tq._delta_chunked(*t, torch.from_numpy(s0), chunk=chunk)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), **DELTA_TOL)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), **DELTA_TOL)
    j = [jnp.asarray(a) for a in (q, k, v, g, beta)]
    jo1, js1 = jq._delta_scan(*j, jnp.asarray(s0))
    jo2, js2 = jq._delta_chunked(*j, jnp.asarray(s0), chunk=chunk)
    for mine, ref in ((o1, jo1), (s1, js1), (o2, jo2), (s2, js2)):
        np.testing.assert_allclose(mine.numpy(), _np(ref), **DELTA_TOL)


def test_padded_rows_are_identity_steps():
    """Rows past TL 37 of 100 with beta 0 and g 0: the chunked rule's state
    is the recurrent rule's at TL, its first TL outputs the recurrent
    ones (the reference test's check), from a nonzero start state too."""
    q, k, v, g, beta = _delta_inputs(100, 4, 8, 8, seed=7)
    tl = 37
    mask = (np.arange(100) < tl)[:, None]
    gm, bm = np.where(mask, g, 0).astype(np.float32), np.where(mask, beta, 0).astype(np.float32)
    for s0 in (np.zeros((4, 8, 8), np.float32),
               np.random.default_rng(8).standard_normal((4, 8, 8), dtype=np.float32)):
        o3, s3 = tq._delta_scan(*(torch.from_numpy(a[:tl]) for a in (q, k, v, g, beta)),
                                torch.from_numpy(s0))
        o4, s4 = tq._delta_chunked(*(torch.from_numpy(a) for a in (q, k, v, gm, bm)),
                                   torch.from_numpy(s0), chunk=16)
        np.testing.assert_allclose(s3.numpy(), s4.numpy(), **DELTA_TOL)
        np.testing.assert_allclose(o3.numpy(), o4.numpy()[:tl], **DELTA_TOL)
        _, js4 = jq._delta_chunked(*(jnp.asarray(a) for a in (q, k, v, gm, bm)),
                                   jnp.asarray(s0), chunk=16)
        np.testing.assert_allclose(s4.numpy(), _np(js4), **DELTA_TOL)


def _layer(jm, tm, i: int):
    return jm.params["layers"][i], tm.params["layers"][i]


def _rows(seed: int, n: int, e: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, e), dtype=np.float32)


def test_gdn_projection_and_gates_match_the_reference(trio):
    _, _, jm, tm = trio
    jl, tl = _layer(jm, tm, 0)
    x = _rows(1, 5, jm.config.hidden_size)
    ref = jq._gdn_project(jm.config, jl, jnp.asarray(x))
    got = tq._gdn_project(tm.config, tl, torch.from_numpy(x))
    assert [tuple(a.shape) for a in got] == [tuple(b.shape) for b in ref]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-6)
    jb, jg = jq._gdn_gates(jl, ref[5], ref[4])
    tb, tg = tq._gdn_gates(tl, got[5], got[4])
    np.testing.assert_allclose(tb.numpy(), _np(jb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), _np(jg), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gated_rmsnorm_matches_the_reference(dtype):
    """The norm first, then times silu(z), in f32: f32 within 1e-6, bf16
    outputs within one bf16 ulp of the reference's."""
    rng = np.random.default_rng(3)
    x, z = (rng.standard_normal((6, 4, 8), dtype=np.float32) for _ in range(2))
    w = rng.standard_normal(8, dtype=np.float32)
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = jq._gated_rmsnorm(jnp.asarray(x).astype(jd), jnp.asarray(z).astype(jd),
                            jnp.asarray(w), 1e-6)
    got = tq._gated_rmsnorm(torch.from_numpy(x).to(td), torch.from_numpy(z).to(td),
                            torch.from_numpy(w), 1e-6)
    assert got.dtype == td
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "f32" else dict(rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(got.float().numpy(), _np(ref.astype(jnp.float32)), **tol)


def _moe_layer(jm, tm):
    return _layer(jm, tm, 1)


@pytest.mark.parametrize("trio", ["moe"], indirect=True)
def test_router_and_moe_block_match_the_reference(trio):
    """The softmax-all, top-k, renormalized router against lax.top_k's on
    the reference's probabilities, and the MoE block (one-hot experts and
    the gated shared expert) against the reference's ``_moe_mlp``."""
    _, _, jm, tm = trio
    jl, tl = _moe_layer(jm, tm)
    x = _rows(5, 9, jm.config.hidden_size)
    w, ids = tq._router(tm.config, tl, torch.from_numpy(x))
    probs = jax.nn.softmax(jnp.asarray(x) @ jl["w_router"], axis=-1)
    jv, ji = jax.lax.top_k(probs, jm.config.num_experts_per_tok)
    jv = jv / jnp.sum(jv, axis=-1, keepdims=True)
    assert ids.numpy().tolist() == np.asarray(ji).tolist()
    np.testing.assert_allclose(w.numpy(), _np(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w.sum(-1).numpy(), np.ones(9), rtol=1e-6)
    got = tq._moe_mlp(tm.config, tl, torch.from_numpy(x))
    ref = jq._moe_mlp(jm.config, jl, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL)


@pytest.mark.parametrize("trio", ["moe"], indirect=True)
@pytest.mark.parametrize("route", ["gmm", "gather"])
def test_expert_routes_match_the_one_hot_plain_version(trio, route):
    """``gmm_experts`` and ``gather_experts`` (gmm_plain and the slab gather
    on the CPU) with the family's router and SiLU product, against
    ``_experts_plain`` at f32 within 1e-5 of max |out|, at 80 rows (T * k
    160: the card's gmm rows)."""
    _, _, jm, tm = trio
    _, tl = _moe_layer(jm, tm)
    x = torch.from_numpy(_rows(6, 80, jm.config.hidden_size))
    w, ids = tq._router(tm.config, tl, x)
    plain = tq._experts_plain(tl, x, w, ids)
    fn = moe.gmm_experts if route == "gmm" else moe.gather_experts
    got = fn(x, (tl["w_experts_gate"], tl["w_experts_up"]), tl["w_experts_down"], w, ids,
             lambda outs, _: (torch.nn.functional.silu(outs[0]) * outs[1]).to(x.dtype))
    assert (got - plain).abs().max() <= 1e-5 * plain.abs().max()


def test_cache_shapes_and_dtypes(trio):
    _, _, jm, tm = trio
    caches = tq.init_caches(tm.config, 32, torch.bfloat16, "cpu")
    ref = jq.init_caches(jm.config, 32, jnp.float32)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in caches] == \
        [{k: tuple(v.shape) for k, v in c.items()} for c in ref]
    assert caches[0]["conv"].shape == (64, 4) and caches[0]["rec"].shape == (4, 8, 8)
    assert caches[1]["k"].shape == (32, 2, 8)
    assert caches[0]["rec"].dtype == torch.float32
    assert all(c[k].dtype == torch.bfloat16 for c in caches for k in c if k != "rec")


@pytest.mark.parametrize("n", [1, 3, 6, 37])
def test_prefill_caches_and_decode_steps_match_the_reference(trio, n):
    """A padded prefill of n tokens (bucket 16, or 64 at n 37: the padded
    rows identity steps), then two decode steps: K/V rows, conv and
    recurrent states and logits against the reference's functions."""
    _, _, jm, tm = trio
    cfg, jcfg = tm.config, jm.config
    tc = tq.init_caches(cfg, 64, torch.float32, "cpu")
    jc = jq.init_caches(jcfg, 64, jnp.float32)
    toks = np.zeros(16 if n < 16 else 64, np.int32)
    toks[:n] = np.random.default_rng(n).integers(1, 96, n)
    tc, tl = tq.prefill_fn(cfg, tm.params, tc, torch.from_numpy(toks), n)
    jc, jl = jq.prefill_fn(jcfg, jm.params, jc, jnp.asarray(toks), jnp.int32(n))
    for step, tok in enumerate((None, 11, 40)):
        if tok is not None:
            pos = n + step - 1
            tc, tl = tq.decode_step_fn(cfg, tm.params, tc, tok, pos)
            jc, jl = jq.decode_step_fn(jcfg, jm.params, jc, jnp.int32(tok), jnp.int32(pos))
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
        for a, b in zip(tc, jc):
            assert set(a) == set(b)
            for key in a:
                np.testing.assert_allclose(a[key].numpy(), _np(b[key]), rtol=1e-4, atol=1e-5)


def test_decode_step_with_a_device_position_is_the_int_path(trio):
    """``pos`` and ``true_len`` as one-element int32 tensors (what a
    captured program reads) give the int path's bits."""
    _, _, _, tm = trio
    cfg = tm.config
    out = []
    for n, pos in ((7, 7), (torch.tensor([7], dtype=torch.int32),
                            torch.tensor([7], dtype=torch.int32))):
        caches = tq.init_caches(cfg, 32, torch.float32, "cpu")
        toks = torch.tensor(list(range(1, 8)) + [0] * 9, dtype=torch.int32)
        _, first = tq.prefill_fn(cfg, tm.params, caches, toks, n)
        _, logits = tq.decode_step_fn(cfg, tm.params, caches, 12, pos)
        out.append((first, logits, caches))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    for a, b in zip(out[0][2], out[1][2]):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_generate_captures_each_bucket_and_chunk_once(trio):
    """The prefill's bucket and each chunk length are captured once, then
    replayed; a second generate gives the first's tokens."""
    name, _, _, tm = trio
    prompt = PROMPTS[name]
    tm.init_fixed_cache(64)
    first = tm.generate(prompt, max_new_tokens=7, chunk_size=3)
    assert tm.generate(prompt, max_new_tokens=7, chunk_size=3) == first
    exes = tm.graphs.executables()
    assert set(exes) == {("prefill", 16), ("generate", 3)}
    assert exes[("prefill", 16)].stats.captures == 1
    assert exes[("prefill", 16)].stats.replays == 2
    assert exes[("generate", 3)].stats.replays == 4
    tm.graphs.reset()
    tm.caches = None


def test_params_from_jax_converts_the_list_tree(trio):
    """The reference's tree (a list of per-layer dicts of different leaves,
    an untied head or None, the f32 rope tables) carried across byte for
    byte; a model on it computes the reference's logits; ``init_params``
    draws the same tree."""
    name, _, jm, tm = trio
    tree = jax.tree.map(np.asarray, dict(jm.params))
    tp = params_from_jax(tree)
    assert isinstance(tp["layers"], list) and tp["lm_head"] is not None
    assert tp["rope_cos"].dtype == torch.float32
    for key in ("embed", "lm_head", "rope_cos", "rope_sin", "final_norm_w"):
        assert tp[key].numpy().tobytes() == tree[key].tobytes()
    for lt, lj in zip(tp["layers"], tree["layers"]):
        assert set(lt) == set(lj)
        for k, v in lj.items():
            assert lt[k].numpy().tobytes() == v.tobytes() and tuple(lt[k].shape) == v.shape
    assert params_from_jax(dict(tree, lm_head=None))["lm_head"] is None
    mine = tq.init_params(tm.config, seed=0, dtype=torch.float32, device="cpu")
    assert [{k: tuple(v.shape) for k, v in lp.items()} for lp in mine["layers"]] == \
        [{k: tuple(v.shape) for k, v in lp.items()} for lp in tp["layers"]]
    assert mine["layers"][0]["A_log"].dtype == torch.float32
    model = Qwen3NextModel(tm.config, tp)
    prompt = PROMPTS[name]
    np.testing.assert_allclose(model.get_logits(prompt), _np(jm.get_logits(prompt)), **TOL)


def test_init_params_at_published_widths_has_the_checkpoint_shapes():
    """``init_params`` at Qwen3-Next-80B-A3B's widths (4 of 48 layers, 2 of
    512 experts, a 512-token vocabulary: the CPU's memory): the leaves a
    checkpoint gives, the packed projections' widths, 2048 x 512 experts."""
    cfg = Qwen3NextConfig.from_hf(dict(num_hidden_layers=4, num_experts=2, head_dim=256,
                                       vocab_size=512))
    p = tq.init_params(cfg, 0, torch.bfloat16, "cpu")
    lin, att = p["layers"][0], p["layers"][3]
    assert cfg.layer_types == ("linear_attention",) * 3 + ("full_attention",)
    assert tuple(lin["w_qkvz"].shape) == (2048, 16 * (2 * 128 + 2 * 2 * 128))
    assert tuple(lin["w_ba"].shape) == (2048, 64)
    assert tuple(lin["conv_w"].shape) == (8192, 4)
    assert tuple(lin["w_out"].shape) == (4096, 2048)
    assert tuple(att["w_q"].shape) == (2048, 16 * 2 * 256)
    assert tuple(att["w_o"].shape) == (4096, 2048)
    assert tuple(att["w_experts_gate"].shape) == (2, 2048, 512)
    assert tuple(att["w_experts_down"].shape) == (2, 512, 2048)
    assert tuple(att["shared_w_down"].shape) == (512, 2048)
    assert tuple(p["lm_head"].shape) == (2048, 512)
    assert cfg.rope_dim == 64 and cfg.conv_dim == 8192


def test_decode_attention_routes():
    """Qwen3-Next-80B-A3B's decode attention (one query row, 16/2 heads, D
    256, bf16 caches) is the flash_decode kernel on the card; every CPU
    tensor takes the plain route."""
    bf = torch.bfloat16
    assert fixed_cache_route("cuda", 1, 16, 2, 256, bf, bf, bf) == "kernel"
    assert fixed_cache_route("cuda", 1, 16, 2, 256, torch.float32, torch.float32,
                             torch.float32) == "kernel"
    assert fixed_cache_route("cpu", 1, 16, 2, 256, bf, bf, bf) == "plain"


@pytest.mark.parametrize("t, route", [(1, "gather"), (4, "gather"), (5, "dense"),
                                      (12, "dense"), (13, "gmm"), (2048, "gmm")])
def test_expert_route_rule_at_top_10(t, route):
    """At top-10 the card takes gmm from T 13 (T * k >= 128), the gather
    formula to T 4 and the one-hot formula between."""
    assert moe.moe_route(t, 10, "cuda") == route
