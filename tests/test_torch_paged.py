"""The port's paged and pipelined serving against the JAX package on the CPU:
the same numpy-seeded inputs and params go through both.

- BlockAllocator ids and ``_paged_write_rows`` pools: bitwise.
- Paged attention (plain version) against the reference's ``_paged_attn_one``,
  its Pallas kernel in interpret mode and ``ops.paged``: rtol 1e-4 at f32.
- Paged prefill and decode-step logits: rtol 1e-4 at f32; the K and V
  pools they fill: rtol 1e-4 beside 1e-4 of each layer's max |value|.
- Greedy engine streams: identical to the JAX engine for paged
  non-pipelined serving and dense pipelined serving. The reference's own
  paged+pipelined engine jitters on tiny random CPU models
  (docs/performance.md), so the port's paged+pipelined streams are held
  against the port's non-pipelined paged engine and the JAX paged engine.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygpukit_tpu.kernels.paged_attention import paged_attention_pools_t
from pygpukit_tpu.llm import CausalTransformerModel as JaxModel
from pygpukit_tpu.llm import TransformerConfig as JaxConfig
from pygpukit_tpu.llm import init_params as jax_init_params
from pygpukit_tpu.llm import serving_paged as jsp
from pygpukit_tpu.llm.model import fuse_params as jax_fuse_params
from pygpukit_tpu.llm.serving import ContinuousBatchingEngine as JaxEngine
from pygpukit_tpu.ops import paged as jpaged
from pygpukit_tpu_torch.kernels import paged_attention, paged_attention_plain
from pygpukit_tpu_torch.llm import (BlockAllocator, CausalTransformerModel,
                                    ContinuousBatchingEngine, TransformerConfig,
                                    params_from_jax)
from pygpukit_tpu_torch.llm import serving_paged as tsp
from pygpukit_tpu_torch.ops import paged as tpaged

torch.set_num_threads(2)

CFG = dict(vocab_size=97, hidden_size=48, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_size=96, head_dim_override=12,
           max_position_embeddings=256, tie_word_embeddings=False)
PROMPTS = [[5, 11, 42], [7, 3], [9, 9, 1, 4, 60, 2, 8], [1, 2], [13, 1, 6]]
N_NEW = [8, 8, 6, 9, 5]


def _pair(cfg_kw=CFG, seed=5, kv_dtype=None):
    """(JAX model, port model) over identical f32 params. The random weights
    are scaled up tenfold: at the init's std 0.02 the tiny model mostly
    repeats the last token, and greedy streams would show little."""
    jcfg = JaxConfig(**cfg_kw)
    params = jax.tree.map(lambda a: a * 10.0 if a.ndim >= 2 else a,
                          jax_init_params(jcfg, seed, jnp.float32))
    jm = JaxModel(jcfg, jax_fuse_params(params), dtype=jnp.float32,
                  kv_dtype=kv_dtype)
    tm = CausalTransformerModel(TransformerConfig(**cfg_kw),
                                params_from_jax(jax.tree.map(np.asarray, jm.params)),
                                dtype=torch.float32, kv_dtype=kv_dtype)
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _t(a):
    return params_from_jax(np.asarray(a))


def _serve(engine_cls, model, prompts=PROMPTS, n_new=N_NEW, **kw):
    kw = dict(dict(max_batch=3, max_seq_len=64, steps_per_dispatch=4), **kw)
    eng = engine_cls(model, **kw)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, n_new)]
    eng.run_until_complete()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs], eng


# ----------------------------------------------------------------- allocator --

@pytest.mark.parametrize("ops", [
    [("a", 1, 20), ("a", 2, 5), ("f", 1), ("a", 3, 33), ("a", 2, 17)],
    [("a", 1, 64), ("a", 2, 8), ("f", 2), ("f", 1), ("a", 3, 1), ("a", 4, 40)],
])
def test_block_allocator_ids_match_reference(ops):
    ja, ta = jsp.BlockAllocator(12, 8), BlockAllocator(12, 8)
    for op in ops:
        if op[0] == "a":
            assert ta.alloc_for(op[1], op[2]) == ja.alloc_for(op[1], op[2])
        else:
            ja.free(op[1])
            ta.free(op[1])
        assert ta.allocated == ja.allocated and ta._free == ja._free
        assert ta.stats() == ja.stats()
    with pytest.raises(MemoryError):
        ta.alloc_for(99, 8 * 12)


# ---------------------------------------------------------------- row writes --

L, NB, HK, BS, D = 2, 6, 2, 4, 8


def _bits(t):
    if isinstance(t, dict):
        return [_bits(t["q"]), _bits(t["s"])]
    return t.contiguous().view(torch.uint8).numpy() if t.element_size() == 1 \
        else t.contiguous().view(torch.int16 if t.element_size() == 2
                                 else torch.int32).numpy()


def _jbits(a):
    if isinstance(a, dict):
        return [_jbits(a["q"]), _jbits(a["s"])]
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


@pytest.mark.parametrize("kind", ["f32", "bf16", "fp8", "int8"])
def test_paged_write_rows_bitwise(kind):
    rng = np.random.default_rng(1)
    n = 7
    rows = (rng.standard_normal((n, HK, D)) * 3).astype(np.float32)
    blocks = np.array([3, 1, 5, 3, 0, 0, 0], np.int32)
    offs = np.array([0, 2, 3, 1, 0, 0, 0], np.int32)
    valid = np.array([1, 1, 1, 1, 0, 0, 0], bool)
    shape = (L, NB, HK, BS, D)
    if kind == "int8":
        jpool = {"q": jnp.zeros(shape, jnp.int8),
                 "s": jnp.zeros((L, NB, BS), jnp.bfloat16)}
        tpool = {"q": torch.zeros(shape, dtype=torch.int8),
                 "s": torch.zeros((L, NB, BS), dtype=torch.bfloat16)}
    else:
        jdt, tdt = {"f32": (jnp.float32, torch.float32),
                    "bf16": (jnp.bfloat16, torch.bfloat16),
                    "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}[kind]
        jpool, tpool = jnp.zeros(shape, jdt), torch.zeros(shape, dtype=tdt)
    rdt = jnp.float32 if kind == "f32" else jnp.bfloat16
    jrows = jnp.asarray(rows, rdt)
    for layer in (1, 0):
        jpool = jsp._paged_write_rows(jpool, jrows, layer, jnp.asarray(blocks),
                                      jnp.asarray(offs), jnp.asarray(valid))
        tsp._paged_write_rows(tpool, _t(jrows), layer, torch.from_numpy(blocks),
                              torch.from_numpy(offs), torch.from_numpy(valid))
    ref, got = _jbits(jpool), _bits(tpool)
    if kind != "int8":
        ref, got = [ref], [got]
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)


def test_paged_write_rows_puts_rows_first():
    """pool[layer, blocks, :, offs, :] with the two index tensors split by a
    slice indexes as [N, Hk, D] (N first, as numpy and JAX do), so row n
    lands at (blocks[n], :, offs[n], :)."""
    pool = torch.zeros((L, NB, HK, BS, D))
    blocks, offs = torch.tensor([4, 2, 5]), torch.tensor([1, 3, 0])
    assert pool[1, blocks, :, offs, :].shape == (3, HK, D)
    rows = torch.arange(3 * HK * D, dtype=torch.float32).reshape(3, HK, D)
    tsp._paged_write_rows(pool, rows, 1, blocks, offs)
    for n in range(3):
        assert torch.equal(pool[1, blocks[n], :, offs[n], :], rows[n])
    assert pool[0].abs().sum() == 0 and pool.abs().sum() == rows.abs().sum()


# ---------------------------------------------------------------- attention --

def _attn_inputs(rng, hq=4, hk=2, d=16, nb=9, bs=4, mb=4, int8=False):
    """Four slots over shuffled blocks: contexts 1, 13 and 20 (past the
    table's mb * bs rows: all of them live) and a dead slot on the trash
    table."""
    b = 4
    kp = rng.standard_normal((nb, hk, bs, d)).astype(np.float32)
    vp = rng.standard_normal((nb, hk, bs, d)).astype(np.float32)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, nb))[:mb] for _ in range(b)])
    tables[-1] = 0                                       # a dead slot: trash
    lens = np.array([1, 13, 20, 5], np.int32)
    if int8:
        from pygpukit_tpu.ops.embedding import kv_quant_rows
        out = []
        for p in (kp, vp):
            qq, ss = kv_quant_rows(jnp.asarray(p.transpose(0, 2, 1, 3)), 2)
            out.append({"q": jnp.asarray(np.asarray(qq).transpose(0, 2, 1, 3)),
                        "s": ss})
        kp, vp = out
    return q, kp, vp, tables.astype(np.int32), lens


def _jax_paged_attn(q, kp, vp, tables, lens, scale, softcap=None, window=None):
    jk = jax.tree.map(jnp.asarray, kp)
    jv = jax.tree.map(jnp.asarray, vp)
    return np.stack([np.asarray(jsp._paged_attn_one(
        jnp.asarray(q[b]), jk, jv, jnp.asarray(tables[b]), jnp.int32(lens[b]),
        scale, softcap, None if window is None else jnp.int32(window)))
        for b in range(q.shape[0])])


@pytest.mark.parametrize("case", ["plain", "softcap", "window", "both", "mha",
                                  "int8"])
def test_paged_attention_plain_matches_reference(case):
    rng = np.random.default_rng(11)
    softcap = 5.0 if case in ("softcap", "both") else None
    window = 6 if case in ("window", "both") else None
    kw = dict(hq=4, hk=4) if case == "mha" else {}
    q, kp, vp, tables, lens = _attn_inputs(rng, int8=case == "int8", **kw)
    ref = _jax_paged_attn(q, kp, vp, tables, lens, 0.3, softcap, window)
    tk, tv = params_from_jax(jax.tree.map(np.asarray, kp)), \
        params_from_jax(jax.tree.map(np.asarray, vp))
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(lens))
    got = paged_attention_plain(*args, 0.3, softcap, window)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-6)
    # the wrapper runs the plain version on CPU tensors
    assert torch.equal(paged_attention(*args, scale=0.3, softcap=softcap,
                                       window=window), got)


def test_paged_attention_matches_pallas_interpret():
    """The reference kernel (scalar-prefetch Pallas, interpret mode) per slot
    against the port's batched plain version; the kernel's scale is
    1/sqrt(D)."""
    rng = np.random.default_rng(12)
    q, kp, vp, tables, lens = _attn_inputs(rng, d=128, bs=8, mb=3)
    ref = np.stack([np.asarray(paged_attention_pools_t(
        jnp.asarray(q[b]), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables[b]), int(lens[b]))) for b in range(len(lens))])
    got = paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                          torch.from_numpy(vp), torch.from_numpy(tables),
                          torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-6)


def test_ops_paged_attention_matches_reference():
    """ops.paged: the gather formulation, the dispatch and the batch form
    against the reference's, pools [NB, BS, Hk, D]."""
    # the dispatch's CUDA branch calls the kernel wrapper, not its module
    # (an import cycle once bound the module under the same name)
    assert tpaged.paged_attention is paged_attention
    rng = np.random.default_rng(13)
    q, kp, vp, tables, lens = _attn_inputs(rng)
    kp, vp = kp.transpose(0, 2, 1, 3).copy(), vp.transpose(0, 2, 1, 3).copy()
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp), torch.from_numpy(vp)
    ref_b = np.asarray(jpaged.paged_attention_batch_fn(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(lens)))
    got_b = tpaged.paged_attention_batch_fn(torch.from_numpy(q), tk, tv,
                                            torch.from_numpy(tables),
                                            torch.from_numpy(lens))
    np.testing.assert_allclose(got_b.numpy(), ref_b, rtol=1e-4, atol=1e-6)
    for b in range(len(lens)):
        ref = np.asarray(jpaged.paged_attention_fn(
            jnp.asarray(q[b]), jk, jv, jnp.asarray(tables[b]), jnp.int32(lens[b])))
        for fn in (tpaged.paged_attention_fn, tpaged.paged_attention_dispatch):
            got = fn(torch.from_numpy(q[b]), tk, tv, torch.from_numpy(tables[b]),
                     int(lens[b]))
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-6)
        # the kernel wrapper on the transposed pools, scale 1/sqrt(D)
        got = paged_attention(torch.from_numpy(q[b:b + 1]), tk.transpose(1, 2),
                              tv.transpose(1, 2), torch.from_numpy(tables[b:b + 1]),
                              torch.from_numpy(lens[b:b + 1]))
        np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-4, atol=1e-6)


def test_reshape_and_cache_bitwise():
    rng = np.random.default_rng(14)
    kn = rng.standard_normal((5, HK, D)).astype(np.float32)
    vn = rng.standard_normal((5, HK, D)).astype(np.float32)
    slots = np.array([0, 9, 10, 23, 4], np.int32)
    jk, jv = jpaged.reshape_and_cache_fn(
        jnp.zeros((NB, BS, HK, D), jnp.bfloat16), jnp.zeros((NB, BS, HK, D), jnp.bfloat16),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(slots))
    tk, tv = torch.zeros((NB, BS, HK, D), dtype=torch.bfloat16), \
        torch.zeros((NB, BS, HK, D), dtype=torch.bfloat16)
    tpaged.reshape_and_cache_fn(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                                slots)
    np.testing.assert_array_equal(_bits(tk), _jbits(jk))
    np.testing.assert_array_equal(_bits(tv), _jbits(jv))


def test_paged_kv_cache_matches_reference():
    """PagedKVCache: appends across block boundaries, attention, the block
    ids it hands out, exhaustion and reuse after free."""
    rng = np.random.default_rng(15)
    kw = dict(num_blocks=6, block_size=4, num_kv_heads=2, head_dim=8, num_layers=2)
    jc = jpaged.PagedKVCache(dtype=jnp.float32, **kw)
    tc = tpaged.PagedKVCache(dtype=torch.float32, device="cpu", **kw)
    for c in (jc, tc):
        c.allocate(7)
        c.allocate(3)
    for seq, t in ((7, 3), (3, 5), (7, 6)):
        for layer in range(2):
            k = rng.standard_normal((t, 2, 8)).astype(np.float32)
            v = rng.standard_normal((t, 2, 8)).astype(np.float32)
            jc.append(seq, layer, jnp.asarray(k), jnp.asarray(v))
            tc.append(seq, layer, torch.from_numpy(k), torch.from_numpy(v))
    assert tc._tables == jc._tables and tc.stats() == jc.stats()
    np.testing.assert_array_equal(tc.block_table(7, 5), jc.block_table(7, 5))
    q = rng.standard_normal((4, 8)).astype(np.float32)
    for seq in (7, 3):
        for layer in range(2):
            np.testing.assert_allclose(
                tc.attention(seq, layer, torch.from_numpy(q)).numpy(),
                np.asarray(jc.attention(seq, layer, jnp.asarray(q))),
                rtol=1e-4, atol=1e-6)
    with pytest.raises(MemoryError):
        tc.append(3, 0, torch.zeros((9, 2, 8)), torch.zeros((9, 2, 8)))
    with pytest.raises(MemoryError):
        jc.append(3, 0, jnp.zeros((9, 2, 8)), jnp.zeros((9, 2, 8)))
    tc.free(7)
    jc.free(7)
    assert tc._free == jc._free


# ------------------------------------------------------ prefill and decode --

@pytest.mark.parametrize("extra", [{}, dict(sliding_window=5,
                                            attn_logit_softcap=3.0)])
def test_paged_prefill_and_decode_logits_match_reference(extra):
    jm, tm = _pair(dict(CFG, **extra), seed=8)
    cfg = jm.config
    shape = (cfg.num_layers, 12, cfg.num_kv_heads, 8, cfg.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    tables = np.array([[5, 2, 9, 0], [7, 1, 0, 0], [0, 0, 0, 0]], np.int32)
    prompts = [[4, 8, 15, 16, 23, 42, 1, 2, 3, 5, 7], [9, 9, 1]]
    for b, prompt in enumerate(prompts):
        padded = np.zeros(32, np.int32)
        padded[:len(prompt)] = prompt
        jk, jv, jl = jsp.paged_prefill_fn(cfg, jm.params, jk, jv,
                                          jnp.asarray(tables[b]),
                                          jnp.asarray(padded), len(prompt))
        tl = tsp.paged_prefill_fn(tm.config, tm.params, tk, tv,
                                  torch.from_numpy(tables[b]),
                                  torch.from_numpy(padded).long(), len(prompt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
    toks = np.array([17, 40, 3], np.int32)
    poss = np.array([11, 3, 20], np.int32)
    for _ in range(3):
        jk, jv, jl = jsp.paged_decode_step_fn(cfg, jm.params, jk, jv,
                                              jnp.asarray(tables), jnp.asarray(toks),
                                              jnp.asarray(poss))
        tl = tsp.paged_decode_step_fn(tm.config, tm.params, tk, tv,
                                      torch.from_numpy(tables),
                                      torch.from_numpy(toks).long(),
                                      torch.from_numpy(poss))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
        toks = np.asarray(jl).argmax(-1).astype(np.int32)
        poss = poss + 1
    # every block a live table holds agrees; block 0 is the trash. Each
    # layer of a pool is held to rtol 1e-4 beside 1e-4 of its max |value|
    # (the f32 norm of the port's kernel checks): both packages compute each
    # step by the same formula, and layer 1's rows are a second pass of the
    # tenfold weights over sums that cancel, where the two CPU BLAS
    # libraries' orders of summation (and XLA's fused multiply-adds and its
    # own tanh and exp) leave each package about 1.4e-4 from a float64
    # evaluation of the same layer, on values up to 40
    for got, ref in ((tk, jk), (tv, jv)):
        for layer in range(cfg.num_layers):
            want = np.asarray(ref)[layer, 1:]
            np.testing.assert_allclose(got[layer, 1:].numpy(), want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())


def _f64_prefill_kv(tm, tokens, true_len):
    """Float64 K (roped) and V rows [L, true_len, Hk, D] of a prefill of the
    port model's params: every step of the layer in numpy float64, the
    reference's formulas (rmsnorm, split-half rope, causal softmax with
    the window and the softcap, swiglu)."""
    from pygpukit_tpu_torch.llm.model import _layer_window
    cfg, p = tm.config, tm.params
    f = lambda t: t.detach().to(torch.float64).numpy()
    lay = {k: f(v) for k, v in p["layers"].items()}
    hq, hk, d, s = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, len(tokens)
    cos, sin = f(p["rope_cos"])[:s, None, :d // 2], f(p["rope_sin"])[:s, None, :d // 2]

    def rms(x, w):
        return x / np.sqrt(np.mean(x * x, -1, keepdims=True) + cfg.norm_eps) * w

    def rope(x):
        x0, x1 = x[..., :d // 2], x[..., d // 2:]
        return np.concatenate([x0 * cos - x1 * sin, x1 * cos + x0 * sin], -1)

    h = f(p["embed"])[np.asarray(tokens)]
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    ks, vs = [], []
    for layer in range(cfg.num_layers):
        qkv = rms(h, lay["attn_norm_w"][layer]) @ lay["w_qkv"][layer]
        q = rope(qkv[:, :hq * d].reshape(s, hq, d))
        k = rope(qkv[:, hq * d:(hq + hk) * d].reshape(s, hk, d))
        v = qkv[:, (hq + hk) * d:].reshape(s, hk, d)
        ks.append(k[:true_len])
        vs.append(v[:true_len])
        kk, vv = np.repeat(k, hq // hk, 1), np.repeat(v, hq // hk, 1)
        sc = np.einsum("qhd,khd->hqk", q, kk) * cfg.attn_scale
        if cfg.attn_logit_softcap is not None:
            sc = cfg.attn_logit_softcap * np.tanh(sc / cfg.attn_logit_softcap)
        mask = (j > i) | (j >= true_len)
        win = _layer_window(cfg, layer)
        if win is not None:
            mask = mask | (j <= i - win)
        sc = np.where(mask, -1e30, sc)
        pr = np.exp(sc - sc.max(-1, keepdims=True))
        pr /= pr.sum(-1, keepdims=True)
        h = h + np.einsum("hqk,khd->qhd", pr, vv).reshape(s, hq * d) @ lay["w_o"][layer]
        gu = rms(h, lay["mlp_norm_w"][layer]) @ lay["w_gate_up"][layer]
        g, u = np.split(gu, 2, -1)
        h = h + (g / (1 + np.exp(-g)) * u) @ lay["w_down"][layer]
    return np.stack(ks), np.stack(vs)


def paged_prefill_f64_distances(extra, seed=8):
    """Max |pool - float64| of layer 1's K and V rows after one prefill
    (the test below's first prompt), for the JAX package and the port:
    {(package, "k" or "v"): (distance, float64 max |value|)}."""
    jm, tm = _pair(dict(CFG, **extra), seed=seed)
    cfg = jm.config
    shape = (cfg.num_layers, 12, cfg.num_kv_heads, 8, cfg.head_dim)
    table = np.array([5, 2, 9, 0], np.int32)
    prompt = [4, 8, 15, 16, 23, 42, 1, 2, 3, 5, 7]
    padded = np.zeros(32, np.int32)
    padded[:len(prompt)] = prompt
    jk, jv, _ = jsp.paged_prefill_fn(cfg, jm.params, jnp.zeros(shape, jnp.float32),
                                     jnp.zeros(shape, jnp.float32), jnp.asarray(table),
                                     jnp.asarray(padded), len(prompt))
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    tsp.paged_prefill_fn(tm.config, tm.params, tk, tv, torch.from_numpy(table),
                         torch.from_numpy(padded).long(), len(prompt))
    rk, rv = _f64_prefill_kv(tm, prompt, len(prompt))
    n = np.arange(len(prompt))
    blocks, offs = table[n // 8], n % 8

    def rows(pool):                                  # layer 1's rows [true_len, Hk, D]
        return np.asarray(pool, np.float64)[1, blocks, :, offs, :]

    out = {}
    for name, pools in (("jax", (jk, jv)), ("port", (tk.numpy(), tv.numpy()))):
        for kv, pool, ref in (("k", pools[0], rk[1]), ("v", pools[1], rv[1])):
            out[(name, kv)] = (float(np.abs(rows(pool) - ref).max()), float(np.abs(ref).max()))
    return out


@pytest.mark.parametrize("extra", [{}, dict(sliding_window=5, attn_logit_softcap=3.0),
                                   dict(attn_logit_softcap=3.0)])
def test_paged_prefill_pools_as_close_to_float64_as_the_reference(extra):
    """The repair of the pool comparison above rests on this: layer 1's K
    and V after a prefill stand from a float64 evaluation of the same layer
    no further for the port than for the JAX package (within 2x), and both
    within 1e-5 of the largest |value|: what separates the two packages is
    the order of sums and XLA's own roundings, not a formula."""
    d = paged_prefill_f64_distances(extra)
    for kv in ("k", "v"):
        (jdist, top), (pdist, _) = d[("jax", kv)], d[("port", kv)]
        assert jdist <= 1e-5 * top and pdist <= 1e-5 * top, (kv, d)
        assert pdist <= 2 * jdist + 1e-6 * top, (kv, d)


# -------------------------------------------------------------- the engine --

def _serve_staggered(engine_cls, model, **kw):
    """Submit the next request only once the queue is empty, so no admission
    pass sees two newcomers (the reference's gate is only sound then)."""
    eng = engine_cls(model, max_batch=3, max_seq_len=64, **kw)
    todo, reqs = list(zip(PROMPTS, N_NEW)), []
    while todo or eng.has_work:
        if todo and not eng._queue:
            p, n = todo.pop(0)
            reqs.append(eng.submit(p, max_new_tokens=n))
        eng.step()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs], eng


@pytest.mark.parametrize("steps,num_blocks", [(1, 5), (4, 5), (4, None)])
def test_paged_streams_match_reference(pair, steps, num_blocks):
    """Paged, not pipelined; each request reserves 2 blocks of 8, so with 5
    blocks (4 usable) two run at once and the third waits for blocks with
    its slot free."""
    jm, tm = pair
    kw = dict(steps_per_dispatch=steps, paged=True, block_size=8,
              num_blocks=num_blocks)
    ref, _ = _serve_staggered(JaxEngine, jm, **kw)
    got, eng = _serve_staggered(ContinuousBatchingEngine, tm, **kw)
    assert got == ref
    assert got == _serve(ContinuousBatchingEngine, tm, **kw)[0]
    assert eng._alloc.free_blocks == eng._alloc.num_blocks - 1
    assert (eng._tables_np == 0).all() and eng.logits_finite()


@pytest.mark.parametrize("kv_dtype", ["int8", "bf16"])
def test_paged_kv_storage_streams_match_reference(kv_dtype):
    """int8 {"q", "s"} and bf16 block pools through the whole engine: the
    row quantization, the scale rows and the dequantizing gather."""
    jm, tm = _pair(kv_dtype=kv_dtype)
    kw = dict(paged=True, block_size=8)
    ref, _ = _serve(JaxEngine, jm, **kw)
    got, eng = _serve(ContinuousBatchingEngine, tm, **kw)
    assert got == ref
    assert isinstance(eng.k_cache, dict) == (kv_dtype == "int8")
    assert _serve(ContinuousBatchingEngine, tm, pipelined=True, **kw)[0] == got


@pytest.mark.parametrize("pipelined", [False, True])
def test_admission_pass_counts_its_own_reservations(pair, pipelined):
    """Three free slots and 4 usable blocks: the reference's gate checks each
    request against the free count alone, admits three requests of 2 blocks
    and fails with MemoryError (ROADMAP E); the port counts the blocks its
    pass has taken, admits two and serves the third when blocks free."""
    jm, tm = pair
    kw = dict(paged=True, block_size=8, num_blocks=5, pipelined=pipelined)
    with pytest.raises(MemoryError):
        _serve(JaxEngine, jm, **kw)
    got, eng = _serve(ContinuousBatchingEngine, tm, **kw)
    assert got == _serve(ContinuousBatchingEngine, tm, **dict(kw, num_blocks=None))[0]
    assert eng._alloc.free_blocks == 4


@pytest.mark.parametrize("steps", [1, 4])
def test_dense_pipelined_streams_match_reference(pair, monkeypatch, steps):
    """Dense pipelined: the reference's batch-rows chunk against the port's,
    waves and single admissions, with its step count."""
    jm, tm = pair
    monkeypatch.setenv("PYGPUKIT_SERVING_STEP", "batch")
    ref, jeng = _serve(JaxEngine, jm, steps_per_dispatch=steps, pipelined=True)
    got, eng = _serve(ContinuousBatchingEngine, tm, steps_per_dispatch=steps,
                      pipelined=True)
    assert got == ref and eng.stats.steps == jeng.stats.steps
    assert eng.stats.prefills == len(PROMPTS) and not eng.has_work


@pytest.mark.parametrize("preadmit,tailskip", [("1", "1"), ("0", "1"),
                                               ("1", "0"), ("0", "0")])
def test_switches_flip_both_packages(pair, monkeypatch, preadmit, tailskip):
    """PYGPUKIT_SERVE_PREADMIT and PYGPUKIT_SERVE_TAILSKIP mean the same in
    both packages: the same streams and the same number of chunks."""
    jm, tm = pair
    monkeypatch.setenv("PYGPUKIT_SERVING_STEP", "batch")
    monkeypatch.setenv("PYGPUKIT_SERVE_PREADMIT", preadmit)
    monkeypatch.setenv("PYGPUKIT_SERVE_TAILSKIP", tailskip)
    kw = dict(max_batch=2, steps_per_dispatch=6, pipelined=True)
    prompts, n_new = [[i + 1, 2] for i in range(5)], [6, 6, 6, 4, 9]
    ref, jeng = _serve(JaxEngine, jm, prompts, n_new, **kw)
    got, eng = _serve(ContinuousBatchingEngine, tm, prompts, n_new, **kw)
    assert got == ref and eng.stats.steps == jeng.stats.steps


@pytest.mark.parametrize("workload", ["mixed", "reuse", "wave"])
def test_paged_pipelined_matches_paged(pair, workload):
    jm, tm = pair
    prompts, n_new, kw = {
        "mixed": (PROMPTS, N_NEW, dict(max_batch=3)),
        "reuse": ([[5, 11], [7, 3, 9], [13, 1], [2, 4, 6, 8]], [6] * 4,
                  dict(max_batch=2)),
        "wave": ([[i + 1, 2, 3] for i in range(7)], [6] * 7, dict(max_batch=8)),
    }[workload]
    kw = dict(kw, paged=True, block_size=8)
    plain, _ = _serve(ContinuousBatchingEngine, tm, prompts, n_new, **kw)
    piped, eng = _serve(ContinuousBatchingEngine, tm, prompts, n_new,
                        pipelined=True, **kw)
    assert piped == plain
    assert plain == _serve(JaxEngine, jm, prompts, n_new, **kw)[0]
    assert eng._alloc.free_blocks == eng._alloc.num_blocks - 1
    if workload == "wave":       # 7 admissions: sub-waves 4 + 2 + a single
        assert eng._prefill_shapes == {(4, 32), (2, 32), (1, 32)}


def test_tail_skip_same_streams_fewer_chunks(pair, monkeypatch):
    _, tm = pair
    runs = {}
    for skip in ("0", "1"):
        monkeypatch.setenv("PYGPUKIT_SERVE_TAILSKIP", skip)
        for paged in (False, True):
            runs[skip, paged] = _serve(
                ContinuousBatchingEngine, tm, [[i + 1, 2] for i in range(4)],
                [6] * 4, max_batch=2, steps_per_dispatch=6, pipelined=True,
                paged=paged, block_size=8)
    for paged in (False, True):
        (s_off, e_off), (s_on, e_on) = runs["0", paged], runs["1", paged]
        assert s_on == s_off
        assert e_on.stats.steps < e_off.stats.steps


def test_early_admit_frees_blocks_by_identity(pair):
    """Length-bound requests get their replacements prefilled while they are
    still in flight; when they resolve, their slot belongs to the newcomer,
    so their blocks are freed by request identity. The pool ends empty."""
    _, tm = pair
    eng = ContinuousBatchingEngine(tm, max_batch=2, max_seq_len=64,
                                   steps_per_dispatch=4, pipelined=True,
                                   paged=True, block_size=8)
    by_identity = []
    finish = eng._maybe_finish_req

    def spy(req, slot, tok, pos=None):
        was_done = req.done
        finish(req, slot, tok, pos)
        if req.done and not was_done:
            by_identity.append(eng._slots[slot] is not None
                               and eng._slots[slot] is not req)
    eng._maybe_finish_req = spy
    reqs = [eng.submit([i + 1, 2], max_new_tokens=8) for i in range(6)]
    eng.run_until_complete()
    assert all(r.done and len(r.generated) == 8 for r in reqs)
    assert any(by_identity)
    assert eng._alloc.free_blocks == eng._alloc.num_blocks - 1
    assert eng._alloc.allocated == {} and (eng._tables_np == 0).all()


def test_submit_refuses_a_request_that_never_fits(pair):
    _, tm = pair
    eng = ContinuousBatchingEngine(tm, max_batch=2, max_seq_len=64,
                                   steps_per_dispatch=4, paged=True,
                                   block_size=8, num_blocks=3)
    with pytest.raises(MemoryError):
        eng.submit(list(range(1, 14)), max_new_tokens=20)
    r = eng.submit([1, 2], max_new_tokens=5)      # the engine still serves
    eng.run_until_complete()
    assert r.done and len(r.generated) == 5


@pytest.mark.parametrize("pipelined", [False, True])
def test_pool_busy_defers_admission(pair, pipelined):
    _, tm = pair
    eng = ContinuousBatchingEngine(tm, max_batch=3, max_seq_len=64,
                                   steps_per_dispatch=4, paged=True,
                                   block_size=8, num_blocks=5,
                                   pipelined=pipelined)
    # each request reserves ceil((2+10+1)/8) = 2 blocks; 4 usable blocks
    reqs = [eng.submit([5, i + 1], max_new_tokens=10) for i in range(5)]
    eng.run_until_complete()
    assert all(r.done and len(r.generated) == 10 for r in reqs)
    assert eng._alloc.free_blocks == 4


def test_paged_pool_is_smaller_and_serves(pair):
    _, tm = pair
    dense = ContinuousBatchingEngine(tm, max_batch=3, max_seq_len=64)
    paged = ContinuousBatchingEngine(tm, max_batch=3, max_seq_len=64,
                                     paged=True, block_size=8, num_blocks=10)
    assert paged.k_cache.numel() < dense.k_cache.numel() / 1.5
    assert paged.k_cache.shape == (2, 10, 2, 8, 12)
    r = paged.submit([5, 6, 7], max_new_tokens=6)
    paged.run_until_complete()
    assert r.done and len(r.generated) == 6


@pytest.mark.parametrize("pipelined", [False, True])
def test_generation_to_context_limit(pair, pipelined):
    """Block reservation clamps to the table capacity, and decode positions
    clamp at MAX - 1, so a request that runs into the limit finishes."""
    jm, tm = pair
    kw = dict(max_batch=2, max_seq_len=32, steps_per_dispatch=8, paged=True,
              block_size=8, pipelined=pipelined)
    got, _ = _serve(ContinuousBatchingEngine, tm, [[1, 2, 3]], [64], **kw)
    assert len(got[0]) == 32 - 3
    if not pipelined:
        assert got == _serve(JaxEngine, jm, [[1, 2, 3]], [64], **kw)[0]


def test_pipelined_eos_and_streaming_order(pair):
    _, tm = pair
    full, _ = _serve(ContinuousBatchingEngine, tm, [[9, 9, 1]], [8])
    eos = full[0][2]
    seen = []
    eng = ContinuousBatchingEngine(tm, max_batch=2, max_seq_len=64,
                                   steps_per_dispatch=4, pipelined=True,
                                   paged=True, block_size=8)
    r1 = eng.submit([5, 11, 42], max_new_tokens=6,
                    on_token=lambda req, t: seen.append(t))
    eng.step()
    r2 = eng.submit([9, 9, 1], max_new_tokens=8, eos_token_id=eos)
    r3 = eng.submit([3, 4], max_new_tokens=1)
    eng.run_until_complete()
    assert r2.generated == full[0][:full[0].index(eos) + 1]
    assert seen == r1.generated and len(seen) == 6
    assert len(r3.generated) == 1 and not eng.has_work


def test_sampled_paged_pipelined_replays_under_seed(pair):
    _, tm = pair
    runs = [_serve(ContinuousBatchingEngine, tm, steps_per_dispatch=3,
                   pipelined=True, paged=True, block_size=8, temperature=0.8,
                   top_k=5, seed=11)[0] for _ in range(2)]
    assert runs[0] == runs[1]
    assert [len(s) for s in runs[0]] == N_NEW


def test_warmup_works_where_the_reference_raises(pair):
    """The reference's warmup on a paged engine that is not pipelined
    raises (serving.py:1154, ROADMAP E); the port's runs the paged prefill
    buckets into the trash block and leaves the streams unchanged."""
    jm, tm = pair
    jeng = JaxEngine(jm, max_batch=3, max_seq_len=64, steps_per_dispatch=4,
                     paged=True, block_size=8)
    with pytest.raises(ValueError):
        jeng.warmup(prompt_lens=(3,))
    ref, _ = _serve(ContinuousBatchingEngine, tm, paged=True, block_size=8)
    eng = ContinuousBatchingEngine(tm, max_batch=3, max_seq_len=64,
                                   steps_per_dispatch=4, paged=True, block_size=8)
    eng.warmup(prompt_lens=(3, 40))
    assert eng._prefill_shapes == {(1, 32), (1, 64)}
    assert eng._alloc.free_blocks == eng._alloc.num_blocks - 1
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, N_NEW)]
    eng.run_until_complete()
    assert [r.generated for r in reqs] == ref


@pytest.mark.parametrize("paged", [False, True])
def test_no_new_prefill_shapes_after_warmup(pair, paged):
    """warmup() runs every prefill shape a pipelined engine can form (buckets
    and power-of-two waves); a ragged workload afterwards runs no new one,
    and the streams are those of an engine that was never warmed up."""
    _, tm = pair
    kw = dict(max_batch=8, max_seq_len=64, steps_per_dispatch=4, pipelined=True,
              paged=paged, block_size=8)
    rng = np.random.default_rng(0)
    prompts = [[i + 1, 2, 3] for i in range(20)]
    n_new = [int(n) for n in rng.integers(2, 12, 20)]
    cold, _ = _serve(ContinuousBatchingEngine, tm, prompts, n_new, **kw)
    eng = ContinuousBatchingEngine(tm, **kw)
    eng.warmup(prompt_lens=(3,))
    shapes = set(eng._prefill_shapes)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, n_new)]
    eng.run_until_complete()
    assert eng._prefill_shapes == shapes
    assert [r.generated for r in reqs] == cold
    with pytest.raises(RuntimeError):
        eng.submit([1], max_new_tokens=2)
        eng.warmup()
