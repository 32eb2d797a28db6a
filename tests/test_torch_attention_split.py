"""The split-KV plan of the decode attention kernels (``csrc/decode_attention.cuh``)
on the CPU, where the kernels cannot run:

- ``split_bounds`` partitions each slot's live window exactly once, in
  64-row chunks, for every split count ``attention_splits`` picks
  (hypothesis over the window start, the context, MAX and B);
- the kernels' algorithm written in plain PyTorch (each split an online
  softmax over its chunks, the splits folded in ascending order, int8 row
  scales folded into the scores and into p, P rounded to the query dtype)
  against the reference's ``_bda_kernel`` in interpret mode and its paged
  engine's gather formulation, on bf16, f32, fp8 and int8 pools, with a
  window, contexts past MAX and empty splits: 1e-5 relative with f32
  queries (1e-2 where the reference itself rounds: bf16 queries, and the
  paged reference's bf16 dequantization of int8 blocks).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from pygpukit_tpu.kernels.batch_decode_attention import \
    batch_decode_attention as jax_bda
from pygpukit_tpu.llm import serving_paged as jsp
from pygpukit_tpu.ops.embedding import kv_quant_rows as jax_kv_quant_rows
from pygpukit_tpu_torch.kernels.batch_decode_attention import (
    ATTN_CHUNK, attention_splits, batch_decode_attention_plain, split_bounds)
from pygpukit_tpu_torch.llm import params_from_jax

torch.set_num_threads(2)

_F32 = torch.float32


@settings(max_examples=300, deadline=None)
@given(b=st.integers(1, 16), hk=st.sampled_from([1, 2, 4, 8]),
       max_len=st.integers(1, 4096), ctx=st.integers(0, 5000),
       window=st.one_of(st.none(), st.integers(1, 5000)))
def test_split_bounds_partition_the_live_window(b, hk, max_len, ctx, window):
    n_split = attention_splits(b, hk, max_len)
    assert 1 <= n_split <= max(1, -(-max_len // ATTN_CHUNK))
    live = min(ctx, max_len)
    lo = ctx - window if window else -(2 ** 30)
    bounds = split_bounds(lo, live, n_split)
    assert len(bounds) == n_split
    covered = [p for start, end in bounds for p in range(start, end)]
    assert covered == list(range(max(lo, 0), live))           # in order, exactly once
    spans = [(s, e) for s, e in bounds if e > s]
    for i, (start, end) in enumerate(spans):
        if i > 0:
            assert start % ATTN_CHUNK == 0                     # inner bounds on chunk edges
        if i < len(spans) - 1:
            assert end % ATTN_CHUNK == 0
    if spans:                                                  # an even deal of the chunks
        chunks = -(-live // ATTN_CHUNK) - max(lo, 0) // ATTN_CHUNK
        most = max(-(-e // ATTN_CHUNK) - s // ATTN_CHUNK for s, e in spans)
        assert most == -(-chunks // n_split)


def _layer(pool, layer):
    """(values [B, MAX, Hk*D], scales [B, MAX] or None) of one layer."""
    if isinstance(pool, dict):
        return pool["q"][:, layer], pool["s"][:, layer]
    return pool[:, layer], None


def _compute(x, cdt):
    if x.dtype not in (_F32, torch.bfloat16):
        x = x.to(torch.bfloat16)
    return x.to(cdt).to(_F32)


def _split_rows(q, rows_of, ctx, max_len, n_split, scale, softcap, window):
    """One slot's [Hq, D] output by the kernels' algorithm. ``rows_of(pos)``
    gives (K, V [n, Hk, D] in the compute dtype as f32, K and V row scales
    [n] or None) of the positions ``pos``."""
    hq, d = q.shape
    cdt = q.dtype
    live = min(ctx, max_len)
    lo = ctx - window if window else -(2 ** 30)
    parts = []
    for start, end in split_bounds(lo, live, n_split):
        hk = None
        m = l_sum = acc = None
        for c0 in range(start // ATTN_CHUNK * ATTN_CHUNK, end, ATTN_CHUNK):
            pos = torch.arange(max(c0, start), min(c0 + ATTN_CHUNK, end))
            kc, vc, ksc, vsc = rows_of(pos)
            hk = kc.shape[1]
            qf = q.reshape(hk, hq // hk, d).to(_F32)
            s = torch.einsum("hgd,nhd->hgn", qf, kc) * scale
            if ksc is not None:
                s = s * ksc
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            if m is None:
                m = torch.full(s.shape[:2], -1e30)
                l_sum = torch.zeros(s.shape[:2])
                acc = torch.zeros(s.shape[:2] + (d,))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l_sum = l_sum * alpha + p.sum(-1)
            if vsc is not None:
                p = p * vsc
            acc = acc * alpha[..., None] + torch.einsum(
                "hgn,nhd->hgd", p.to(cdt).to(_F32), vc)
            m = m_new
        if m is not None:
            parts.append((m, l_sum, acc))
    if not parts:                      # every split empty: zeros
        return torch.zeros((hq, d), dtype=cdt)
    mx = torch.stack([p[0] for p in parts]).amax(0)
    l_sum = sum(p[1] * torch.exp(p[0] - mx) for p in parts)
    acc = sum(p[2] * torch.exp(p[0] - mx)[..., None] for p in parts)
    return (acc / torch.clamp_min(l_sum, 1e-30)[..., None]).reshape(hq, d).to(cdt)


def dense_split_plain(q, k_pool, v_pool, layer, lens, scale, softcap=None, window=None):
    b, _, hq, d = q.shape
    k, ks = _layer(k_pool, layer)
    v, vs = _layer(v_pool, layer)
    max_len, hk = k.shape[1], k.shape[2] // d
    n_split = attention_splits(b, hk, max_len)
    outs = []
    for bi in range(b):
        def rows_of(pos, bi=bi):
            kc = _compute(k[bi, pos], q.dtype).reshape(len(pos), hk, d)
            vc = _compute(v[bi, pos], q.dtype).reshape(len(pos), hk, d)
            return (kc, vc, None if ks is None else ks[bi, pos].to(_F32),
                    None if vs is None else vs[bi, pos].to(_F32))
        outs.append(_split_rows(q[bi, 0], rows_of, int(lens[bi]), max_len, n_split,
                                scale, softcap, window))
    return torch.stack(outs)[:, None]


STORAGE = {"bf16": jnp.bfloat16, "f32": jnp.float32, "e4m3": jnp.float8_e4m3fn,
           "e5m2": jnp.float8_e5m2, "int8": jnp.int8}
B, L, MAX, HQ, HK, D = 4, 2, 256, 8, 2, 64
# slot 1 (70 rows) leaves two of the four splits empty, slot 2 is past MAX,
# slot 3 holds no row
LENS = np.array([200, 70, 300, 0], np.int32)


def _dense_pools(rng, kind):
    """Matching JAX and port pools [B, L, MAX, Hk*D] of one storage."""
    out = []
    for _ in range(2):
        rows = rng.standard_normal((B, L, MAX, HK * D)).astype(np.float32) * 2
        if kind == "int8":
            qq, ss = jax_kv_quant_rows(jnp.asarray(rows), 1)
            jp = {"q": qq, "s": ss}
        else:
            jp = jnp.asarray(rows).astype(STORAGE[kind])
        out.append((jp, params_from_jax(jax.tree.map(np.asarray, jp))))
    return out


@pytest.mark.parametrize("softcap,window", [(None, None), (20.0, 100)])
@pytest.mark.parametrize("kind,qdt", [(k, "f32") for k in STORAGE]
                         + [(k, "bf16") for k in STORAGE if k != "f32"])
def test_dense_split_matches_reference_kernel(kind, qdt, softcap, window):
    rng = np.random.default_rng(3)
    (jk, tk), (jv, tv) = _dense_pools(rng, kind)
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    jq = jnp.asarray(q, jnp.float32 if qdt == "f32" else jnp.bfloat16)
    tq = params_from_jax(np.asarray(jq))
    ref = jax_bda(jq, jk, jv, jnp.int32(1), jnp.asarray(LENS), chunk=64, softcap=softcap,
                  window=None if window is None else jnp.int32(window))
    got = dense_split_plain(tq, tk, tv, 1, torch.from_numpy(LENS), 0.125, softcap, window)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    tol = dict(rtol=1e-5, atol=1e-6) if qdt == "f32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)
    # and the port's plain version (a full softmax) agrees with both
    plain = batch_decode_attention_plain(tq, tk, tv, 1, torch.from_numpy(LENS), 0.125,
                                         softcap, window)
    np.testing.assert_allclose(plain.float().numpy(), ref, **tol)


def paged_split_plain(q, k_pool, v_pool, tables, lens, scale, softcap=None, window=None):
    """The kernels' algorithm over block pools [NB, Hk, BS, D] (int8: with
    [NB, BS] scales) through block tables [B, MB]."""
    b, hq, d = q.shape
    kq, ks = (k_pool["q"], k_pool["s"]) if isinstance(k_pool, dict) else (k_pool, None)
    vq, vs = (v_pool["q"], v_pool["s"]) if isinstance(v_pool, dict) else (v_pool, None)
    _, hk, bs, _ = kq.shape
    mb = tables.shape[1]
    n_split = attention_splits(b, hk, mb * bs)
    outs = []
    for bi in range(b):
        def rows_of(pos, bi=bi):
            blk, off = tables[bi, pos // bs].long(), pos % bs
            kc = _compute(kq[blk, :, off], q.dtype)              # [n, Hk, D]
            vc = _compute(vq[blk, :, off], q.dtype)
            return (kc, vc, None if ks is None else ks[blk, off].to(_F32),
                    None if vs is None else vs[blk, off].to(_F32))
        outs.append(_split_rows(q[bi], rows_of, int(lens[bi]), mb * bs, n_split, scale,
                                softcap, window))
    return torch.stack(outs)


@pytest.mark.parametrize("softcap,window", [(None, None), (20.0, 100)])
@pytest.mark.parametrize("kind", list(STORAGE))
def test_paged_split_matches_reference(kind, softcap, window):
    """Against the reference paged engine's attention (``_paged_attn_one``,
    the XLA gather it sends int8 pools to) with f32 queries."""
    rng = np.random.default_rng(4)
    nb, bs, mb = 40, 16, 8
    pools = []
    for _ in range(2):
        rows = rng.standard_normal((nb, HK, bs, D)).astype(np.float32) * 2
        if kind == "int8":
            qq, ss = jax_kv_quant_rows(jnp.asarray(rows.transpose(0, 2, 1, 3)), 2)
            pools.append({"q": jnp.asarray(np.asarray(qq).transpose(0, 2, 1, 3)), "s": ss})
        else:
            pools.append(jnp.asarray(rows).astype(STORAGE[kind]))
    tables = np.stack([rng.permutation(np.arange(1, nb))[:mb] for _ in range(B)]).astype(np.int32)
    # 200 > mb * bs = 128; no empty context: the reference's gather
    # formulation averages V there, its kernel (and the port's) gives zeros
    lens = np.array([100, 20, 200, 5], np.int32)
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    ref = np.stack([np.asarray(jsp._paged_attn_one(
        jnp.asarray(q[i]), pools[0], pools[1], jnp.asarray(tables[i]), jnp.int32(lens[i]),
        0.125, softcap, None if window is None else jnp.int32(window)))
        for i in range(B)])
    tk, tv = (params_from_jax(jax.tree.map(np.asarray, p)) for p in pools)
    got = paged_split_plain(torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
                            torch.from_numpy(lens), 0.125, softcap, window)
    # the reference dequantizes int8 blocks to bf16 (q * s rounded); the
    # kernels fold the exact scale into the scores
    tol = dict(rtol=1e-2, atol=1e-2) if kind == "int8" else dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), ref, **tol)
