"""Batched decode attention over the dense serving pools (port of
``pygpukit_tpu/kernels/batch_decode_attention.py``).

One query per head for all B slots against layer ``layer`` of the merged
``[B, L, MAX, Hk*D]`` pools, masked to each slot's context
``pos < min(ctx_lens[b], MAX)`` and, with a window, ``pos >= ctx - window``;
GQA, optional softcap ``cap * tanh(s / cap)``. Pools of every storage the
engines build: bf16, f32, fp8 e4m3/e5m2 and int8 ``{"q", "s"}`` dicts, under
bf16 or f32 queries. CUDA tensors launch ``csrc/batch_decode_attention.cu``
(or raise); CPU tensors take the plain version.

The kernel splits each slot's live window over blocks (split-KV):
``attention_split.attention_splits`` picks the number of splits from the
shapes alone and ``split_bounds`` deals the 64-row chunks out, as the CUDA
body (``csrc/decode_attention.cuh``) does; a second pass folds the splits in
ascending order. ``paged_attention`` and ``flash_decode`` share both.
"""

from __future__ import annotations

import math

import torch

from ..ops.embedding import kv_leaf
from ._build import count, launch, require_on, stream_of
from .attention_split import (ATTN_CHUNK,  # noqa: F401 (re-exported)
                              attention_splits, split_bounds)

_F32 = torch.float32
_NEG_INF = -1e30
#: the kernels' numbers for the query dtypes and the pool storages
#: (``csrc/decode_attention.cuh``; int8 ``{"q", "s"}`` dicts are INT8_KIND)
_Q_KINDS = {torch.bfloat16: 0, _F32: 1}
_KV_KINDS = {torch.bfloat16: 0, _F32: 1, torch.float8_e4m3fn: 2,
             torch.float8_e5m2: 3}
INT8_KIND = 4
#: the head dims the decode-attention kernels are built for
HEAD_DIMS = (64, 80, 96, 128, 256)
#: the most query heads a kv head that the kernel (and row 17's) takes
MAX_GROUP = 16


def supports(hq: int, hk: int, d: int) -> bool:
    """The split-KV attention body (this kernel and ``paged_attention``)
    is built for this shape: D one of HEAD_DIMS, 1 to MAX_GROUP query heads
    a kv head. Reads the shape and nothing else: the batch-rows and paged
    steps send other shapes to the plain versions, and the wrappers raise
    on them."""
    return d in HEAD_DIMS and hk >= 1 and hq % hk == 0 and hq // hk <= MAX_GROUP


def storage_kinds(q: torch.Tensor, k_pool, v_pool) -> tuple[int, int]:
    """(query kind, storage kind) of the kernels; NotImplementedError for
    a dtype no engine builds (an f16 pool, say) or two storages."""
    kinds = {_kv_kind(k_pool), _kv_kind(v_pool)}
    if q.dtype not in _Q_KINDS or len(kinds) != 1 or None in kinds:
        raise NotImplementedError(
            f"the CUDA attention kernels take bf16 or f32 queries over one of "
            f"bf16, f32, fp8 or int8 {{q, s}} pools (got {q.dtype} over "
            f"{_kv_dtype(k_pool)} / {_kv_dtype(v_pool)})")
    return _Q_KINDS[q.dtype], kinds.pop()


def _kv_dtype(pool):
    return {k: v.dtype for k, v in pool.items()} if isinstance(pool, dict) \
        else pool.dtype


def _kv_kind(pool) -> int | None:
    if isinstance(pool, dict):
        ok = pool["q"].dtype == torch.int8 and pool["s"].dtype == torch.bfloat16
        return INT8_KIND if ok else None
    return _KV_KINDS.get(pool.dtype)


def kernel_leaves(pool, what: str):
    """(values, row scales or None) of a pool for a kernel: contiguous, the
    values 16-byte aligned (the cp.async rows), both on one device."""
    vals, scales = (pool["q"], pool["s"]) if isinstance(pool, dict) else (pool, None)
    if not (vals.is_contiguous() and vals.data_ptr() % 16 == 0):
        raise ValueError(f"{what} must be contiguous and 16-byte aligned")
    if scales is not None:
        if not scales.is_contiguous():
            raise ValueError(f"{what} row scales must be contiguous")
        require_on(vals.device, **{f"{what} scales": scales})
    return vals, scales


def ptr_or_null(t) -> int | None:
    """A tensor's device pointer, or None (NULL to ctypes) for no tensor."""
    return None if t is None else t.data_ptr()


def _layer_rows(pool, layer: int, hk: int, d: int):
    """(values [B, MAX, Hk, D], row scales [B, MAX] or None) of one layer."""
    if isinstance(pool, dict):
        q, s = pool["q"][:, layer], pool["s"][:, layer]
    else:
        q, s = pool[:, layer], None
    return q.reshape(q.shape[0], q.shape[1], hk, d), s


def _to_compute(x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Pool values in the query dtype (fp8 and int8 storage go through
    bf16 first, as the reference kernel converts them), held as f32."""
    if x.dtype not in (_F32, torch.bfloat16):
        x = x.to(torch.bfloat16)
    return x.to(cdt).to(_F32)


def batch_decode_attention_plain(q: torch.Tensor, k_pool, v_pool, layer: int,
                                 ctx_lens: torch.Tensor, scale: float,
                                 softcap: float | None = None,
                                 window: int | None = None) -> torch.Tensor:
    """Full masked softmax in f32. The P@V operand is rounded to the query
    dtype first, as the reference kernel does; int8 row scales fold into
    the score columns (k) and into P (v)."""
    b, _, hq, d = q.shape
    leaf = kv_leaf(k_pool)
    max_len = leaf.shape[2]
    hk = leaf.shape[3] // d
    g = hq // hk
    cdt = q.dtype
    k, ks = _layer_rows(k_pool, layer, hk, d)
    v, vs = _layer_rows(v_pool, layer, hk, d)
    qf = q.reshape(b, hk, g, d).to(_F32)
    s = torch.einsum("bhgd,bphd->bhgp", qf, _to_compute(k, cdt)) * scale
    if ks is not None:
        s = s * ks.to(_F32)[:, None, None, :]
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(max_len, device=q.device)[None, :]
    ctx = ctx_lens.to(device=q.device, dtype=torch.long)[:, None]
    lo = ctx - window if window is not None and window > 0 \
        else torch.full_like(ctx, -(2 ** 30))
    dead = ((pos >= ctx) | (pos < lo))[:, None, None, :]
    s = torch.where(dead, torch.full_like(s, _NEG_INF), s)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(dead, torch.zeros_like(s), torch.exp(s - m))
    l_sum = torch.sum(p, dim=-1, keepdim=True)
    if vs is not None:
        p = p * vs.to(_F32)[:, None, None, :]
    o = torch.einsum("bhgp,bphd->bhgd", p.to(cdt).to(_F32), _to_compute(v, cdt))
    o = o / torch.clamp_min(l_sum, 1e-30)
    return o.reshape(b, 1, hq, d).to(cdt)


def batch_decode_attention(q: torch.Tensor, k_pool, v_pool, layer: int,
                           ctx_lens: torch.Tensor, scale: float | None = None,
                           softcap: float | None = None,
                           window: int | None = None) -> torch.Tensor:
    """q [B, 1, Hq, D] -> [B, 1, Hq, D]. ``ctx_lens`` [B] int: lengths
    including the row just written (may exceed MAX). ``window``: host int,
    None or <= 0 for full attention."""
    b, t, hq, d = q.shape
    if t != 1:
        raise ValueError("batch_decode_attention takes one query per slot")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if not kv_leaf(k_pool).is_cuda:
        return batch_decode_attention_plain(q, k_pool, v_pool, layer, ctx_lens,
                                            scale, softcap, window)
    return launch_batch_decode_attention(q, k_pool, v_pool, layer, ctx_lens, scale,
                                         softcap, window)


def launch_batch_decode_attention(q: torch.Tensor, k_pool, v_pool, layer: int,
                                  ctx_lens: torch.Tensor, scale: float,
                                  softcap: float | None, window: int | None,
                                  write: tuple | None = None) -> torch.Tensor:
    """The kernel's launch on CUDA pools (q [B, 1, Hq, D]). ``write``: (k_new,
    v_new [B, Hk*D] contiguous in q's dtype, poss [B] int32), the rows pass
    one stores first (the fused row write of ``kv_row_write.
    kv_write_attention``), counted as a launch of ``kv_rows_write_fused``
    too."""
    b, _, hq, d = q.shape
    leaf = kv_leaf(k_pool)
    q_kind, kv_kind = storage_kinds(q, k_pool, v_pool)
    kq, ks = kernel_leaves(k_pool, "k_pool")
    vq, vs = kernel_leaves(v_pool, "v_pool")
    require_on(leaf.device, q=q, v_pool=vq)
    if kq.ndim != 4 or kq.shape != vq.shape:
        raise ValueError("pools must be merged [B, L, MAX, Hk*D] of one shape")
    _, n_layers, max_len, lanes = kq.shape
    hk = lanes // d
    if hk * d != lanes or not supports(hq, hk, d):
        raise ValueError(f"unsupported attention shape: Hq={hq} Hk*D={lanes} D={d}")
    qc = q.contiguous()
    lens = ctx_lens.to(device=leaf.device, dtype=torch.int32).contiguous()
    n_split = attention_splits(b, hk, max_len)
    part = torch.empty(b * hq * n_split * (d + 2), device=leaf.device, dtype=_F32)
    out = torch.empty_like(qc)
    kn, vn, poss = write if write is not None else (None, None, None)
    launch("batch_decode_attention", "pgk_batch_decode_attention",
           qc.data_ptr(), kq.data_ptr(), vq.data_ptr(), ptr_or_null(ks),
           ptr_or_null(vs), lens.data_ptr(), ptr_or_null(kn), ptr_or_null(vn),
           ptr_or_null(poss), out.data_ptr(), part.data_ptr(), b, hq, hk, d,
           int(layer), n_layers, max_len, n_split, q_kind, kv_kind,
           float(scale), float(softcap) if softcap else 0.0,
           int(window) if window else 0, stream_of(leaf))
    if write is not None:
        count("kv_rows_write_fused")
    return out
