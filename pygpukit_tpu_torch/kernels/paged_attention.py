"""Paged decode attention over block pools (port of
``pygpukit_tpu/kernels/paged_attention.py``).

One query per head for all B slots against one layer's block pool
``[NB, Hk, BS, D]``; slot b's position p is offset ``p % BS`` of block
``tables[b, p // BS]``. Masked to ``p < ctx_lens[b]`` and, with a window,
``p >= ctx - window``; GQA; optional softcap ``cap * tanh(s / cap)``. Pools
of bf16, f32, fp8 or int8 ``{"q": [NB, Hk, BS, D], "s": [NB, BS]}`` under
bf16 or f32 queries. CUDA tensors launch ``csrc/paged_attention.cu`` once
for every slot, split over blocks as ``batch_decode_attention`` splits
(``attention_splits`` of the table's capacity); CPU tensors take the plain
version.

The plain version is the reference engine's XLA path
(``serving_paged._paged_gather`` + ``_paged_attn_one``) batched over slots:
gather the table's blocks, full f32 softmax over the gathered rows. The
kernel is the Pallas kernel's online softmax, which rounds P to bf16 before
P@V; the two agree to bf16 rounding.
"""

from __future__ import annotations

import math

import torch

from ..ops.embedding import kv_dequant, kv_leaf
from ._build import launch, require_on, stream_of

_F32 = torch.float32
_NEG_INF = -1e30


def _paged_gather(pool_l, tables: torch.Tensor) -> torch.Tensor:
    """Gather each slot's blocks from one layer's pool as ``[B, Hk, MB*BS,
    D]``. int8 dict pools gather both leaves and dequantise only the
    gathered blocks (bf16, as the reference); fp8 reads as bf16."""
    idx = tables.to(torch.long)
    if isinstance(pool_l, dict):
        seq = kv_dequant(pool_l["q"][idx], pool_l["s"][idx][:, :, None])
    else:
        seq = pool_l[idx]                                 # [B, MB, Hk, BS, D]
        if seq.dtype not in (_F32, torch.bfloat16, torch.float16):
            seq = seq.to(torch.bfloat16)
    b, mb, hk, bs, d = seq.shape
    return seq.permute(0, 2, 1, 3, 4).reshape(b, hk, mb * bs, d)


def paged_attention_plain(q: torch.Tensor, k_pool_l, v_pool_l,
                          tables: torch.Tensor, ctx_lens: torch.Tensor,
                          scale: float, softcap: float | None = None,
                          window: int | None = None) -> torch.Tensor:
    """q [B, Hq, D] -> [B, Hq, D] in q's dtype; f32 scores and softmax."""
    b, hq, d = q.shape
    kseq = _paged_gather(k_pool_l, tables)
    vseq = _paged_gather(v_pool_l, tables)
    hk, t = kseq.shape[1], kseq.shape[2]
    qh = q.reshape(b, hk, hq // hk, d).to(_F32)
    scores = torch.einsum("bhgd,bhtd->bhgt", qh, kseq.to(_F32)) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores * (1.0 / softcap))
    idx = torch.arange(t, device=q.device)[None, :]
    ctx = ctx_lens.to(device=q.device, dtype=torch.long)[:, None]
    mask = idx < ctx
    if window is not None and window > 0:
        mask = mask & (idx >= ctx - window)
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, _NEG_INF))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgt,bhtd->bhgd", p, vseq.to(_F32))
    return o.reshape(b, hq, d).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pool_l, v_pool_l, tables: torch.Tensor,
                    ctx_lens: torch.Tensor, scale: float | None = None,
                    softcap: float | None = None,
                    window: int | None = None) -> torch.Tensor:
    """q [B, Hq, D]; pools [NB, Hk, BS, D] (one layer); tables [B, MB] int
    physical block ids; ctx_lens [B] int lengths including the row just
    written. ``scale`` defaults to 1/sqrt(D); ``window``: host int, None or
    <= 0 for full attention. Returns [B, Hq, D]."""
    b, hq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    leaf = kv_leaf(k_pool_l)
    if not leaf.is_cuda:
        return paged_attention_plain(q, k_pool_l, v_pool_l, tables, ctx_lens,
                                     scale, softcap, window)
    # imported here: batch_decode_attention imports ops, whose paged module
    # imports this one
    from .batch_decode_attention import (attention_splits, kernel_leaves, ptr_or_null,
                                         storage_kinds, supports)
    q_kind, kv_kind = storage_kinds(q, k_pool_l, v_pool_l)
    kq, ks = kernel_leaves(k_pool_l, "k_pool")
    vq, vs = kernel_leaves(v_pool_l, "v_pool")
    require_on(leaf.device, q=q, v_pool=vq, tables=tables, ctx_lens=ctx_lens)
    if kq.ndim != 4 or kq.shape != vq.shape:
        raise ValueError("pools must be contiguous [NB, Hk, BS, D] of one shape")
    nb, hk, bs, dp = kq.shape
    if dp != d or not supports(hq, hk, d):
        raise ValueError(f"unsupported paged attention shape: Hq={hq} Hk={hk} D={d}")
    if ks is not None and ks.shape != (nb, bs):
        raise ValueError("int8 row scales must be [NB, BS]")
    if tables.ndim != 2 or tables.shape[0] != b or ctx_lens.shape != (b,):
        raise ValueError("tables must be [B, MB] and ctx_lens [B]")
    qc = q.contiguous()
    tbl = tables.to(torch.int32).contiguous()
    lens = ctx_lens.to(torch.int32).contiguous()
    mb = tbl.shape[1]
    n_split = attention_splits(b, hk, mb * bs)
    part = torch.empty(b * hq * n_split * (d + 2), device=leaf.device, dtype=_F32)
    out = torch.empty_like(qc)
    launch("paged_attention", "pgk_paged_attention", qc.data_ptr(),
           kq.data_ptr(), vq.data_ptr(), ptr_or_null(ks), ptr_or_null(vs),
           tbl.data_ptr(),
           lens.data_ptr(), out.data_ptr(), part.data_ptr(), b, hq, hk, d, bs, mb,
           n_split, q_kind, kv_kind, float(scale),
           float(softcap) if softcap else 0.0, int(window) if window else 0,
           stream_of(leaf))
    return out
