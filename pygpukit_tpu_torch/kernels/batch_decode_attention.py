"""Batched decode attention over the dense serving pools (port of
``pygpukit_tpu/kernels/batch_decode_attention.py``).

One query per head for all B slots against layer ``layer`` of the merged
``[B, L, MAX, Hk*D]`` pools, masked to each slot's context
``pos < min(ctx_lens[b], MAX)`` and, with a window, ``pos >= ctx - window``;
GQA, optional softcap ``cap * tanh(s / cap)``. CUDA tensors launch
``csrc/batch_decode_attention.cu`` (bf16 pools and queries); CPU tensors take
the plain version, which also covers f32, fp8 and int8 ``{"q", "s"}`` pools.
"""

from __future__ import annotations

import math

import torch

from ..ops.embedding import kv_leaf
from ._build import launch, require_on, stream_of

_F32 = torch.float32
_NEG_INF = -1e30


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
    leaf = kv_leaf(k_pool)
    if not leaf.is_cuda:
        return batch_decode_attention_plain(q, k_pool, v_pool, layer, ctx_lens,
                                            scale, softcap, window)
    if isinstance(k_pool, dict) or k_pool.dtype != torch.bfloat16 \
            or v_pool.dtype != torch.bfloat16 or q.dtype != torch.bfloat16:
        raise NotImplementedError("the CUDA attention kernel takes bf16 "
                                  "queries and pools")
    require_on(leaf.device, q=q, v_pool=v_pool)
    if k_pool.ndim != 4 or not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous merged [B, L, MAX, Hk*D]")
    _, n_layers, max_len, lanes = k_pool.shape
    hk = lanes // d
    if hk * d != lanes or hq % hk or hq // hk > 16 or d not in (64, 128):
        raise ValueError(f"unsupported attention shape: Hq={hq} Hk*D={lanes} D={d}")
    qc = q.contiguous()
    lens = ctx_lens.to(device=leaf.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(qc)
    launch("batch_decode_attention", "pgk_batch_decode_attention",
           qc.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), lens.data_ptr(),
           out.data_ptr(), b, hq, hk, d, int(layer), n_layers, max_len,
           float(scale), float(softcap) if softcap else 0.0,
           int(window) if window else 0, stream_of(leaf))
    return out
