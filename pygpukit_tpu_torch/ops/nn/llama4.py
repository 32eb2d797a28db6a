"""Llama-4 ops (counterpart of ``pygpukit_tpu/ops/nn/llama4.py``): the
parameterless QK norm, the iRoPE temperature and causal SDPA with that
temperature folded into q. ``l2norm`` here is the Llama-4 QK norm (the
MEAN of squares, eps 1e-6); ``ops.nn.norm.l2norm`` is the true L2 norm."""

from __future__ import annotations

import math

import torch

from ...core.array import Array
from .._common import apply_op
from .norm import qk_l2norm_fn

_F32 = torch.float32
_NEG_INF = -1e30


def irope_scale_fn(positions: torch.Tensor, attn_scale: float = 0.1,
                   floor_scale: float = 8192.0) -> torch.Tensor:
    """The temperature of each position, f32:
    log1p(floor((pos + 1) / floor_scale)) * attn_scale + 1."""
    p = positions.to(_F32)
    return torch.log1p(torch.floor((p + 1.0) / floor_scale)) * attn_scale + 1.0


def irope_scale_q_fn(q: torch.Tensor, positions: torch.Tensor, attn_scale: float = 0.1,
                     floor_scale: float = 8192.0) -> torch.Tensor:
    """q [S, H, D] times its position's temperature, in f32, back in q's
    dtype."""
    scale = irope_scale_fn(positions, attn_scale, floor_scale)
    return (q.to(_F32) * scale[:, None, None]).to(q.dtype)


def sdpa_irope_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, attn_scale: float = 0.1,
                  floor_scale: float = 8192.0, causal_offset: int = 0) -> torch.Tensor:
    """Causal SDPA in f32 with the iRoPE temperature folded into q: q [S,
    H, D], k/v [S_k, Hk, D] (GQA by repeating each kv head over its group),
    query i attending keys j <= i + ``causal_offset``. [S, H, D] in q's
    dtype."""
    s, h, d = q.shape
    hk = k.shape[1]
    if hk != h:
        k = torch.repeat_interleave(k, h // hk, dim=1)
        v = torch.repeat_interleave(v, h // hk, dim=1)
    q = irope_scale_q_fn(q, positions, attn_scale, floor_scale)
    qh, kh, vh = (t.permute(1, 0, 2).to(_F32) for t in (q, k, v))
    scores = torch.matmul(qh, kh.transpose(1, 2)) / math.sqrt(d)
    i = torch.arange(s, device=q.device)[:, None] + causal_offset
    j = torch.arange(k.shape[0], device=q.device)[None, :]
    scores = torch.where(j > i, torch.full_like(scores, _NEG_INF), scores)
    out = torch.matmul(torch.softmax(scores, dim=-1), vh)
    return out.permute(1, 0, 2).to(q.dtype)


def l2norm(x, eps: float = 1e-6, *, out: Array | None = None) -> Array:
    """The Llama-4 QK norm (``qk_l2norm_fn``) over the last dim."""
    return apply_op(lambda a: qk_l2norm_fn(a, eps), x, out=out)


def irope_scale_q(q, positions, attn_scale: float = 0.1, floor_scale: float = 8192.0, *,
                  out: Array | None = None) -> Array:
    return apply_op(lambda a, p: irope_scale_q_fn(a, p, attn_scale, floor_scale),
                    q, positions, out=out)


def sdpa_irope(q, k, v, positions, attn_scale: float = 0.1, floor_scale: float = 8192.0,
               causal_offset: int = 0, *, out: Array | None = None) -> Array:
    return apply_op(lambda a, b, c, p: sdpa_irope_fn(a, b, c, p, attn_scale, floor_scale,
                                                     causal_offset),
                    q, k, v, positions, out=out)
