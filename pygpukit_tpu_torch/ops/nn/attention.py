"""Prefill attention: causal SDPA and the flash (chunked online-softmax)
recurrence (counterpart of ``pygpukit_tpu/ops/nn/attention.py``, the part
the uncached forward needs; the fixed-cache decode routes come with the
ops layer).

Layouts follow the reference: q/k/v are ``[S, H, D]``; GQA by repeating
each kv head over its group on the plain route.

Route of ``flash_attention_fn`` (the reference's route test at :164-169):
on CUDA tensors, with no softcap, no window and the default scale, the
hand-written ``kernels.flash_attention`` kernel, at every length and for
bf16 and f32 alike; softcap, window or another scale take the plain route
on the card too, as the reference sends them to XLA. The scale counts as
the default when it equals ``1/sqrt(D)`` once rounded to f32, the kernel's
scale: the reference compares Python floats, and ``head_dim ** -0.5`` (the
config's scale) differs from ``1/math.sqrt(head_dim)`` in the last bit at D
128. The reference's other conditions (a TPU backend, bf16 only, S >= 8192,
S % 256 == 0, D % 128 == 0) are TPU compiler workarounds and are not
ported; nor are ``PYGPUKIT_FLASH_ATTENTION`` and the jax-shipped TPU flash
kernel. CPU tensors always take the plain route: ``sdpa_causal_fn`` (or
``_full_attn``) for S <= ``chunk_size`` and the chunked recurrence above,
f32 throughout, as the reference computes off the TPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...kernels.flash_attention import flash_attention

_F32 = torch.float32
_NEG_INF = -1e30


def _gqa_expand(k: torch.Tensor, n_heads_q: int) -> torch.Tensor:
    """[S, Hk, D] -> [S, Hq, D] by repeating each kv head over its group."""
    n_kv = k.shape[-2]
    if n_kv == n_heads_q:
        return k
    return k.repeat_interleave(n_heads_q // n_kv, dim=-2)


def _apply_softcap(scores: torch.Tensor, softcap: float | None) -> torch.Tensor:
    """Gemma-2 attention logit soft-capping: cap * tanh(scores / cap)."""
    if softcap is None:
        return scores
    return softcap * torch.tanh(scores * (1.0 / softcap))


def _window_or_inf(window) -> int | None:
    """Effective sliding window: None stays None, 0 or less is unbounded."""
    if window is None:
        return None
    return int(window) if int(window) > 0 else 1 << 30


def _heads_f32(t: torch.Tensor) -> torch.Tensor:
    return t.permute(1, 0, 2).to(_F32)                     # [H, S, D]


def sdpa_causal_fn(q, k, v, scale: float | None = None,
                   softcap: float | None = None, window=None) -> torch.Tensor:
    """Causal SDPA, [S, H, D] layout, f32 softmax. ``window``: query i
    attends keys j with i - window < j <= i (0 = full)."""
    s, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k, v = _gqa_expand(k, h), _gqa_expand(v, h)
    scores = torch.matmul(_heads_f32(q), _heads_f32(k).transpose(1, 2)) * scale
    scores = _apply_softcap(scores, softcap)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = j > i
    w = _window_or_inf(window)
    if w is not None:
        mask = mask | (j <= i - w)
    scores = torch.where(mask, torch.full_like(scores, _NEG_INF), scores)
    out = torch.matmul(torch.softmax(scores, dim=-1), _heads_f32(v))
    return out.permute(1, 0, 2).to(q.dtype)


def _full_attn(q, k, v, scale: float) -> torch.Tensor:
    """Unmasked softmax attention (k/v already expanded)."""
    scores = torch.matmul(_heads_f32(q), _heads_f32(k).transpose(1, 2)) * scale
    out = torch.matmul(torch.softmax(scores, dim=-1), _heads_f32(v))
    return out.permute(1, 0, 2).to(q.dtype)


def _kernel_scale(scale: float, d: int) -> bool:
    return np.float32(scale) == np.float32(1.0 / math.sqrt(d))


def flash_attention_fn(q, k, v, scale: float | None = None,
                       chunk_size: int = 512, causal: bool = True,
                       softcap: float | None = None, window=None) -> torch.Tensor:
    """Online-softmax attention, q [S, Hq, D], k/v [S, Hk, D] -> [S, Hq, D]
    (route in the module docstring). The plain chunked recurrence keeps the
    reference's f32 running max, sum and accumulator over key chunks of
    ``chunk_size``, keys padded to a chunk multiple and masked."""
    s, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if (q.is_cuda and softcap is None and window is None
            and _kernel_scale(scale, d)):
        return flash_attention(q, k, v, causal=causal)
    k, v = _gqa_expand(k, h), _gqa_expand(v, h)
    if s <= chunk_size:
        if causal:
            return sdpa_causal_fn(q, k, v, scale, softcap=softcap, window=window)
        return _full_attn(q, k, v, scale)

    pad = (-s) % chunk_size
    qh = _heads_f32(q)
    kh = torch.nn.functional.pad(_heads_f32(k), (0, 0, 0, pad))
    vh = torch.nn.functional.pad(_heads_f32(v), (0, 0, 0, pad))
    q_idx = torch.arange(s, device=q.device)[None, :, None]            # [1, S, 1]
    w_eff = _window_or_inf(window)
    m = torch.full((h, s, 1), _NEG_INF, dtype=_F32, device=q.device)
    l_sum = torch.zeros((h, s, 1), dtype=_F32, device=q.device)
    acc = torch.zeros((h, s, d), dtype=_F32, device=q.device)
    for c0 in range(0, s + pad, chunk_size):
        k_blk, v_blk = kh[:, c0:c0 + chunk_size], vh[:, c0:c0 + chunk_size]
        scores = torch.matmul(qh, k_blk.transpose(1, 2)) * scale
        scores = _apply_softcap(scores, softcap)
        kv_idx = c0 + torch.arange(chunk_size, device=q.device)[None, None, :]
        mask = kv_idx >= s
        if causal:
            mask = mask | (kv_idx > q_idx)
        if w_eff is not None:
            mask = mask | (kv_idx <= q_idx - w_eff)
        scores = torch.where(mask, torch.full_like(scores, _NEG_INF), scores)
        m_new = torch.maximum(m, torch.amax(scores, dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, v_blk)
        m = m_new
    out = acc / torch.clamp_min(l_sum, 1e-30)
    return out.permute(1, 0, 2).to(q.dtype)
