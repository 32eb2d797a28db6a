"""Rotary position embedding, split-half (NeoX) convention (counterpart of
``pygpukit_tpu/ops/nn/rope.py``; the interleaved and scaled variants come
with the model families that need them).

  out[:half] = x[:half]*cos - x[half:]*sin
  out[half:] = x[half:]*cos + x[:half]*sin

Tables are [max_seq_len, head_dim] f32 with the half-dim frequencies
duplicated across the two halves (HF layout); apply reads the first half.
``rope_tables`` makes them as tensors for the model, ``rope_init`` as
Arrays, the reference's public form.
"""

from __future__ import annotations

import torch

from ...core.array import Array, as_tensor
from ...core.backend import resolve_device

_F32 = torch.float32


def rope_tables(max_seq_len: int, head_dim: int, base: float = 10000.0,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Standard RoPE tables (cos, sin), each [max_seq_len, head_dim] f32, on
    ``device`` (the card unless the caller names one)."""
    device = resolve_device(device)
    half = head_dim // 2
    inv_freq = 1.0 / (base ** (torch.arange(half, dtype=_F32, device=device)
                                / half))
    pos = torch.arange(max_seq_len, dtype=_F32, device=device)
    angles = torch.outer(pos, inv_freq)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def rope_init(max_seq_len: int, head_dim: int, base: float = 10000.0,
              device=None) -> tuple[Array, Array]:
    """Standard RoPE tables as Arrays."""
    cos, sin = rope_tables(max_seq_len, head_dim, base, device)
    return Array(cos), Array(sin)


def apply_rope_fn(x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> torch.Tensor:
    """Rotate x [S, H, D] with per-row tables [S, D] (rows broadcast over
    the heads axis)."""
    half = x.shape[-1] // 2
    c = cos[..., :half].unsqueeze(-2)
    s = sin[..., :half].unsqueeze(-2)
    xf0 = x[..., :half].to(_F32)
    xf1 = x[..., half:].to(_F32)
    r0 = xf0 * c - xf1 * s
    r1 = xf1 * c + xf0 * s
    return torch.cat([r0, r1], dim=-1).to(x.dtype)


def rope_inplace(q: Array, k: Array, cos, sin) -> None:
    """Rotate q [S, Hq, D] and k [S, Hk, D] by the tables' first S rows;
    rebinds both handles (the old tensors are not written)."""
    c, s = as_tensor(cos, q.device), as_tensor(sin, q.device)
    seq = q.shape[0]
    q._set_buffer(apply_rope_fn(q.torch, c[:seq], s[:seq]))
    k._set_buffer(apply_rope_fn(k.torch, c[:seq], s[:seq]))
