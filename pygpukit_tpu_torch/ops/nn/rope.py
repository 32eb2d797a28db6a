"""Rotary position embedding and its variants, PoPE and ALiBi (counterpart
of ``pygpukit_tpu/ops/nn/rope.py``).

Split-half (NeoX) rotation, the default:

  out[:half] = x[:half]*cos - x[half:]*sin
  out[half:] = x[half:]*cos + x[:half]*sin

Interleaved (even/odd pairs, GLM-4, Ernie 4.5, Llama-4) rotates x[2i] and
x[2i+1] by frequency i. Tables are [max_seq_len, head_dim] f32 with the
half-dim frequencies duplicated across the two halves (HF layout); both
rotations read the first half.

Tables: standard, NTK-aware, YaRN, Llama-3 (``rope_type: "llama3"``),
LongRoPE (Phi-3) and linear interpolation, each computed in f32 as the
reference computes it. ``rope_tables*`` return tensors on ``device`` (the
card unless the caller names one) for the model; ``rope_init*`` the same
tables as Arrays, the reference's public form.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core.array import Array, as_tensor
from ...core.backend import resolve_device
from ...core.numerics import true_div

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

def _rdiv(num: float, x: torch.Tensor) -> torch.Tensor:
    """``num / x`` as an IEEE division (torch's scalar-over-tensor form
    multiplies by the reciprocal)."""
    return torch.full_like(x, num) / x


def _tables_from_inv_freq(inv_freq: torch.Tensor, positions: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    angles = torch.outer(positions, inv_freq)                 # [S, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def _base_inv_freq(head_dim: int, base: float, device) -> torch.Tensor:
    """1 / base^(i / half) in f32, the base rounded to f32 first. The power
    is taken in f64 and rounded once: the reference's f32 ``pow`` rounds
    correctly, torch's f32 one may be an ulp off, and an ulp of a frequency
    moves the angle at position p by p ulps. Every division here and below
    is an IEEE one, as the reference's are."""
    half = head_dim // 2
    e = true_div(torch.arange(half, dtype=_F32, device=device), half)
    return _rdiv(1.0, (float(np.float32(base)) ** e.to(torch.float64)).to(_F32))


def _positions(max_seq_len: int, device) -> torch.Tensor:
    return torch.arange(max_seq_len, dtype=_F32, device=device)


def rope_tables(max_seq_len: int, head_dim: int, base: float = 10000.0,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Standard RoPE tables (cos, sin), each [max_seq_len, head_dim] f32, on
    ``device`` (the card unless the caller names one)."""
    device = resolve_device(device)
    return _tables_from_inv_freq(_base_inv_freq(head_dim, base, device),
                                 _positions(max_seq_len, device))


def rope_tables_ntk_aware(max_seq_len: int, head_dim: int, base: float = 10000.0,
                          scale: float = 1.0, device=None):
    """NTK-aware tables: the base scaled instead of the positions, base' =
    base * scale^(d / (d - 2))."""
    device = resolve_device(device)
    base_scaled = base * (scale ** (head_dim / max(head_dim - 2, 1)))
    return _tables_from_inv_freq(_base_inv_freq(head_dim, base_scaled, device),
                                 _positions(max_seq_len, device))


def _yarn_mscale(s: float, m: float = 1.0) -> float:
    return 1.0 if s <= 1 else 0.1 * m * math.log(s) + 1.0


def rope_tables_yarn(max_seq_len: int, head_dim: int, base: float = 10000.0,
                     scale: float = 1.0, original_max_len: int = 4096,
                     beta_fast: float = 32.0, beta_slow: float = 1.0,
                     mscale: float | None = None, mscale_all_dim: float | None = None,
                     attention_factor: float | None = None, truncate: bool = True,
                     device=None):
    """YaRN tables as transformers computes them (``_compute_yarn_parameters``):
    a ramp over dimension indices between the log-derived correction bounds
    blends interpolated (inv_freq / scale) and extrapolated frequencies,
    and the attention factor (from mscale and mscale_all_dim unless given)
    multiplies both tables."""
    device = resolve_device(device)
    if attention_factor is None:
        if mscale and mscale_all_dim:
            attention_factor = float(_yarn_mscale(scale, mscale)
                                     / _yarn_mscale(scale, mscale_all_dim))
        else:
            attention_factor = _yarn_mscale(scale)

    def corr_dim(rot):
        return (head_dim * math.log(original_max_len / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    low, high = corr_dim(beta_fast), corr_dim(beta_slow)
    if truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, head_dim - 1)
    if low == high:
        high += 0.001
    half = head_dim // 2
    ramp = torch.clamp(true_div(torch.arange(half, dtype=_F32, device=device) - low,
                                high - low), 0.0, 1.0)
    extrap = 1.0 - ramp
    inv_freq = _base_inv_freq(head_dim, base, device)
    interp = true_div(inv_freq, scale) * (1 - extrap) + inv_freq * extrap
    cos, sin = _tables_from_inv_freq(interp, _positions(max_seq_len, device))
    f = float(np.float32(attention_factor))
    return cos * f, sin * f


def rope_tables_llama3(max_seq_len: int, head_dim: int, base: float = 500000.0,
                       scale: float = 8.0, original_max_len: int = 8192,
                       low_freq_factor: float = 1.0, high_freq_factor: float = 4.0,
                       device=None):
    """Llama-3.1 frequency-dependent scaling (HF ``rope_type: "llama3"``,
    ``_compute_llama3_parameters``): wavelengths above ``original_max_len /
    low_freq_factor`` are interpolated by ``scale``, those under
    ``original_max_len / high_freq_factor`` kept, a smooth ramp between."""
    device = resolve_device(device)
    inv_freq = _base_inv_freq(head_dim, base, device)
    wavelen = _rdiv(2 * np.pi, inv_freq)
    low_w = original_max_len / low_freq_factor
    high_w = original_max_len / high_freq_factor
    smooth = torch.clamp(true_div(_rdiv(original_max_len, wavelen) - low_freq_factor,
                                  high_freq_factor - low_freq_factor), 0.0, 1.0)
    scaled = (1 - smooth) * true_div(inv_freq, scale) + smooth * inv_freq
    interp = torch.where(wavelen > low_w, true_div(inv_freq, scale),
                         torch.where(wavelen < high_w, inv_freq, scaled))
    return _tables_from_inv_freq(interp, _positions(max_seq_len, device))


def rope_tables_longrope(max_seq_len: int, head_dim: int, base: float, ext_factors,
                         attention_factor: float = 1.0, device=None):
    """LongRoPE (Phi-3, HF ``rope_type: "longrope"``): the inverse
    frequencies divided by ``ext_factors`` (the checkpoint's short_factor or
    long_factor list, head_dim / 2 of them), both tables multiplied by the
    attention factor."""
    device = resolve_device(device)
    ext = torch.as_tensor(np.asarray(ext_factors, np.float32), device=device)
    inv_freq = _base_inv_freq(head_dim, base, device) / ext
    cos, sin = _tables_from_inv_freq(inv_freq, _positions(max_seq_len, device))
    f = float(np.float32(attention_factor))
    return cos * f, sin * f


def rope_tables_linear(max_seq_len: int, head_dim: int, base: float = 10000.0,
                       scale: float = 1.0, device=None):
    """Linear position interpolation: position p rotates as p / scale."""
    device = resolve_device(device)
    return _tables_from_inv_freq(_base_inv_freq(head_dim, base, device),
                                 true_div(_positions(max_seq_len, device), scale))


def _arrays(tables) -> tuple[Array, Array]:
    return Array(tables[0]), Array(tables[1])


def rope_init(max_seq_len: int, head_dim: int, base: float = 10000.0,
              device=None) -> tuple[Array, Array]:
    """Standard RoPE tables as Arrays."""
    return _arrays(rope_tables(max_seq_len, head_dim, base, device))


def rope_init_ntk_aware(max_seq_len: int, head_dim: int, base: float = 10000.0,
                        scale: float = 1.0, device=None) -> tuple[Array, Array]:
    return _arrays(rope_tables_ntk_aware(max_seq_len, head_dim, base, scale, device))


def rope_init_yarn(max_seq_len: int, head_dim: int, base: float = 10000.0,
                   scale: float = 1.0, original_max_len: int = 4096,
                   beta_fast: float = 32.0, beta_slow: float = 1.0,
                   mscale: float | None = None, mscale_all_dim: float | None = None,
                   attention_factor: float | None = None, truncate: bool = True,
                   device=None) -> tuple[Array, Array]:
    return _arrays(rope_tables_yarn(max_seq_len, head_dim, base, scale, original_max_len,
                                    beta_fast, beta_slow, mscale, mscale_all_dim,
                                    attention_factor, truncate, device))


def rope_init_llama3(max_seq_len: int, head_dim: int, base: float = 500000.0,
                     scale: float = 8.0, original_max_len: int = 8192,
                     low_freq_factor: float = 1.0, high_freq_factor: float = 4.0,
                     device=None) -> tuple[Array, Array]:
    return _arrays(rope_tables_llama3(max_seq_len, head_dim, base, scale, original_max_len,
                                      low_freq_factor, high_freq_factor, device))


def rope_init_longrope(max_seq_len: int, head_dim: int, base: float, ext_factors,
                       attention_factor: float = 1.0, device=None) -> tuple[Array, Array]:
    return _arrays(rope_tables_longrope(max_seq_len, head_dim, base, ext_factors,
                                        attention_factor, device))


def rope_init_linear(max_seq_len: int, head_dim: int, base: float = 10000.0,
                     scale: float = 1.0, device=None) -> tuple[Array, Array]:
    return _arrays(rope_tables_linear(max_seq_len, head_dim, base, scale, device))


# ---------------------------------------------------------------------------
# Application
# ---------------------------------------------------------------------------

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


def apply_rope_interleaved_fn(x: torch.Tensor, cos: torch.Tensor,
                              sin: torch.Tensor) -> torch.Tensor:
    """Rotate the even/odd pairs of x [S, H, D] (pair i by frequency i) with
    tables [S, D] in the half-duplicated layout."""
    half = x.shape[-1] // 2
    c = cos[..., :half].unsqueeze(-2).to(_F32)
    s = sin[..., :half].unsqueeze(-2).to(_F32)
    xe = x[..., 0::2].to(_F32)
    xo = x[..., 1::2].to(_F32)
    oe = xe * c - xo * s
    oo = xe * s + xo * c
    return torch.stack([oe, oo], dim=-1).reshape(x.shape).to(x.dtype)


def _rotate_pair(q: Array, k: Array, c: torch.Tensor, s: torch.Tensor, fn) -> None:
    q._set_buffer(fn(q.torch, c, s))
    k._set_buffer(fn(k.torch, c, s))


def rope_inplace(q: Array, k: Array, cos, sin) -> None:
    """Rotate q [S, Hq, D] and k [S, Hk, D] by the tables' first S rows;
    rebinds both handles (the old tensors are not written)."""
    c, s = as_tensor(cos, q.device), as_tensor(sin, q.device)
    seq = q.shape[0]
    _rotate_pair(q, k, c[:seq], s[:seq], apply_rope_fn)


def rope_inplace_interleaved(q: Array, k: Array, cos, sin) -> None:
    """``rope_inplace`` with the even/odd pair rotation."""
    c, s = as_tensor(cos, q.device), as_tensor(sin, q.device)
    seq = q.shape[0]
    _rotate_pair(q, k, c[:seq], s[:seq], apply_rope_interleaved_fn)


def rope_inplace_f32table(q: Array, k: Array, cos, sin, start_pos: int = 0) -> None:
    """``rope_inplace`` with the rows from ``start_pos`` on (incremental
    decode)."""
    c, s = as_tensor(cos, q.device), as_tensor(sin, q.device)
    seq = q.shape[0]
    _rotate_pair(q, k, c[start_pos:start_pos + seq], s[start_pos:start_pos + seq],
                 apply_rope_fn)


# ---------------------------------------------------------------------------
# PoPE: an additive sinusoidal position encoding
# ---------------------------------------------------------------------------

def pope_init_encoding(max_seq_len: int, head_dim: int, base: float = 10000.0,
                       device=None) -> Array:
    """[max_seq_len, head_dim] f32: sin of each frequency at the even
    columns, cos at the odd ones."""
    device = resolve_device(device)
    angles = torch.outer(_positions(max_seq_len, device), _base_inv_freq(head_dim, base, device))
    enc = torch.zeros((max_seq_len, head_dim), dtype=_F32, device=device)
    enc[:, 0::2] = torch.sin(angles)
    enc[:, 1::2] = torch.cos(angles)
    return Array(enc)


def pope_inplace(q: Array, k: Array, encoding, start_pos: int = 0) -> None:
    """Add the encoding's rows from ``start_pos`` to q [S, Hq, D] and k [S,
    Hk, D] in f32 (rebinds both handles)."""
    e = as_tensor(encoding, q.device)
    seq = q.shape[0]
    e = e[start_pos:start_pos + seq][:, None, :]
    for a in (q, k):
        t = a.torch
        a._set_buffer((t.to(_F32) + e).to(t.dtype))


# ---------------------------------------------------------------------------
# ALiBi: a linear distance bias on the scores
# ---------------------------------------------------------------------------

def alibi_init_slopes(num_heads: int, device=None) -> Array:
    """Head h's slope 2^(-8 (h + 1) / H), f32."""
    device = resolve_device(device)
    h = torch.arange(num_heads, dtype=_F32, device=device)
    return Array(2.0 ** true_div(-8.0 * (h + 1), num_heads))


def alibi_bias_fn(seq_len: int, slopes: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """[H, S, S] f32 bias -slope * (i - j); keys after the query at -1e9
    when ``causal``."""
    i = torch.arange(seq_len, device=slopes.device)[:, None]
    j = torch.arange(seq_len, device=slopes.device)[None, :]
    bias = -slopes.to(_F32)[:, None, None] * (i - j).to(_F32)[None]
    if causal:
        bias = torch.where(j[None] > i[None], torch.full_like(bias, -1e9), bias)
    return bias


def alibi_compute_bias(seq_len: int, num_heads: int, slopes, causal: bool = True) -> Array:
    return Array(alibi_bias_fn(seq_len, as_tensor(slopes), causal))


def alibi_add_bias(scores: Array, slopes) -> Array:
    """scores [H, S, S] += -slope * (i - j) in f32, in place (rebinds the
    handle). The bias is not masked: the caller masks."""
    t = scores.torch
    bias = alibi_bias_fn(t.shape[-1], as_tensor(slopes, t.device), causal=False)
    scores._set_buffer((t.to(_F32) + bias).to(t.dtype))
    return scores
