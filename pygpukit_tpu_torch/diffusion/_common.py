"""Pieces the diffusion stack shares: JAX's type promotion for products,
the reference's activations and its f32 softmax attention.

``jnp.dot`` of an f32 activation and a bf16 weight is an f32 product
(both operands promoted to their common type); ``torch.matmul`` refuses
mixed dtypes, so ``dot`` promotes first, by ``torch.promote_types``, and
never casts an activation down.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_F32 = torch.float32


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(x, w)``: both operands in their promoted dtype."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def linear(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """x @ p[name.w] + p[name.b]."""
    return dot(x, p[f"{name}.w"]) + p[f"{name}.b"]


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def layer(stacked: dict, i: int) -> dict:
    """Layer i's leaves of a stacked ``[L, ...]`` tree (views)."""
    return {k: v[i] for k, v in stacked.items()}


def attention_heads(qh, kh, vh, scale: bool = True, bias=None, mask=None):
    """Softmax attention over [H, S, D] heads in f32: scores / sqrt(D) (or
    unscaled), plus ``bias``, ``mask`` True hiding a key (-1e30) -> [H, S, D]."""
    scores = torch.matmul(qh.to(_F32), kh.to(_F32).transpose(-1, -2))
    if scale:
        scores = scores / math.sqrt(qh.shape[-1])
    if bias is not None:
        scores = scores + bias
    if mask is not None:
        scores = torch.where(mask, -1e30, scores)
    return torch.matmul(torch.softmax(scores, dim=-1), vh.to(_F32))


def ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine in f32, the population variance, back in
    x's dtype."""
    xf = x.to(_F32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def tensor_on(x, device, dtype=None) -> torch.Tensor:
    """A numpy array, number or tensor as a tensor on ``device`` (in
    ``dtype`` when given)."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.as_tensor(a if a.flags.writeable else a.copy())
    return x.to(device=device, dtype=dtype or x.dtype)
