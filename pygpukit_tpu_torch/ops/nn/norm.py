"""Normalization (counterpart of ``pygpukit_tpu/ops/nn/norm.py``).
Reductions accumulate in f32 whatever the input dtype. ``*_fn`` work on
tensors inside the model; the wrappers take and return Arrays."""

from __future__ import annotations

import torch

from ...core.array import Array
from .._common import apply_op

_F32 = torch.float32


def rmsnorm_fn(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    xf = x.to(_F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.to(_F32)).to(x.dtype)


def layernorm_fn(x: torch.Tensor, weight: torch.Tensor, bias=None,
                 eps: float = 1e-5):
    xf = x.to(_F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * weight.to(_F32)
    if bias is not None:
        y = y + bias.to(_F32)
    return y.to(x.dtype)


def l2norm_fn(x: torch.Tensor, eps: float = 1e-12):
    """Parameterless L2 norm over the last dim (unit-vector scaling)."""
    xf = x.to(_F32)
    inv = torch.rsqrt(torch.sum(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype)


def qk_l2norm_fn(x: torch.Tensor, eps: float = 1e-6):
    """Parameterless RMS-style "L2 norm" over the last dim: the Llama-4
    QK norm (rsqrt of the MEAN of squares, transformers'
    Llama4TextL2Norm), not ``l2norm_fn``'s sum."""
    xf = x.to(_F32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype)


def groupnorm_fn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 num_groups: int, eps: float = 1e-5):
    """GroupNorm over the channel dim of NHWC x [N, H, W, C], C split into
    ``num_groups`` groups, statistics over H, W and the group's channels."""
    xf = x.to(_F32)
    n, h, w, cc = xf.shape
    xg = xf.reshape(n, h * w, num_groups, cc // num_groups)
    mu = torch.mean(xg, dim=(1, 3), keepdim=True)
    var = torch.mean((xg - mu) ** 2, dim=(1, 3), keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(n, h, w, cc)
    return (y * weight.to(_F32) + bias.to(_F32)).to(x.dtype)


def rmsnorm(x, weight, eps: float = 1e-6, *, out: Array | None = None) -> Array:
    return apply_op(lambda a, w: rmsnorm_fn(a, w, eps), x, weight, out=out)


def layernorm(x, weight, bias=None, eps: float = 1e-5, *,
              out: Array | None = None) -> Array:
    if bias is None:
        return apply_op(lambda a, w: layernorm_fn(a, w, None, eps), x, weight, out=out)
    return apply_op(lambda a, w, b: layernorm_fn(a, w, b, eps), x, weight, bias, out=out)


def l2norm(x, eps: float = 1e-12, *, out: Array | None = None) -> Array:
    return apply_op(lambda a: l2norm_fn(a, eps), x, out=out)


def groupnorm(x, weight, bias, num_groups: int, eps: float = 1e-5, *,
              out: Array | None = None) -> Array:
    return apply_op(lambda a, w, b: groupnorm_fn(a, w, b, num_groups, eps),
                    x, weight, bias, out=out)
