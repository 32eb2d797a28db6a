"""Normalization (counterpart of ``pygpukit_tpu/ops/nn/norm.py``).
Reductions accumulate in f32 whatever the input dtype."""

from __future__ import annotations

import torch

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
