"""Activations (counterpart of ``pygpukit_tpu/ops/nn/activation.py``).
``*_fn`` work on tensors; the wrappers take and return Arrays."""

from __future__ import annotations

import math

import torch

from ...core.array import Array
from .._common import apply_op

_F32 = torch.float32
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu_fn(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    xf = x.to(_F32)
    if approximate:                     # tanh approximation (GPT-2)
        y = 0.5 * xf * (1.0 + torch.tanh(
            _SQRT_2_OVER_PI * (xf + 0.044715 * xf ** 3)))
    else:
        y = 0.5 * xf * (1.0 + torch.erf(xf / math.sqrt(2.0)))
    return y.to(x.dtype)


def silu_fn(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(_F32)
    return (xf / (1.0 + torch.exp(-xf))).to(x.dtype)


def relu_fn(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def relu2_fn(x: torch.Tensor) -> torch.Tensor:
    r = torch.clamp_min(x.to(_F32), 0)
    return (r * r).to(x.dtype)


def swiglu_fn(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up, computed in f32."""
    gf = gate.to(_F32)
    return ((gf / (1.0 + torch.exp(-gf))) * up.to(_F32)).to(gate.dtype)


def geglu_fn(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return (gelu_fn(gate).to(_F32) * up.to(_F32)).to(gate.dtype)


def gelu(x, approximate: bool = True, *, out: Array | None = None) -> Array:
    return apply_op(lambda a: gelu_fn(a, approximate), x, out=out)


def silu(x, *, out: Array | None = None) -> Array:
    return apply_op(silu_fn, x, out=out)


def relu(x, *, out: Array | None = None) -> Array:
    return apply_op(relu_fn, x, out=out)


def relu2(x, *, out: Array | None = None) -> Array:
    return apply_op(relu2_fn, x, out=out)


def swiglu(gate, up, *, out: Array | None = None) -> Array:
    return apply_op(swiglu_fn, gate, up, out=out)


def geglu(gate, up, *, out: Array | None = None) -> Array:
    return apply_op(geglu_fn, gate, up, out=out)
