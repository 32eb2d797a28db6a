"""Activations (counterpart of ``pygpukit_tpu/ops/nn/activation.py``)."""

from __future__ import annotations

import math

import torch

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


def swiglu_fn(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up, computed in f32."""
    gf = gate.to(_F32)
    return ((gf / (1.0 + torch.exp(-gf))) * up.to(_F32)).to(gate.dtype)
