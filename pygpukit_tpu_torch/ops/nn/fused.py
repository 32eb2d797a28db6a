"""Fused ops (counterpart of ``pygpukit_tpu/ops/nn/fused.py``): the
residual add before an RMS norm, a biased product before GELU, and the
gated activations. Plain tensor code, as the reference's are plain jnp
expressions; the intermediates are f32."""

from __future__ import annotations

import torch

from ...core.array import Array
from ...kernels.gemm import xla_dot
from .._common import apply_op, tensors
from .activation import geglu, gelu_fn, swiglu  # noqa: F401 (the reference's names)
from .norm import rmsnorm_fn

_F32 = torch.float32


def rmsnorm_residual_fn(x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor,
                        eps: float = 1e-6):
    """h = x + residual (an f32 sum rounded to x's dtype); y = rmsnorm(h,
    weight). Returns (y, h)."""
    h = (x.to(_F32) + residual.to(_F32)).to(x.dtype)
    return rmsnorm_fn(h, weight, eps), h


def linear_bias_gelu_fn(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """gelu(x @ w + b): an f32 product plus the bias in f32, the tanh GELU,
    x's dtype out."""
    y = xla_dot(x, w, _F32) + b.to(_F32)
    return gelu_fn(y).to(x.dtype)


def rmsnorm_residual(x, residual, weight, eps: float = 1e-6,
                     *, out: Array | None = None) -> tuple[Array, Array]:
    y, h = rmsnorm_residual_fn(*tensors(x, residual, weight), eps)
    if out is not None:
        out._set_buffer(y.to(out.dtype.torch_dtype))
        return out, Array(h)
    return Array(y), Array(h)


def linear_bias_gelu(x, w, b, *, out: Array | None = None) -> Array:
    return apply_op(linear_bias_gelu_fn, x, w, b, out=out)
