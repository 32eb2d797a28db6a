"""Elementwise binary ops (counterpart of ``pygpukit_tpu/ops/elementwise.py``).
Operands promote to the reference's result dtype (``_common.promote``)."""

from __future__ import annotations

import torch

from ..core.array import Array
from ._common import binary, check_same_shape, finish, promote, tensors


def add(a, b, *, out: Array | None = None) -> Array:
    check_same_shape(a, b, "add")
    return binary(torch.add, a, b, out)


def sub(a, b, *, out: Array | None = None) -> Array:
    check_same_shape(a, b, "sub")
    return binary(torch.sub, a, b, out)


def mul(a, b, *, out: Array | None = None) -> Array:
    check_same_shape(a, b, "mul")
    return binary(torch.mul, a, b, out)


def div(a, b, *, out: Array | None = None) -> Array:
    """True division: int / int is f32, as in the reference."""
    check_same_shape(a, b, "div")
    return binary(torch.true_divide, a, b, out)


def maximum(a, b, *, out: Array | None = None) -> Array:
    return binary(torch.maximum, a, b, out)


def minimum(a, b, *, out: Array | None = None) -> Array:
    return binary(torch.minimum, a, b, out)


def pow(a, b, *, out: Array | None = None) -> Array:  # noqa: A001
    return binary(torch.pow, a, b, out)


def _clip(x, lo, hi):
    if lo is not None:
        x = torch.maximum(*promote(x, lo))
    if hi is not None:
        x = torch.minimum(*promote(x, hi))
    return x


def clamp(a, min_val=None, max_val=None, *, out: Array | None = None) -> Array:
    return finish(_clip(tensors(a)[0], min_val, max_val), out)


def where(cond, a, b, *, out: Array | None = None) -> Array:
    c, x, y = tensors(cond, a, b)
    x, y = promote(x, y)
    return finish(torch.where(c if isinstance(c, torch.Tensor) and c.dtype == torch.bool
                              else torch.as_tensor(c, device=x.device) != 0, x, y), out)


def add_scaled(a, b, alpha: float, *, out: Array | None = None) -> Array:
    """a + alpha * b (axpy)."""
    return binary(torch.add, a, binary(torch.mul, alpha, b).torch, out)
