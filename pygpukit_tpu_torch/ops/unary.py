"""Unary math ops (counterpart of ``pygpukit_tpu/ops/unary.py``).

Transcendental ops take integer and bool operands to f32, as the reference
does; ``floor``, ``ceil`` and ``round`` are the identity on integers,
``abs``, ``neg`` and ``sign`` keep the integer type, and ``rsqrt`` and
``sigmoid`` round each step as the reference composes them.
"""

from __future__ import annotations

import torch

from ..core.array import Array
from ._common import apply_op


def _to_float(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.to(torch.float32)


def _make(fn, to_float: bool = True):
    def op(a, *, out: Array | None = None) -> Array:
        return apply_op(lambda x: fn(_to_float(x) if to_float else x), a, out=out)
    return op


def _keep_int(fn):
    """An op the reference leaves as the identity on integers and bool."""
    return lambda x: fn(x) if x.is_floating_point() else x


exp = _make(torch.exp)
log = _make(torch.log)
sin = _make(torch.sin)
cos = _make(torch.cos)
tan = _make(torch.tan)
tanh = _make(torch.tanh)
sqrt = _make(torch.sqrt)
rsqrt = _make(lambda x: torch.reciprocal(torch.sqrt(x)))
abs = _make(lambda x: x if x.dtype == torch.bool else torch.abs(x),  # noqa: A001
            to_float=False)
neg = _make(torch.neg, to_float=False)
reciprocal = _make(torch.reciprocal)
floor = _make(_keep_int(torch.floor), to_float=False)
ceil = _make(_keep_int(torch.ceil), to_float=False)
round = _make(_keep_int(torch.round), to_float=False)  # noqa: A001
sign = _make(torch.sign, to_float=False)
log2 = _make(torch.log2)
expm1 = _make(torch.expm1)
log1p = _make(torch.log1p)
sigmoid = _make(lambda x: torch.reciprocal(1 + torch.exp(-x)))
erf = _make(torch.erf)
