"""Reductions (counterpart of ``pygpukit_tpu/ops/reduction.py``).

Result dtypes are the reference's: ``sum`` of bool, int8, int16 and int32
is int32 and of unsigned types uint32 (integer sums wrap mod 2^32); ``mean``
of an integer is f32; ``argmax``/``argmin`` are int32; ``cumsum`` keeps its
operand's type (bool -> int32). bf16 and f16 sums and means run in f32 and
round once, as ``jnp.sum``/``jnp.mean`` upcast them; a bf16 or f16
``cumsum`` does too, where the reference's XLA scan rounds its partial sums
to bf16 (a few ulps apart at the tail of a long axis).
"""

from __future__ import annotations

import torch

from ..core.array import Array
from ._common import apply_op

_F32 = torch.float32
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def _dims(x: torch.Tensor, axis) -> tuple[int, ...]:
    if axis is None:
        return tuple(range(x.dim()))
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in the type its sum accumulates in: int64 for integers and bool,
    f32 for bf16 and f16."""
    if not x.is_floating_point():
        return x.to(torch.int64)
    return x.to(_F32) if x.element_size() < 4 else x


def sum_fn(x: torch.Tensor, axis=None, keepdims: bool = False) -> torch.Tensor:
    if x.is_floating_point():
        out = x.dtype
    else:
        out = torch.uint32 if x.dtype in _UNSIGNED else torch.int32
    return torch.sum(_wide(x), dim=_dims(x, axis), keepdim=keepdims).to(out)


def mean_fn(x: torch.Tensor, axis=None, keepdims: bool = False) -> torch.Tensor:
    out = x.dtype if x.is_floating_point() else _F32
    xf = x if x.dtype == _F32 else x.to(_F32)
    return torch.mean(xf, dim=_dims(x, axis), keepdim=keepdims).to(out)


def sum(a, axis=None, keepdims: bool = False, *, out: Array | None = None) -> Array:  # noqa: A001
    return apply_op(lambda x: sum_fn(x, axis, keepdims), a, out=out)


def mean(a, axis=None, keepdims: bool = False, *, out: Array | None = None) -> Array:
    return apply_op(lambda x: mean_fn(x, axis, keepdims), a, out=out)


def max(a, axis=None, keepdims: bool = False, *, out: Array | None = None) -> Array:  # noqa: A001
    return apply_op(lambda x: torch.amax(x, dim=_dims(x, axis), keepdim=keepdims),
                    a, out=out)


def min(a, axis=None, keepdims: bool = False, *, out: Array | None = None) -> Array:  # noqa: A001
    return apply_op(lambda x: torch.amin(x, dim=_dims(x, axis), keepdim=keepdims),
                    a, out=out)


def _arg(fn, x: torch.Tensor, axis) -> torch.Tensor:
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return fn(x, dim=axis).to(torch.int32)


def argmax(a, axis=None, *, out: Array | None = None) -> Array:
    return apply_op(lambda x: _arg(torch.argmax, x, axis), a, out=out)


def argmin(a, axis=None, *, out: Array | None = None) -> Array:
    return apply_op(lambda x: _arg(torch.argmin, x, axis), a, out=out)


def sum_axis(a, axis: int, *, out: Array | None = None) -> Array:
    return sum(a, axis=axis, out=out)


def softmax(a, axis: int = -1, *, out: Array | None = None) -> Array:
    def _softmax(x):
        m = torch.amax(x, dim=axis, keepdim=True)
        e = torch.exp(x - m)
        return e / sum_fn(e, axis, True)
    return apply_op(_softmax, a, out=out)


def log_softmax(a, axis: int = -1, *, out: Array | None = None) -> Array:
    def _lsm(x):
        s = x - torch.amax(x, dim=axis, keepdim=True)
        return s - torch.log(sum_fn(torch.exp(s), axis, True))
    return apply_op(_lsm, a, out=out)


def cumsum(a, axis: int = -1, *, out: Array | None = None) -> Array:
    def _cumsum(x):
        out_dt = torch.int32 if x.dtype == torch.bool else x.dtype
        return torch.cumsum(_wide(x), dim=axis).to(out_dt)
    return apply_op(_cumsum, a, out=out)
