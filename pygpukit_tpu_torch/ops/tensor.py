"""Tensor layout ops: transposes, casts, concat, repeat, pad (counterpart of
``pygpukit_tpu/ops/tensor.py``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.array import Array
from ..core.dtypes import to_dtype
from ._common import apply_op, finish, promote


def transpose_2d(a, *, out: Array | None = None) -> Array:
    return apply_op(lambda x: x.transpose(0, 1), a, out=out)


def transpose_3d_021(a, *, out: Array | None = None) -> Array:
    return apply_op(lambda x: x.permute(0, 2, 1), a, out=out)


def transpose_3d_102(a, *, out: Array | None = None) -> Array:
    return apply_op(lambda x: x.permute(1, 0, 2), a, out=out)


def transpose_4d_0213(a, *, out: Array | None = None) -> Array:
    return apply_op(lambda x: x.permute(0, 2, 1, 3), a, out=out)


def transpose_4d_0231(a, *, out: Array | None = None) -> Array:
    return apply_op(lambda x: x.permute(0, 2, 3, 1), a, out=out)


def reshape_copy(a, shape, *, out: Array | None = None) -> Array:
    return apply_op(lambda x: x.reshape(shape), a, out=out)


def cast(a, dtype, *, out: Array | None = None) -> Array:
    d = to_dtype(dtype)
    return apply_op(lambda x: x.to(d.torch_dtype), a, out=out)


def cast_f32_to_bf16(a, *, out: Array | None = None) -> Array:
    return cast(a, "bfloat16", out=out)


def cast_bf16_to_f32(a, *, out: Array | None = None) -> Array:
    return cast(a, "float32", out=out)


def cast_f32_to_f16(a, *, out: Array | None = None) -> Array:
    return cast(a, "float16", out=out)


def concat(arrays, axis: int = 0, *, out: Array | None = None) -> Array:
    """Concatenate along ``axis``, operands promoted to one dtype."""
    return finish(torch.cat(promote(*arrays), dim=axis), out)


def repeat(a, repeats: int, axis: int = 0, *, out: Array | None = None) -> Array:
    return apply_op(lambda x: torch.repeat_interleave(x, repeats, dim=axis), a, out=out)


def _pad(x: torch.Tensor, pad_width, value) -> torch.Tensor:
    widths = np.broadcast_to(np.asarray(pad_width, dtype=np.int64), (x.dim(), 2))
    flat = [int(w) for before_after in widths[::-1] for w in before_after]
    return F.pad(x, flat, value=value)


def pad(a, pad_width, value=0.0, *, out: Array | None = None) -> Array:
    """numpy-style ``pad_width`` (an int, a pair, or a pair per axis),
    constant ``value`` cast to a's dtype."""
    return apply_op(lambda x: _pad(x, pad_width, value), a, out=out)
