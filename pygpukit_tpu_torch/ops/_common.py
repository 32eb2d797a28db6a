"""Shared plumbing for the ops layer (counterpart of
``pygpukit_tpu/ops/_common.py``).

Every public op validates, computes on tensors and either returns a new
``Array`` or rebinds a caller-provided ``out=`` Array to the result (cast to
out's dtype; the old tensor is never written). Ops accept ``Array``,
``torch.Tensor``, ``np.ndarray`` or Python scalars.

Result dtypes are the reference's, which runs JAX with 64-bit types off.
``promote`` computes them: tensors of any rank (0-d included, as JAX's
arrays are never weakly typed) promote by ``torch.promote_types``; Python
scalars are weak and keep the tensors' type within its kind (``bf16 + 2.0``
is bf16, ``int32 + 2.5`` is f32); 64-bit results become 32-bit.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.array import Array, as_tensor
from ..core.dtypes import canonical_dtype

_SCALARS = (bool, int, float)


def _device_of(args) -> torch.device | None:
    for a in args:
        if isinstance(a, Array):
            return a.device
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def tensors(*args) -> list:
    """Arrays, tensors and numpy arrays as tensors on the first operand's
    device; Python scalars stay scalars."""
    dev = _device_of(args)
    return [a if isinstance(a, _SCALARS) else as_tensor(a, dev) for a in args]


def result_dtype(*args) -> torch.dtype:
    """The reference's result dtype of an elementwise op over ``args``
    (tensors and Python scalars; see the module docstring)."""
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    if not ts:                       # scalars alone: bool < int32 < f32
        ts = [torch.tensor(args[0])]
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    for s in args:
        if isinstance(s, _SCALARS):
            dt = torch.result_type(torch.empty((1,), dtype=dt), s)
    return canonical_dtype(dt)


def promote(*args) -> list[torch.Tensor]:
    """``args`` as tensors of their common result dtype on one device
    (scalars become 0-d tensors there)."""
    ts = tensors(*args)
    dt = result_dtype(*ts)
    dev = _device_of(ts) or torch.device("cpu")
    return [torch.tensor(a, dtype=dt, device=dev) if isinstance(a, _SCALARS)
            else a.to(dt) for a in ts]


def finish(res: torch.Tensor, out: Array | None = None) -> Array:
    """A new Array of ``res``, or ``out`` rebound to ``res`` in out's dtype."""
    if out is None:
        return Array(res)
    if not isinstance(out, Array):
        raise TypeError("out= must be an Array")
    if tuple(res.shape) != out.shape:
        raise ValueError(f"out shape {out.shape} != result shape {tuple(res.shape)}")
    out._set_buffer(res.to(out.dtype.torch_dtype))
    return out


def apply_op(fn: Callable, *args, out: Array | None = None) -> Array:
    """``fn`` over the operands as tensors (scalars passed through)."""
    return finish(fn(*tensors(*args)), out)


def binary(fn: Callable, a, b, out: Array | None = None) -> Array:
    """An elementwise ``fn(a, b)`` on operands promoted to their result
    dtype."""
    return finish(fn(*promote(a, b)), out)


def check_same_shape(a, b, op_name: str) -> None:
    sa, sb = tuple(np.shape(a) if np.isscalar(a) else a.shape), \
        tuple(np.shape(b) if np.isscalar(b) else b.shape)
    if sa != sb:
        # numpy-style broadcasting, as the reference allows
        try:
            np.broadcast_shapes(sa, sb)
        except ValueError:
            raise ValueError(f"{op_name}: incompatible shapes {sa} vs {sb}") from None
