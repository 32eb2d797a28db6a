"""NumPy-like device array: a handle over one ``torch.Tensor`` (counterpart
of ``pygpukit_tpu/core/array.py``).

The reference's buffers are immutable ``jax.Array``s and its "in-place"
ops rebind the handle. This handle keeps that contract: ``out=``,
``fill_`` and the in-place rope rebind it to a new tensor and never write
into the old one, so a view taken earlier (``reshape``, ``T``, ``narrow``,
indexing) never changes. Results follow the reference's dtypes, which are
JAX's with 64-bit types off: a 64-bit tensor becomes 32-bit when an Array
takes it (``core.dtypes.canonical_dtype``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import dtypes as _dt
from .backend import resolve_device
from .host import tensor_from_numpy, tensor_to_numpy


def _canonical(t: torch.Tensor) -> torch.Tensor:
    d = _dt.canonical_dtype(t.dtype)
    return t if d == t.dtype else t.to(d)


class Array:
    """Device array handle. Shape and dtype are fixed; the tensor can be
    rebound."""

    __slots__ = ("_t",)

    def __init__(self, t: torch.Tensor):
        self._t = _canonical(t)

    # -- construction helpers ------------------------------------------------

    @staticmethod
    def from_torch(t: torch.Tensor) -> "Array":
        return Array(t)

    @staticmethod
    def from_numpy(arr: np.ndarray, dtype=None, device=None) -> "Array":
        """A copy of ``arr`` on ``device`` (the card unless the caller names
        one), converted to ``dtype`` (default: arr's, 64-bit -> 32-bit)."""
        dev = resolve_device(device)
        arr = np.asarray(arr)
        d = _dt.to_dtype(dtype if dtype is not None else arr.dtype)
        d = _dt.to_dtype(_dt.canonical_dtype(d.torch_dtype))
        if d.np_dtype is not None:
            return Array(tensor_from_numpy(np.asarray(arr, dtype=d.np_dtype), dev))
        return Array(tensor_from_numpy(arr, dev).to(d.torch_dtype))

    # -- core properties -----------------------------------------------------

    @property
    def torch(self) -> torch.Tensor:
        """The underlying tensor (current buffer)."""
        return self._t

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self._t.shape)

    @property
    def dtype(self) -> _dt.DataType:
        return _dt.to_dtype(self._t.dtype)

    @property
    def ndim(self) -> int:
        return self._t.dim()

    @property
    def size(self) -> int:
        return self._t.numel()

    @property
    def itemsize(self) -> float:
        return self.dtype.itemsize

    @property
    def nbytes(self) -> int:
        return int(self.size * self.dtype.itemsize)

    @property
    def device(self) -> torch.device:
        return self._t.device

    # -- buffer rebinding (the reference's "in-place" mechanism) --------------

    def _set_buffer(self, t: torch.Tensor) -> None:
        if tuple(t.shape) != tuple(self._t.shape):
            raise ValueError(
                f"buffer rebind shape mismatch: {tuple(t.shape)} != {self.shape}")
        self._t = _canonical(t)

    # -- host transfer -------------------------------------------------------

    def to_numpy(self) -> np.ndarray:
        return tensor_to_numpy(self._t)

    def item(self):
        return self.to_numpy().item()

    def block_until_ready(self) -> "Array":
        if self._t.is_cuda:
            torch.cuda.synchronize(self._t.device)
        return self

    # -- shape ops (views: nothing writes into a tensor an Array holds) ------

    def reshape(self, *shape) -> "Array":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return Array(self._t.reshape(shape))

    def view(self, *shape) -> "Array":
        return self.reshape(*shape)

    def ravel(self) -> "Array":
        return Array(self._t.reshape(-1))

    def transpose(self, *axes) -> "Array":
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return Array(self._t.permute(axes or tuple(reversed(range(self.ndim)))))

    @property
    def T(self) -> "Array":
        return self.transpose()

    def narrow(self, dim: int, start: int, length: int) -> "Array":
        """Contiguous slice along one dimension."""
        return Array(self._t.narrow(dim, start, length))

    def slice_rows(self, start: int, end: int) -> "Array":
        return Array(self._t[start:end])

    def squeeze(self, axis=None) -> "Array":
        if axis is None:
            return Array(self._t.squeeze())
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        for a in axes:
            if self._t.shape[a] != 1:
                raise ValueError(f"cannot squeeze axis {a} of size {self._t.shape[a]}")
        return Array(self._t.squeeze(axes))

    def astype(self, dtype) -> "Array":
        return Array(self._t.to(_dt.to_dtype(dtype).torch_dtype))

    def copy(self) -> "Array":
        return Array(self._t.clone())

    def fill_(self, value) -> "Array":
        self._t = torch.full_like(self._t, value)
        return self

    def __getitem__(self, idx) -> "Array":
        if isinstance(idx, Array):
            idx = idx.torch
        elif isinstance(idx, tuple):
            idx = tuple(i.torch if isinstance(i, Array) else i for i in idx)
        if isinstance(idx, torch.Tensor) and idx.dtype != torch.bool:
            idx = idx.long()
        return Array(self._t[idx])

    # -- reductions (numpy-style methods; the ops layer's semantics) ----------

    def sum(self, axis=None, keepdims: bool = False) -> "Array":
        from ..ops.reduction import sum as _sum
        return _sum(self, axis, keepdims)

    def mean(self, axis=None, keepdims: bool = False) -> "Array":
        from ..ops.reduction import mean
        return mean(self, axis, keepdims)

    def max(self, axis=None, keepdims: bool = False) -> "Array":
        from ..ops.reduction import max as _max
        return _max(self, axis, keepdims)

    def min(self, axis=None, keepdims: bool = False) -> "Array":
        from ..ops.reduction import min as _min
        return _min(self, axis, keepdims)

    def argmax(self, axis=None) -> "Array":
        from ..ops.reduction import argmax
        return argmax(self, axis)

    # -- operator overloads (the ops layer's promotion rules) ----------------

    def _binop(self, other, fn, reflected: bool = False) -> "Array":
        from ..ops._common import binary
        return binary(fn, other, self) if reflected else binary(fn, self, other)

    def __add__(self, other):
        return self._binop(other, torch.add)

    def __radd__(self, other):
        return self._binop(other, torch.add, True)

    def __sub__(self, other):
        return self._binop(other, torch.sub)

    def __rsub__(self, other):
        return self._binop(other, torch.sub, True)

    def __mul__(self, other):
        return self._binop(other, torch.mul)

    def __rmul__(self, other):
        return self._binop(other, torch.mul, True)

    def __truediv__(self, other):
        return self._binop(other, torch.true_divide)

    def __rtruediv__(self, other):
        return self._binop(other, torch.true_divide, True)

    def __neg__(self):
        return Array(torch.neg(self._t))

    def __matmul__(self, other):
        from ..ops.matmul import matmul
        return matmul(self, other)

    def __eq__(self, other: Any):  # elementwise, like numpy
        return self._binop(other, torch.eq)

    def __ne__(self, other: Any):
        return self._binop(other, torch.ne)

    def __lt__(self, other):
        return self._binop(other, torch.lt)

    def __le__(self, other):
        return self._binop(other, torch.le)

    def __gt__(self, other):
        return self._binop(other, torch.gt)

    def __ge__(self, other):
        return self._binop(other, torch.ge)

    def __hash__(self):
        return id(self)

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of 0-d array")
        return self.shape[0]

    def __repr__(self) -> str:
        return f"Array(shape={self.shape}, dtype={self.dtype.name})"


def as_tensor(x, device=None) -> torch.Tensor:
    """Coerce Array / tensor / numpy / scalar into a tensor (the reference's
    ``as_jax``). numpy arrays and scalars land on ``device``, the card
    unless the caller names one; Arrays and tensors stay where they are."""
    if isinstance(x, Array):
        return x.torch
    if isinstance(x, torch.Tensor):
        return _canonical(x)
    if isinstance(x, (np.ndarray, np.generic)):
        return Array.from_numpy(x, device=device).torch
    if isinstance(x, (bool, int, float)):
        return Array.from_numpy(np.asarray(x), device=device).torch
    raise TypeError(f"cannot make a tensor of {type(x).__name__}")


def wrap(x) -> Array:
    """Wrap a tensor into an Array handle."""
    if isinstance(x, Array):
        return x
    return Array(as_tensor(x))
