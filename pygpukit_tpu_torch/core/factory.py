"""Array constructors (counterpart of ``pygpukit_tpu/core/factory.py``).

Every constructor places its Array on ``device``: the card unless the caller
names one (RuntimeError without a card; ``device="cpu"`` for the CPU).
``zeros_like`` and ``ones_like`` default to their argument's device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dtypes as _dt
from .array import Array
from .backend import resolve_device


def _resolve(dtype) -> torch.dtype:
    return _dt.to_dtype(dtype if dtype is not None else _dt.float32).torch_dtype


def zeros(shape, dtype=None, device=None) -> Array:
    return Array(torch.zeros(shape, dtype=_resolve(dtype), device=resolve_device(device)))


def ones(shape, dtype=None, device=None) -> Array:
    return Array(torch.ones(shape, dtype=_resolve(dtype), device=resolve_device(device)))


def full(shape, fill_value, dtype=None, device=None) -> Array:
    return Array(torch.full(shape, fill_value, dtype=_resolve(dtype),
                            device=resolve_device(device)))


def empty(shape, dtype=None, device=None) -> Array:
    """Zeros, as the reference's ``empty`` gives (XLA has no uninitialised
    allocation)."""
    return zeros(shape, dtype, device)


def arange(*args, dtype=None, device=None) -> Array:
    """``numpy.arange(*args, dtype=dtype)`` with dtype default int32 (the
    reference's; float bounds then count in steps cast to int32)."""
    d = _dt.to_dtype(dtype if dtype is not None else _dt.int32)
    return Array.from_numpy(np.arange(*args, dtype=d.np_dtype), device=device)


def from_numpy(arr: np.ndarray, dtype=None, device=None) -> Array:
    return Array.from_numpy(np.asarray(arr), dtype, device)


def zeros_like(a: Array, device=None) -> Array:
    return zeros(a.shape, a.dtype, device if device is not None else a.device)


def ones_like(a: Array, device=None) -> Array:
    return ones(a.shape, a.dtype, device if device is not None else a.device)


def randn(*shape, dtype=None, seed: int = 0, device=None) -> Array:
    """Standard normal f32 draws from a ``torch.Generator`` seeded with
    ``seed``, cast to ``dtype``. The values differ from the reference's
    ``jax.random.normal``; the same seed on the same device replays them."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    return Array(x.to(_resolve(dtype)))
