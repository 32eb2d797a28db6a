"""Host transfers with identical bytes: numpy <-> torch.

numpy's bf16 and fp8 (the ``ml_dtypes`` types the reference package uses)
have no ``torch.from_numpy`` route, so those arrays cross as same-width
unsigned integers and are reinterpreted on the other side. ``ml_dtypes`` is
optional: without it bf16 and fp8 tensors cannot become numpy arrays, and
no numpy array of those types can exist to convert.
"""

from __future__ import annotations

import numpy as np
import torch

#: ml_dtypes name -> (same-width numpy carrier, torch dtype)
BIT_CARRIERS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, getattr(torch, "float8_e4m3fn", None)),
    "float8_e5m2": (np.uint8, getattr(torch, "float8_e5m2", None)),
}
_TORCH_TO_ML = {torch_dt: name for name, (_, torch_dt) in BIT_CARRIERS.items()
                if torch_dt is not None}


def ml_dtypes_module():
    """The ``ml_dtypes`` module, or None where it is not installed."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return ml_dtypes


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One numpy array (or numpy scalar) -> a tensor with identical bytes,
    on ``device`` when one is given, else where numpy had it (the CPU)."""
    a = np.array(a, order="C")         # a writable copy torch may own
    carrier = BIT_CARRIERS.get(a.dtype.name)
    if carrier is not None:
        np_dt, torch_dt = carrier
        if torch_dt is None:
            raise TypeError(f"this torch build has no {a.dtype.name}")
        t = torch.from_numpy(a.view(np_dt)).view(torch_dt)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor -> a numpy array with identical bytes; bf16 and fp8 become
    ``ml_dtypes`` arrays (TypeError without ``ml_dtypes``)."""
    t = t.detach().cpu()
    name = _TORCH_TO_ML.get(t.dtype)
    if name is None:
        return t.numpy()
    ml = ml_dtypes_module()
    if ml is None:
        raise TypeError(f"a {t.dtype} tensor needs ml_dtypes to become a numpy array")
    carrier = BIT_CARRIERS[name][0]
    return t.contiguous().view(torch.uint16 if carrier == np.uint16
                               else torch.uint8).numpy().view(getattr(ml, name))
