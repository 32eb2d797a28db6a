"""Carry a reference parameter tree across to the port.

``params_from_jax`` takes the reference package's param pytree with its
leaves as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns
the same nested dict of torch tensors on ``device``, bytes unchanged:
stacked ``[L, ...]`` leaves, ``{"q_packed", "scale"}``, ``{"q_packed",
"scale_block"}`` and ``{"q", "scale"}`` dicts, rope tables. numpy's bf16 and fp8 (ml_dtypes) have no
``torch.from_numpy`` route, so those leaves cross as same-width unsigned
integers and are reinterpreted in torch.
"""

from __future__ import annotations

import numpy as np
import torch

#: ml_dtypes name -> (same-width numpy carrier, torch dtype)
_BIT_CARRIERS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, getattr(torch, "float8_e4m3fn", None)),
    "float8_e5m2": (np.uint8, getattr(torch, "float8_e5m2", None)),
}


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One numpy array (or numpy scalar) -> a tensor with identical bytes."""
    a = np.array(a, order="C")         # a writable copy torch may own
    carrier = _BIT_CARRIERS.get(a.dtype.name)
    if carrier is not None:
        np_dt, torch_dt = carrier
        if torch_dt is None:
            raise TypeError(f"this torch build has no {a.dtype.name}")
        t = torch.from_numpy(a.view(np_dt)).view(torch_dt)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def _drop_split_scales(leaf: dict) -> dict:
    """An int4_block dict of a built reference model carries ``scale_lo``
    and ``scale_hi``, the two halves of ``scale_block`` along K/B (the
    reference's ``prepare_block_scales``). In torch a half is a free view,
    so the port keeps ``scale_block`` alone: the two leaves are checked to
    equal its halves and dropped. ValueError when they differ."""
    leaf = dict(leaf)
    lo, hi = leaf.pop("scale_lo"), leaf.pop("scale_hi")
    s = np.asarray(leaf["scale_block"])
    half = s.shape[-2] // 2
    for name, part, ref in (("scale_lo", lo, s[..., :half, :]),
                            ("scale_hi", hi, s[..., half:, :])):
        part = np.asarray(part)
        if part.shape != ref.shape or part.tobytes() != ref.tobytes():
            raise ValueError(f"{name} is not the matching half of scale_block")
    return leaf


def params_from_jax(tree, device=None):
    """A reference param tree of numpy leaves -> the port's tensors.
    ``None`` leaves (a tied head) stay ``None``; int4_block dicts lose
    their ``scale_lo``/``scale_hi`` copies (see ``_drop_split_scales``)."""
    if isinstance(tree, dict):
        if "scale_block" in tree and "scale_lo" in tree:
            tree = _drop_split_scales(tree)
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return tensor_from_numpy(tree, device)
