"""Carry a reference parameter tree across to the port.

``params_from_jax`` takes the reference package's param pytree with its
leaves as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns
the same nested dict of torch tensors, bytes unchanged: stacked ``[L,
...]`` leaves, ``{"q_packed", "scale"}``, ``{"q_packed", "scale_block"}``
and ``{"q", "scale"}`` dicts, rope tables, the per-layer lists of Mamba's and
LFM2's trees and 0-d leaves (Llama-4's per-layer ``use_rope``, kept 0-d).
bf16 and fp8 leaves cross through
``core.host.tensor_from_numpy``'s same-width integer carriers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.host import tensor_from_numpy


def _drop_split_scales(leaf: dict) -> dict:
    """An int4_block dict (numpy or torch leaves) of a built reference
    model carries ``scale_lo`` and ``scale_hi``, the two halves of
    ``scale_block`` along K/B (the
    reference's ``prepare_block_scales``). In torch a half is a free view,
    so the port keeps ``scale_block`` alone: the two leaves are checked to
    equal its halves and dropped. ValueError when they differ."""
    leaf = dict(leaf)
    lo, hi = leaf.pop("scale_lo"), leaf.pop("scale_hi")
    s = leaf["scale_block"]
    half = s.shape[-2] // 2
    for name, part, ref in (("scale_lo", lo, s[..., :half, :]),
                            ("scale_hi", hi, s[..., half:, :])):
        if tuple(part.shape) != tuple(ref.shape) or _bytes(part) != _bytes(ref):
            raise ValueError(f"{name} is not the matching half of scale_block")
    return leaf


def _bytes(a) -> bytes:
    """The bytes of a numpy array or a tensor, C order."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def params_from_jax(tree, device=None):
    """A reference param tree of numpy leaves -> the port's tensors, a
    byte-exact conversion: the tensors stay where numpy had them (the CPU)
    unless ``device`` is given. ``None`` leaves (a tied head) stay
    ``None``; lists and tuples map element by element (a list stays a
    list); int4_block dicts lose their ``scale_lo``/``scale_hi`` copies
    (see ``_drop_split_scales``)."""
    if isinstance(tree, dict):
        if "scale_block" in tree and "scale_lo" in tree:
            tree = _drop_split_scales(tree)
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    if tree is None:
        return None
    return tensor_from_numpy(tree, device)
