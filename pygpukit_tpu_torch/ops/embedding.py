"""Embedding lookup and KV-cache storage ops (counterpart of
``pygpukit_tpu/ops/embedding.py``).

Caches are preallocated tensors updated in place. The serving pools are
always merged ``[B, L, MAX, Hk*D]`` (contiguous, so the per-layer and
per-slot views are free); an int8 cache is a dict ``{"q": int8[shape],
"s": bf16[shape[:-1]]}`` carrying one scale per written row.
"""

from __future__ import annotations

import torch

from ..core.array import Array
from ..core.backend import resolve_device
from ..core.dtypes import FP8_MAX
from ..core.numerics import true_div
from ._common import apply_op, tensors

_F32 = torch.float32


def to_kv_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast to the cache storage dtype; fp8 targets clamp to the format's
    finite range first (out-of-range casts are NaN, not saturating)."""
    m = FP8_MAX.get(dtype)
    if m is not None and x.dtype != dtype:
        x = torch.clamp(x.to(_F32), -m, m)
    return x.to(dtype)


def embedding_lookup_fn(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [V, E] at integer ``ids`` (any shape)."""
    return table[ids.to(torch.long)]


def embedding_lookup(table, ids, *, out: Array | None = None) -> Array:
    """Rows of ``table`` [V, E] at ``ids`` (any shape)."""
    tt, ti = tensors(table, ids)
    return apply_op(lambda t: embedding_lookup_fn(t, ti), tt, out=out)


embedding_lookup_batch = embedding_lookup


def kv_compute_dtype(cache_dtype: torch.dtype) -> torch.dtype:
    """The dtype attention runs the cache operands in: fp8 and int8
    storage is dequantized to bf16 at the read, any other is its own."""
    if cache_dtype in FP8_MAX or cache_dtype == torch.int8:
        return torch.bfloat16
    return cache_dtype


def kv_cache_zeros(shape, dtype: torch.dtype, device=None, merged: bool = False):
    """A zeroed cache on ``device`` (the card unless the caller names one):
    a tensor, or for int8 storage the ``{"q", "s"}`` dict with one scale per
    row. ``merged``: the minor dim is ``Hk*D`` (the serving pools); else
    the minor dims are ``[Hk, D]`` (the single-stream ``[L, MAX, Hk, D]``
    caches) and a row's scale covers both."""
    device = resolve_device(device)
    if dtype != torch.int8:
        return torch.zeros(shape, dtype=dtype, device=device)
    rows = tuple(shape[:-1] if merged else shape[:-2])
    return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
            "s": torch.zeros(rows, dtype=torch.bfloat16, device=device)}


def kv_leaf(cache):
    """The storage leaf carrying the cache's shape (dict-safe)."""
    return cache["q"] if isinstance(cache, dict) else cache


def kv_quant_rows(new: torch.Tensor, n_red: int):
    """(int8 rows, bf16 row scales), amax over the last ``n_red`` dims.
    Quantizes against the bf16-rounded scale so quant and dequant use the
    identical value; rounds half to even like the reference."""
    f = new.to(_F32)
    dims = tuple(range(new.ndim - n_red, new.ndim))
    amax = torch.amax(torch.abs(f), dim=dims)
    s = torch.clamp_min(true_div(amax, 127.0), 1e-8).to(torch.bfloat16)
    sf = s.to(_F32).reshape(s.shape + (1,) * n_red)
    q = torch.clamp(torch.round(f / sf), -127, 127).to(torch.int8)
    return q, s


def kv_dequant(blk_q: torch.Tensor, blk_s: torch.Tensor) -> torch.Tensor:
    """bf16 view of an int8 cache block: q * per-row scale."""
    n_red = blk_q.ndim - blk_s.ndim
    return blk_q.to(torch.bfloat16) * blk_s.reshape(blk_s.shape + (1,) * n_red)


def kv_write(cache, new: torch.Tensor, start: tuple):
    """Write ``new`` into ``cache`` at ``start`` in place, converting to the
    storage dtype (int8 dicts quantize per row). Starts clamp into range
    as ``lax.dynamic_update_slice`` clamps. One start may be a one-element
    integer tensor on the cache's device (the decode position): that axis
    is written by an index copy at the clamped start, and the host never
    reads it. Returns the cache."""
    leaf = kv_leaf(cache)
    dyn = [a for a, s in enumerate(start) if isinstance(s, torch.Tensor)]
    if len(dyn) > 1:
        raise ValueError(f"kv_write takes one tensor start, got {len(dyn)}")
    idx = tuple(slice(None) if a in dyn else
                slice(min(max(int(s), 0), dim - n), min(max(int(s), 0), dim - n) + n)
                for a, (s, dim, n) in enumerate(zip(start, leaf.shape, new.shape)))
    if dyn:
        a = dyn[0]
        at = torch.clamp(start[a].reshape(()).to(torch.long), 0,
                         leaf.shape[a] - new.shape[a])
        rows = at + torch.arange(new.shape[a], device=leaf.device)

        def put(view, src):
            if view.dtype in FP8_MAX:       # index_copy_ takes no fp8: copy the bytes
                view, src = view.view(torch.uint8), src.view(torch.uint8)
            view.index_copy_(a, rows, src)
    else:
        def put(view, src):
            view[...] = src
    if isinstance(cache, dict):
        q, s = kv_quant_rows(new, leaf.ndim - cache["s"].ndim)
        put(cache["q"][idx], q)
        put(cache["s"][idx[:cache["s"].ndim]], s)
    else:
        put(cache[idx], to_kv_dtype(new, cache.dtype))
    return cache


def kv_cache_update_fn(k_cache, v_cache, k_new: torch.Tensor, v_new: torch.Tensor, pos):
    """Write k_new/v_new [T, Hk, D] into the [MAX, Hk, D] caches at
    position ``pos`` (an int or a one-element device tensor), in place.
    Returns (k_cache, v_cache)."""
    return kv_write(k_cache, k_new, (pos, 0, 0)), kv_write(v_cache, v_new, (pos, 0, 0))


def kv_cache_prefill_fn(k_cache, v_cache, k_new: torch.Tensor, v_new: torch.Tensor):
    """``kv_cache_update_fn`` at position 0."""
    return kv_cache_update_fn(k_cache, v_cache, k_new, v_new, 0)


def kv_cache_update(k_cache: Array, v_cache: Array, k_new, v_new, pos) -> None:
    """The Array-handle update: the rows written into the handles' tensors
    in place (the reference rebinds its handles to the updated buffers)."""
    kt, vt, kn, vn = tensors(k_cache, v_cache, k_new, v_new)
    kv_cache_update_fn(kt, vt, kn, vn, pos)


kv_cache_update_gqa = kv_cache_update


def kv_cache_prefill(k_cache: Array, v_cache: Array, k_new, v_new) -> None:
    kv_cache_update(k_cache, v_cache, k_new, v_new, 0)


kv_cache_prefill_gqa = kv_cache_prefill
