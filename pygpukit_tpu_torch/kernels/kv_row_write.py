"""Per-slot KV row writes for the batch-rows decode step (port of
``pygpukit_tpu/kernels/kv_row_write.py``).

Writes one K row and one V row per slot, in place, into layer ``layer`` of
the merged ``[B, L, MAX, Hk*D]`` pools at positions ``poss`` clamped to
``[0, MAX-1]`` (where ``lax.dynamic_update_slice`` clamps in the XLA write
the TPU kernel replaced), converted to the pools' storage: bf16, f32, fp8
(clamped) or int8 ``{"q", "s"}`` (quantized per row). CUDA tensors launch
``csrc/kv_row_write.cu``, bitwise the plain version; CPU tensors take the
plain version.

The batch-rows decode step writes and then attends: :func:`kv_write_attention`
is the two, the write bitwise :func:`kv_rows_write`'s and the attention
``batch_decode_attention``'s. On CUDA pools it is one launch: the rows are
stored by the attention's own pass one (``csrc/batch_decode_attention.cu``,
counted under ``kv_rows_write_fused``), and ``csrc/kv_row_write.cu`` does
not run.
"""

from __future__ import annotations

import math

import torch

from ..ops.embedding import kv_leaf, kv_quant_rows, to_kv_dtype
from ._build import launch, require_on, stream_of
from .batch_decode_attention import (batch_decode_attention_plain, kernel_leaves,
                                     launch_batch_decode_attention, ptr_or_null,
                                     storage_kinds)


def kv_rows_write_plain(k_pool, v_pool, k_new: torch.Tensor,
                        v_new: torch.Tensor, layer: int,
                        poss: torch.Tensor) -> None:
    b = k_new.shape[0]
    max_len = kv_leaf(k_pool).shape[2]
    slots = torch.arange(b, device=poss.device)
    pos = torch.clamp(poss.to(torch.long), 0, max_len - 1)
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        rows = new.reshape(b, -1)
        if isinstance(pool, dict):
            q, s = kv_quant_rows(rows, 1)
            pool["q"][slots, layer, pos] = q
            pool["s"][slots, layer, pos] = s
        else:
            pool[slots, layer, pos] = to_kv_dtype(rows, pool.dtype)


def kv_rows_write(k_pool, v_pool, k_new: torch.Tensor, v_new: torch.Tensor,
                  layer: int, poss: torch.Tensor) -> None:
    """Write k_new/v_new [B, Hk, D] at per-slot positions ``poss`` [B]
    into layer ``layer`` of the pools, in place."""
    leaf = kv_leaf(k_pool)
    if not leaf.is_cuda:
        return kv_rows_write_plain(k_pool, v_pool, k_new, v_new, layer, poss)
    kr, vr, p = _write_operands(k_pool, k_new, v_new, poss)
    _launch_write(k_pool, v_pool, kr, vr, layer, p)


def _write_operands(k_pool, k_new, v_new, poss):
    """(k rows, v rows [B, Hk*D] contiguous, poss int32) for a CUDA write."""
    leaf = kv_leaf(k_pool)
    if k_new.dtype not in (torch.bfloat16, torch.float32) or v_new.dtype != k_new.dtype:
        raise NotImplementedError(f"the CUDA row write takes bf16 or f32 rows "
                                  f"(got {k_new.dtype}, {v_new.dtype})")
    require_on(leaf.device, k_new=k_new, v_new=v_new)
    b = k_new.shape[0]
    if poss.numel() != b:
        raise ValueError(f"poss holds {poss.numel()} positions for {b} slots")
    return (k_new.reshape(b, -1).contiguous(), v_new.reshape(b, -1).contiguous(),
            poss.to(device=leaf.device, dtype=torch.int32).contiguous())


def _launch_write(k_pool, v_pool, kr, vr, layer: int, p) -> None:
    new_kind, pool_kind = storage_kinds(kr, k_pool, v_pool)
    kq, ks = kernel_leaves(k_pool, "k_pool")
    vq, vs = kernel_leaves(v_pool, "v_pool")
    require_on(kv_leaf(k_pool).device, v_pool=vq)
    if kq.ndim != 4 or kq.shape != vq.shape:
        raise ValueError("pools must be merged [B, L, MAX, Hk*D] of one shape")
    b, n_layers, max_len, row = kq.shape
    if ks is not None and ks.shape != kq.shape[:3]:
        raise ValueError("int8 row scales must be [B, L, MAX]")
    if kr.shape != (b, row) or vr.shape != (b, row):
        raise ValueError(f"new rows {tuple(kr.shape)} do not fit pools of rows "
                         f"[{b}, {row}]")
    launch("kv_rows_write", "pgk_kv_rows_write", kr.data_ptr(), vr.data_ptr(),
           kq.data_ptr(), vq.data_ptr(), ptr_or_null(ks), ptr_or_null(vs),
           p.data_ptr(), b, int(layer), n_layers, max_len, row, new_kind, pool_kind,
           stream_of(kq))


def kv_write_attention(q: torch.Tensor, k_pool, v_pool, k_new: torch.Tensor,
                       v_new: torch.Tensor, layer: int, poss: torch.Tensor,
                       ctx_lens: torch.Tensor, scale: float | None = None,
                       softcap: float | None = None,
                       window: int | None = None) -> torch.Tensor:
    """:func:`kv_rows_write` of k_new/v_new [B, Hk, D] at ``poss``, then
    ``batch_decode_attention`` of q [B, 1, Hq, D] over ``ctx_lens``: the
    pools and the output are those two calls' bits. CPU pools take the two
    plain versions; CUDA pools one launch of the attention kernel, whose
    pass one stores the rows first (k_new and v_new in q's dtype)."""
    b, t, hq, d = q.shape
    if t != 1:
        raise ValueError("kv_write_attention takes one query per slot")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if not kv_leaf(k_pool).is_cuda:
        kv_rows_write_plain(k_pool, v_pool, k_new, v_new, layer, poss)
        return batch_decode_attention_plain(q, k_pool, v_pool, layer, ctx_lens, scale,
                                            softcap, window)
    kr, vr, p = _write_operands(k_pool, k_new, v_new, poss)
    if kr.dtype != q.dtype:
        raise NotImplementedError(f"the fused row write takes rows in the query's "
                                  f"dtype (got {kr.dtype} rows, {q.dtype} queries)")
    if kr.shape != (b, kv_leaf(k_pool).shape[-1]) or vr.shape != kr.shape:
        raise ValueError(f"new rows {tuple(kr.shape)} do not fit the pools")
    return launch_batch_decode_attention(q, k_pool, v_pool, layer, ctx_lens, scale,
                                         softcap, window, write=(kr, vr, p))
