"""Per-slot KV row writes for the batch-rows decode step (port of
``pygpukit_tpu/kernels/kv_row_write.py``).

Writes one K row and one V row per slot, in place, into layer ``layer`` of
the merged ``[B, L, MAX, Hk*D]`` pools at positions ``poss`` clamped to
``[0, MAX-1]`` (where ``lax.dynamic_update_slice`` clamps in the XLA write
the TPU kernel replaced), converted to the pools' storage: bf16, f32, fp8
(clamped) or int8 ``{"q", "s"}`` (quantized per row). CUDA tensors launch
``csrc/kv_row_write.cu``, bitwise the plain version; CPU tensors take the
plain version.
"""

from __future__ import annotations

import torch

from ..ops.embedding import kv_leaf, kv_quant_rows, to_kv_dtype
from ._build import launch, require_on, stream_of
from .batch_decode_attention import kernel_leaves, ptr_or_null, storage_kinds


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
    if k_new.dtype not in (torch.bfloat16, torch.float32) or v_new.dtype != k_new.dtype:
        raise NotImplementedError(f"the CUDA row write takes bf16 or f32 rows "
                                  f"(got {k_new.dtype}, {v_new.dtype})")
    new_kind, pool_kind = storage_kinds(k_new, k_pool, v_pool)
    kq, ks = kernel_leaves(k_pool, "k_pool")
    vq, vs = kernel_leaves(v_pool, "v_pool")
    require_on(leaf.device, v_pool=vq, k_new=k_new, v_new=v_new)
    if kq.ndim != 4 or kq.shape != vq.shape:
        raise ValueError("pools must be merged [B, L, MAX, Hk*D] of one shape")
    b, n_layers, max_len, row = kq.shape
    if ks is not None and ks.shape != kq.shape[:3]:
        raise ValueError("int8 row scales must be [B, L, MAX]")
    kr = k_new.reshape(b, row).contiguous()
    vr = v_new.reshape(b, row).contiguous()
    p = poss.to(device=leaf.device, dtype=torch.int32).contiguous()
    launch("kv_rows_write", "pgk_kv_rows_write", kr.data_ptr(), vr.data_ptr(),
           kq.data_ptr(), vq.data_ptr(), ptr_or_null(ks), ptr_or_null(vs),
           p.data_ptr(), b, int(layer), n_layers, max_len, row, new_kind, pool_kind,
           stream_of(leaf))
