"""Per-slot KV row writes for the batch-rows decode step (port of
``pygpukit_tpu/kernels/kv_row_write.py``).

Writes one K row and one V row per slot, in place, into layer ``layer`` of
the merged ``[B, L, MAX, Hk*D]`` pools at positions ``poss`` clamped to
``[0, MAX-1]`` (where ``lax.dynamic_update_slice`` clamps in the XLA write
the TPU kernel replaced). CUDA tensors launch ``csrc/kv_row_write.cu``
(bf16 pools); CPU tensors take the plain version, which also covers f32,
fp8 (clamped) and int8 ``{"q", "s"}`` pools.
"""

from __future__ import annotations

import torch

from ..ops.embedding import kv_leaf, kv_quant_rows, to_kv_dtype
from ._build import launch, require_on, stream_of


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
    if isinstance(k_pool, dict) or k_pool.dtype != torch.bfloat16 \
            or v_pool.dtype != torch.bfloat16:
        raise NotImplementedError("the CUDA row write takes bf16 pools")
    require_on(leaf.device, v_pool=v_pool, k_new=k_new, v_new=v_new)
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous")
    b, n_layers, max_len = k_pool.shape[:3]
    row = k_pool[0, 0, 0].numel()
    kr = k_new.reshape(b, row).to(torch.bfloat16).contiguous()
    vr = v_new.reshape(b, row).to(torch.bfloat16).contiguous()
    p = poss.to(device=leaf.device, dtype=torch.int32).contiguous()
    launch("kv_rows_write", "pgk_kv_rows_write", kr.data_ptr(), vr.data_ptr(),
           k_pool.data_ptr(), v_pool.data_ptr(), p.data_ptr(), b, int(layer),
           n_layers, max_len, row, stream_of(leaf))
