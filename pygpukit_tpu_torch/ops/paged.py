"""Paged KV cache and paged attention, the library API beside the engine
(port of ``pygpukit_tpu/ops/paged.py``).

The pool is a fixed ``[num_blocks, block_size, Hk, D]`` buffer per layer;
per-sequence block tables map positions to blocks. ``paged_attention_fn``
is the gather formulation in plain PyTorch; ``paged_attention_dispatch``
runs the ``paged_attention`` kernel on CUDA tensors (pools transposed to the
kernel's ``[NB, Hk, BS, D]`` per call, as the reference's Pallas wrapper
transposes) and the gather formulation on CPU tensors. Pools are updated in
place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.backend import resolve_device
from ..kernels.paged_attention import paged_attention, paged_attention_plain
from .embedding import to_kv_dtype


def reshape_and_cache_fn(k_pool, v_pool, k_new, v_new, slot_mapping):
    """Write new K/V rows [T, Hk, D] into pool slots, in place; slot =
    block_id * block_size + offset. Returns the pools."""
    nb, bs, hk, d = k_pool.shape
    slots = torch.as_tensor(slot_mapping, device=k_pool.device).to(torch.long)
    k_pool.view(nb * bs, hk, d)[slots] = to_kv_dtype(k_new, k_pool.dtype)
    v_pool.view(nb * bs, hk, d)[slots] = to_kv_dtype(v_new, v_pool.dtype)
    return k_pool, v_pool


def _as_batch(q, k_pool, v_pool, block_tables, ctx_lens, contiguous=False):
    """The kernel wrapper's arguments for queries [B, Hq, D] over pools
    [NB, BS, Hk, D]: the pools as [NB, Hk, BS, D] (a view, or a copy for the
    kernel), tables [B, MB] and lengths [B] on the pools' device, and the
    reference's scale 1/sqrt(D)."""
    dev = k_pool.device
    kt, vt = k_pool.transpose(1, 2), v_pool.transpose(1, 2)
    if contiguous:
        kt, vt = kt.contiguous(), vt.contiguous()
    tables = torch.as_tensor(block_tables, device=dev).reshape(q.shape[0], -1)
    lens = torch.as_tensor(ctx_lens, device=dev).reshape(q.shape[0])
    return q, kt, vt, tables, lens, 1.0 / math.sqrt(q.shape[-1])


def paged_attention_fn(q, k_pool, v_pool, block_table, ctx_len):
    """Decode attention over paged KV: q [Hq, D] (one query), pools
    [NB, BS, Hk, D], block_table [max_blocks] int (padded with any valid
    id), ctx_len an int or scalar tensor. The gather formulation in plain
    PyTorch on any device: f32 softmax, scale 1/sqrt(D)."""
    return paged_attention_plain(*_as_batch(q[None], k_pool, v_pool,
                                            block_table, ctx_len))[0]


def paged_attention_dispatch(q, k_pool, v_pool, block_table, ctx_len):
    """``paged_attention_fn`` with the kernel behind it: CUDA tensors launch
    the ``paged_attention`` kernel on pools transposed per call (always; no
    fallback), CPU tensors run the gather formulation."""
    return paged_attention(*_as_batch(q[None], k_pool, v_pool, block_table,
                                      ctx_len, contiguous=k_pool.is_cuda))[0]


def paged_attention_batch_fn(q, k_pool, v_pool, block_tables, ctx_lens):
    """q [B, Hq, D], block_tables [B, max_blocks], ctx_lens [B] ->
    [B, Hq, D]. Pools are shared across the batch."""
    return paged_attention_plain(*_as_batch(q, k_pool, v_pool, block_tables,
                                            ctx_lens))


@dataclass
class PagedKVCache:
    """Block-table allocator and device pools ``[L, NB, BS, Hk, D]``.

    Host-side free-list allocation; the pools are written in place by
    ``reshape_and_cache_fn``. ``device`` None places them on the card."""

    num_blocks: int
    block_size: int
    num_kv_heads: int
    head_dim: int
    num_layers: int = 1
    dtype: torch.dtype = torch.bfloat16
    device: torch.device | str | None = None
    k_pool: torch.Tensor | None = None
    v_pool: torch.Tensor | None = None
    _free: list = field(default_factory=list)
    _tables: dict = field(default_factory=dict)   # seq_id -> list[block_id]
    _lens: dict = field(default_factory=dict)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        shape = (self.num_layers, self.num_blocks, self.block_size,
                 self.num_kv_heads, self.head_dim)
        self.k_pool = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self._free = list(range(self.num_blocks - 1, -1, -1))

    # -- allocation ----------------------------------------------------------

    def allocate(self, seq_id: int) -> None:
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        self._tables[seq_id] = []
        self._lens[seq_id] = 0

    def free(self, seq_id: int) -> None:
        blocks = self._tables.pop(seq_id, [])
        self._free.extend(reversed(blocks))
        self._lens.pop(seq_id, None)

    def _ensure_capacity(self, seq_id: int, new_len: int) -> None:
        table = self._tables[seq_id]
        needed = -(-new_len // self.block_size)
        while len(table) < needed:
            if not self._free:
                raise MemoryError("paged KV pool exhausted")
            table.append(self._free.pop())

    def slot_mapping(self, seq_id: int, n_tokens: int) -> np.ndarray:
        """Flat pool slots for the next n_tokens of this sequence."""
        start = self._lens[seq_id]
        self._ensure_capacity(seq_id, start + n_tokens)
        table = self._tables[seq_id]
        pos = np.arange(start, start + n_tokens)
        blocks = np.asarray(table)[pos // self.block_size]
        return (blocks * self.block_size + pos % self.block_size).astype(np.int32)

    def append(self, seq_id: int, layer: int, k_new, v_new) -> None:
        """Write T new tokens' KV for one layer; advances the length on the
        last layer."""
        t = k_new.shape[0]
        reshape_and_cache_fn(self.k_pool[layer], self.v_pool[layer], k_new,
                             v_new, self.slot_mapping(seq_id, t))
        if layer == self.num_layers - 1:
            self._lens[seq_id] += t

    def block_table(self, seq_id: int, max_blocks: int | None = None
                    ) -> np.ndarray:
        table = self._tables[seq_id]
        mb = max_blocks or self.num_blocks
        out = np.zeros(mb, np.int32)
        out[:len(table)] = table
        return out

    def context_len(self, seq_id: int) -> int:
        return self._lens[seq_id]

    def attention(self, seq_id: int, layer: int, q) -> torch.Tensor:
        """Single-query paged attention for one sequence and layer."""
        bt = self.block_table(seq_id, max_blocks=max(len(self._tables[seq_id]), 1))
        return paged_attention_dispatch(q, self.k_pool[layer], self.v_pool[layer],
                                        bt, self._lens[seq_id])

    def stats(self) -> dict:
        return {
            "num_blocks": self.num_blocks,
            "free_blocks": len(self._free),
            "sequences": len(self._tables),
            "used_blocks": self.num_blocks - len(self._free),
        }
