"""Memory pool: quota, size-class reuse, LRU eviction, stats (counterpart
of ``pygpukit_tpu/memory/pool.py``).

The pool keeps *logical* budget blocks: the card's memory belongs to
torch's caching allocator, and the pool is the accounting and reuse
policy the scheduler bills against. Blocks may also own real host staging
memory (``host_backed=True``), which ``host_buffer`` exposes.

Two routes make the same decisions (same block ids, reuses, evictions and
stats for the same calls): the native pool (``native/src/pool.cpp``,
through ``_native``) and a pure-Python copy of its rules. A free block
goes onto its size class's list, and an allocation of that class takes
the most recently freed one. When the quota is short, the free block least
recently used (freed, or allocated) is evicted first, across all classes.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import numpy as np

from .._native import PkPoolStats, select_native

SIZE_CLASSES = [256 << i for i in range(21)]  # 256 B .. 256 MB


def _size_class(size: int) -> int:
    for c in SIZE_CLASSES:
        if size <= c:
            return c
    return SIZE_CLASSES[-1]


@dataclass
class PoolStats:
    quota_bytes: int = 0
    used_bytes: int = 0
    peak_bytes: int = 0
    allocations: int = 0
    frees: int = 0
    reuses: int = 0
    evictions: int = 0
    failures: int = 0
    free_list_bytes: int = 0


class MemoryBlock:
    __slots__ = ("block_id", "size", "pool")

    def __init__(self, block_id: int, size: int, pool: "MemoryPool"):
        self.block_id = block_id
        self.size = size
        self.pool = pool

    def free(self) -> None:
        self.pool.free(self)


class _Block:
    __slots__ = ("size", "in_use", "tick", "host")

    def __init__(self, size: int, tick: int, host):
        self.size, self.in_use, self.tick, self.host = size, True, tick, host


class MemoryPool:
    """Quota'd pool with size-class free lists and LRU eviction (module
    docstring). ``use_native``: None takes the native pool when it loads,
    True requires it, False takes the Python route."""

    def __init__(self, quota_bytes: int = 8 << 30, use_native: bool | None = None):
        self._native = select_native(use_native, "pool")
        self._handle = None
        if self._native is not None:
            self._handle = self._native.pk_pool_create(quota_bytes)
            return
        self._lock = threading.Lock()
        self._quota = quota_bytes
        self._used = 0
        self._free_bytes = 0
        self._next = 1
        self._tick = 0
        self._blocks: dict[int, _Block] = {}
        self._free: dict[int, list[int]] = {}      # class -> ids, most recent last
        self._stats = PoolStats(quota_bytes=quota_bytes)

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def alloc(self, size: int, host_backed: bool = False) -> MemoryBlock:
        """A block of ``size`` rounded up to its class; MemoryError past
        the quota."""
        if self._handle is not None:
            bid = self._native.pk_pool_alloc(self._handle, size, 1 if host_backed else 0)
            if bid == 0:
                raise MemoryError(f"pool quota exceeded allocating {size}B")
            return MemoryBlock(bid, _size_class(size), self)
        cls = _size_class(size)
        with self._lock:
            ids = self._free.get(cls)
            if ids:
                bid = ids.pop()
                blk = self._blocks[bid]
                blk.in_use = True
                blk.tick = self._next_tick()
                self._free_bytes -= cls
                self._used += cls
                self._stats.reuses += 1
                self._stats.allocations += 1
                self._bump()
                return MemoryBlock(bid, cls, self)
            while self._used + self._free_bytes + cls > self._quota and self._free_bytes > 0:
                self._evict_one()
            if self._used + cls > self._quota:
                self._stats.failures += 1
                raise MemoryError(f"pool quota exceeded allocating {size}B")
            bid = self._next
            self._next += 1
            host = np.zeros(cls, np.uint8) if host_backed else None
            self._blocks[bid] = _Block(cls, self._next_tick(), host)
            self._used += cls
            self._stats.allocations += 1
            self._bump()
            return MemoryBlock(bid, cls, self)

    def free(self, block: MemoryBlock) -> None:
        """Park the block on its class's free list (a freed or evicted
        block is left alone)."""
        if self._handle is not None:
            self._native.pk_pool_free(self._handle, block.block_id)
            return
        with self._lock:
            blk = self._blocks.get(block.block_id)
            if blk is None or not blk.in_use:
                return
            blk.in_use = False
            blk.tick = self._next_tick()
            self._used -= blk.size
            self._free_bytes += blk.size
            self._free.setdefault(blk.size, []).append(block.block_id)
            self._stats.frees += 1

    def host_buffer(self, block_id: int):
        """uint8 numpy view of a host-backed block's staging memory; None
        for a block without one (or one no longer in the pool)."""
        if self._handle is not None:
            ptr = self._native.pk_pool_host_ptr(self._handle, block_id)
            if not ptr:
                return None
            size = self._native.pk_pool_block_size(self._handle, block_id)
            return np.frombuffer((ctypes.c_ubyte * size).from_address(ptr), np.uint8)
        with self._lock:
            blk = self._blocks.get(block_id)
            return None if blk is None else blk.host

    def trim(self, bytes_target: int) -> int:
        """Evict free blocks, least recently used first, until at least
        ``bytes_target`` are reclaimed or none is left; the bytes reclaimed."""
        if self._handle is not None:
            return self._native.pk_pool_trim(self._handle, bytes_target)
        with self._lock:
            before = self._free_bytes
            while self._free_bytes > 0 and before - self._free_bytes < bytes_target:
                self._evict_one()
            return before - self._free_bytes

    def stats(self) -> PoolStats:
        if self._handle is not None:
            raw = PkPoolStats()
            self._native.pk_pool_stats(self._handle, raw)
            return PoolStats(**{f: getattr(raw, f) for f, _ in raw._fields_})
        with self._lock:
            self._stats.used_bytes = self._used
            self._stats.free_list_bytes = self._free_bytes
            return PoolStats(**self._stats.__dict__)

    def _next_tick(self) -> int:
        self._tick += 1
        return self._tick

    def _evict_one(self) -> None:
        cls, bid = min(((c, i) for c, ids in self._free.items() for i in ids),
                       key=lambda ci: self._blocks[ci[1]].tick)
        self._free[cls].remove(bid)
        self._free_bytes -= cls
        del self._blocks[bid]
        self._stats.evictions += 1

    def _bump(self) -> None:
        if self._used > self._stats.peak_bytes:
            self._stats.peak_bytes = self._used

    def __del__(self):
        try:
            if self._handle is not None:
                self._native.pk_pool_destroy(self._handle)
                self._handle = None
        except Exception:
            pass
