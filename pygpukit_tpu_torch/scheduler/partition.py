"""Logical device partitions (counterpart of
``pygpukit_tpu/scheduler/partition.py``).

A partition is a quota bundle (memory bytes, compute fraction, bandwidth,
concurrent executions) that a model's context is confined to; the
multi-model controller bills each context against its own. Partitions
live in their scheduler, on either route: the native scheduler's table
(``pk_part_*``) or the Python route's (``Scheduler.partitions``), with the
same rules. Tasks submitted with a ``partition_id`` count against it too.
A destroyed partition admits nothing more, but its usage stays readable
and releases still apply.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .._native import PkPartitionLimits, PkPartitionUsage
from .core import Scheduler, _Partition


@dataclass
class PartitionLimits:
    memory_bytes: int = 1 << 30
    compute_fraction: float = 1.0
    bandwidth: float = 0.0        # 0 = unlimited
    max_streams: int = 1


@dataclass
class PartitionUsage:
    memory_used: int = 0
    bandwidth_used: float = 0.0
    streams_used: int = 0
    tasks_admitted: int = 0
    tasks_rejected: int = 0


class PartitionManager:
    """Create and destroy a scheduler's partitions; acquire and release
    their resources."""

    def __init__(self, scheduler: Scheduler):
        self.scheduler = scheduler
        self._native = scheduler._native if scheduler.is_native else None

    @property
    def is_native(self) -> bool:
        return self._native is not None

    def create(self, limits: PartitionLimits) -> int:
        s = self.scheduler
        if self._native is not None:
            raw = PkPartitionLimits(limits.memory_bytes, limits.compute_fraction,
                                    limits.bandwidth, limits.max_streams)
            return self._native.pk_part_create(s._handle, raw)
        with s._lock:
            pid = s._next_partition
            s._next_partition += 1
            s.partitions[pid] = _Partition(replace(limits), PartitionUsage())
            return pid

    def destroy(self, part_id: int) -> None:
        s = self.scheduler
        if self._native is not None:
            self._native.pk_part_destroy(s._handle, part_id)
            return
        with s._lock:
            part = s.partitions.get(part_id)
            if part is not None:
                part.alive = False

    def acquire(self, part_id: int, memory: int, bandwidth: float = 0.0) -> bool:
        """Take ``memory``, ``bandwidth`` and one stream of the partition;
        False (nothing taken) when a limit would be passed or the partition
        is gone."""
        s = self.scheduler
        if self._native is not None:
            return self._native.pk_part_acquire(s._handle, part_id, memory, bandwidth) == 0
        with s._lock:
            part = s.partitions.get(part_id)
            if part is None or not part.alive:
                return False
            lim, use = part.limits, part.usage
            if use.memory_used + memory > lim.memory_bytes:
                return False
            if lim.bandwidth > 0 and use.bandwidth_used + bandwidth > lim.bandwidth:
                return False
            if use.streams_used + 1 > lim.max_streams:
                return False
            use.memory_used += memory
            use.bandwidth_used += bandwidth
            use.streams_used += 1
            return True

    def release(self, part_id: int, memory: int, bandwidth: float = 0.0) -> None:
        s = self.scheduler
        if self._native is not None:
            self._native.pk_part_release(s._handle, part_id, memory, bandwidth)
            return
        with s._lock:
            part = s.partitions.get(part_id)
            if part is None:
                return
            use = part.usage
            use.memory_used -= min(use.memory_used, memory)
            use.bandwidth_used = max(0.0, use.bandwidth_used - bandwidth)
            if use.streams_used:
                use.streams_used -= 1

    def usage(self, part_id: int) -> PartitionUsage | None:
        """A copy of the partition's usage; None for an unknown id."""
        s = self.scheduler
        if self._native is not None:
            raw = PkPartitionUsage()
            if self._native.pk_part_usage(s._handle, part_id, raw) != 0:
                return None
            return PartitionUsage(raw.memory_used, raw.bandwidth_used, raw.streams_used,
                                  raw.tasks_admitted, raw.tasks_rejected)
        with s._lock:
            part = s.partitions.get(part_id)
            return None if part is None else replace(part.usage)
