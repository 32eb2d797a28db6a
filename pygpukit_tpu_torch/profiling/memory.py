"""Memory profiler: snapshots of the device's and a pool's usage
(counterpart of ``pygpukit_tpu/profiling/memory.py``). Device bytes are
the port's ``core.memory.get_memory_info``: on the card the caching
allocator's allocated bytes."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..core.memory import get_memory_info


@dataclass
class MemorySnapshot:
    label: str
    timestamp: float
    device_used: int
    device_total: int
    pool_stats: dict = field(default_factory=dict)

    @property
    def device_used_gib(self) -> float:
        return self.device_used / (1 << 30)


class MemoryProfiler:
    """Snapshots of ``device`` (the backend's unless named) and ``pool``."""

    def __init__(self, pool=None, device=None):
        self.pool = pool
        self.device = device
        self.snapshots: list[MemorySnapshot] = []

    def snapshot(self, label: str = "") -> MemorySnapshot:
        info = get_memory_info(self.device)
        snap = MemorySnapshot(
            label=label or f"snap_{len(self.snapshots)}",
            timestamp=time.time(),
            device_used=info.used_bytes,
            device_total=info.total_bytes,
            pool_stats=(self.pool.stats().__dict__ if self.pool else {}),
        )
        self.snapshots.append(snap)
        return snap

    def delta(self) -> int:
        """Device-bytes change between the last two snapshots."""
        if len(self.snapshots) < 2:
            return 0
        return self.snapshots[-1].device_used - self.snapshots[-2].device_used

    def summary(self) -> str:
        lines = [f"{'label':<24}{'used GiB':>10}{'total GiB':>11}"]
        for s in self.snapshots:
            lines.append(f"{s.label:<24}{s.device_used_gib:>10.3f}"
                         f"{s.device_total / (1 << 30):>11.1f}")
        return "\n".join(lines)


def print_memory_summary(pool=None, device=None) -> None:
    prof = MemoryProfiler(pool, device)
    prof.snapshot("now")
    print(prof.summary())
