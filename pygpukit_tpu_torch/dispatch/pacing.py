"""Kernel pacing: launch throttling per logical stream (counterpart of
``pygpukit_tpu/dispatch/pacing.py``): a token bucket over time windows, so
one model's launch storm cannot starve another's.

It throttles the host's enqueue rate; on the card the stream orders the
work. The multi-model controller uses it for a context's bandwidth share.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass


@dataclass
class PacingConfig:
    window_s: float = 0.1              # accounting window
    max_bytes_per_window: int = 1 << 30
    max_launches_per_window: int = 10000


@dataclass
class PacingStats:
    launches: int = 0
    bytes: int = 0
    throttled: int = 0
    total_wait_s: float = 0.0


class KernelPacingEngine:
    def __init__(self, config: PacingConfig | None = None):
        self.config = config or PacingConfig()
        self.stats = PacingStats()
        self._lock = threading.Lock()
        self._window_start = time.monotonic()
        self._window_bytes = 0
        self._window_launches = 0

    def admit(self, bytes_moved: int = 0, block: bool = True) -> bool:
        """Account a launch; sleeps into the next window when over budget.

        Returns False (non-blocking mode) when the launch would exceed the
        window budget.
        """
        cfg = self.config
        while True:
            with self._lock:
                now = time.monotonic()
                if now - self._window_start >= cfg.window_s:
                    self._window_start = now
                    self._window_bytes = 0
                    self._window_launches = 0
                over = (self._window_bytes + bytes_moved
                        > cfg.max_bytes_per_window
                        or self._window_launches + 1
                        > cfg.max_launches_per_window)
                # a single launch larger than the whole window budget can
                # never fit: admit it alone into an empty window (it then
                # consumes the window) instead of spinning forever
                if (over and self._window_launches == 0
                        and bytes_moved > cfg.max_bytes_per_window):
                    over = False
                if not over:
                    self._window_bytes += bytes_moved
                    self._window_launches += 1
                    self.stats.launches += 1
                    self.stats.bytes += bytes_moved
                    return True
                wait = max(cfg.window_s - (now - self._window_start), 1e-4)
                self.stats.throttled += 1
                if block:
                    self.stats.total_wait_s += wait
            if not block:
                return False
            time.sleep(wait)
