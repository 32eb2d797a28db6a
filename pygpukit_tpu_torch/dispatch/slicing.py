"""Work slicing (counterpart of ``pygpukit_tpu/dispatch/slicing.py``):
large row-wise work issued as a sequence of smaller calls with a yield
point between them, so one long operation cannot hold the card while
other work waits. The results are joined with ``torch.cat``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable

import torch


@dataclass
class SliceConfig:
    slice_rows: int = 1024             # rows per slice
    yield_fn: Callable | None = None   # called between slices


@dataclass
class SliceStats:
    operations: int = 0
    slices: int = 0
    yields: int = 0


class SliceScheduler:
    def __init__(self, config: SliceConfig | None = None):
        self.config = config or SliceConfig()
        self.stats = SliceStats()
        self._lock = threading.Lock()

    def run_sliced(self, fn: Callable, x: torch.Tensor, *args, axis: int = 0):
        """``fn`` over ``x`` in slices of ``slice_rows`` along ``axis``, the
        results concatenated. ``fn`` must be independent across that axis
        (elementwise or row-wise ops, a matmul over M, ...)."""
        n = x.shape[axis]
        rows = self.config.slice_rows
        with self._lock:
            self.stats.operations += 1
        if n <= rows:
            with self._lock:
                self.stats.slices += 1
            return fn(x, *args)
        outs = []
        for start in range(0, n, rows):
            outs.append(fn(x.narrow(axis, start, min(rows, n - start)), *args))
            with self._lock:
                self.stats.slices += 1
            if self.config.yield_fn is not None:
                self.config.yield_fn()
                with self._lock:
                    self.stats.yields += 1
        return torch.cat(outs, dim=axis)
