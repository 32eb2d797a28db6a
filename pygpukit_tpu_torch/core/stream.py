"""Logical streams and timing events (counterpart of
``pygpukit_tpu/core/stream.py``).

A ``Stream`` is what the reference's is: a logical ordering domain for the
scheduler layer, not a hardware stream. ``record`` keeps a
``torch.cuda.Event`` recorded after the work issued so far for each CUDA
tensor it is given (a CPU tensor is complete when its op returns), and
``synchronize`` waits on those events. Every launch stays on the current
CUDA stream: the port creates no second hardware stream, because
``flash_decode`` and a split ``w4a8_gemm`` keep arrival counters that
every launch shares (``csrc/flash_decode.cu``, ``csrc/w4a8_gemm.cu``), so
two of them must never run beside each other.

``Event`` times the interval between two records: CUDA timing events on
the card, the host clock after a synchronize on the CPU.
"""

from __future__ import annotations

import enum
import itertools
import threading
import time
from dataclasses import dataclass, field

import torch

from .array import Array
from .backend import resolve_device


class StreamPriority(enum.IntEnum):
    HIGH = 0
    LOW = 1


_ids = itertools.count()


@dataclass
class Stream:
    priority: StreamPriority = StreamPriority.LOW
    stream_id: int = field(default_factory=lambda: next(_ids))
    _pending: list = field(default_factory=list, repr=False)

    def record(self, buf) -> None:
        """Mark an in-flight tensor (or Array) as this stream's: a CUDA
        event after the work issued so far; nothing for a CPU tensor."""
        t = buf.torch if isinstance(buf, Array) else buf
        if not (isinstance(t, torch.Tensor) and t.is_cuda):
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        self._pending.append(ev)
        if len(self._pending) > 64:
            # an event waits for all work before it: the last ones suffice
            self._pending = self._pending[-8:]

    def synchronize(self) -> None:
        for ev in self._pending:
            ev.synchronize()
        self._pending.clear()

    def __enter__(self):
        _tls.current = self
        return self

    def __exit__(self, *exc):
        _tls.current = None
        return False


class _TLS(threading.local):
    current: Stream | None = None


_tls = _TLS()
_default = Stream(StreamPriority.LOW)


def default_stream() -> Stream:
    return _default


def current_stream() -> Stream:
    return _tls.current or _default


class StreamManager:
    """A pool of logical streams by priority, handed out round robin."""

    def __init__(self, n_high: int = 1, n_low: int = 2):
        self.high = [Stream(StreamPriority.HIGH) for _ in range(n_high)]
        self.low = [Stream(StreamPriority.LOW) for _ in range(n_low)]
        self._rr = {StreamPriority.HIGH: 0, StreamPriority.LOW: 0}
        self._lock = threading.Lock()

    def get(self, priority: StreamPriority = StreamPriority.LOW) -> Stream:
        pool = self.high if priority == StreamPriority.HIGH else self.low
        with self._lock:
            i = self._rr[priority]
            self._rr[priority] = (i + 1) % len(pool)
        return pool[i]

    def synchronize_all(self) -> None:
        for s in self.high + self.low:
            s.synchronize()


class Event:
    """A timing event on ``device`` (the card unless named): a CUDA timing
    event recorded on the current stream, or on the CPU the host clock
    read after the logical stream's pending work is done."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._ev: torch.cuda.Event | None = None
        self._t: float | None = None

    def record(self, stream: Stream | None = None) -> None:
        if self.device.type == "cuda":
            self._ev = torch.cuda.Event(enable_timing=True)
            self._ev.record(torch.cuda.current_stream(self.device))
            return
        (stream or current_stream()).synchronize()
        self._t = time.perf_counter()

    def elapsed_ms(self, other: "Event") -> float:
        """Milliseconds from this record to ``other``'s (waits for
        ``other`` on the card)."""
        if self._ev is not None and other._ev is not None:
            other._ev.synchronize()
            return self._ev.elapsed_time(other._ev)
        if self._t is None or other._t is None:
            raise RuntimeError("event not recorded")
        return (other._t - self._t) * 1e3

    def elapsed_us(self, other: "Event") -> float:
        return self.elapsed_ms(other) * 1e3
