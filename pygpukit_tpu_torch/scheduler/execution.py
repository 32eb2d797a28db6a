"""Concurrent multi-model serving: a context per model with a memory
budget, a partition and a device (counterpart of
``pygpukit_tpu/scheduler/execution.py``).

Each model gets an ``ExecutionContext`` whose budget is drawn from the
controller's and billed to its own partition. Contexts go round-robin over
the controller's devices: every card torch sees, or the CPU when the
controller is built for it (``device="cpu"``, or the CPU backend). Work run
through a context is pinned to its device by the thread-local
``with torch.device(...)`` (the default device of tensors made inside)
and ``torch.cuda.device(index)`` (the current card).

Contexts get no streams of their own: the port's programs run on one
stream (``flash_decode`` and the w4a8 GEMM's split-K fold keep arrival
counters in ``__device__`` memory), so two contexts on one card take
turns there, launch by launch and replay by replay
(``kernels._build.DEVICE_LOCK``). ``run_async`` runs on the controller's
executor threads.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import enum
import threading
from dataclasses import dataclass, field

import torch

from ..core.backend import get_backend
from .core import Scheduler
from .partition import PartitionLimits, PartitionManager


class ContextState(enum.Enum):
    CREATED = "created"
    ACTIVE = "active"
    IDLE = "idle"
    DESTROYED = "destroyed"


@dataclass
class ContextStats:
    executions: int = 0
    total_wait_s: float = 0.0
    rejected: int = 0


@contextlib.contextmanager
def _pinned(device: torch.device):
    """Make ``device`` the default device (and the current card) of this
    thread inside the block."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.device(device))
        if device.type == "cuda":
            stack.enter_context(torch.cuda.device(device))
        yield


@dataclass
class ExecutionContext:
    """One model's context. With a bandwidth budget every ``run`` passes
    the context's KernelPacingEngine (one model's launch storm cannot
    starve another); ``run_sliced`` splits large row-wise work through the
    SliceScheduler with a yield point between slices."""
    name: str
    max_memory: int
    partition_id: int
    device_index: int
    controller: "MultiModelController"
    state: ContextState = ContextState.CREATED
    stats: ContextStats = field(default_factory=ContextStats)
    pacing: object | None = None          # KernelPacingEngine
    slicer: object | None = None          # SliceScheduler
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @property
    def device(self) -> torch.device:
        devs = self.controller.devices
        return devs[self.device_index % len(devs)]

    def run(self, fn, *args, memory_bytes: int = 0, **kwargs):
        """``fn(*args, **kwargs)`` on this context's device with
        ``memory_bytes`` and one stream of its partition held;
        RuntimeError when the partition cannot give them."""
        ctrl = self.controller
        mem = memory_bytes or 0
        if not ctrl.partitions.acquire(self.partition_id, mem):
            with self._lock:
                self.stats.rejected += 1
            raise RuntimeError(f"context {self.name!r}: partition resources exhausted")
        try:
            with self._lock:
                self.state = ContextState.ACTIVE
                self.stats.executions += 1
            if self.pacing is not None:
                self.pacing.admit(bytes_moved=mem)
            with _pinned(self.device):
                return fn(*args, **kwargs)
        finally:
            ctrl.partitions.release(self.partition_id, mem)
            with self._lock:
                self.state = ContextState.IDLE

    async def run_async(self, fn, *args, memory_bytes: int = 0, **kwargs):
        """``run`` on one of the controller's executor threads."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self.controller._executor,
            lambda: self.run(fn, *args, memory_bytes=memory_bytes, **kwargs))

    def run_sliced(self, fn, x, *args, axis: int = 0, memory_bytes: int = 0):
        """Row-sliced execution with yields between slices, each slice
        paced."""
        if self.slicer is None:
            from ..dispatch.slicing import SliceConfig, SliceScheduler
            self.slicer = SliceScheduler(SliceConfig(yield_fn=lambda: None))

        def paced(chunk, *a):
            if self.pacing is not None:
                self.pacing.admit(bytes_moved=memory_bytes)
            with _pinned(self.device):
                return fn(chunk, *a)

        return self.slicer.run_sliced(paced, x, *args, axis=axis)

    @contextlib.contextmanager
    def session(self):
        """Run the block pinned to this context's device."""
        with self._lock:
            self.state = ContextState.ACTIVE
        try:
            with _pinned(self.device):
                yield self
        finally:
            with self._lock:
                self.state = ContextState.IDLE


@dataclass
class ControllerStats:
    contexts: int = 0
    total_budget: int = 0
    allocated_budget: int = 0


class MultiModelController:
    """Registry of contexts and arbiter of the global memory budget.
    ``device``: None takes the backend's devices (every card, or the CPU
    on the CPU backend); ``"cpu"`` builds the controller for the CPU."""

    def __init__(self, total_memory: int = 16 << 30, max_workers: int = 4,
                 device=None):
        if device is None:
            self.devices = get_backend().devices()
        else:
            dev = torch.device(device)
            self.devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                            if dev.type == "cuda" and dev.index is None else [dev])
        self.scheduler = Scheduler(total_memory=total_memory)
        self.partitions = PartitionManager(self.scheduler)
        self.total_memory = total_memory
        self.allocated = 0
        self.contexts: dict[str, ExecutionContext] = {}
        self._lock = threading.RLock()
        self._next_device = 0
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers)

    def create_context(self, name: str, max_memory: int,
                       max_streams: int = 2,
                       device_index: int | None = None,
                       bandwidth_bytes_per_s: float | None = None,
                       slice_rows: int | None = None) -> ExecutionContext:
        """A context with ``max_memory`` of the budget (MemoryError past
        it, ValueError for a taken name). ``bandwidth_bytes_per_s`` attaches
        a pacing engine for the context's bandwidth share; ``slice_rows``
        sets run_sliced's slice."""
        with self._lock:
            if name in self.contexts:
                raise ValueError(f"context {name!r} already exists")
            if self.allocated + max_memory > self.total_memory:
                raise MemoryError(f"budget exhausted: {self.allocated + max_memory} > "
                                  f"{self.total_memory}")
            pid = self.partitions.create(PartitionLimits(memory_bytes=max_memory,
                                                         max_streams=max_streams))
            if device_index is None:
                device_index = self._next_device
                self._next_device += 1
            pacing = None
            if bandwidth_bytes_per_s is not None:
                from ..dispatch.pacing import KernelPacingEngine, PacingConfig
                window = 0.05
                pacing = KernelPacingEngine(PacingConfig(
                    window_s=window,
                    max_bytes_per_window=int(bandwidth_bytes_per_s * window)))
            slicer = None
            if slice_rows is not None:
                from ..dispatch.slicing import SliceConfig, SliceScheduler
                slicer = SliceScheduler(SliceConfig(slice_rows=slice_rows,
                                                    yield_fn=lambda: None))
            ctx = ExecutionContext(name=name, max_memory=max_memory, partition_id=pid,
                                   device_index=device_index, controller=self,
                                   pacing=pacing, slicer=slicer)
            self.contexts[name] = ctx
            self.allocated += max_memory
            return ctx

    def destroy_context(self, name: str) -> None:
        with self._lock:
            ctx = self.contexts.pop(name, None)
            if ctx is None:
                return
            self.partitions.destroy(ctx.partition_id)
            self.allocated -= ctx.max_memory
            ctx.state = ContextState.DESTROYED

    def get(self, name: str) -> ExecutionContext:
        return self.contexts[name]

    def stats(self) -> ControllerStats:
        with self._lock:
            return ControllerStats(contexts=len(self.contexts),
                                   total_budget=self.total_memory,
                                   allocated_budget=self.allocated)

    def shutdown(self) -> None:
        self._executor.shutdown(wait=True)


_controller: MultiModelController | None = None
_controller_lock = threading.Lock()


def initialize(total_memory: int = 16 << 30, device=None) -> MultiModelController:
    """The process's controller, made at the first call."""
    global _controller
    with _controller_lock:
        if _controller is None:
            _controller = MultiModelController(total_memory, device=device)
        return _controller


def create_context(name: str, max_memory: int, **kw) -> ExecutionContext:
    return initialize().create_context(name, max_memory, **kw)


def get_controller() -> MultiModelController | None:
    return _controller
