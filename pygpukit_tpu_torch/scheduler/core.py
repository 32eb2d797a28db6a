"""QoS task scheduler: admission control, memory and bandwidth
reservation, partitions (counterpart of ``pygpukit_tpu/scheduler/core.py``).

Two routes make the same decisions: the native scheduler
(``native/src/scheduler.cpp``, through ``_native``) and a pure-Python copy
of its rules. For the same calls they give the same task ids, admission
results (decision, ETA, available memory), run order, task states,
partition usage and stats:

- a task's memory limit is ``total_memory`` grown by its class's share of
  the overcommit (GUARANTEED none, the others all); it is rejected past
  that limit, past the bandwidth left, when ``max_pending`` tasks wait, or
  when its partition is gone (REJECT_DEPS) or full. An admitted task
  reserves its memory and bandwidth until it completes or is cancelled;
  it is ADMIT when its memory fits what is unreserved, else QUEUE with an
  ETA of the deficit over the bandwidth;
- ``next_task`` runs the waiting task of the lowest QoS class, then the
  highest priority (class base plus the task's own), then the earliest.
"""

from __future__ import annotations

import enum
import heapq
import threading
from dataclasses import dataclass, replace

from .._native import (PkAdmitResult, PkSchedConfig, PkSchedStats, PkTaskDesc,
                       select_native)


class TaskPolicy(enum.IntEnum):
    """QoS classes."""
    GUARANTEED = 0
    BURSTABLE = 1
    BEST_EFFORT = 2


class TaskState(enum.IntEnum):
    PENDING = 0
    QUEUED = 1
    RUNNING = 2
    COMPLETED = 3
    FAILED = 4
    REJECTED = 5


class AdmitDecision(enum.IntEnum):
    ADMIT = 0
    QUEUE = 1
    REJECT_MEMORY = 2
    REJECT_BANDWIDTH = 3
    REJECT_QUEUE_FULL = 4
    REJECT_DEPS = 5

    @property
    def admitted(self) -> bool:
        return self in (AdmitDecision.ADMIT, AdmitDecision.QUEUE)


@dataclass
class AdmissionResult:
    decision: AdmitDecision
    eta_seconds: float = 0.0
    available_memory: int = 0


@dataclass
class Task:
    """A task: its reservation, class and priority, and an optional
    callable that ``run_pending`` runs."""
    task_id: int = 0
    memory_bytes: int = 0
    bandwidth: float = 0.0
    policy: TaskPolicy = TaskPolicy.BEST_EFFORT
    priority: int = 0
    partition_id: int = 0
    fn: object = None
    result: object = None
    error: Exception | None = None


@dataclass
class SchedulerStats:
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    rejected: int = 0
    queued: int = 0
    running: int = 0
    reserved_memory: int = 0


# the QoS table of native/src/scheduler.cpp (kQos): base priority and the
# share of the overcommit headroom each class may use
_QOS_PRIORITY = {TaskPolicy.GUARANTEED: 300, TaskPolicy.BURSTABLE: 200,
                 TaskPolicy.BEST_EFFORT: 100}
_QOS_OVERCOMMIT = {TaskPolicy.GUARANTEED: 0.0, TaskPolicy.BURSTABLE: 1.0,
                   TaskPolicy.BEST_EFFORT: 1.0}


@dataclass
class _Partition:
    """A partition on the Python route (``scheduler.partition``)."""
    limits: object
    usage: object
    alive: bool = True


class Scheduler:
    """QoS scheduler with deterministic admission (module docstring).
    ``use_native``: None takes the native scheduler when it loads, True
    requires it, False takes the Python route."""

    def __init__(self, total_memory: int = 8 << 30,
                 overcommit_ratio: float = 1.2, max_pending: int = 256,
                 total_bandwidth: float = 100.0,
                 use_native: bool | None = None):
        self._native = select_native(use_native, "scheduler")
        self._tasks: dict[int, Task] = {}
        self._lock = threading.RLock()
        self.total_memory = total_memory
        self.overcommit_ratio = overcommit_ratio
        self.max_pending = max_pending
        self.total_bandwidth = total_bandwidth
        self._handle = None
        if self._native is not None:
            cfg = PkSchedConfig(total_memory, overcommit_ratio, max_pending, total_bandwidth)
            self._handle = self._native.pk_sched_create(cfg)
            return
        self._states: dict[int, TaskState] = {}
        self._heap: list[tuple] = []          # (class, -priority, seq, id)
        self._waiting: set[int] = set()       # ids queued (heap entries may be stale)
        self._seq = 0
        self._next_id = 1
        self._reserved = 0
        self._bandwidth_reserved = 0.0
        self._stats = SchedulerStats()
        self.partitions: dict[int, _Partition] = {}
        self._next_partition = 1

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    # -- submission -----------------------------------------------------------

    def submit(self, task: Task) -> tuple[int, AdmissionResult]:
        """Admit ``task`` (module docstring); its id and the result."""
        if self._handle is not None:
            desc = PkTaskDesc(task.memory_bytes, task.bandwidth, int(task.policy),
                              task.priority, task.partition_id)
            res = PkAdmitResult()
            with self._lock:
                tid = self._native.pk_sched_submit(self._handle, desc, res)
                task.task_id = tid
                self._tasks[tid] = task
            return tid, AdmissionResult(AdmitDecision(res.decision), res.eta_seconds,
                                        res.available_memory)
        with self._lock:
            res = self._admit(task)
            self._stats.submitted += 1
            tid = self._next_id
            self._next_id += 1
            self._seq += 1
            task.task_id = tid
            self._tasks[tid] = task
            part = self.partitions.get(task.partition_id) if task.partition_id else None
            if not res.decision.admitted:
                self._stats.rejected += 1
                self._states[tid] = TaskState.REJECTED
                if part is not None:
                    part.usage.tasks_rejected += 1
                return tid, res
            self._states[tid] = TaskState.QUEUED
            heapq.heappush(self._heap, (int(task.policy),
                                        -(_QOS_PRIORITY[task.policy] + task.priority),
                                        self._seq, tid))
            self._waiting.add(tid)
            self._stats.queued += 1
            self._reserved += task.memory_bytes
            self._bandwidth_reserved += task.bandwidth
            if part is not None:
                part.usage.memory_used += task.memory_bytes
                part.usage.bandwidth_used += task.bandwidth
                part.usage.tasks_admitted += 1
            return tid, res

    def _admit(self, task: Task) -> AdmissionResult:
        ratio = 1.0 + (self.overcommit_ratio - 1.0) * _QOS_OVERCOMMIT[task.policy]
        limit = int(self.total_memory * ratio)
        avail = limit - self._reserved if limit > self._reserved else 0
        if task.memory_bytes > limit:
            return AdmissionResult(AdmitDecision.REJECT_MEMORY, 0.0, avail)
        if (self.total_bandwidth > 0
                and self._bandwidth_reserved + task.bandwidth > self.total_bandwidth):
            return AdmissionResult(AdmitDecision.REJECT_BANDWIDTH, 0.0, avail)
        if len(self._waiting) >= self.max_pending:
            return AdmissionResult(AdmitDecision.REJECT_QUEUE_FULL, 0.0, avail)
        if task.partition_id:
            part = self.partitions.get(task.partition_id)
            if part is None or not part.alive:
                return AdmissionResult(AdmitDecision.REJECT_DEPS, 0.0, avail)
            if part.usage.memory_used + task.memory_bytes > part.limits.memory_bytes:
                return AdmissionResult(AdmitDecision.REJECT_MEMORY, 0.0, avail)
        if task.memory_bytes <= avail:
            return AdmissionResult(AdmitDecision.ADMIT, 0.0, avail)
        deficit = float(task.memory_bytes - avail)
        eta = (deficit / (self.total_bandwidth * 1e6) if self.total_bandwidth > 0
               else 0.1 * len(self._waiting))
        return AdmissionResult(AdmitDecision.QUEUE, eta, avail)

    def next_task(self) -> Task | None:
        """Start the next waiting task (module docstring); None if none."""
        if self._handle is not None:
            with self._lock:
                tid = self._native.pk_sched_next(self._handle)
                return self._tasks.get(tid) if tid else None
        with self._lock:
            while self._heap:
                tid = heapq.heappop(self._heap)[3]
                if tid in self._waiting:
                    self._waiting.discard(tid)
                    self._states[tid] = TaskState.RUNNING
                    self._stats.queued -= 1
                    self._stats.running += 1
                    return self._tasks[tid]
            return None

    def complete(self, task_id: int, failed: bool = False) -> None:
        """End a running or waiting task (a waiting one leaves the queue) and
        release its reservation; any other task is left alone."""
        if self._handle is not None:
            self._native.pk_sched_complete(self._handle, task_id, 1 if failed else 0)
            return
        with self._lock:
            state = self._states.get(task_id)
            if state not in (TaskState.RUNNING, TaskState.QUEUED):
                return
            if state == TaskState.QUEUED:
                self._waiting.discard(task_id)
                self._stats.queued -= 1
            else:
                self._stats.running -= 1
            t = self._tasks[task_id]
            self._reserved -= min(self._reserved, t.memory_bytes)
            self._bandwidth_reserved = max(0.0, self._bandwidth_reserved - t.bandwidth)
            part = self.partitions.get(t.partition_id) if t.partition_id else None
            if part is not None:
                part.usage.memory_used -= min(part.usage.memory_used, t.memory_bytes)
                part.usage.bandwidth_used = max(0.0, part.usage.bandwidth_used - t.bandwidth)
            self._states[task_id] = TaskState.FAILED if failed else TaskState.COMPLETED
            if failed:
                self._stats.failed += 1
            else:
                self._stats.completed += 1

    def task_state(self, task_id: int) -> TaskState | None:
        """The task's state, None for an unknown id."""
        if self._handle is not None:
            s = self._native.pk_sched_task_state(self._handle, task_id)
            return TaskState(s) if s >= 0 else None
        with self._lock:
            return self._states.get(task_id)

    def run_pending(self) -> int:
        """Drain the queue in scheduling order, running each ``Task.fn``
        (an exception is kept in ``Task.error`` and fails the task);
        returns the tasks run."""
        n = 0
        while True:
            t = self.next_task()
            if t is None:
                return n
            try:
                if callable(t.fn):
                    t.result = t.fn()
                self.complete(t.task_id, failed=False)
            except Exception as e:  # noqa: BLE001 - kept on the task
                t.error = e
                self.complete(t.task_id, failed=True)
            n += 1

    def stats(self) -> SchedulerStats:
        if self._handle is not None:
            raw = PkSchedStats()
            self._native.pk_sched_stats(self._handle, raw)
            return SchedulerStats(**{f: getattr(raw, f) for f, _ in raw._fields_})
        with self._lock:
            return replace(self._stats, reserved_memory=self._reserved)

    def __del__(self):
        try:
            if self._handle is not None:
                self._native.pk_sched_destroy(self._handle)
                self._handle = None
        except Exception:
            pass
