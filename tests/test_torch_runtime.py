"""The port's runtime services against the reference's: the memory pool,
the QoS scheduler with its partitions, the transfer engine and the
multi-model controller (``pygpukit_tpu_torch.{memory,scheduler,transfer}``).

The cases of tests/test_scheduler.py and tests/test_stress.py run on the
port, parametrised over ``use_native`` as the reference's are (transfers
to ``device="cpu"``). Then parity: the same trace of calls through the
reference's and the port's pool, scheduler and partitions gives the same
results, run order, task states, partition usage and stats, exactly.

The reference's two routes differ from each other: its native route
(``native/src``) reuses a size class's most recently freed block, tracks
task states, estimates an ETA for a queued task and checks partitions at
admission; its pure-Python route reuses the earliest freed block and does
none of the rest. The port's two routes both follow the native sources.
So a random trace that reaches all of that is held against the
reference's native route, on both of the port's routes; and the
reference's pure-Python route is held on a trace inside what its two
routes share (the test checks that they agree there first), on decisions,
run order and stats.
"""

import numpy as np
import pytest
import torch

import pygpukit_tpu as ref
from pygpukit_tpu import _native as ref_native
from pygpukit_tpu_torch import _native as port_native
from pygpukit_tpu_torch.core import backend
from pygpukit_tpu_torch.memory import MemoryPool
from pygpukit_tpu_torch.scheduler import (AdmitDecision, MultiModelController,
                                          PartitionLimits, PartitionManager, Scheduler,
                                          Task, TaskPolicy, TaskState)
from pygpukit_tpu_torch.transfer import AsyncTransferEngine

BACKENDS = [False] + ([True] if port_native.native_available() else [])
REF_NATIVE = ref_native.native_available()


@pytest.fixture
def cpu_backend():
    backend.set_backend("cpu")
    yield
    backend.reset_backend()


# ---------------------------------------------- the reference's cases (port) --

@pytest.mark.parametrize("use_native", BACKENDS)
class TestMemoryPool:
    def test_alloc_free_reuse(self, use_native):
        pool = MemoryPool(quota_bytes=1 << 20, use_native=use_native)
        assert pool.is_native == use_native
        b1 = pool.alloc(1000)
        assert b1.size == 1024  # size class rounding
        pool.free(b1)
        pool.alloc(900)         # same class -> reuse
        s = pool.stats()
        assert s.reuses == 1
        assert s.allocations == 2

    def test_quota_enforced(self, use_native):
        pool = MemoryPool(quota_bytes=4096, use_native=use_native)
        pool.alloc(2048)
        pool.alloc(2048)
        with pytest.raises(MemoryError):
            pool.alloc(2048)
        assert pool.stats().failures == 1

    def test_eviction_on_pressure(self, use_native):
        pool = MemoryPool(quota_bytes=4096, use_native=use_native)
        b = pool.alloc(2048)
        pool.free(b)            # parked in free list
        pool.alloc(4096)        # needs eviction of the parked block
        assert pool.stats().evictions >= 1

    def test_trim(self, use_native):
        pool = MemoryPool(quota_bytes=1 << 20, use_native=use_native)
        blocks = [pool.alloc(4096) for _ in range(4)]
        for b in blocks:
            pool.free(b)
        assert pool.trim(8192) >= 8192

    def test_host_ptr_lifecycle(self, use_native):
        pool = MemoryPool(1 << 20, use_native=use_native)
        blk = pool.alloc(4096, host_backed=True)
        buf = pool.host_buffer(blk.block_id)
        assert buf is not None and buf.nbytes >= 4096
        buf[:4] = [1, 2, 3, 4]                        # writable staging
        assert list(pool.host_buffer(blk.block_id)[:4]) == [1, 2, 3, 4]
        blk.free()
        blk2 = pool.alloc(512, host_backed=False)     # device-only: no host buffer
        assert pool.host_buffer(blk2.block_id) is None
        blk2.free()

    def test_alloc_free_cycles(self, use_native):
        pool = MemoryPool(quota_bytes=1 << 24, use_native=use_native)
        for _ in range(50):
            blocks = [pool.alloc(1 << (8 + i % 8)) for i in range(16)]
            for b in blocks:
                pool.free(b)
        s = pool.stats()
        assert s.allocations == 800
        assert s.reuses > 500          # free lists actually reused
        assert s.used_bytes == 0


@pytest.mark.parametrize("use_native", BACKENDS)
class TestScheduler:
    def test_admit_and_order(self, use_native):
        s = Scheduler(total_memory=1 << 30, use_native=use_native)
        assert s.is_native == use_native
        _, r1 = s.submit(Task(memory_bytes=1 << 20, policy=TaskPolicy.BEST_EFFORT))
        s.submit(Task(memory_bytes=1 << 20, policy=TaskPolicy.GUARANTEED))
        s.submit(Task(memory_bytes=1 << 20, policy=TaskPolicy.BURSTABLE, priority=5))
        assert r1.decision == AdmitDecision.ADMIT
        assert s.next_task().policy == TaskPolicy.GUARANTEED
        assert s.next_task().policy == TaskPolicy.BURSTABLE
        assert s.next_task().policy == TaskPolicy.BEST_EFFORT
        assert s.next_task() is None

    def test_reject_memory(self, use_native):
        s = Scheduler(total_memory=1 << 20, overcommit_ratio=1.0, use_native=use_native)
        _, r = s.submit(Task(memory_bytes=1 << 30, policy=TaskPolicy.GUARANTEED))
        assert r.decision == AdmitDecision.REJECT_MEMORY
        assert s.stats().rejected == 1

    def test_overcommit_burstable_only(self, use_native):
        s = Scheduler(total_memory=1 << 20, overcommit_ratio=2.0, use_native=use_native)
        _, rg = s.submit(Task(memory_bytes=int(1.5 * (1 << 20)),
                              policy=TaskPolicy.GUARANTEED))
        _, rb = s.submit(Task(memory_bytes=int(1.5 * (1 << 20)),
                              policy=TaskPolicy.BURSTABLE))
        assert rg.decision == AdmitDecision.REJECT_MEMORY
        assert rb.decision in (AdmitDecision.ADMIT, AdmitDecision.QUEUE)

    def test_queue_full(self, use_native):
        s = Scheduler(total_memory=1 << 30, max_pending=2, use_native=use_native)
        s.submit(Task(memory_bytes=1))
        s.submit(Task(memory_bytes=1))
        _, r = s.submit(Task(memory_bytes=1))
        assert r.decision == AdmitDecision.REJECT_QUEUE_FULL

    def test_run_pending_executes(self, use_native):
        s = Scheduler(total_memory=1 << 30, use_native=use_native)
        results = []
        t = Task(memory_bytes=16, fn=lambda: results.append(1) or "ok")
        s.submit(t)
        assert s.run_pending() == 1 and results == [1] and t.result == "ok"
        assert s.stats().completed == 1
        assert s.task_state(t.task_id) == TaskState.COMPLETED

    def test_failed_task_captured(self, use_native):
        s = Scheduler(total_memory=1 << 30, use_native=use_native)

        def boom():
            raise ValueError("x")
        t = Task(memory_bytes=16, fn=boom)
        s.submit(t)
        s.run_pending()
        assert isinstance(t.error, ValueError)
        assert s.stats().failed == 1
        assert s.task_state(t.task_id) == TaskState.FAILED

    def test_oversubscription_rejected(self, use_native):
        s = Scheduler(total_memory=1 << 30, total_bandwidth=100.0, use_native=use_native)
        _, r1 = s.submit(Task(memory_bytes=1, bandwidth=60.0))
        _, r2 = s.submit(Task(memory_bytes=1, bandwidth=60.0))
        assert r1.decision.admitted
        assert r2.decision == AdmitDecision.REJECT_BANDWIDTH
        t = s.next_task()
        s.complete(t.task_id)
        _, r3 = s.submit(Task(memory_bytes=1, bandwidth=60.0))
        assert r3.decision.admitted

    def test_many_tasks_qos_ordering(self, use_native):
        s = Scheduler(total_memory=1 << 30, max_pending=512, use_native=use_native)
        order = []
        policies = [TaskPolicy.BEST_EFFORT, TaskPolicy.GUARANTEED, TaskPolicy.BURSTABLE]
        for i in range(120):
            p = policies[i % 3]
            s.submit(Task(memory_bytes=1024, policy=p, fn=lambda p=p: order.append(p)))
        assert s.run_pending() == 120
        last_g = max(i for i, p in enumerate(order) if p == TaskPolicy.GUARANTEED)
        first_be = min(i for i, p in enumerate(order) if p == TaskPolicy.BEST_EFFORT)
        assert last_g < first_be
        assert s.stats().completed == 120


@pytest.mark.parametrize("use_native", BACKENDS)
class TestPartitions:
    def test_acquire_release_limits(self, use_native):
        s = Scheduler(total_memory=1 << 30, use_native=use_native)
        pm = PartitionManager(s)
        pid = pm.create(PartitionLimits(memory_bytes=1 << 20, max_streams=1))
        assert pm.acquire(pid, 1 << 19)
        assert not pm.acquire(pid, 1 << 19)  # max_streams=1 blocks the second
        pm.release(pid, 1 << 19)
        assert pm.acquire(pid, 1 << 19)
        u = pm.usage(pid)
        assert u.memory_used == 1 << 19
        assert u.streams_used == 1

    def test_memory_limit(self, use_native):
        s = Scheduler(total_memory=1 << 30, use_native=use_native)
        pm = PartitionManager(s)
        pid = pm.create(PartitionLimits(memory_bytes=1000, max_streams=8))
        assert not pm.acquire(pid, 2000)

    def test_tasks_bill_their_partition(self, use_native):
        s = Scheduler(total_memory=1 << 30, use_native=use_native)
        pm = PartitionManager(s)
        pid = pm.create(PartitionLimits(memory_bytes=1000, max_streams=1))
        _, r = s.submit(Task(memory_bytes=600, partition_id=pid))
        _, r2 = s.submit(Task(memory_bytes=600, partition_id=pid))
        assert r.decision.admitted and r2.decision == AdmitDecision.REJECT_MEMORY
        assert (pm.usage(pid).tasks_admitted, pm.usage(pid).tasks_rejected) == (1, 1)
        pm.destroy(pid)
        _, r3 = s.submit(Task(memory_bytes=1, partition_id=pid))
        assert r3.decision == AdmitDecision.REJECT_DEPS


@pytest.mark.parametrize("use_native", BACKENDS)
class TestTransferEngine:
    def test_h2d_d2h_roundtrip(self, use_native):
        eng = AsyncTransferEngine(num_workers=2, use_native=use_native)
        assert eng.is_native == use_native
        arr = np.arange(1024, dtype=np.float32)
        buf = eng.h2d(arr, device="cpu").result(timeout=30)
        assert isinstance(buf, torch.Tensor) and buf.device.type == "cpu"
        back = eng.d2h(buf).result(timeout=30)
        np.testing.assert_array_equal(back, arr)
        s = eng.stats()
        assert s.completed >= 2
        assert s.bytes_h2d == arr.nbytes
        if use_native:
            assert eng.native_stats().completed >= 2
        eng.shutdown()

    def test_bitwise_across_chunks(self, use_native, monkeypatch):
        """Many staging chunks, an odd tail, bf16 bytes."""
        from pygpukit_tpu_torch.transfer import engine
        monkeypatch.setattr(engine, "CHUNK_BYTES", 4096)
        eng = AsyncTransferEngine(num_workers=1, use_native=use_native)
        arr = np.random.default_rng(0).standard_normal(3 * 1024 * 1024 + 7).astype(np.float32)
        t = eng.h2d(arr, device="cpu").result(30)
        assert t.numpy().tobytes() == arr.tobytes()
        bf = torch.from_numpy(arr).to(torch.bfloat16)
        back = eng.d2h(bf).result(30)
        assert back.tobytes() == bf.view(torch.uint16).numpy().tobytes()
        eng.shutdown()

    def test_priority_and_sync(self, use_native, cpu_backend):
        eng = AsyncTransferEngine(num_workers=1, use_native=use_native)
        futs = [eng.h2d(np.ones(16, np.float32), priority=AsyncTransferEngine.LOW)
                for _ in range(4)]
        hi = eng.h2d(np.zeros(16, np.float32), priority=AsyncTransferEngine.HIGH)
        eng.synchronize()
        assert hi.done() and all(f.done() for f in futs)
        eng.shutdown()

    def test_high_jumps_the_queue(self, use_native):
        """A HIGH upload queued behind LOW ones resolves before every LOW
        one still queued when it came (the worker is held busy first)."""
        import threading
        gate = threading.Event()
        eng = AsyncTransferEngine(num_workers=1, use_native=use_native)
        blocker = eng._submit(gate.wait, AsyncTransferEngine.LOW)
        lows = [eng.h2d(np.ones(16, np.float32), AsyncTransferEngine.LOW, device="cpu")
                for _ in range(4)]
        hi = eng.h2d(np.zeros(16, np.float32), AsyncTransferEngine.HIGH, device="cpu")
        gate.set()
        eng.synchronize()
        assert blocker.done()
        assert all(hi.finished_at < f.finished_at for f in lows)
        eng.shutdown()

    def test_flood(self, use_native):
        eng = AsyncTransferEngine(num_workers=3, use_native=use_native)
        futs = [eng.h2d(np.full(256, i, np.float32), device="cpu") for i in range(64)]
        for i, f in enumerate(futs):
            assert float(f.result(60)[0]) == i
        assert eng.stats().completed >= 64
        eng.shutdown()


def test_transfer_default_device_is_the_card_or_raises():
    eng = AsyncTransferEngine(num_workers=1, use_native=False)
    try:
        if torch.cuda.is_available():
            assert eng.h2d(np.ones(4, np.float32)).result(30).is_cuda
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                eng.h2d(np.ones(4, np.float32))
    finally:
        eng.shutdown()


class TestMultiModel:
    def test_contexts_and_budget(self):
        ctrl = MultiModelController(total_memory=1 << 30, device="cpu")
        a = ctrl.create_context("model_a", 1 << 29)
        b = ctrl.create_context("model_b", 1 << 29)
        with pytest.raises(MemoryError):
            ctrl.create_context("model_c", 1 << 29)
        with pytest.raises(ValueError):
            ctrl.create_context("model_a", 1)
        assert a.device_index != b.device_index
        assert a.run(lambda x: x * 2, 21) == 42
        assert ctrl.stats().contexts == 2
        ctrl.destroy_context("model_b")
        assert ctrl.create_context("model_c", 1 << 29) is not None  # budget freed
        ctrl.shutdown()

    def test_session_pins_device(self):
        ctrl = MultiModelController(total_memory=1 << 30, device="cpu")
        ctx = ctrl.create_context("m", 1 << 20, device_index=1)
        with ctx.session():
            x = torch.ones(4) + 1
        assert x.device.type == "cpu" and float(x.sum()) == 8.0
        ctrl.shutdown()

    def test_backend_devices(self, cpu_backend):
        ctrl = MultiModelController(total_memory=1 << 30)
        assert ctrl.devices == [torch.device("cpu")]
        ctrl.shutdown()

    @pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
    def test_without_a_card_the_default_controller_raises(self):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MultiModelController(total_memory=1 << 30)

    def test_run_async_contexts_concurrently(self):
        import asyncio
        ctrl = MultiModelController(total_memory=1 << 30, device="cpu")
        a = ctrl.create_context("a", 1 << 20)
        b = ctrl.create_context("b", 1 << 20)

        async def both():
            return await asyncio.gather(a.run_async(lambda: torch.arange(4) * 2),
                                        b.run_async(lambda: torch.arange(4) + 1))
        x, y = asyncio.run(both())
        assert x.tolist() == [0, 2, 4, 6] and y.tolist() == [1, 2, 3, 4]
        assert a.stats.executions == b.stats.executions == 1
        ctrl.shutdown()

    def test_paced_context_throttles(self):
        import time
        ctrl = MultiModelController(total_memory=1 << 30, device="cpu")
        ctx = ctrl.create_context("paced", 1 << 20, bandwidth_bytes_per_s=1e6)  # 1 MB/s
        t0 = time.monotonic()
        for _ in range(3):
            ctx.run(lambda: None, memory_bytes=60_000)  # > window budget
        assert ctx.pacing.stats.launches == 3
        assert ctx.pacing.stats.throttled >= 1
        assert time.monotonic() - t0 >= 0.04
        ctrl.shutdown()

    def test_run_sliced_correct_and_counted(self):
        ctrl = MultiModelController(total_memory=1 << 30, device="cpu")
        ctx = ctrl.create_context("sliced", 1 << 20, slice_rows=8)
        x = torch.arange(20.0).reshape(20, 1)
        out = ctx.run_sliced(lambda c: c * 2.0, x)
        assert torch.equal(out, x * 2.0)
        assert ctx.slicer.stats.slices == 3             # ceil(20/8)
        ctrl.shutdown()


# ------------------------------------------------------------------ parity --

def _pool_trace(mod, use_native: bool, ops: list) -> list:
    pool = mod.memory.MemoryPool(quota_bytes=96 << 10, use_native=use_native)
    live, by_class, log = [], {}, []
    for op in ops:
        if op[0] == "alloc" or (op[0] == "alloc_c" and op[1] not in by_class):
            size = op[1] if op[0] == "alloc" else 256 << op[1]
            try:
                b = pool.alloc(size, host_backed=op[2])
                (live.append(b) if op[0] == "alloc" else by_class.__setitem__(op[1], b))
                log.append(("alloc", b.block_id, b.size,
                            pool.host_buffer(b.block_id) is not None))
            except MemoryError:
                log.append(("alloc", "MemoryError"))
        elif op[0] == "free" and live:
            # op[2]: free a block and keep it listed (a later free is a double free)
            b = live[op[1] % len(live)] if op[2] else live.pop(op[1] % len(live))
            pool.free(b)
            log.append(("free", b.block_id))
        elif op[0] == "free_c" and op[1] in by_class:
            b = by_class.pop(op[1])
            pool.free(b)
            log.append(("free", b.block_id))
        elif op[0] == "trim":
            log.append(("trim", pool.trim(op[1])))
        log.append(tuple(pool.stats().__dict__.values()))
    return log


def _pool_ops(seed: int, shared: bool) -> list:
    """Random pool calls. ``shared``: at most one block of a size class
    exists at a time, no double frees and no trims (where the reference's
    routes agree: reuse order cannot differ)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(300):
        r = rng.random()
        if shared:
            c = int(rng.integers(10))               # 256 B .. 128 KB
            ops.append(("alloc_c" if r < 0.55 else "free_c", c, bool(rng.random() < 0.3)))
        elif r < 0.55:
            ops.append(("alloc", int(2 ** rng.uniform(6, 15)), bool(rng.random() < 0.3)))
        elif r < 0.9:
            ops.append(("free", int(rng.integers(1 << 30)), bool(rng.random() < 0.1)))
        else:
            ops.append(("trim", int(rng.integers(1, 40 << 10))))
    return ops


def _sched_trace(mod, use_native: bool, ops: list, states: bool = True) -> list:
    s = mod.scheduler.Scheduler(total_memory=1 << 20, overcommit_ratio=1.5, max_pending=8,
                                total_bandwidth=120.0, use_native=use_native)
    pm = mod.scheduler.PartitionManager(s)
    log, ids, parts = [], [], []
    for op in ops:
        kind = op[0]
        if kind == "submit":
            _, mem, bw, pol, prio, pref = op
            pid = (parts[pref % len(parts)] if parts and pref >= 0
                   else (0 if pref == -1 else 99))
            tid, r = s.submit(mod.scheduler.Task(memory_bytes=mem, bandwidth=bw,
                                                 policy=mod.scheduler.TaskPolicy(pol),
                                                 priority=prio, partition_id=pid))
            ids.append(tid)
            log.append(("submit", tid, int(r.decision), r.eta_seconds, r.available_memory))
        elif kind == "next":
            t = s.next_task()
            log.append(("next", None if t is None else t.task_id))
        elif kind == "complete":
            tid = ids[op[1] % len(ids)] if ids and op[1] >= 0 else 999
            s.complete(tid, failed=op[2])
            log.append(("complete", tid))
        elif kind == "create":
            pid = pm.create(mod.scheduler.PartitionLimits(memory_bytes=op[1],
                                                          bandwidth=op[2], max_streams=op[3]))
            parts.append(pid)
            log.append(("create", pid))
        elif kind == "destroy" and parts:
            pm.destroy(parts[op[1] % len(parts)])
        elif kind == "acquire" and parts:
            log.append(("acquire", pm.acquire(parts[op[1] % len(parts)], op[2], op[3])))
        elif kind == "release" and parts:
            pm.release(parts[op[1] % len(parts)], op[2], op[3])
        log.append(tuple(s.stats().__dict__.values()))
    if states:
        log.append([s.task_state(t) for t in ids + [999]])
    log.append([tuple(pm.usage(p).__dict__.values()) for p in parts])
    return log


def _sched_ops(seed: int, shared: bool) -> list:
    """Random scheduler and partition calls; ``shared``: no partitions, no
    completion but of the task just started (the reference's routes agree
    there)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(800):
        r = rng.random()
        if r < 0.45:
            ops.append(("submit", int(rng.choice([0, 1024, 64 << 10, 300 << 10, 900 << 10,
                                                  2 << 20])),
                        float(rng.choice([0.0, 0.0, 0.5, 2.5, 7.25])), int(rng.integers(3)),
                        int(rng.integers(-3, 4)),
                        -1 if shared else int(rng.choice([-1, -1, -1, -2, 0, 1, 2, 3]))))
        elif r < 0.57 or (shared and r < 0.8):
            ops.append(("next",))
            if shared:
                ops.append(("complete", -2, bool(rng.random() < 0.2)))
        elif r < 0.8:
            ops.append(("complete", int(rng.integers(-1, 1 << 20)), bool(rng.random() < 0.3)))
        elif shared:
            continue
        elif r < 0.84:
            ops.append(("create", int(rng.choice([4096, 300 << 10, 1 << 20])),
                        float(rng.choice([0.0, 5.0])), int(rng.integers(1, 4))))
        elif r < 0.86:
            ops.append(("destroy", int(rng.integers(1 << 20))))
        elif r < 0.94:
            ops.append(("acquire", int(rng.integers(1 << 20)), int(rng.integers(0, 200 << 10)),
                        float(rng.choice([0.0, 1.5]))))
        else:
            ops.append(("release", int(rng.integers(1 << 20)), int(rng.integers(0, 200 << 10)),
                        float(rng.choice([0.0, 1.5]))))
    return ops


@pytest.mark.skipif(not REF_NATIVE, reason="the reference's native library did not build")
@pytest.mark.parametrize("port_route", BACKENDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_matches_the_reference_native_route(seed, port_route):
    ops = _pool_ops(seed, shared=False)
    want = _pool_trace(ref, True, ops)
    assert ("alloc", "MemoryError") in want
    assert _pool_trace(__import__("pygpukit_tpu_torch"), port_route, ops) == want


@pytest.mark.skipif(not REF_NATIVE, reason="the reference's native library did not build")
@pytest.mark.parametrize("port_route", BACKENDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_and_partitions_match_the_reference_native_route(seed, port_route):
    ops = _sched_ops(seed, shared=False)
    want = _sched_trace(ref, True, ops)
    decisions = {e[2] for e in want if isinstance(e, tuple) and e and e[0] == "submit"}
    assert decisions >= {0, 1, 2, 3, 4, 5}, decisions       # every decision reached
    assert _sched_trace(__import__("pygpukit_tpu_torch"), port_route, ops) == want


def _shared_sched_trace(mod, use_native: bool, ops: list) -> list:
    """The shared trace: a completion ends the task ``next`` started last;
    no ETA and no states (the reference's Python route has neither)."""
    s = mod.scheduler.Scheduler(total_memory=1 << 20, overcommit_ratio=1.5, max_pending=8,
                                total_bandwidth=12.0, use_native=use_native)
    log, last = [], None
    for op in ops:
        if op[0] == "submit":
            _, mem, bw, pol, prio, _ = op
            tid, r = s.submit(mod.scheduler.Task(memory_bytes=mem, bandwidth=bw,
                                                 policy=mod.scheduler.TaskPolicy(pol),
                                                 priority=prio))
            log.append(("submit", tid, int(r.decision), r.available_memory))
        elif op[0] == "next":
            t = s.next_task()
            last = None if t is None else t.task_id
            log.append(("next", last))
        elif op[0] == "complete" and last is not None:
            s.complete(last, failed=op[2])
            log.append(("complete", last))
            last = None
        log.append(tuple(s.stats().__dict__.values()))
    return log


@pytest.mark.parametrize("port_route", BACKENDS)
@pytest.mark.parametrize("seed", [1, 2])
def test_scheduler_matches_the_reference_python_route(seed, port_route):
    ops = _sched_ops(seed, shared=True)
    want = _shared_sched_trace(ref, False, ops)
    if REF_NATIVE:                       # the domain where the reference's routes agree
        assert _shared_sched_trace(ref, True, ops) == want
    assert {e[2] for e in want if e[0] == "submit"} >= {0, 1, 2, 3, 4}
    assert _shared_sched_trace(__import__("pygpukit_tpu_torch"), port_route, ops) == want


@pytest.mark.parametrize("port_route", BACKENDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_pool_matches_the_reference_python_route(seed, port_route):
    ops = _pool_ops(seed, shared=True)
    want = _pool_trace(ref, False, ops)
    if REF_NATIVE:
        assert _pool_trace(ref, True, ops) == want
    assert _pool_trace(__import__("pygpukit_tpu_torch"), port_route, ops) == want


@pytest.mark.parametrize("port_route", BACKENDS)
def test_partitions_match_the_reference_python_route(port_route):
    """Partition calls alone (no tasks, nothing destroyed): the reference's
    Python route keeps them apart from its scheduler but decides the same."""
    rng = np.random.default_rng(5)
    logs = []
    for mod, route in ((ref, False), (__import__("pygpukit_tpu_torch"), port_route)):
        pm = mod.scheduler.PartitionManager(mod.scheduler.Scheduler(use_native=route))
        pids = [pm.create(mod.scheduler.PartitionLimits(memory_bytes=m, bandwidth=b,
                                                        max_streams=k))
                for m, b, k in ((4096, 0.0, 2), (1 << 20, 5.0, 3), (300 << 10, 2.5, 1))]
        log = []
        for _ in range(200):
            pid = pids[int(rng.integers(3))]
            mem, bw = int(rng.integers(0, 3000)), float(rng.choice([0.0, 1.5, 3.0]))
            if rng.random() < 0.6:
                log.append(pm.acquire(pid, mem, bw))
            else:
                pm.release(pid, mem, bw)
            log.append([tuple(pm.usage(p).__dict__.values()) for p in pids])
        logs.append(log)
        rng = np.random.default_rng(5)
    assert logs[0] == logs[1]


def test_ten_thousand_tasks_same_order_on_both_routes():
    """test_stress.py's pattern at 10 000 tasks (as the card phase runs it):
    the order the tasks' functions run in and the stats, both routes."""
    if len(BACKENDS) < 2:
        pytest.skip("the native library did not build")
    runs = []
    for route in BACKENDS:
        s = Scheduler(total_memory=1 << 40, max_pending=10_000, use_native=route)
        order = []
        for i in range(10_000):
            s.submit(Task(memory_bytes=1024 + (i % 7), policy=TaskPolicy(i % 3),
                          priority=(i * 7919) % 5, fn=lambda i=i: order.append(i)))
        assert s.run_pending() == 10_000
        runs.append((order, s.stats()))
    assert runs[0] == runs[1]
