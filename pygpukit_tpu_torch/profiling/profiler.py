"""Op profiler (counterpart of ``pygpukit_tpu/profiling/profiler.py``):
KernelRecord with derived TFLOP/s and GB/s, an enable flag, nothing
recorded while disabled.

An op's time is the host wall clock around a device barrier
(``torch.cuda.synchronize`` on the result's card, or on every card when
there is no result; nothing on the CPU). ``trace`` wraps
``torch.profiler.profile`` with the CPU and CUDA activities and writes a
Chrome trace into its directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch
from torch.utils import _pytree as pytree

from ..core.backend import resolve_device


@dataclass
class KernelRecord:
    """One op's record."""
    name: str
    ms: float
    flops: int = 0
    bytes: int = 0
    count: int = 1

    @property
    def us(self) -> float:
        return self.ms * 1e3

    @property
    def tflops(self) -> float:
        return self.flops / (self.ms * 1e-3) / 1e12 if self.ms > 0 else 0.0

    @property
    def gbps(self) -> float:
        return self.bytes / (self.ms * 1e-3) / 1e9 if self.ms > 0 else 0.0


def _sync(result=None) -> None:
    """Device barrier: the cards ``result`` lies on, or every card when
    there is no result."""
    cards = {x.device for x in pytree.tree_leaves(result)
             if isinstance(x, torch.Tensor) and x.is_cuda}
    if result is None and torch.cuda.is_available():
        torch.cuda.synchronize()
    for dev in cards:
        torch.cuda.synchronize(dev)


class Profiler:
    """Enable, record, report."""

    def __init__(self):
        self.enabled = False
        self.records: list[KernelRecord] = []
        self.last_trace: str | None = None

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self.records.clear()

    @contextlib.contextmanager
    def record(self, name: str, flops: int = 0, bytes: int = 0):  # noqa: A002
        """Time the block; put its result under ``holder["result"]`` so the
        barrier waits for it."""
        if not self.enabled:
            yield
            return
        _sync()
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            _sync(holder.get("result"))
            ms = (time.perf_counter() - t0) * 1e3
            self.records.append(KernelRecord(name, ms, flops, bytes))

    def profile_fn(self, name: str, fn, *args, flops: int = 0,
                   bytes: int = 0, iters: int = 10, warmup: int = 2):  # noqa: A002
        """Time ``fn(*args)``: ``warmup`` calls, then the mean of ``iters``."""
        out = None
        for _ in range(warmup):
            out = fn(*args)
        _sync(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _sync(out)
        ms = (time.perf_counter() - t0) * 1e3 / iters
        rec = KernelRecord(name, ms, flops, bytes, count=iters)
        self.records.append(rec)
        return rec

    def stats(self) -> dict[str, KernelRecord]:
        """Records summed by name."""
        agg: dict[str, KernelRecord] = {}
        for r in self.records:
            if r.name in agg:
                a = agg[r.name]
                a.ms += r.ms
                a.flops += r.flops
                a.bytes += r.bytes
                a.count += r.count
            else:
                agg[r.name] = KernelRecord(r.name, r.ms, r.flops, r.bytes, r.count)
        return agg

    def summary(self) -> str:
        lines = [f"{'name':<32}{'count':>6}{'total ms':>10}{'TFLOPS':>9}{'GB/s':>9}"]
        for name, r in sorted(self.stats().items(), key=lambda kv: -kv[1].ms):
            lines.append(f"{name:<32}{r.count:>6}{r.ms:>10.3f}"
                         f"{r.tflops:>9.2f}{r.gbps:>9.1f}")
        return "\n".join(lines)

    @contextlib.contextmanager
    def trace(self, logdir: str):
        """``torch.profiler`` over the block (CPU and, with a card, CUDA
        activities); the Chrome trace goes to ``logdir`` and its path to
        ``last_trace``. Yields the profile."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield prof
            _sync()
        path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        self.last_trace = path


_global = Profiler()


def get_profiler() -> Profiler:
    return _global


def enable_profiling() -> None:
    _global.enable()


def disable_profiling() -> None:
    _global.disable()


def get_profile_stats() -> dict[str, KernelRecord]:
    return _global.stats()


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 output, the reference's ``preferred_element_type``:
    one f32-output product of the operands (``aten::mm.dtype``) for bf16 or
    f16 on the card, else the port's dot rule (``kernels.gemm.xla_dot``:
    f32 operands, f32 sums)."""
    if (a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) and a.dtype == b.dtype
            and hasattr(torch.ops.aten.mm, "dtype")):
        return torch.ops.aten.mm.dtype(a, b, torch.float32)
    from ..kernels.gemm import xla_dot
    return xla_dot(a, b, torch.float32)


def profile_matmul(m: int = 4096, n: int = 4096, k: int = 4096,
                   dtype="bfloat16", device=None) -> KernelRecord:
    """Time one ``m x k @ k x n`` product of ``dtype`` operands with f32
    output (seeded normal operands on ``device``, the backend's unless
    named)."""
    dev = resolve_device(device)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((m, k), generator=g, device=dev).to(dt)
    b = torch.randn((k, n), generator=g, device=dev).to(dt)
    itemsize = a.element_size()
    return _global.profile_fn(f"matmul_{m}x{n}x{k}_{dtype}", _f32_product, a, b,
                              flops=2 * m * n * k,
                              bytes=(m * k + k * n) * itemsize + m * n * 4)
