"""Benchmark framework (counterpart of ``pygpukit_tpu/benchmark/base.py``):
a base suite with a markdown report headed by the device and its peaks.

``time_fn`` times the captured path where the reference times a jitted
one: ``fn`` is captured once at its arguments (``core.capture``: a CUDA
graph on the card, a plain call on the CPU), replayed ``warmup`` times,
then ``iters`` replays between two card synchronizes on the host's wall
clock.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
from torch.utils import _pytree as pytree

from ..core.backend import resolve_device
from ..core.executable import capture


@dataclass
class BenchResult:
    name: str
    ms: float
    flops: int = 0
    bytes: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def tflops(self) -> float:
        return self.flops / (self.ms * 1e-3) / 1e12 if self.ms else 0.0

    @property
    def gbps(self) -> float:
        return self.bytes / (self.ms * 1e-3) / 1e9 if self.ms else 0.0


def _hard_sync(out) -> None:
    """Wait for the cards ``out`` lies on."""
    for dev in {x.device for x in pytree.tree_leaves(out)
                if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(dev)


def time_fn(fn, *args, iters: int = 20, warmup: int = 3) -> float:
    """Steady-state mean ms of ``fn(*args)`` by replays of its capture."""
    exe = capture(fn, *args, name=getattr(fn, "__name__", "bench"))
    try:
        out = None
        for _ in range(warmup):
            out = exe.replay(*args)
        _hard_sync(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = exe.replay(*args)
        _hard_sync(out)
        return (time.perf_counter() - t0) * 1e3 / iters
    finally:
        exe.reset()


class Benchmark:
    """Base suite: subclasses implement run() appending to self.results,
    on ``device`` (the backend's unless named)."""

    title = "benchmark"

    def __init__(self, device=None):
        self.device = device
        self.results: list[BenchResult] = []

    def _device(self) -> torch.device:
        return resolve_device(self.device)

    def run(self) -> None:
        raise NotImplementedError

    def report_markdown(self) -> str:
        from ..core.device import get_device_info
        info = get_device_info(device=self.device)
        bf16, hbm = info.peak_bf16_tflops, info.peak_hbm_gbps
        peaks = (f"peak {bf16:.0f} bf16 TFLOPS, {hbm:.0f} GB/s HBM" if bf16 and hbm
                 else "no published peaks")
        lines = [
            f"## {self.title}",
            "",
            f"Device: {info.device_kind} ({peaks})",
            "",
            "| name | ms | TFLOPS | GB/s | % peak |",
            "|---|---|---|---|---|",
        ]
        for r in self.results:
            if bf16 and hbm:
                pct = f"{100 * r.tflops / bf16 if r.flops else 100 * r.gbps / hbm:.0f}%"
            else:
                pct = "—"
            lines.append(f"| {r.name} | {r.ms:.3f} | {r.tflops:.1f} | {r.gbps:.0f} | {pct} |")
        return "\n".join(lines)
