"""Memory info and host/device copies (counterpart of
``pygpukit_tpu/core/memory.py``). The total is the device's (the card's
properties, or the host's memory on the CPU), the used bytes the caching
allocator's (none on the CPU), free = total - used, as the reference
defines them. Copies to the card go through pinned host memory and do not
block; ``copy_to_host_async`` starts a pinned device-to-host copy and
records an event that ``.result()`` waits on."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .array import Array
from .backend import resolve_device
from .device import host_memory_bytes
from .host import tensor_from_numpy, tensor_to_numpy


@dataclass
class MemoryInfo:
    total_bytes: int
    used_bytes: int
    free_bytes: int

    @property
    def total_gib(self) -> float:
        return self.total_bytes / (1 << 30)

    @property
    def used_gib(self) -> float:
        return self.used_bytes / (1 << 30)


def get_memory_info(device=None) -> MemoryInfo:
    """On ``device`` (the card unless named)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        used = torch.cuda.memory_allocated(dev)
    else:
        total, used = host_memory_bytes(), 0
    return MemoryInfo(total_bytes=total, used_bytes=used, free_bytes=total - used)


def copy_to_device(arr: np.ndarray, device=None) -> Array:
    """numpy -> an Array on ``device`` (the card unless named): through a
    pinned host copy and a non-blocking transfer on the card."""
    dev = resolve_device(device)
    t = tensor_from_numpy(np.asarray(arr))
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return Array(t.to(dev))


def copy_to_host(a: Array) -> np.ndarray:
    return a.to_numpy()


class _HostCopy:
    """A device-to-host copy in flight: ``result()`` waits for it."""

    def __init__(self, host: torch.Tensor, event):
        self._host, self._event = host, event

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return tensor_to_numpy(self._host)


def copy_to_host_async(a: Array) -> _HostCopy:
    """Start a copy of ``a`` to the host (pinned, non-blocking on the card)."""
    t = a.torch
    if not t.is_cuda:
        return _HostCopy(t.clone(), None)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return _HostCopy(host, ev)


def synchronize(device=None) -> None:
    """Wait for all work issued to ``device`` (the card unless named; the
    CPU's ops are done when they return)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
