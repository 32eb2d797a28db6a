"""Device queries (counterpart of ``pygpukit_tpu/core/device.py``): the
card's name, count, memory and published peaks, read by the profiler side
of the port and by ``chip_smoke.py``'s bounds.

``CARD_PEAKS`` is the one table of published dense peaks (operations/s by
operand type, HBM bytes/s), matched by a lowercase substring of the
device's name. The memory size is the device's own
(``torch.cuda.get_device_properties``). On the CPU the peaks are the
reference's nominal CPU figures, used for no measurement, and the memory
is the host's. The reference's ``is_tpu_available`` becomes
``is_cuda_available``, the port's own backend query.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch

from .backend import get_backend, resolve_device

#: published dense peaks of the H100 SXM (NVIDIA's H100 data sheet, without
#: sparsity): operations/s by operand type and HBM3 bytes/s
CARD_PEAKS = {
    "h100": {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "hbm_bytes_s": 3.35e12},
}
#: the reference's nominal CPU figures (bf16 1 TFLOP/s, 50 GB/s)
_CPU_PEAKS = {"bf16": 1e12, "hbm_bytes_s": 50e9}


def card_peaks(kind: str) -> dict:
    """CARD_PEAKS' entry of a device named ``kind`` (KeyError if none)."""
    name = kind.lower()
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    raise KeyError(f"no published peaks for {kind!r}")


@dataclass
class DeviceInfo:
    platform: str
    device_kind: str
    index: int
    num_devices: int
    peak_bf16_tflops: float | None
    peak_hbm_gbps: float | None
    hbm_gib: float
    coords: tuple = field(default_factory=tuple)

    @property
    def name(self) -> str:
        return f"{self.device_kind} #{self.index}"


def host_memory_bytes() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def get_device_info(index: int = 0, device=None) -> DeviceInfo:
    """The backend's device ``index`` (``device`` None) or the named
    device; a card missing from CARD_PEAKS has no peaks (None)."""
    dev = resolve_device(device)
    if device is None and dev.type == "cuda":
        dev = torch.device("cuda", index)
    if dev.type != "cuda":
        return DeviceInfo("cpu", "cpu", 0, 1, _CPU_PEAKS["bf16"] / 1e12,
                          _CPU_PEAKS["hbm_bytes_s"] / 1e9, host_memory_bytes() / (1 << 30))
    props = torch.cuda.get_device_properties(dev)
    try:
        peaks = card_peaks(props.name)
        bf16, hbm = peaks["bf16"] / 1e12, peaks["hbm_bytes_s"] / 1e9
    except KeyError:
        bf16 = hbm = None
    return DeviceInfo("gpu", props.name, dev.index or 0, torch.cuda.device_count(), bf16,
                      hbm, props.total_memory / (1 << 30))


def device_count() -> int:
    """The CUDA cards visible to torch (0 without one)."""
    return torch.cuda.device_count()


def is_cuda_available() -> bool:
    return torch.cuda.is_available()
