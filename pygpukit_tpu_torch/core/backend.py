"""Backend selection for the PyTorch port (counterpart of
``pygpukit_tpu/core/backend.py``).

The reference picks a TPU or the CPU interpreter. Here the backend is the
card (platform ``"gpu"``: every CUDA device torch sees, ``cuda:0`` first)
or the CPU (platform ``"cpu"``). Every public constructor places its
tensors on the backend's device unless the caller names one
(``resolve_device``). The backend is chosen once and kept:

- ``PYGPUKIT_BACKEND=cpu`` (or ``gpu``/``cuda``) names it;
- otherwise the card when torch sees one;
- otherwise ``get_backend()`` raises RuntimeError, as ``require_cuda`` does.

It never falls to the CPU on its own: the CPU is the caller's choice,
``set_backend("cpu")``, the variable, or ``device="cpu"`` at a call.
Kernel wrappers do not consult this module: they key on the device of the
tensor they are given (CUDA tensor -> hand-written kernel, CPU tensor ->
its plain PyTorch version), so ``interpret_mode()`` (the CPU backend) is
when the plain versions run.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import torch

_PLATFORMS = {"gpu": "gpu", "cuda": "gpu", "cpu": "cpu"}


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when no card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible to torch; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", 0)


@dataclass(frozen=True)
class Backend:
    """The resolved backend: ``platform`` ``"gpu"`` or ``"cpu"``;
    ``interpret`` is True on the CPU, where the kernels' plain versions
    run."""

    platform: str
    interpret: bool

    @property
    def is_simulation(self) -> bool:
        return self.platform != "gpu"

    def devices(self) -> list[torch.device]:
        if self.platform == "cpu":
            return [torch.device("cpu")]
        require_cuda()
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    @property
    def device(self) -> torch.device:
        return torch.device("cpu") if self.platform == "cpu" else require_cuda()

    @property
    def device_count(self) -> int:
        return len(self.devices())


_lock = threading.Lock()
_backend: Backend | None = None


def _make(platform: str, interpret: bool | None = None) -> Backend:
    name = _PLATFORMS.get(str(platform).lower())
    if name is None:
        raise ValueError(f"unknown backend {platform!r}: choose gpu or cpu")
    if interpret is not None and interpret != (name == "cpu"):
        raise ValueError("the plain versions run exactly on the CPU backend "
                         f"(interpret={interpret} asked with {name!r})")
    return Backend(platform=name, interpret=name == "cpu")


def get_backend() -> Backend:
    """The backend (module docstring); RuntimeError with no card unless
    the CPU was asked for."""
    global _backend
    with _lock:
        if _backend is None:
            forced = os.environ.get("PYGPUKIT_BACKEND")
            if forced:
                _backend = _make(forced)
            else:
                require_cuda()
                _backend = _make("gpu")
        return _backend


def set_backend(platform: str, *, interpret: bool | None = None) -> Backend:
    """Choose the backend: ``set_backend("cpu")`` (the tests' hook, as the
    reference's) or ``set_backend("gpu")``."""
    global _backend
    with _lock:
        _backend = _make(platform, interpret)
        return _backend


def reset_backend() -> None:
    """Forget the choice: the next ``get_backend()`` chooses again."""
    global _backend
    with _lock:
        _backend = None


def default_device() -> torch.device:
    return get_backend().device


def interpret_mode() -> bool:
    """True on the CPU backend, where the plain versions run."""
    return get_backend().interpret


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the backend's device (the
    card unless the CPU was asked for)."""
    return torch.device(device) if device is not None else get_backend().device


def set_deterministic_numerics() -> None:
    """Full-precision float32 products (no TF32) for matmuls and cuDNN, and
    f32 sums inside bf16 matmuls. TF32 keeps about three decimal digits,
    which breaks f32 parity with the reference package; a bf16 product with
    reduced-precision reductions may round partial sums to bf16, where the
    reference accumulates bf16 operands in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
