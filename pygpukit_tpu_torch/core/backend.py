"""Device selection for the PyTorch port.

Counterpart of ``pygpukit_tpu/core/backend.py``. There the backend picks a
TPU or the CPU interpreter; here it picks a CUDA card when one is visible
and the CPU otherwise. Kernel wrappers do not consult this module: they key
on the device of the tensor they are given (CUDA tensor -> hand-written
kernel, CPU tensor -> its plain PyTorch version).
"""

from __future__ import annotations

import torch


def get_device() -> torch.device:
    """``cuda:0`` when a CUDA card is visible, else ``cpu``."""
    return torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when no card is visible. Entry
    points that measure or exercise the kernels call this: they must not
    fall back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible to torch")
    return torch.device("cuda", 0)


def set_deterministic_numerics() -> None:
    """Full-precision float32 products (no TF32) for matmuls and cuDNN, and
    f32 sums inside bf16 matmuls. TF32 keeps about three decimal digits,
    which breaks f32 parity with the reference package; a bf16 product with
    reduced-precision reductions may round partial sums to bf16, where the
    reference accumulates bf16 operands in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
