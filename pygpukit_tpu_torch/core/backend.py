"""Device selection for the PyTorch port.

Counterpart of ``pygpukit_tpu/core/backend.py``. There the backend picks a
TPU or the CPU interpreter; here every public constructor places its
tensors on ``cuda:0`` unless the caller names a device, and raises when no
card is visible: the CPU is used only when the caller asks for it
(``device="cpu"``). Kernel wrappers do not consult this module: they key on
the device of the tensor they are given (CUDA tensor -> hand-written
kernel, CPU tensor -> its plain PyTorch version).
"""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when no card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible to torch; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card (``require_cuda``)."""
    return torch.device(device) if device is not None else require_cuda()


def set_deterministic_numerics() -> None:
    """Full-precision float32 products (no TF32) for matmuls and cuDNN, and
    f32 sums inside bf16 matmuls. TF32 keeps about three decimal digits,
    which breaks f32 parity with the reference package; a bf16 product with
    reduced-precision reductions may round partial sums to bf16, where the
    reference accumulates bf16 operands in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
