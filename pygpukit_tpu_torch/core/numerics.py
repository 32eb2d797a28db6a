"""IEEE division by a constant on every device, and full-precision f32
products.

On CUDA, ``tensor / python_float`` is computed as ``tensor * (1 / d)``, which
can differ from the correctly rounded quotient in the last bit. The
reference's quantizers divide (``amax / 127.0`` in jnp), and a one-ulp
scale flips rounding of the quantized values, so every quantizer here
divides by a same-device tensor instead.
"""

from __future__ import annotations

import torch


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as an IEEE division, on the CPU and on CUDA."""
    return x / torch.full_like(x, d)


def require_full_f32(x: torch.Tensor, name: str) -> None:
    """Raise unless f32 products on x's device run at full precision: a
    CUDA tensor needs TF32 off (``set_deterministic_numerics``), as the
    reference's f32 dots run at ``HIGHEST``."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{name} needs allow_tf32=False on CUDA for full "
                           "f32 products")
