"""IEEE division by a constant on every device.

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
