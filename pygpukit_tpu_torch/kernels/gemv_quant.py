"""w4a8 int4 matmul: the port of the reference's w4a8 GEMV and GEMM
(``pygpukit_tpu/kernels/gemv_quant.py``).

``y[M, N] = bf16((acc * scale[n]) * sx[m])`` where each activation row is
quantized to int8 (``sx = max(amax/127, 1e-12)``, round half to even) and
``acc`` is the exact integer dot with the split-half packed int4 weight
``[N, K/2]`` (low nibble = k < K/2). One entry point: on a CUDA tensor,
rows <= 8 launch the GEMV kernel (``csrc/w4a8_gemv.cu``) and rows > 8 the
GEMM kernel (``csrc/w4a8_gemm.cu``); on a CPU tensor the plain version runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.numerics import true_div
from ._build import launch, require_on, stream_of

_F32 = torch.float32
GEMV_MAX_ROWS = 8


def quantize_acts(x2: torch.Tensor):
    """Per-row int8 activation quant: (xq int8 [M, K], sx f32 [M, 1])."""
    xf = x2.to(_F32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    sx = torch.clamp_min(true_div(amax, 127.0), 1e-12)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def _rows(x: torch.Tensor, k_half: int) -> torch.Tensor:
    """x as [M, 2*k_half]: 1-D becomes one row; an odd in-dim the weight was
    pack-padded for is zero-extended (zeros leave amax unchanged)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[-1] < 2 * k_half:
        x2 = F.pad(x2, (0, 2 * k_half - x2.shape[-1]))
    elif x2.shape[-1] > 2 * k_half:
        raise ValueError(f"x K dim {x2.shape[-1]} exceeds packed weight K "
                         f"{2 * k_half}")
    return x2


def w4a8_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch w4a8 product. The integer dot runs as an f32 matmul of
    integer values: every product and partial sum is an integer below 2^24
    (|acc| <= 127 * 8 * K), so it is exact in any summation order, provided
    the product is true f32 (TF32 off on CUDA)."""
    from ..llm.quant import unpack_int4
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("w4a8_matmul_plain needs allow_tf32=False on CUDA "
                           "for an exact integer dot")
    x2 = _rows(x, packed.shape[-1])
    xq, sx = quantize_acts(x2)
    q = unpack_int4(packed)                                  # [N, K] int8
    acc = torch.matmul(xq.to(_F32), q.to(_F32).t())
    y = (acc * scale.reshape(1, -1).to(_F32)) * sx
    return y.to(torch.bfloat16)


def w4a8_matmul(x: torch.Tensor, packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] or [K] (bf16/f32), packed [N, K/2] uint8, scale [N] or
    [1, N] f32 -> y [M, N] bf16. CUDA tensors launch the GEMV (M <= 8) or
    GEMM (M > 8) kernel; CPU tensors take the plain version."""
    if not x.is_cuda:
        return w4a8_matmul_plain(x, packed, scale)
    n, k_half = packed.shape
    x2 = _rows(x, k_half)
    if x2.dtype not in (torch.bfloat16, _F32):
        raise TypeError(f"w4a8 kernels take bf16 or f32 activations, got {x2.dtype}")
    require_on(x2.device, packed=packed, scale=scale)
    if packed.dtype != torch.uint8 or not packed.is_contiguous():
        raise TypeError("packed weight must be a contiguous uint8 tensor")
    if k_half % 16:
        raise ValueError(f"w4a8 kernels need K % 32 == 0, got K={2 * k_half}")
    sc = scale.reshape(-1)
    if sc.dtype != _F32 or sc.numel() != n or not sc.is_contiguous():
        raise TypeError("scale must be a contiguous f32 tensor of N values")
    x2 = x2.contiguous()
    m = x2.shape[0]
    xq = torch.empty((m, 2 * k_half), dtype=torch.int8, device=x2.device)
    sx = torch.empty((m,), dtype=_F32, device=x2.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    name = "w4a8_gemv" if m <= GEMV_MAX_ROWS else "w4a8_gemm"
    launch(name, "pgk_" + name, x2.data_ptr(), int(x2.dtype == _F32),
           packed.data_ptr(), sc.data_ptr(), xq.data_ptr(), sx.data_ptr(),
           out.data_ptr(), m, n, k_half, stream_of(x2))
    return out
