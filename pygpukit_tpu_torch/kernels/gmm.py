"""Grouped matmul: the port of megablox ``gmm``, which jax ships and
``pygpukit_tpu/ops/moe.py:60`` calls three times a MoE layer.

``gmm(lhs, rhs, group_sizes)`` computes what ``megablox.gmm`` computes with
its default ``preferred_element_type=float32``: ``lhs`` [M, K] with rows
sorted by group, ``rhs`` [G, K, N], ``group_sizes`` [G] int; rows
``offs[g]..offs[g+1]`` of the f32 result [M, N] are ``lhs[rows] @ rhs[g]``
(``offs`` the exclusive prefix sum of the sizes). Rows past the sum of the
sizes are zeros (megablox leaves them unwritten). A CUDA tensor launches
the hand-written kernel (``csrc/gmm.cu``), which reads the sizes from
device memory and needs no host sync; a CPU tensor runs ``gmm_plain``.

The kernel takes bf16 operands with K and N multiples of 8 (16-byte rows)
and raises NotImplementedError on anything else; it has no fall-back.
Unlike megablox, M need not be a multiple of 128: a partial row tile is
zero-filled on load and stored with predicates.
"""

from __future__ import annotations

import torch

from ..core.numerics import require_full_f32
from ._build import launch, require_on, stream_of
from .gemm import _rows16

_F32 = torch.float32
_BF16 = torch.bfloat16


def _check_shapes(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> None:
    if (lhs.dim() != 2 or rhs.dim() != 3 or group_sizes.dim() != 1
            or lhs.shape[1] != rhs.shape[1] or group_sizes.shape[0] != rhs.shape[0]):
        raise ValueError(f"gmm shapes: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}")


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes) -> torch.Tensor:
    """The kernel's plain version: one f32 ``torch.matmul`` per group over
    that group's rows. ``group_sizes`` is a tensor (read on the host) or a
    sequence of ints."""
    sizes = group_sizes.tolist() if isinstance(group_sizes, torch.Tensor) else list(group_sizes)
    require_full_f32(lhs, "gmm")
    m = lhs.shape[0]
    out = torch.zeros((m, rhs.shape[2]), dtype=_F32, device=lhs.device)
    start = 0
    for g, size in enumerate(sizes):
        end = min(start + max(int(size), 0), m)
        if end > start:
            out[start:end] = torch.matmul(lhs[start:end].to(_F32), rhs[g].to(_F32))
        start = end
    return out


def _gmm_kernel(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/gmm.cu`` on CUDA operands."""
    if lhs.dtype != _BF16 or rhs.dtype != _BF16:
        raise NotImplementedError(f"the gmm kernel takes bf16 operands, got {lhs.dtype} and "
                                  f"{rhs.dtype}")
    m, k = lhs.shape
    n = rhs.shape[2]
    if k % 8 or n % 8:
        raise NotImplementedError(f"the gmm kernel needs K and N multiples of 8, got K {k}, "
                                  f"N {n}")
    require_on(lhs.device, rhs=rhs, group_sizes=group_sizes)
    out = torch.empty((m, n), dtype=_F32, device=lhs.device)
    if m == 0:
        return out
    lhs = _rows16(lhs)
    rhs = rhs.contiguous()
    sizes = group_sizes.to(torch.int32).contiguous()
    launch("gmm", "pgk_gmm", lhs.data_ptr(), rhs.data_ptr(), sizes.data_ptr(), out.data_ptr(),
           m, n, k, rhs.shape[0], lhs.stride(0), stream_of(lhs))
    return out


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped matmul, f32 [M, N] (see the module docstring)."""
    _check_shapes(lhs, rhs, group_sizes)
    if not lhs.is_cuda:
        return gmm_plain(lhs, rhs, group_sizes)
    return _gmm_kernel(lhs, rhs, group_sizes)
