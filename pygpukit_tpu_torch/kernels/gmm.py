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

bf16 operands with K, N and the lhs row stride multiples of 8 (16-byte
rows) take the kernel's TMA + wgmma route; f32 operands (an f32 model's,
which the reference hands megablox unchanged), bf16 ones off 8, and a
bf16/f32 pair (cast to f32) take its CUDA-core route
(``gmm_simt_kernel``: f32 FMAs, no TF32, any K, N and stride). Other
dtypes raise NotImplementedError. Both routes count as one ``gmm``
launch. Unlike megablox, M need not be a multiple of 128, and row tiles start at
each group's first row rather than on 128-row boundaries, so no tile spans
two groups: :func:`gmm_row_tiles` enumerates them as the kernel's device
scan (``gmm_locate`` in ``csrc/gmm.cu``) does, and :func:`gmm_plan` gives
the launch, which depends on the shapes alone.
"""

from __future__ import annotations

import torch

from ..core.numerics import require_full_f32
from ._build import launch, require_on, stream_of
from .gemm import H100_SMS, TILE_M, _cdiv, _rows16, pick_bn

_F32 = torch.float32
_BF16 = torch.bfloat16


def _check_shapes(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> None:
    if (lhs.dim() != 2 or rhs.dim() != 3 or group_sizes.dim() != 1
            or lhs.shape[1] != rhs.shape[1] or group_sizes.shape[0] != rhs.shape[0]):
        raise ValueError(f"gmm shapes: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}")


def gmm_row_tiles(sizes, m: int) -> list[tuple[int, int, int, int]]:
    """The kernel's row tiles in order, each ``(segment, lo, hi, m0)``: the
    tile computes rows ``[m0, m0 + TILE_M)`` and stores those in ``[lo,
    hi)``. Segment g < G holds group g's rows clamped to ``m``; segment G the
    rows past the sum of the sizes (stored as zeros). A segment of r rows
    has ``ceil(r / TILE_M)`` tiles starting at its first row."""
    tiles, end = [], 0
    for g, size in enumerate(list(sizes) + [None]):
        if size is None:                       # the rows past the sum
            lo, hi = min(end, m), m
        else:
            lo, hi = min(end, m), min(end + max(int(size), 0), m)
            end += max(int(size), 0)
        tiles += [(g, lo, hi, lo + j * TILE_M) for j in range(_cdiv(hi - lo, TILE_M))]
    return tiles


def gmm_plan(m: int, n: int, n_groups: int, sms: int = H100_SMS) -> dict:
    """The launch of an [m, k] x [n_groups, k, n] product: the tile width,
    the upper bound of row tiles (``ceil(m / TILE_M) + n_groups``) and the
    persistent grid. Depends on shapes alone, never on the group sizes."""
    row_bound = _cdiv(m, TILE_M) + n_groups
    bn = pick_bn(row_bound, n, sms)       # one CTA a tile, one tile an SM
    return {"bn": bn, "row_bound": row_bound, "tiles_n": _cdiv(n, bn),
            "grid": min(row_bound * _cdiv(n, bn), sms)}


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


def gmm_route(lhs_dtype: torch.dtype, rhs_dtype: torch.dtype, k: int, n: int) -> str:
    """The kernel route of CUDA operands (module docstring): "wgmma" or
    "simt"; NotImplementedError for a dtype neither takes."""
    for dt in (lhs_dtype, rhs_dtype):
        if dt not in (_BF16, _F32):
            raise NotImplementedError(f"the gmm kernel takes bf16 or f32 operands, got "
                                      f"{lhs_dtype} and {rhs_dtype}")
    if lhs_dtype == rhs_dtype == _BF16 and k % 8 == 0 and n % 8 == 0:
        return "wgmma"
    return "simt"


def _gmm_kernel(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/gmm.cu`` on CUDA operands."""
    m, k = lhs.shape
    n = rhs.shape[2]
    route = gmm_route(lhs.dtype, rhs.dtype, k, n)
    require_on(lhs.device, rhs=rhs, group_sizes=group_sizes)
    out = torch.empty((m, n), dtype=_F32, device=lhs.device)
    if m == 0:
        return out
    sizes = group_sizes.to(torch.int32).contiguous()
    rhs = rhs.contiguous()
    if route == "wgmma":
        lhs = _rows16(lhs)
        launch("gmm", "pgk_gmm", lhs.data_ptr(), rhs.data_ptr(), sizes.data_ptr(),
               out.data_ptr(), m, n, k, rhs.shape[0], lhs.stride(0), stream_of(lhs))
        return out
    if lhs.dtype != rhs.dtype:                  # a bf16/f32 pair: the f32 product
        lhs, rhs = lhs.to(_F32), rhs.to(_F32)
    lhs = lhs if lhs.stride(-1) == 1 else lhs.contiguous()
    launch("gmm", "pgk_gmm_simt", lhs.data_ptr(), rhs.data_ptr(), sizes.data_ptr(),
           out.data_ptr(), m, n, k, rhs.shape[0], lhs.stride(0), int(lhs.dtype == _F32),
           stream_of(lhs))
    return out


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped matmul, f32 [M, N] (see the module docstring)."""
    _check_shapes(lhs, rhs, group_sizes)
    if not lhs.is_cuda:
        return gmm_plain(lhs, rhs, group_sizes)
    return _gmm_kernel(lhs, rhs, group_sizes)
