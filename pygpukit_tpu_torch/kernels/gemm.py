"""Dense GEMM: the port of ``pygpukit_tpu/kernels/gemm.py``.

``gemm`` keeps the reference's route. ``PYGPUKIT_GEMM`` is read per call and
``force=`` overrides it: with ``"pallas"`` and ``m >= 64``, ``n >= 128``,
``k >= 128`` (the reference's size rule, :116) a CUDA tensor launches the
hand-written kernel (``csrc/gemm.cu``: bf16 on the tensor cores through the
TMA + wgmma mainloop of ``csrc/hopper_gemm.cuh``, f32 on the CUDA cores
without TF32) and a CPU tensor runs its plain version ``gemm_plain``. Every other call takes the reference's XLA route, a
``torch.matmul`` with f32 sums: bf16 x bf16 -> bf16 stays one bf16 product
on the card (cuBLAS sums in f32 while ``set_deterministic_numerics`` keeps
reduced-precision reductions off), everything else multiplies in f32 and
rounds once. f32 products need TF32 off on the card (the reference's
``HIGHEST``); ``PYGPUKIT_ALLOW_TF32`` is not ported.

The reference pads unaligned shapes to its tiles; the kernel predicates its
edges instead (TMA reads zeros past them), and the wrapper pads only where
the tensor maps' 16-byte rows need it (bf16 ``K % 8`` or ``N % 8``).

The bf16 launch plan is a function of the shapes and of how many clusters
the card runs at once alone, mirrored here for the tests: :func:`gemm_plan`
(the tile width and the persistent grid of CTA clusters, which share A
along a row and B along a column), :func:`raster` and :func:`gemm_tile`
(which tile each CTA computes, in order); ``hg_pick_bn`` and ``hg_raster`` in
``csrc/hopper_gemm.cuh`` and the tile loop of ``csrc/gemm.cu`` are the same
functions.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ..core.numerics import require_full_f32
from ._build import launch, require_on, stream_of

_F32 = torch.float32
_BF16 = torch.bfloat16
GEMM_ENV = "PYGPUKIT_GEMM"
#: the kernel route's smallest sizes (the reference's rule at gemm.py:116)
MIN_M, MIN_N, MIN_K = 64, 128, 128
#: the bf16 mainloop's tile rows and K depth a stage, its tile widths (first
#: wins a tie), the units of one raster group, and the H100 SXM's SMs
TILE_M, TILE_K, TILE_NS, RASTER_ROWS, H100_SMS = 128, 64, (256, 128), 16, 132
#: gemm's cluster of each tile width, (row tiles, column tiles), and how many
#: of them fit on the H100 at once (the card reports its own: pgk_gemm_plan)
CLUSTERS = {256: (2, 1), 128: (2, 2)}
H100_CLUSTERS = {256: 66, 128: 33}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_bn(row_tiles: int, n: int, sms: int = H100_SMS) -> int:
    """gmm's tile width for ``row_tiles`` 128-row tiles over ``n`` columns
    on ``sms`` SMs: the one whose waves cost least (waves x width), 256 on a
    tie."""
    costs = [_cdiv(row_tiles * _cdiv(n, bn), sms) * bn for bn in TILE_NS]
    return TILE_NS[costs.index(min(costs))]


def gemm_units(m: int, n: int, bn: int) -> tuple[int, int]:
    """Row and column units of an [m, n] output at tile width ``bn``: a unit
    is the CLUSTERS[bn] tiles one cluster computes."""
    cm, cn = CLUSTERS[bn]
    return _cdiv(_cdiv(m, TILE_M), cm), _cdiv(_cdiv(n, bn), cn)


def gemm_plan(m: int, n: int, clusters: dict = H100_CLUSTERS) -> dict:
    """The bf16 kernel's launch plan for an [m, k] @ [k, n] product, with
    ``clusters[bn]`` clusters running at once: the tile width whose waves of
    units cost least (waves x width, 256 on a tie), its cluster shape, the
    units, the persistent grid (``grid`` CTAs) and its waves. Depends on
    shapes alone."""
    units = {bn: gemm_units(m, n, bn) for bn in TILE_NS}
    cost = {bn: _cdiv(um * un, clusters[bn]) * bn for bn, (um, un) in units.items()}
    bn = 128 if cost[128] < cost[256] else 256
    (cm, cn), (units_m, units_n) = CLUSTERS[bn], units[bn]
    units = units_m * units_n
    return {"bn": bn, "cluster": (cm, cn), "units_m": units_m, "units_n": units_n,
            "units": units, "grid": cm * cn * min(units, clusters[bn]),
            "waves": _cdiv(units, clusters[bn])}


def raster(t: int, tiles_m: int, tiles_n: int) -> tuple[int, int]:
    """(row unit, column unit) of unit ``t`` in launch order: groups of
    RASTER_ROWS row units, each swept column by column with its row units
    fastest."""
    per = RASTER_ROWS * tiles_n
    first = t // per * RASTER_ROWS
    h = min(RASTER_ROWS, tiles_m - first)
    r = t % per
    return first + r % h, r // h


def gemm_tile(unit: int, rank: int, plan: dict) -> tuple[int, int]:
    """(row tile, column tile) that CTA ``rank`` (``rm + cm * rn``) of a
    ``(cm, cn)`` cluster computes for ``unit``: row tile ``cm * um + rm``,
    column tile ``cn * un + rn`` (past the last when their count is not a
    multiple: zeros read, nothing stored)."""
    cm, cn = plan["cluster"]
    um, un = raster(unit, plan["units_m"], plan["units_n"])
    return um * cm + rank % cm, un * cn + rank // cm


def xla_dot(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The reference's XLA dot (2-D or batched): f32 sums, one rounding to
    ``out_dtype``."""
    if a.is_cuda and a.dtype == b.dtype == out_dtype == _BF16:
        return torch.matmul(a, b)
    require_full_f32(a, "gemm")
    return torch.matmul(a.to(_F32), b.to(_F32)).to(out_dtype)


def gemm_plain(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's plain version: ``(a.float() @ b.float()).to(out_dtype)``."""
    require_full_f32(a, "gemm")
    return torch.matmul(a.to(_F32), b.to(_F32)).to(out_dtype)


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """t with unit column stride, 16-byte rows and a 16-byte aligned start."""
    if (t.stride(-1) != 1 or (t.stride(0) * t.element_size()) % 16
            or t.data_ptr() % 16):
        t = t.contiguous()
    return t


def _gemm_kernel(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``csrc/gemm.cu`` on CUDA operands."""
    if a.dtype not in (_BF16, _F32) or b.dtype not in (_BF16, _F32):
        raise NotImplementedError(f"the gemm kernel takes bf16 or f32 operands, got "
                                  f"{a.dtype} and {b.dtype}")
    if out_dtype not in (_BF16, _F32):
        raise NotImplementedError(f"the gemm kernel writes bf16 or f32, not {out_dtype}")
    require_on(a.device, b=b)
    if a.dtype != b.dtype:                   # mixed bf16/f32: an f32 product
        a, b = a.to(_F32), b.to(_F32)
    is_f32 = a.dtype == _F32
    if is_f32:
        require_full_f32(a, "gemm")
    m, k = a.shape
    n = b.shape[1]
    if not is_f32:
        kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
        if kp != k:
            a, b = F.pad(a, (0, kp - k)), F.pad(b, (0, 0, 0, kp - k))
        if np_ != n:
            b = F.pad(b, (0, np_ - n))
        a, b = _rows16(a), _rows16(b)
        k = kp
    else:
        a = a if a.stride(-1) == 1 else a.contiguous()
        b = b if b.stride(-1) == 1 else b.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    launch("gemm", "pgk_gemm", a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
           a.stride(0), b.stride(0), n, int(is_f32), int(out_dtype == _F32),
           stream_of(a))
    return out


def gemm(a: torch.Tensor, b: torch.Tensor, *, out_dtype: torch.dtype | None = None,
         force: str | None = None) -> torch.Tensor:
    """C[m, n] = A[m, k] @ B[k, n] (route in the module docstring)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    mode = force or os.environ.get(GEMM_ENV, "")
    m, k = a.shape
    n = b.shape[1]
    if not (mode == "pallas" and m >= MIN_M and n >= MIN_N and k >= MIN_K):
        return xla_dot(a, b, out_dtype)
    if not a.is_cuda:
        return gemm_plain(a, b, out_dtype)
    return _gemm_kernel(a, b, out_dtype)


def batched_gemm(a: torch.Tensor, b: torch.Tensor, *,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """[B, m, k] @ [B, k, n]: the reference's batched XLA dot, f32 sums."""
    return xla_dot(a, b, out_dtype or torch.promote_types(a.dtype, b.dtype))
