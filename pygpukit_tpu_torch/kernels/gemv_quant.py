"""Quantized decode matmuls: the port of the reference's GEMVs and w4a8
GEMM (``pygpukit_tpu/kernels/gemv_quant.py``).

Five products, each a wrapper over a hand-written kernel beside a plain
PyTorch version. A CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain version.

- ``w4a8_matmul``: int4 ``[N, K/2]`` + per-column scale, per-row int8
  activations; rows <= 8 the GEMV kernel (``csrc/w4a8_gemv.cu``, int8
  mma.sync over 16-column tiles, K split across a block's warps, launched
  as the activation quantization's programmatic dependent:
  :func:`w4a8_gemv_plan`),
  rows > 8 the GEMM (``csrc/w4a8_gemm.cu``, int8 wgmma with split K where
  the tiles alone fill the card poorly: :func:`w4a8_gemm_plan`).
- ``w4a16_matmul``: the same int4 leaf against bf16 activations
  (``csrc/w4a16_gemv.cu``, bf16 mma.sync over 16-column tiles, K split
  across a block's warps, launched as its predecessor's programmatic
  dependent: :func:`w4a16_plan`).
- ``block_w4a8_matmul`` / ``block_w4a16_matmul``: int4_block K-major
  ``[K/2, N]`` + bf16 block scales ``[K/B, N]`` (``csrc/block_w4a8_gemv.cu``,
  a column tile a block over all of K, folded in order: :func:`block_w4a8_plan`;
  ``csrc/block_w4a16_gemv.cu``, bf16 mma.sync over 64-column tiles with K
  split across a cluster's blocks, launched as its predecessor's
  programmatic dependent: :func:`block_w4a16_plan`).
- ``conv_matmul``: a K-major ``[K, N]`` fp8 e4m3fn / e5m2, int8 or bf16
  weight converted to bf16 in the kernel, times a per-column scale
  (``csrc/conv_gemv.cu``, 64-column tiles with K split across a cluster's
  blocks and folded in order: :func:`conv_gemv_plan`).
- ``gemv_quant``: the reference's library GEMV over an N-major ``[N, K]``
  weight of the same four storage types against one row
  (``csrc/gemv_quant.cu``).

The four GEMVs take rows <= 8 on the card; the model sends more rows to the
plain versions (``llm/model.py`` route rule), whose ``out_dtype`` keeps the
head's logits in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.numerics import require_full_f32, true_div
from ._build import launch, require_on, stream_of
from .gemm import H100_SMS, raster

_F32 = torch.float32
_BF16 = torch.bfloat16
GEMV_MAX_ROWS = 8

#: conv_gemv's storage kinds (the C entry's ``kind``)
CONV_KINDS = {torch.float8_e4m3fn: 0, torch.float8_e5m2: 1, torch.int8: 2,
              torch.bfloat16: 3}


def quantize_acts(x2: torch.Tensor):
    """Per-row int8 activation quant: (xq int8 [M, K], sx f32 [M, 1])."""
    xf = x2.to(_F32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    sx = torch.clamp_min(true_div(amax, 127.0), 1e-12)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def _rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """x as [M, k]: 1-D becomes one row; an in-dim the weight was padded
    for (int4 pack padding, int4_block block padding) is zero-extended
    (zeros leave amax and every dot unchanged)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[-1] < k:
        x2 = F.pad(x2, (0, k - x2.shape[-1]))
    elif x2.shape[-1] > k:
        raise ValueError(f"x K dim {x2.shape[-1]} exceeds the weight's K {k}")
    return x2


def _gemv_rows(x2: torch.Tensor, name: str) -> int:
    m = x2.shape[0]
    if not 1 <= m <= GEMV_MAX_ROWS:
        raise ValueError(f"{name} takes 1 to {GEMV_MAX_ROWS} rows, got {m}")
    return m


def _col_scale(scale: torch.Tensor, n: int) -> torch.Tensor:
    sc = scale.reshape(-1)
    if sc.dtype != _F32 or sc.numel() != n or not sc.is_contiguous():
        raise TypeError("scale must be a contiguous f32 tensor of N values")
    return sc


def _packed_u8(packed: torch.Tensor) -> None:
    if packed.dtype != torch.uint8 or packed.dim() != 2 or not packed.is_contiguous():
        raise TypeError("packed weight must be a contiguous 2-D uint8 tensor")


# ---------------------------------------------------------------------------
# int4 [N, K/2]: w4a8 and w4a16
# ---------------------------------------------------------------------------

def w4a8_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch w4a8 product. The integer dot runs as an f32 matmul of
    integer values: every product and partial sum is an integer below 2^24
    (|acc| <= 127 * 8 * K), so it is exact in any summation order, provided
    the product is true f32 (TF32 off on CUDA); on CPU tensors as the int8
    product ``ops.matmul.int8_dot`` (the same integers, without an f32 copy
    of the weight)."""
    from ..llm.quant import unpack_int4
    from ..ops.matmul import int8_dot
    require_full_f32(x, "w4a8_matmul_plain")
    x2 = _rows(x, 2 * packed.shape[-1])
    xq, sx = quantize_acts(x2)
    q = unpack_int4(packed)                                  # [N, K] int8
    if x2.is_cuda:
        acc = torch.matmul(xq.to(_F32), q.to(_F32).t())
    else:
        acc = int8_dot(q, xq.t()).t().to(_F32)
    y = (acc * scale.reshape(1, -1).to(_F32)) * sx
    return y.to(_BF16)


#: w4a8_gemm's tile (weight rows = output columns, activation rows), the
#: packed bytes of K a stage, its K splits at most, and the tiles it splits
#: at most (``csrc/w4a8_gemm.cu``)
W4A8_TILE_N, W4A8_TILE_M, W4A8_STAGE_K, W4A8_MAX_SPLITS, W4A8_MAX_SPLIT_TILES = \
    128, 128, 128, 8, 4096
#: int32 values of one unit's split-K sums in the GEMM's scratch
W4A8_UNIT_INTS = W4A8_TILE_N * W4A8_TILE_M


def w4a8_gemm_plan(m: int, n: int, k_half: int, sms: int = H100_SMS) -> dict:
    """The w4a8 GEMM's launch plan for M rows, N columns and K/2 packed
    bytes on ``sms`` SMs: tiles of 128 x 128, ``n_k`` stages of 128 packed
    bytes of K, and the K splits whose waves of units cost least (waves x
    stages a unit, the fewest splits on a tie) among those that keep the
    units within two waves; a unit is a split of a tile, the persistent
    grid at most one block an SM. Depends on the shapes (and the card)
    alone; ``w4a8_plan`` in the kernel is the same rule."""
    tiles_m, tiles_n = -(-m // W4A8_TILE_M), -(-n // W4A8_TILE_N)
    n_k = -(-k_half // W4A8_STAGE_K)
    tiles = tiles_m * tiles_n
    splits = 1
    if tiles <= W4A8_MAX_SPLIT_TILES:
        best = -(-tiles // sms) * n_k
        for s in range(2, min(W4A8_MAX_SPLITS, n_k, 2 * sms // tiles) + 1):
            cost = -(-tiles * s // sms) * -(-n_k // s)
            if cost < best:
                best, splits = cost, s
    units = tiles * splits
    return {"tiles_m": tiles_m, "tiles_n": tiles_n, "n_k": n_k, "splits": splits,
            "units": units, "grid": min(units, sms)}


def w4a8_gemm_unit(u: int, plan: dict) -> tuple[int, int, int, int]:
    """(activation tile, weight tile, first stage, end stage) of unit ``u``:
    split ``u % splits`` of tile ``u // splits``, the tiles in
    :func:`~pygpukit_tpu_torch.kernels.gemm.raster` order (the kernel's
    ``w4_unit``)."""
    s, sp, n_k = u % plan["splits"], plan["splits"], plan["n_k"]
    tm, tn = raster(u // sp, plan["tiles_m"], plan["tiles_n"])
    return tm, tn, s * n_k // sp, (s + 1) * n_k // sp


#: the w4a8 GEMV (``csrc/w4a8_gemv.cu``): output columns a block (the
#: mma's M), and the 16-byte chunks of a packed column up to which a block
#: runs 4 warps, then 8 (16 above)
W4A8_GEMV_TILE, W4A8_GEMV_NARROW_CHUNKS, W4A8_GEMV_WIDE_CHUNKS = 16, 32, 128


def w4a8_gemv_plan(rows: int, n: int, k_half: int) -> dict:
    """The w4a8 GEMV's launch plan: a block a 16-column tile over all of K,
    its warps (4 up to W4A8_GEMV_NARROW_CHUNKS 16-byte chunks a column, 8 up
    to W4A8_GEMV_WIDE_CHUNKS, 16 above) each a contiguous slice of the
    chunks (:func:`w4a8_gemv_slices`); rows do not change it. The kernel's
    ``pgk_w4a8_gemv_plan`` is the same rule."""
    chunks = k_half // 16
    warps = 4 if chunks <= W4A8_GEMV_NARROW_CHUNKS else 8 if chunks <= W4A8_GEMV_WIDE_CHUNKS \
        else 16
    return {"tile_n": W4A8_GEMV_TILE, "blocks": -(-n // W4A8_GEMV_TILE), "warps": warps}


def w4a8_gemv_slices(k_half: int, warps: int) -> list[tuple[int, int]]:
    """The 16-byte chunks ``[c0, c1)`` of a packed column that each warp of
    a block sums; lane t of a group takes chunks c0 + 4 i + t (round i)."""
    nch = k_half // 16
    return [(w * nch // warps, (w + 1) * nch // warps) for w in range(warps)]


def w4a8_gemv_launch(x2: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                     pdl: bool = True) -> torch.Tensor:
    """The w4a8 GEMV kernel on CUDA rows ``x2`` [M <= 8, K]: the activation
    quantization's launch, then the GEMV as its programmatic dependent
    (``pdl``, what :func:`w4a8_matmul` takes) or after it. Both are bitwise
    the plain version, which CPU rows take."""
    if not x2.is_cuda:
        return w4a8_matmul_plain(x2, packed, scale)
    x2 = _rows(x2, 2 * packed.shape[1])
    _w4a8_operands(x2, packed, scale, packed.shape[1])
    return _w4a8_gemv(x2, packed, scale, pdl)


def _w4a8_gemv(x2: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
               pdl: bool) -> torch.Tensor:
    """:func:`w4a8_gemv_launch` past the operand checks it shares with the
    GEMM."""
    n, k_half = packed.shape
    m = _gemv_rows(x2, "w4a8_gemv")
    if packed.data_ptr() % 16:
        raise ValueError("w4a8_gemv needs a 16-byte aligned packed weight")
    sc = _col_scale(scale, n)
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:                          # the quantization reads x in 16-byte words
        x2 = x2.clone()
    xq = torch.empty((m, 2 * k_half), dtype=torch.int8, device=x2.device)
    sx = torch.empty((m,), dtype=_F32, device=x2.device)
    out = torch.empty((m, n), dtype=_BF16, device=x2.device)
    launch("w4a8_gemv", "pgk_w4a8_gemv", x2.data_ptr(), int(x2.dtype == _F32),
           packed.data_ptr(), sc.data_ptr(), xq.data_ptr(), sx.data_ptr(), out.data_ptr(), m, n,
           k_half, int(pdl), stream_of(x2))
    return out


def _w4a8_operands(x2: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                   k_half: int) -> None:
    if x2.dtype not in (_BF16, _F32):
        raise TypeError(f"w4a8 kernels take bf16 or f32 activations, got {x2.dtype}")
    require_on(x2.device, packed=packed, scale=scale)
    _packed_u8(packed)
    if k_half % 16:
        raise ValueError(f"w4a8 kernels need K % 32 == 0, got K={2 * k_half}")


_SMS: dict = {}


def _card_sms(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def w4a8_matmul(x: torch.Tensor, packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] or [K] (bf16/f32), packed [N, K/2] uint8, scale [N] or
    [1, N] f32 -> y [M, N] bf16. CUDA tensors launch the GEMV (M <= 8) or
    GEMM (M > 8) kernel; CPU tensors take the plain version."""
    if not x.is_cuda:
        return w4a8_matmul_plain(x, packed, scale)
    n, k_half = packed.shape
    x2 = _rows(x, 2 * k_half)
    _w4a8_operands(x2, packed, scale, k_half)
    m = x2.shape[0]
    if m <= GEMV_MAX_ROWS:
        return _w4a8_gemv(x2, packed, scale, True)
    sc = _col_scale(scale, n)
    x2 = x2.contiguous()
    xq = torch.empty((m, 2 * k_half), dtype=torch.int8, device=x2.device)
    sx = torch.empty((m,), dtype=_F32, device=x2.device)
    out = torch.empty((m, n), dtype=_BF16, device=x2.device)
    args = (x2.data_ptr(), int(x2.dtype == _F32), packed.data_ptr(), sc.data_ptr(),
            xq.data_ptr(), sx.data_ptr())
    if k_half > 65536:
        raise ValueError(f"w4a8_gemm takes K up to 131072, got K={2 * k_half}")
    if packed.data_ptr() % 16:
        raise ValueError("w4a8_gemm needs a 16-byte aligned packed weight (TMA)")
    plan = w4a8_gemm_plan(m, n, k_half, _card_sms(x2.device))
    part = (torch.empty((plan["units"] * W4A8_UNIT_INTS,), dtype=torch.int32,
                        device=x2.device) if plan["splits"] > 1 else None)
    launch("w4a8_gemm", "pgk_w4a8_gemm", *args, None if part is None else part.data_ptr(),
           out.data_ptr(), m, n, k_half, stream_of(x2))
    return out


def w4a16_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                       out_dtype: torch.dtype = _BF16) -> torch.Tensor:
    """Plain w4a16 product: bf16 x against the unpacked nibbles in f32,
    ``(acc * scale[n])`` rounded once to ``out_dtype`` (the reference's
    XLA route, ``model.py:292-299``, and its GEMV's math)."""
    from ..llm.quant import unpack_int4
    require_full_f32(x, "w4a16_matmul_plain")
    x2 = _rows(x, 2 * packed.shape[-1]).to(_BF16).to(_F32)
    acc = torch.matmul(x2, unpack_int4(packed).to(_F32).t())
    return (acc * scale.reshape(1, -1).to(_F32)).to(out_dtype)


#: the w4a16 GEMV (``csrc/w4a16_gemv.cu``): rounds (two 16-byte weight
#: vectors each) a lane has in flight before their math
W4A16_BATCH = 2


def w4a16_plan(n: int, k_half: int, rows: int = 1) -> dict:
    """The w4a16 GEMV's launch plan: a block a 16-column tile over all of K
    (``blocks`` tiles), its ``warps`` (w4a8_gemv_plan's rule: 4 up to
    W4A8_GEMV_NARROW_CHUNKS 16-byte chunks a column, 8 up to
    W4A8_GEMV_WIDE_CHUNKS, 16 above) each a contiguous slice of the chunks
    (:func:`w4a8_gemv_slices`), ``batch`` rounds of a lane in flight. Rows
    do not change it; it depends on the shapes alone, so a captured graph
    stays valid. ``pgk_w4a16_plan`` is the same rule."""
    p = w4a8_gemv_plan(rows, n, k_half)
    return {"tile_n": p["tile_n"], "blocks": p["blocks"], "warps": p["warps"],
            "batch": W4A16_BATCH}


def w4a16_matmul(x: torch.Tensor, packed: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] or [K], packed [N, K/2] uint8, scale [N] or [1, N] f32 ->
    y [M, N] bf16 with x rounded to bf16. CUDA: the w4a16 GEMV kernel
    (M <= 8; bf16 tensor cores over :func:`w4a16_plan`'s grid); CPU: the
    plain version."""
    if not x.is_cuda:
        return w4a16_matmul_plain(x, packed, scale)
    n, k_half = packed.shape
    x2 = _rows(x, 2 * k_half)
    m = _gemv_rows(x2, "w4a16_gemv")
    require_on(x2.device, packed=packed, scale=scale)
    _packed_u8(packed)
    if k_half % 16:
        raise ValueError(f"w4a16_gemv needs K % 32 == 0, got K={2 * k_half}")
    if packed.data_ptr() % 16:
        raise ValueError("w4a16_gemv needs a 16-byte aligned packed weight")
    sc = _col_scale(scale, n)
    xb = x2.to(_BF16).contiguous()
    if xb.data_ptr() % 16:                  # the kernel reads x 16 bytes at a time
        xb = xb.clone()
    out = torch.empty((m, n), dtype=_BF16, device=x2.device)
    launch("w4a16_gemv", "pgk_w4a16_gemv", xb.data_ptr(), packed.data_ptr(),
           sc.data_ptr(), out.data_ptr(), m, n, k_half, stream_of(xb))
    return out


# ---------------------------------------------------------------------------
# int4_block [K/2, N] + [K/B, N]: w4a8 and w4a16
# ---------------------------------------------------------------------------

def _block_size(packed: torch.Tensor, scale_block: torch.Tensor) -> int:
    k = 2 * packed.shape[-2]
    nb = scale_block.shape[-2]
    if k % nb or scale_block.shape[-1] != packed.shape[-1]:
        raise ValueError(f"scale_block {tuple(scale_block.shape)} does not fit a "
                         f"[K/2, N] = {tuple(packed.shape)} weight")
    return k // nb


def _block_storage(packed, scale_block, b: int, n: int) -> None:
    _packed_u8(packed)
    if scale_block.dtype != _BF16 or scale_block.dim() != 2 \
            or not scale_block.is_contiguous():
        raise TypeError("scale_block must be a contiguous 2-D bf16 tensor")
    if n % 4 or b % 8:
        raise ValueError(f"int4_block GEMVs need N % 4 == 0 and B % 8 == 0, "
                         f"got N={n}, B={b}")


def _half_block_dots(xq: torch.Tensor, q: torch.Tensor, lo: int, hi: int,
                     b: int) -> tuple[int, torch.Tensor]:
    """Exact dots of rows [lo, hi) of K, block by block: (first block,
    Z [blocks, M, N]) with Z[j] over the rows of block first + j inside
    [lo, hi). Operands carry integer values in f32; every sum is an integer
    below 2^24, so the batched matmul is exact in any order."""
    b0, b1 = lo // b, -(-hi // b)
    front, back = lo - b0 * b, b1 * b - hi
    xs = F.pad(xq[:, lo:hi], (front, back))                     # [M, nbk * B]
    qs = F.pad(q[lo:hi], (0, 0, front, back))                   # [nbk * B, N]
    nbk, m = b1 - b0, xq.shape[0]
    z = torch.bmm(xs.reshape(m, nbk, b).transpose(0, 1), qs.reshape(nbk, b, -1))
    return b0, z


def block_w4a8_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                            scale_block: torch.Tensor) -> torch.Tensor:
    """Plain int4_block w4a8 product, bitwise the kernel's:
    ``bf16((Y_lo + Y_hi) * sx)`` with ``Y_h = sum_b Z_h[b] * s[b]`` over
    the blocks of half h in ascending order, one rounding per multiply and
    per add (a Python loop: ``torch.sum``'s order is open). Z_h[b] is the
    exact dot of block b's rows inside half h, so a block straddling K/2
    adds its two parts into Y_lo and Y_hi."""
    from ..llm.quant import unpack_int4
    require_full_f32(x, "block_w4a8_matmul_plain")
    k_half = packed.shape[-2]
    b = _block_size(packed, scale_block)
    xq, sx = quantize_acts(_rows(x, 2 * k_half))
    xf = xq.to(_F32)
    q = unpack_int4(packed, axis=-2).to(_F32)                   # [K, N]
    s = scale_block.to(_F32)
    y = []
    for lo, hi in ((0, k_half), (k_half, 2 * k_half)):
        b0, z = _half_block_dots(xf, q, lo, hi, b)
        acc = torch.zeros_like(z[0])
        for j in range(z.shape[0]):
            acc = acc + z[j] * s[b0 + j]
        y.append(acc)
    return ((y[0] + y[1]) * sx).to(_BF16)


#: the block w4a8 GEMV's column tiles (groups of 4 columns: 32, 16 or 8),
#: the blocks a tile width must reach to be taken (the H100's SMs), and the
#: segments a chunk (``csrc/block_w4a8_gemv.cu``)
BLOCK_GROUPS, BLOCK_WAVE, BLOCK_CHUNK = (8, 4, 2), 132, 32
#: rows up to which the kernel quantizes the activations itself (above, the
#: separate act_quant launch runs first): a function of the shapes alone
BLOCK_FUSED_MAX_ROWS = 2


def block_segments(k_half: int, b: int) -> list[tuple[int, int]]:
    """The packed-row segments ``[start, end)`` of a ``[K/2, N]`` int4_block
    weight with block size ``b``, each inside one low-half block and one
    high-half block: the blocks themselves when ``b`` divides K/2, else
    halves of them (low blocks end at multiples of ``b``, high ones where
    ``(K/2 + r) % b == 0``). The kernel's ``Segments``."""
    off = (b - k_half % b) % b
    edges = sorted({e for e in range(0, k_half, b)} | {e for e in range(off, k_half, b)}
                   | {k_half})
    return list(zip(edges[:-1], edges[1:]))


def block_w4a8_plan(n: int, k_half: int, b: int, rows: int = 1) -> dict:
    """The block w4a8 GEMV's grid: one block a column tile over all of K,
    the tile the widest of 32, 16 and 8 columns whose tiles number at least
    BLOCK_WAVE; the 32-bit words a thread loads from a packed row at once
    (2 at one row where N allows, else 1); the segments, walked in
    chunks of BLOCK_CHUNK, each shared by ``parts`` threads. Depends on the
    shapes alone (``block_groups`` and ``launch_width`` in the kernel)."""
    groups = next((gr for gr in BLOCK_GROUPS if -(-n // (4 * gr)) >= BLOCK_WAVE),
                  BLOCK_GROUPS[-1])
    words = 2 if rows == 1 else 1
    if n % (4 * words):
        words = 1
    segments = len(block_segments(k_half, b))
    return {"tile_n": 4 * groups, "tiles": -(-n // (4 * groups)), "words": words,
            "parts": 8 * words // groups, "segments": segments,
            "chunks": -(-segments // BLOCK_CHUNK)}


def block_w4a8_matmul(x: torch.Tensor, packed: torch.Tensor,
                      scale_block: torch.Tensor) -> torch.Tensor:
    """x [M, K] or [K] (bf16/f32), packed [K/2, N] uint8, scale_block
    [K/B, N] bf16 -> y [M, N] bf16. CUDA: the block w4a8 GEMV kernel
    (M <= 8; the activation quantization fused up to BLOCK_FUSED_MAX_ROWS
    rows); CPU: the plain version."""
    if not x.is_cuda:
        return block_w4a8_matmul_plain(x, packed, scale_block)
    x2 = _rows(x, 2 * packed.shape[-2])
    return block_w4a8_launch(x2, packed, scale_block,
                             x2.shape[0] <= BLOCK_FUSED_MAX_ROWS)


def block_w4a8_launch(x2: torch.Tensor, packed: torch.Tensor, scale_block: torch.Tensor,
                      fused: bool) -> torch.Tensor:
    """The block w4a8 GEMV kernel on CUDA rows ``x2`` [M, K], with the
    activation quantization inside the kernel (``fused``) or as the
    separate act_quant launch before it. :func:`block_w4a8_matmul` picks
    by rows; both forms are bitwise the plain version, which CPU rows
    take."""
    if not x2.is_cuda:
        return block_w4a8_matmul_plain(x2, packed, scale_block)
    k_half, n = packed.shape
    b = _block_size(packed, scale_block)
    m = _gemv_rows(x2, "block_w4a8_gemv")
    if x2.dtype not in (_BF16, _F32):
        raise TypeError(f"block_w4a8_gemv takes bf16 or f32 activations, got {x2.dtype}")
    require_on(x2.device, packed=packed, scale_block=scale_block)
    _block_storage(packed, scale_block, b, n)
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:                          # the kernel reads x in 16-byte words
        x2 = x2.clone()
    xq = sx = None
    if not fused:
        xq = torch.empty((m, 2 * k_half), dtype=torch.int8, device=x2.device)
        sx = torch.empty((m,), dtype=_F32, device=x2.device)
    out = torch.empty((m, n), dtype=_BF16, device=x2.device)
    launch("block_w4a8_gemv", "pgk_block_w4a8_gemv", x2.data_ptr(),
           int(x2.dtype == _F32), packed.data_ptr(), scale_block.data_ptr(),
           None if xq is None else xq.data_ptr(), None if sx is None else sx.data_ptr(),
           out.data_ptr(), m, n, k_half, b, int(fused), stream_of(x2))
    return out


def block_w4a16_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                             scale_block: torch.Tensor,
                             out_dtype: torch.dtype = _BF16) -> torch.Tensor:
    """Plain int4_block w4a16 product: ``w = bf16(nibble * s)``, bf16 x, f32
    sums, rounded once to ``out_dtype`` (the reference's block GEMV and its
    XLA dequant route, ``model.py:277-291``)."""
    from ..llm.quant import dequantize_block
    require_full_f32(x, "block_w4a16_matmul_plain")
    x2 = _rows(x, 2 * packed.shape[-2]).to(_BF16).to(_F32)
    w = dequantize_block(packed, scale_block, _BF16).to(_F32)
    return torch.matmul(x2, w).to(out_dtype)


#: the block w4a16 GEMV (``csrc/w4a16_mma.cuh``): packed K rows a warp takes
#: a round, columns a block, the cluster's blocks at most, warps a block at
#: most, and the blocks the splits aim for (two on each of the H100's SMs)
W4A16_ROUND, W4A16_TILE_N, W4A16_MAX_SPLITS, W4A16_MAX_WARPS = 32, 64, 8, 8
W4A16_TARGET_BLOCKS = 264


def block_w4a16_plan(n: int, k_half: int, rows: int = 1) -> dict:
    """The block w4a16 GEMV's grid: ``tiles`` of 64 columns x ``splits`` of
    K's 32-row ``rounds`` (a tile's splits one thread-block cluster: the
    fewest powers of 2 that bring the blocks to W4A16_TARGET_BLOCKS, at most
    W4A16_MAX_SPLITS, each a round at least); ``warps`` a block, one per
    round of its split up to W4A16_MAX_WARPS; ``smem`` the dynamic shared
    bytes (each warp's sums and each split's at ``rows``). Depends on the
    shapes alone (``make_plan`` in the kernel, reported by
    ``pgk_block_w4a16_plan``)."""
    rounds = -(-k_half // W4A16_ROUND)
    tiles = -(-n // W4A16_TILE_N)
    splits = 1
    while (splits < W4A16_MAX_SPLITS and tiles * splits < W4A16_TARGET_BLOCKS
           and 2 * splits <= rounds):
        splits *= 2
    warps = min(-(-rounds // splits), W4A16_MAX_WARPS)
    return {"tile_n": W4A16_TILE_N, "tiles": tiles, "splits": splits, "warps": warps,
            "rounds": rounds, "smem": (warps + splits) * rows * W4A16_TILE_N * 4,
            "blocks": tiles * splits}


def block_w4a16_warp_rounds(rounds: int, splits: int, warps: int) -> list[tuple[int, int]]:
    """The rounds ``[i0, i1)`` of each warp of a tile, split-major (warp w
    of split s is ``s * warps + w``): the order its sums are folded in."""
    total = splits * warps
    return [(gw * rounds // total, (gw + 1) * rounds // total) for gw in range(total)]


def block_w4a16_matmul(x: torch.Tensor, packed: torch.Tensor,
                       scale_block: torch.Tensor) -> torch.Tensor:
    """x [M, K] or [K], packed [K/2, N] uint8, scale_block [K/B, N] bf16 ->
    y [M, N] bf16 with x rounded to bf16. CUDA: the block w4a16 GEMV kernel
    (M <= 8; bf16 tensor cores over :func:`block_w4a16_plan`'s grid); CPU:
    the plain version."""
    if not x.is_cuda:
        return block_w4a16_matmul_plain(x, packed, scale_block)
    k_half, n = packed.shape
    b = _block_size(packed, scale_block)
    x2 = _rows(x, 2 * k_half)
    m = _gemv_rows(x2, "block_w4a16_gemv")
    require_on(x2.device, packed=packed, scale_block=scale_block)
    _block_storage(packed, scale_block, b, n)
    xb = x2.to(_BF16).contiguous()
    if xb.data_ptr() % 16:                  # the kernel reads x 16 bytes at a time
        xb = xb.clone()
    out = torch.empty((m, n), dtype=_BF16, device=x2.device)
    launch("block_w4a16_gemv", "pgk_block_w4a16_gemv", xb.data_ptr(),
           packed.data_ptr(), scale_block.data_ptr(), out.data_ptr(), m, n,
           k_half, b, stream_of(xb))
    return out


# ---------------------------------------------------------------------------
# K-major [K, N] fp8 / int8 / bf16: the converting GEMV
# ---------------------------------------------------------------------------

def conv_matmul_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      out_dtype: torch.dtype = _BF16) -> torch.Tensor:
    """Plain converting product: bf16 x against w converted to f32 (exact
    for all four storage types), ``(acc * scale[n])`` rounded once to
    ``out_dtype`` (the reference's XLA route, ``model.py:374-376``)."""
    require_full_f32(x, "conv_matmul_plain")
    k = w.shape[-2]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[-1] != k:
        raise ValueError(f"x K dim {x2.shape[-1]} != weight K {k}")
    acc = torch.matmul(x2.to(_BF16).to(_F32), w.to(_F32))
    return (acc * scale.reshape(1, -1).to(_F32)).to(out_dtype)


#: the converting GEMV (``csrc/conv_gemv.cu``): threads a block, output
#: columns a block, the blocks the K splits aim for (two on each of the
#: H100's 132 SMs) and the splits at most (a cluster's blocks)
CONV_THREADS, CONV_TILE_N, CONV_TARGET_BLOCKS, CONV_MAX_SPLITS = 256, 64, 264, 8


def conv_row_bound(rows: int) -> int:
    """The kernel's row bound (1, 2, 4 or 8): its f32 sums a thread."""
    return 1 if rows <= 1 else 2 if rows <= 2 else 4 if rows <= 4 else 8


def conv_gemv_plan(rows: int, n: int, k: int) -> dict:
    """The converting GEMV's grid: ``tiles`` of 64 columns x ``splits`` of
    K's quads (groups of 4 rows), a tile's splits one thread-block cluster;
    a thread owns ``cols`` columns (16 up to 2 rows, 8 up to 4, 4 up to 8)
    and is one of ``klanes`` K lanes. The splits are the fewest powers of 2
    that bring the blocks to CONV_TARGET_BLOCKS, at most CONV_MAX_SPLITS and
    as many as leave every K lane a quad. Depends on the shapes alone
    (``conv_plan`` in the kernel, reported by ``pgk_conv_gemv_plan``)."""
    r = conv_row_bound(rows)
    cols = 16 if r <= 2 else 8 if r == 4 else 4
    klanes = CONV_THREADS * cols // CONV_TILE_N
    tiles = -(-n // CONV_TILE_N)
    splits = 1
    while (splits < CONV_MAX_SPLITS and tiles * splits < CONV_TARGET_BLOCKS
           and (k // 4) // (2 * splits) >= klanes):
        splits *= 2
    return {"tile_n": CONV_TILE_N, "tiles": tiles, "splits": splits, "cols": cols,
            "klanes": klanes, "blocks": tiles * splits}


def conv_split_quads(k: int, splits: int) -> list[tuple[int, int]]:
    """The quads ``[q0, q1)`` (K rows 4 q0 .. 4 q1) of each split, in the
    ascending order block 0 of the cluster folds them."""
    quads = k // 4
    return [(s * quads // splits, (s + 1) * quads // splits) for s in range(splits)]


def conv_matmul(x: torch.Tensor, w: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] or [K], w [K, N] fp8 e4m3fn / e5m2, int8 or bf16, scale [N]
    or [1, N] f32 -> y [M, N] bf16 with x rounded to bf16. CUDA: the
    converting GEMV kernel (M <= 8; its grid :func:`conv_gemv_plan`, K
    split across a cluster's blocks); CPU: the plain version."""
    if not x.is_cuda:
        return conv_matmul_plain(x, w, scale)
    if w.dtype not in CONV_KINDS or w.dim() != 2 or not w.is_contiguous():
        raise TypeError("conv_gemv takes a contiguous 2-D fp8 e4m3fn/e5m2, int8 "
                        f"or bf16 weight, got {w.dtype} {tuple(w.shape)}")
    k, n = w.shape
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[-1] != k:
        raise ValueError(f"x K dim {x2.shape[-1]} != weight K {k}")
    m = _gemv_rows(x2, "conv_gemv")
    require_on(x2.device, w=w, scale=scale)
    if n % 4 or k % 4:
        raise ValueError(f"conv_gemv needs N % 4 == 0 and K % 4 == 0, got K={k}, N={n}")
    if w.data_ptr() % (4 * w.element_size()):
        raise ValueError("conv_gemv needs a weight aligned to 4 of its values")
    sc = _col_scale(scale, n)
    xb = x2.to(_BF16).contiguous()
    if xb.data_ptr() % 8:                           # the kernel reads x in 8-byte words
        xb = xb.clone()
    out = torch.empty((m, n), dtype=_BF16, device=x2.device)
    launch("conv_gemv", "pgk_conv_gemv", xb.data_ptr(), w.data_ptr(),
           CONV_KINDS[w.dtype], sc.data_ptr(), out.data_ptr(), m, n, k,
           stream_of(xb))
    return out


# ---------------------------------------------------------------------------
# N-major [N, K] fp8 / int8 / bf16: the library GEMV
# ---------------------------------------------------------------------------

#: gemv_quant's launch (``csrc/gemv_quant.cu``): warps a block, one output
#: row each, and the 16-byte vectors of its row a lane has in flight (the
#: kernel reports its own through ``pgk_gemv_quant_plan``; a card test holds
#: them equal)
GEMV_WARPS, GEMV_BATCH = 4, 8


def gemv_quant_plan(n: int) -> list[int | None]:
    """The output row each warp of gemv_quant's grid sums, warps in launch
    order (block by block; None past N): the fewest blocks of GEMV_WARPS
    warps that cover N, warp w of block b on row b * GEMV_WARPS + w. The
    kernel computes the same row from blockIdx and the warp index."""
    blocks = -(-n // GEMV_WARPS)
    return [w if w < n else None for w in range(blocks * GEMV_WARPS)]


def gemv_lane_vectors(n_vec: int, lane: int) -> list[list[int]]:
    """The 16-byte vectors of a row that lane ``lane`` of its warp loads,
    batch by batch (GEMV_BATCH in flight before their math): vector
    ``base + 32 u + lane`` for u < GEMV_BATCH, bases 256 apart."""
    step = 32 * GEMV_BATCH
    return [[v for u in range(GEMV_BATCH) if (v := base + 32 * u + lane) < n_vec]
            for base in range(0, n_vec, step)]


def gemv_quant_plain(w_q: torch.Tensor, x: torch.Tensor,
                     scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain ``gemv_quant``: w converted to f32 (exact for all four storage
    types) against x rounded to bf16, f32 sums, ``(acc * scale[n])``
    rounded once to bf16."""
    require_full_f32(x, "gemv_quant_plain")
    acc = torch.matmul(w_q.to(_F32), x.reshape(-1).to(_BF16).to(_F32))
    if scale is not None:
        acc = acc * scale.reshape(-1).to(_F32)
    return acc.to(_BF16)


def gemv_quant(w_q: torch.Tensor, x: torch.Tensor,
               scale: torch.Tensor | None = None) -> torch.Tensor:
    """y[N] = (W[N, K] @ x[K]) * scale[N] in bf16 (the reference's
    ``gemv_quant``): w_q N-major (K contiguous per output) in fp8
    e4m3fn / e5m2, int8 or bf16; x bf16 or f32, rounded to bf16; scale f32
    [N] or None (1.0). CUDA: the gemv_quant kernel (a row a warp,
    :func:`gemv_quant_plan`; a row that is not whole 16-byte vectors on
    16-byte boundaries adds a scalar head and tail); CPU: the plain
    version."""
    if not x.is_cuda:
        return gemv_quant_plain(w_q, x, scale)
    if w_q.dtype not in CONV_KINDS or w_q.dim() != 2:
        raise NotImplementedError("gemv_quant takes a 2-D fp8 e4m3fn/e5m2, int8 or bf16 "
                                  f"weight, got {w_q.dtype} {tuple(w_q.shape)}")
    if x.dtype not in (_BF16, _F32):
        raise NotImplementedError(f"gemv_quant takes bf16 or f32 x, got {x.dtype}")
    n, k = w_q.shape
    xv = x.reshape(-1).contiguous()
    if xv.numel() != k:
        raise ValueError(f"x has {xv.numel()} values, the weight's K is {k}")
    sc = None if scale is None else scale.reshape(-1).to(_F32).contiguous()
    require_on(xv.device, w_q=w_q, **({} if sc is None else {"scale": sc}))
    if sc is not None and sc.numel() != n:
        raise ValueError(f"scale has {sc.numel()} values, the weight's N is {n}")
    w = w_q.contiguous()
    out = torch.empty((n,), dtype=_BF16, device=xv.device)
    launch("gemv_quant", "pgk_gemv_quant", w.data_ptr(), CONV_KINDS[w.dtype],
           xv.data_ptr(), int(xv.dtype == _F32), None if sc is None else sc.data_ptr(),
           out.data_ptr(), n, k, stream_of(xv))
    return out
