"""Matmul family: dense and quantized GEMM/GEMV (counterpart of
``pygpukit_tpu/ops/matmul.py``).

``_dot`` sends 2-D operands to ``kernels.gemm.gemm``, whose
``PYGPUKIT_GEMM=pallas`` route launches the hand-written GEMM kernel on the
card (route in ``kernels/gemm.py``); every other product here is an XLA dot
in the reference and a plain torch product in f32 sums here. On the card
``matmul_int8`` multiplies with ``torch._int_mm`` (M padded to a multiple
of 32, K and N to multiples of 8), on the CPU with an int32 product; both
are exact.
The quantizers divide by tensors (``core.numerics.true_div``), so their
scales and codes match the reference byte for byte on both devices.
``quantize_int4`` returns its [-7, 7] codes as int8 (torch has no int4).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.array import Array
from ..core.dtypes import FP8_MAX, canonical_dtype, to_dtype
from ..core.numerics import true_div
from ..kernels.gemm import batched_gemm, gemm, xla_dot
from ._common import apply_op, finish, tensors

_F32 = torch.float32
_BF16 = torch.bfloat16
_FP8 = torch.float8_e4m3fn


def _promote(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    return canonical_dtype(torch.promote_types(a.dtype, b.dtype))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-D or batched dot with f32 sums; 2-D reaches ``kernels.gemm``."""
    if a.dim() == 2 and b.dim() == 2:
        return gemm(a, b, out_dtype=_promote(a, b))
    return xla_dot(a, b, _promote(a, b))


def matmul(a, b, *, out: Array | None = None) -> Array:
    """C = A @ B (2-D or batched)."""
    ta, tb = tensors(a, b)
    if ta.shape[-1] != tb.shape[-2 if tb.dim() > 1 else 0]:
        raise ValueError(f"matmul: inner dims mismatch {tuple(ta.shape)} @ "
                         f"{tuple(tb.shape)}")
    return finish(_dot(ta, tb), out)


def _contract_last(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """``dot_general`` over the last dims of a and b, f32 sums."""
    dims = ([a.dim() - 1], [b.dim() - 1])
    if a.is_cuda and a.dtype == b.dtype == out_dtype == _BF16:
        return torch.tensordot(a, b, dims=dims)
    return torch.tensordot(a.to(_F32), b.to(_F32), dims=dims).to(out_dtype)


def matmul_nt(a, b, *, out: Array | None = None) -> Array:
    """C = A @ B.T, B stored row-major [N, K]."""
    ta, tb = tensors(a, b)
    return finish(_contract_last(ta, tb, _promote(ta, tb)), out)


def batched_matmul(a, b, *, out: Array | None = None) -> Array:
    return apply_op(batched_gemm, a, b, out=out)


def gemv(w, x, *, out: Array | None = None) -> Array:
    """y[N] = W[N, K] @ x[K]."""
    tw, tx = tensors(w, x)
    return finish(xla_dot(tw, tx, _promote(tw, tx)), out)


gemv_bf16 = gemv


# ---------------------------------------------------------------------------
# Quantized paths: per-tensor (fp8) or per-channel (int8/int4) f32 scales
# ---------------------------------------------------------------------------

def quantize_fp8(a, *, out_dtype=_FP8) -> tuple[Array, Array]:
    """Per-tensor symmetric fp8 quantization -> (q, scale)."""
    out_dtype = to_dtype(out_dtype).torch_dtype
    x = tensors(a)[0].to(_F32)
    scale = torch.clamp_min(true_div(torch.amax(torch.abs(x)), FP8_MAX[out_dtype]), 1e-12)
    return Array((x / scale).to(out_dtype)), Array(scale.reshape(()))


def _quantize_sym(w, axis: int, qmax: float) -> tuple[Array, Array]:
    x = tensors(w)[0].to(_F32)
    amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    scale = torch.clamp_min(true_div(amax, qmax), 1e-12)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return Array(q), Array(scale)


def quantize_int8(w, *, axis: int = -1) -> tuple[Array, Array]:
    """Per-channel symmetric int8 quantization along ``axis``."""
    return _quantize_sym(w, axis, 127.0)


def quantize_int4(w, *, axis: int = -1) -> tuple[Array, Array]:
    """Per-channel symmetric int4 quantization: codes in [-7, 7], stored as
    int8 (the reference stores jnp.int4)."""
    return _quantize_sym(w, axis, 7.0)


def matmul_fp8(a_q, b_q, a_scale, b_scale, *, out_dtype=_BF16,
               out: Array | None = None) -> Array:
    """fp8 x fp8 GEMM with per-tensor scales: f32 product of the values
    (exact), times ``sa * sb``, rounded once to ``out_dtype``."""
    def _f(aq, bq, sa, sb):
        acc = xla_dot(aq.to(_BF16), bq.to(_BF16), _F32)
        return (acc * (sa * sb)).to(out_dtype)
    return apply_op(_f, a_q, b_q, a_scale, b_scale, out=out)


def matmul_w8a16(a, w_q, w_scale, *, out_dtype=_BF16, out: Array | None = None) -> Array:
    """bf16 activation x fp8 weight [K, N] with a per-tensor or per-channel
    scale."""
    def _f(x, wq, ws):
        return (xla_dot(x.to(_BF16), wq.to(_BF16), _F32) * ws).to(out_dtype)
    return apply_op(_f, a, w_q, w_scale, out=out)


def int8_dot(xi: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product [M, K] @ [K, N]:
    ``torch._int_mm``. On the card it takes K and N in multiples of 8 and
    refuses some small K for M off a multiple of 32 (measured on an H100),
    so M, K and N are zero-padded to those; on the CPU it takes any shape
    (oneDNN's s8 x s8 -> s32 product, the int32 product's bits)."""
    if not xi.is_cuda:
        return torch._int_mm(xi.contiguous(), q.contiguous())
    m, k = xi.shape
    n = q.shape[1]
    mp, kp, np_ = -(-m // 32) * 32, -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        xi = F.pad(xi, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        q = F.pad(q, (0, np_ - n, 0, kp - k))
    return torch._int_mm(xi, q)[:m, :n]


def matmul_int8(a_q, b_q, a_scale, b_scale, *, out_dtype=_BF16,
                out: Array | None = None) -> Array:
    """int8 x int8 GEMM, exact int32 sums; ``(acc * sa) * sb`` in f32."""
    def _f(aq, bq, sa, sb):
        return ((int8_dot(aq, bq).to(_F32) * sa) * sb).to(out_dtype)
    return apply_op(_f, a_q, b_q, a_scale, b_scale, out=out)


def _gemv_scaled(x, w_q, w_scale, out_dtype):
    acc = xla_dot(w_q.to(_BF16), x.to(_BF16), _F32)
    return (acc * w_scale.reshape(-1)).to(out_dtype)


def gemv_w8a16(x, w_q, w_scale, *, out_dtype=_BF16, out: Array | None = None) -> Array:
    """x[K] x fp8 W[N, K] decode GEMV."""
    return apply_op(lambda a, b, c: _gemv_scaled(a, b, c, out_dtype), x, w_q, w_scale,
                    out=out)


def gemv_int4(x, w_q, w_scale, *, out_dtype=_BF16, out: Array | None = None) -> Array:
    """x[K] x int4 W[N, K] (codes as int8) decode GEMV."""
    return apply_op(lambda a, b, c: _gemv_scaled(a, b, c, out_dtype), x, w_q, w_scale,
                    out=out)


def grouped_matmul(a, b_stack, group_ids, *, out: Array | None = None) -> Array:
    """Rows of ``a`` [T, K] times their expert's weight ``b_stack`` [E, K, N]:
    the reference's dense one-hot formulation (every expert's product, then
    a one-hot sum over experts; an id outside [0, E) gives a zero row)."""
    def _f(x, w, gid):
        e = w.shape[0]
        onehot = (gid.reshape(-1, 1) == torch.arange(e, device=gid.device)).to(_F32)
        per_e = torch.einsum("tk,ekn->ten", x.to(_F32), w.to(_F32))
        return torch.einsum("te,ten->tn", onehot, per_e).to(x.dtype)
    return apply_op(_f, a, b_stack, group_ids, out=out)


def quantize_fp8_block(w, block: int = 128) -> tuple[Array, Array]:
    """Blockwise fp8: w [K, N] -> (q fp8 [K, N], scales f32 [K/block,
    N/block]), K and N padded to block multiples for the scales."""
    x = tensors(w)[0].to(_F32)
    k, n = x.shape
    kb, nb = -(-k // block), -(-n // block)
    blocks = F.pad(x, (0, nb * block - n, 0, kb * block - k)).reshape(kb, block, nb, block)
    amax = torch.amax(torch.abs(blocks), dim=(1, 3))
    scale = torch.clamp_min(true_div(amax, FP8_MAX[_FP8]), 1e-12)
    q = (blocks / scale[:, None, :, None]).to(_FP8)
    return Array(q.reshape(kb * block, nb * block)[:k, :n]), Array(scale)


def matmul_fp8_block(a, w_q, w_scale, *, block: int = 128, out_dtype=_BF16,
                     out: Array | None = None) -> Array:
    """x [M, K] @ blockwise-fp8 W [K, N]: per-(K-block, N-block) f32 partial
    dots, each scaled, summed over the K blocks."""
    def _f(x, wq, ws):
        m, k = x.shape
        n = wq.shape[1]
        kb, nb = ws.shape
        xb = F.pad(x.to(_BF16).to(_F32), (0, kb * block - k)).reshape(m, kb, block)
        wb = F.pad(wq.to(_F32), (0, nb * block - n, 0, kb * block - k))
        part = torch.einsum("mkc,kcnd->mknd", xb, wb.reshape(kb, block, nb, block))
        y = torch.einsum("mknd,kn->mnd", part, ws.to(_F32)).reshape(m, nb * block)
        return y[:, :n].to(out_dtype)
    return apply_op(_f, a, w_q, w_scale, out=out)


# ---------------------------------------------------------------------------
# Availability probes
# ---------------------------------------------------------------------------

def fp8_available() -> bool:
    return True


def int8_available() -> bool:
    return True


def int4_available() -> bool:
    return True


def w8a16_available() -> bool:
    return True


def nvf4_available() -> bool:
    return False


def grouped_gemm_available() -> bool:
    return True
