"""Flash attention (prefill) and flash decoding (port of
``pygpukit_tpu/kernels/flash_attention.py``).

``flash_attention``: q ``[S, Hq, D]``, k/v ``[S, Hk, D]`` (GQA) -> ``[S, Hq,
D]`` in q's dtype, causal or full, scale ``1/sqrt(D)``. ``flash_decode``:
one query row ``[1, Hq, D]`` over fixed caches ``[MAX, Hk, D]`` whose rows
``[0, ctx_len)`` are live. Both keep the reference kernels' arithmetic: f32
scores and running state, P rounded to the input dtype before P@V, the sum
floored at 1e-30. CUDA tensors launch ``csrc/flash_attention.cu`` (bf16 or
f32, D 64 or 128) or raise; CPU tensors take the plain versions, which
compute the same full softmax with P rounded the same way (the kernels'
online form rounds P against a running maximum, so the two agree to bf16
rounding, and to f32 summation order in f32).

The reference's GQA head repeat, its padding to block multiples and its
eight-row query padding in the decode kernel are TPU layout needs and are
not ported: the kernels read each kv head's rows in place and mask the
ragged edge themselves.
"""

from __future__ import annotations

import math

import torch

from ._build import launch, require_on, stream_of

_F32 = torch.float32
_NEG_INF = -1e30
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
#: flash_decode splits the live context into chunks of a multiple of this
#: many rows (the kernel's shared-memory step)
DECODE_ROWS = 64
#: ... aiming at about this many blocks over all kv heads (132 SMs)
DECODE_BLOCKS = 128
#: query rows per step of flash_attention_plain (bounds its score memory)
_PLAIN_Q_BLOCK = 512


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Full masked softmax in f32, 512 query rows at a time (causal
    blocks read keys up to their last row only): s = (q.k) * scale, masked
    keys at -1e30 with p = 0, p = exp(s - max), P rounded to v's dtype
    before P@V, out = acc / max(l, 1e-30) in q's dtype."""
    s, hq, d = q.shape
    hk = k.shape[1]
    g = hq // hk
    scale = _scale(d)
    kh = k.permute(1, 0, 2).to(_F32)[:, None]              # [Hk, 1, S, D]
    vh = v.permute(1, 0, 2).to(_F32)[:, None]
    out = torch.empty_like(q)
    for q0 in range(0, s, _PLAIN_Q_BLOCK):
        q1 = min(s, q0 + _PLAIN_Q_BLOCK)
        kend = q1 if causal else s
        qb = q[q0:q1].reshape(q1 - q0, hk, g, d).permute(1, 2, 0, 3).to(_F32)
        sc = torch.matmul(qb, kh[:, :, :kend].transpose(-1, -2)) * scale
        if causal:
            rows = torch.arange(q0, q1, device=q.device)[:, None]
            dead = torch.arange(kend, device=q.device)[None, :] > rows
            sc = torch.where(dead, torch.full_like(sc, _NEG_INF), sc)
        m = torch.amax(sc, dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        if causal:
            p = torch.where(dead, torch.zeros_like(p), p)
        l_sum = torch.sum(p, dim=-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).to(_F32), vh[:, :, :kend])
        o = o / torch.clamp_min(l_sum, 1e-30)              # [Hk, G, Q, D]
        out[q0:q1] = o.permute(2, 0, 1, 3).reshape(q1 - q0, hq, d).to(q.dtype)
    return out


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, ctx_len) -> torch.Tensor:
    """One query row per head over the cache rows ``[0, ctx_len)``: the
    plain arithmetic of ``flash_attention_plain`` without a causal mask.
    An empty context gives zeros, as the reference's skipped blocks do."""
    _, hq, d = q.shape
    hk = k_cache.shape[1]
    live = max(0, min(int(ctx_len), k_cache.shape[0]))
    if live == 0:
        return torch.zeros_like(q)
    qh = q.reshape(hk, hq // hk, d).to(_F32)
    kk = k_cache[:live].permute(1, 0, 2).to(_F32)          # [Hk, ctx, D]
    vv = v_cache[:live].permute(1, 0, 2).to(_F32)
    sc = torch.einsum("hgd,hkd->hgk", qh, kk) * _scale(d)
    p = torch.exp(sc - torch.amax(sc, dim=-1, keepdim=True))
    l_sum = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("hgk,hkd->hgd", p.to(v_cache.dtype).to(_F32), vv)
    o = o / torch.clamp_min(l_sum, 1e-30)
    return o.reshape(1, hq, d).to(q.dtype)


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_kernel_operands(q, k, v, what: str) -> None:
    require_on(q.device, k=k, v=v)
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(f"the CUDA {what} kernel takes bf16 or f32 q, k "
                                  f"and v of one dtype (got {q.dtype}, {k.dtype}, "
                                  f"{v.dtype})")
    hq, d = q.shape[1], q.shape[2]
    hk = k.shape[1]
    if (k.shape != v.shape or k.shape[2] != d or hq % hk or d not in (64, 128)):
        raise ValueError(f"unsupported {what} shape: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [S, Hq, D], k/v [S, Hk, D] -> [S, Hq, D] in q's dtype, scale
    1/sqrt(D), keys after the query masked when ``causal``."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal)
    _check_kernel_operands(q, k, v, "flash_attention")
    s, hq, d = q.shape
    if s < 1 or k.shape[0] != s:
        raise ValueError(f"flash_attention needs S >= 1 keys per query row: "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    qc, kc, vc = (_kernel_operand(t) for t in (q, k, v))
    out = torch.empty_like(qc)
    launch("flash_attention", "pgk_flash_attention", qc.data_ptr(), kc.data_ptr(),
           vc.data_ptr(), out.data_ptr(), s, hq, k.shape[1], d, int(bool(causal)),
           int(q.dtype == _F32), _scale(d), stream_of(q))
    return out


def decode_split(live: int, hk: int) -> tuple[int, int]:
    """(rows per chunk, chunks) of flash_decode's split: chunks of a multiple
    of DECODE_ROWS rows, about DECODE_BLOCKS blocks over the kv heads, none
    empty. A function of the context and Hk alone, so a replay splits the
    same way."""
    if live <= 0:
        return DECODE_ROWS, 0
    per_block = -(-live // max(1, DECODE_BLOCKS // hk))
    chunk = -(-per_block // DECODE_ROWS) * DECODE_ROWS
    return chunk, -(-live // chunk)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 ctx_len) -> torch.Tensor:
    """q [1, Hq, D], caches [MAX, Hk, D], ``ctx_len`` an int (or a 0-d
    tensor, read on the host) -> [1, Hq, D] in q's dtype."""
    if not q.is_cuda:
        return flash_decode_plain(q, k_cache, v_cache, ctx_len)
    _check_kernel_operands(q, k_cache, v_cache, "flash_decode")
    _, hq, d = q.shape
    max_len, hk, _ = k_cache.shape
    if q.shape[0] != 1 or hq // hk > 32:
        raise ValueError(f"flash_decode takes one query row and at most 32 query "
                         f"heads per kv head: q {tuple(q.shape)}, Hk {hk}")
    live = max(0, min(int(ctx_len), max_len))
    chunk, n_split = decode_split(live, hk)
    qc, kc, vc = (_kernel_operand(t) for t in (q, k_cache, v_cache))
    scratch = dict(device=q.device, dtype=_F32)
    pm = torch.empty((hq, max(n_split, 1)), **scratch)
    pl = torch.empty((hq, max(n_split, 1)), **scratch)
    pacc = torch.empty((hq, max(n_split, 1), d), **scratch)
    out = torch.empty_like(qc)
    launch("flash_decode", "pgk_flash_decode", qc.data_ptr(), kc.data_ptr(),
           vc.data_ptr(), out.data_ptr(), pm.data_ptr(), pl.data_ptr(),
           pacc.data_ptr(), live, hq, hk, d, chunk, n_split, int(q.dtype == _F32),
           _scale(d), stream_of(q))
    return out
