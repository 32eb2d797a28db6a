"""Flash attention (prefill) and flash decoding (port of
``pygpukit_tpu/kernels/flash_attention.py``).

``flash_attention``: q ``[S, Hq, D]``, k/v ``[S, Hk, D]`` (GQA) -> ``[S, Hq,
D]`` in q's dtype, causal or full, scale ``1/sqrt(D)``. ``flash_decode``:
one query row ``[1, Hq, D]`` over fixed caches ``[MAX, Hk, D]`` whose rows
``[0, ctx_len)`` are live. Both keep the reference kernels' arithmetic: f32
scores and running state, P rounded to the input dtype before P@V, the sum
floored at 1e-30. CUDA tensors launch ``csrc/flash_attention.cu`` and
``csrc/flash_decode.cu`` (bf16 or f32, D 64, 80, 96, 128 or 256) or raise; CPU tensors
take the plain versions, which compute the same full softmax with P rounded
the same way (the kernels' online form rounds P against a running maximum,
so the two agree to bf16 rounding, and to f32 summation order in f32).

``flash_decode`` is one launch over the decode-attention bodies that the
batch kernels share (``csrc/decode_attention.cuh``): the tensor-core one
for bf16 with up to 16 query heads a kv head, the CUDA-core one otherwise.
Its split comes from the shapes alone (:func:`decode_plan`) and
``ctx_len`` may be an int32 tensor on the card, which the kernel reads, so
a CUDA graph captured once replays at every context.

The reference's GQA head repeat, its padding to block multiples and its
eight-row query padding in the decode kernel are TPU layout needs and are
not ported: the kernels read each kv head's rows in place and mask the
ragged edge themselves.
"""

from __future__ import annotations

import math

import torch

from ._build import launch, require_on, stream_of
from .attention_split import ATTN_CHUNK, attention_splits

_F32 = torch.float32
_NEG_INF = -1e30
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
#: flash_decode's arrival counters: one per kv head (``csrc/flash_decode.cu``)
MAX_KV_HEADS = 4096
#: flash_decode's tensor-core route (bf16, at most 16 query heads a kv
#: head): the 64-row chunks a block of four warps takes at most (two a
#: warp, both in flight), and the blocks it aims at (one an SM)
DECODE_MMA_CHUNKS, DECODE_MMA_BLOCKS = 8, 132
#: the head dims both kernels are built for
HEAD_DIMS = (64, 80, 96, 128, 256)
#: query rows per step of flash_attention_plain (bounds its score memory)
_PLAIN_Q_BLOCK = 512


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def supports(hq: int, hk: int, d: int) -> bool:
    """``flash_attention`` is built for this shape: D one of HEAD_DIMS and
    whole groups of query heads. Reads the shape and nothing else; the
    routes send other shapes to the plain version, and the wrapper raises
    on them."""
    return d in HEAD_DIMS and hk >= 1 and hq % hk == 0


def decode_supports(hq: int, hk: int, d: int) -> bool:
    """``flash_decode`` is built for this shape: D one of HEAD_DIMS, 1 to
    32 query heads a kv head, at most MAX_KV_HEADS kv heads (as
    ``supports``: the shape alone)."""
    return (d in HEAD_DIMS and 1 <= hk <= MAX_KV_HEADS and hq % hk == 0
            and hq // hk <= 32)


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
    if (k.shape != v.shape or k.shape[2] != d or hq % hk or d not in HEAD_DIMS):
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


def mma_fold_splits(g: int, d: int) -> int:
    """Splits the tensor-core kernel's last block can stage in its ring to
    fold them in one pass: ``pgk_mma_fold_splits`` of
    ``csrc/decode_attention.cuh`` (a ring of four warps x 2 stages at D 64,
    1 above, x K and V tiles of 64 rows, 32 at D 256, of D rounded up to 32
    columns and padded by 16 bytes; a split takes G (D + 3) floats, and each
    head one more)."""
    rows = 32 if d > 128 else ATTN_CHUNK
    cols = -(-d // 32) * 32
    ring = 4 * (2 if d == 64 else 1) * 2 * rows * (2 * cols + 16)
    return (ring - 4 * g) // (g * (d + 3) * 4)


def decode_plan(hq: int, max_len: int, hk: int, d: int = 64,
                dtype: torch.dtype = torch.bfloat16) -> int:
    """flash_decode's splits per kv head (its grid is splits x Hk blocks),
    from the shapes alone, so one captured launch serves every context.
    Tensor-core route: at most DECODE_MMA_CHUNKS chunks a split, about
    DECODE_MMA_BLOCKS blocks, no more splits than its last block folds in
    one pass; CUDA-core route: the batch kernels' plan for one slot (a warp
    a query head). ValueError for a shape the kernel does not take: more
    than 32 query heads per kv head, more than MAX_KV_HEADS kv heads."""
    if hk < 1 or hq % hk or hq // hk > 32 or hk > MAX_KV_HEADS:
        raise ValueError(f"flash_decode takes 1 to 32 query heads per kv head and at "
                         f"most {MAX_KV_HEADS} kv heads: Hq {hq}, Hk {hk}")
    if dtype == torch.bfloat16 and hq // hk <= 16:        # the tensor-core route
        chunks = -(-max_len // ATTN_CHUNK)
        return max(1, min(-(-chunks // DECODE_MMA_CHUNKS), -(-DECODE_MMA_BLOCKS // hk),
                          mma_fold_splits(hq // hk, d)))
    return attention_splits(1, hk, max_len)


def _ctx_operand(ctx_len, device, max_len: int):
    """(device tensor or None, int) of ``ctx_len`` for the kernel: a CUDA
    tensor (one int32 element) stays on the card and the kernel reads it;
    an int or a CPU tensor is passed by value, clamped to [0, MAX] (the
    kernel's own reading of it)."""
    if isinstance(ctx_len, torch.Tensor) and ctx_len.is_cuda:
        require_on(device, ctx_len=ctx_len)
        if ctx_len.numel() != 1 or ctx_len.dtype != torch.int32:
            raise ValueError(f"a CUDA ctx_len must be one int32 element, got "
                             f"{ctx_len.dtype} {tuple(ctx_len.shape)}")
        return ctx_len, 0
    return None, max(0, min(int(ctx_len), max_len))


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 ctx_len) -> torch.Tensor:
    """q [1, Hq, D], caches [MAX, Hk, D] -> [1, Hq, D] in q's dtype over
    the cache rows ``[0, ctx_len)`` (below 0: none, zeros out; above MAX:
    all). ``ctx_len``: an int, or a tensor of one element; on the card an
    int32 CUDA tensor, which the kernel reads and the host never does."""
    if not q.is_cuda:
        return flash_decode_plain(q, k_cache, v_cache, ctx_len)
    _check_kernel_operands(q, k_cache, v_cache, "flash_decode")
    _, hq, d = q.shape
    max_len, hk, _ = k_cache.shape
    if q.shape[0] != 1:
        raise ValueError(f"flash_decode takes one query row: q {tuple(q.shape)}")
    n_split = decode_plan(hq, max_len, hk, d, q.dtype)
    ctx, ctx_val = _ctx_operand(ctx_len, q.device, max_len)
    qc, kc, vc = (_kernel_operand(t) for t in (q, k_cache, v_cache))
    part = torch.empty(hq * n_split * (d + 2), device=q.device, dtype=_F32)
    out = torch.empty_like(qc)
    launch("flash_decode", "pgk_flash_decode", qc.data_ptr(), kc.data_ptr(),
           vc.data_ptr(), None if ctx is None else ctx.data_ptr(), ctx_val,
           out.data_ptr(), part.data_ptr(), hq, hk, d, max_len, n_split,
           int(q.dtype == _F32), _scale(d), stream_of(q))
    return out
