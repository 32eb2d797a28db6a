"""Attention: causal SDPA, the flash (chunked online-softmax) recurrence
and decode over a fixed cache (counterpart of
``pygpukit_tpu/ops/nn/attention.py``; the batched ``sdpa_batch_*`` forms
serve the reference's vmapped serving step, which the port replaces with
its batch-rows kernels).

Layouts follow the reference: q/k/v are ``[S, H, D]``; GQA by repeating
each kv head over its group on the plain route.

Route of ``flash_attention_fn`` (``flash_attention_route``; the
reference's route test at :131-169): on CUDA tensors, with no softcap, no
window and the default scale, the hand-written ``kernels.flash_attention``
kernel, at every length and for bf16 and f32 alike; softcap, window or
another scale take the plain route on the card too, as the reference sends
them to XLA, and so does a shape the kernel is not built for
(``kernels.flash_attention.supports``: a head dim outside its five, as
the reference checks eligibility before its kernels). A window no shorter than the keys masks nothing and counts as
none (``effective_window``; here and for fixed-cache decode). ``PYGPUKIT_FLASH_ATTENTION`` is read per call: ``pallas`` and
``jax`` take the kernel (the jax-shipped TPU flash kernel computes the same
function, causal softmax(QK^T scale)V, in another summation order, so the
port routes both names to its one kernel), ``xla`` forces the plain route.
The scale counts as the default when it equals ``1/sqrt(D)`` once rounded
to f32, the kernel's scale: the reference compares Python floats, and
``head_dim ** -0.5`` (the config's scale) differs from
``1/math.sqrt(head_dim)`` in the last bit at D 128. The reference's other
conditions (a TPU backend, bf16 only, S >= 8192, S % 256 == 0, D % 128 ==
0) are TPU compiler workarounds and are not ported. CPU tensors always
take the plain route: ``sdpa_causal_fn`` (or ``_full_attn``) for S <=
``chunk_size`` and the chunked recurrence above, f32 throughout, as the
reference computes off the TPU.

Route of fixed-cache decode (``sdpa_fixed_cache_fn``), by the same rule:
one query row (T = 1) on CUDA tensors over bf16 or f32 caches of q's
dtype, with no softcap, no window, the default scale (compared in f32) and
a shape the kernel is built for (``kernels.flash_attention.
decode_supports``: its five head dims, at most 32 query heads a kv head),
launches the hand-written ``kernels.flash_decode`` kernel (one launch over
a split fixed by the shapes; ``ctx_len`` passed through as given: an int,
or an int32 tensor on the card that the kernel reads, so a captured graph
serves every position). Everything else takes
the plain route on every device, as the reference computes it in XLA:
lookahead windows (T > 1), int8 dicts, fp8 caches, a softcap, a window or
another scale, and every CPU tensor. The plain route is the full softmax
over the whole cache, or, for caches of ``FLASH_DECODING_MIN_CACHE`` rows
and more (or as ``PYGPUKIT_FLASH_DECODING[_CHUNK]`` or ``decode_pref``
choose), the kv-chunk online softmax over the live chunks only (every
chunk when ``ctx_len`` is a tensor: the dead ones are selected away on the
device). ``ctx_len`` is an int or a one-element integer tensor (the
device position), never read on the host when it is a tensor. Caches are
``[MAX, Hk, D]`` tensors (fp8 read as bf16) or int8 ``{"q", "s"}`` dicts
dequantised against their per-row scales.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
import os

import numpy as np
import torch

from ...core.array import Array
from ...core.dtypes import FP8_MAX
from ...kernels.flash_attention import decode_supports as _flash_decode_supports
from ...kernels.flash_attention import flash_attention as _flash_kernel
from ...kernels.flash_attention import flash_decode as _flash_decode_kernel
from ...kernels.flash_attention import supports as _flash_supports
from .._common import apply_op

_F32 = torch.float32
_NEG_INF = -1e30


def _gqa_expand(k: torch.Tensor, n_heads_q: int) -> torch.Tensor:
    """[S, Hk, D] -> [S, Hq, D] by repeating each kv head over its group."""
    n_kv = k.shape[-2]
    if n_kv == n_heads_q:
        return k
    return k.repeat_interleave(n_heads_q // n_kv, dim=-2)


def _apply_softcap(scores: torch.Tensor, softcap: float | None) -> torch.Tensor:
    """Gemma-2 attention logit soft-capping: cap * tanh(scores / cap)."""
    if softcap is None:
        return scores
    return softcap * torch.tanh(scores * (1.0 / softcap))


def _window_or_inf(window) -> int | None:
    """Effective sliding window: None stays None, 0 or less is unbounded."""
    if window is None:
        return None
    return int(window) if int(window) > 0 else 1 << 30


def _heads_f32(t: torch.Tensor) -> torch.Tensor:
    return t.permute(1, 0, 2).to(_F32)                     # [H, S, D]


def sdpa_causal_fn(q, k, v, scale: float | None = None,
                   softcap: float | None = None, window=None) -> torch.Tensor:
    """Causal SDPA, [S, H, D] layout, f32 softmax. ``window``: query i
    attends keys j with i - window < j <= i (0 = full)."""
    s, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k, v = _gqa_expand(k, h), _gqa_expand(v, h)
    scores = torch.matmul(_heads_f32(q), _heads_f32(k).transpose(1, 2)) * scale
    scores = _apply_softcap(scores, softcap)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = j > i
    w = _window_or_inf(window)
    if w is not None:
        mask = mask | (j <= i - w)
    scores = torch.where(mask, torch.full_like(scores, _NEG_INF), scores)
    out = torch.matmul(torch.softmax(scores, dim=-1), _heads_f32(v))
    return out.permute(1, 0, 2).to(q.dtype)


def _full_attn(q, k, v, scale: float) -> torch.Tensor:
    """Unmasked softmax attention (k/v already expanded)."""
    scores = torch.matmul(_heads_f32(q), _heads_f32(k).transpose(1, 2)) * scale
    out = torch.matmul(torch.softmax(scores, dim=-1), _heads_f32(v))
    return out.permute(1, 0, 2).to(q.dtype)


def _kernel_scale(scale: float, d: int) -> bool:
    return np.float32(scale) == np.float32(1.0 / math.sqrt(d))


FLASH_ENV = "PYGPUKIT_FLASH_ATTENTION"


def effective_window(window, n_keys: int):
    """``window``, or None where it is at least ``n_keys``: a window that
    long masks none of the keys (Phi-3.5's 262144 over a 2048-token
    forward or an 8192-row cache), so the kernels' route takes it."""
    return None if window is not None and window >= n_keys else window


def flash_attention_route(device_type: str, scale: float, d: int,
                          softcap: float | None = None, window=None,
                          n_heads: int | None = None, n_kv_heads: int | None = None) -> str:
    """"kernel" or "plain": the route of ``flash_attention_fn`` for a
    ``device_type`` tensor (the rule in the module docstring). A shape the
    kernel is not built for (``kernels.flash_attention.supports``: the
    head dim, and the heads when given) takes the plain route."""
    hq = n_heads or 1
    if (device_type != "cuda" or softcap is not None or window is not None
            or not _kernel_scale(scale, d) or os.environ.get(FLASH_ENV, "") == "xla"
            or not _flash_supports(hq, n_kv_heads or hq, d)):
        return "plain"
    return "kernel"


def flash_attention_fn(q, k, v, scale: float | None = None,
                       chunk_size: int = 512, causal: bool = True,
                       softcap: float | None = None, window=None) -> torch.Tensor:
    """Online-softmax attention, q [S, Hq, D], k/v [S, Hk, D] -> [S, Hq, D]
    (route in the module docstring). The plain chunked recurrence keeps the
    reference's f32 running max, sum and accumulator over key chunks of
    ``chunk_size``, keys padded to a chunk multiple and masked."""
    s, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    window = effective_window(window, s)
    if flash_attention_route(q.device.type, scale, d, softcap, window, h,
                             k.shape[1]) == "kernel":
        return _flash_kernel(q, k, v, causal=causal)
    k, v = _gqa_expand(k, h), _gqa_expand(v, h)
    if s <= chunk_size:
        if causal:
            return sdpa_causal_fn(q, k, v, scale, softcap=softcap, window=window)
        return _full_attn(q, k, v, scale)

    pad = (-s) % chunk_size
    qh = _heads_f32(q)
    kh = torch.nn.functional.pad(_heads_f32(k), (0, 0, 0, pad))
    vh = torch.nn.functional.pad(_heads_f32(v), (0, 0, 0, pad))
    q_idx = torch.arange(s, device=q.device)[None, :, None]            # [1, S, 1]
    w_eff = _window_or_inf(window)
    m = torch.full((h, s, 1), _NEG_INF, dtype=_F32, device=q.device)
    l_sum = torch.zeros((h, s, 1), dtype=_F32, device=q.device)
    acc = torch.zeros((h, s, d), dtype=_F32, device=q.device)
    for c0 in range(0, s + pad, chunk_size):
        k_blk, v_blk = kh[:, c0:c0 + chunk_size], vh[:, c0:c0 + chunk_size]
        scores = torch.matmul(qh, k_blk.transpose(1, 2)) * scale
        scores = _apply_softcap(scores, softcap)
        kv_idx = c0 + torch.arange(chunk_size, device=q.device)[None, None, :]
        mask = kv_idx >= s
        if causal:
            mask = mask | (kv_idx > q_idx)
        if w_eff is not None:
            mask = mask | (kv_idx <= q_idx - w_eff)
        scores = torch.where(mask, torch.full_like(scores, _NEG_INF), scores)
        m_new = torch.maximum(m, torch.amax(scores, dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, v_blk)
        m = m_new
    out = acc / torch.clamp_min(l_sum, 1e-30)
    return out.permute(1, 0, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode over a fixed cache
# ---------------------------------------------------------------------------

#: cache size from which decode switches to the kv-chunk route (the
#: reference gates on the cache capacity); PYGPUKIT_FLASH_DECODING=
#: full|chunked overrides
FLASH_DECODING_MIN_CACHE = 8192
FLASH_DECODING_CHUNK = 2048

#: scoped decode-attention preference (mode, chunk), set by ``decode_pref``
_decode_pref: contextvars.ContextVar = contextvars.ContextVar("pygpukit_decode_pref",
                                                              default=None)


@contextlib.contextmanager
def decode_pref(mode: str, chunk: int | None = None):
    """Prefer a fixed-cache decode route ("full"/"chunked") and kv-chunk
    size inside the block. ``PYGPUKIT_FLASH_DECODING[_CHUNK]`` still win."""
    tok = _decode_pref.set((mode, chunk))
    try:
        yield
    finally:
        _decode_pref.reset(tok)


def _decode_backend(max_len: int) -> str:
    mode = os.environ.get("PYGPUKIT_FLASH_DECODING", "")
    if mode in ("full", "chunked"):
        return mode
    pref = _decode_pref.get()
    if pref is not None:
        return pref[0]
    return "chunked" if max_len >= FLASH_DECODING_MIN_CACHE else "full"


def _flash_chunk() -> int:
    """kv-chunk size of the chunked route (PYGPUKIT_FLASH_DECODING_CHUNK
    overrides, then ``decode_pref``)."""
    env = os.environ.get("PYGPUKIT_FLASH_DECODING_CHUNK")
    if env:
        return int(env)
    pref = _decode_pref.get()
    if pref is not None and pref[1]:
        return pref[1]
    return FLASH_DECODING_CHUNK


def _kv_load(blk):
    """A cache block for attention math: fp8 storage reads as bf16, int8
    dicts dequantise against their per-row scales, others as stored."""
    if isinstance(blk, dict):
        from ..embedding import kv_dequant
        return kv_dequant(blk["q"], blk["s"])
    if blk.dtype in FP8_MAX:
        return blk.to(torch.bfloat16)
    return blk


def _kv_shape(cache) -> tuple[int, ...]:
    """Storage-leaf shape of a plain or int8-dict cache."""
    return tuple((cache["q"] if isinstance(cache, dict) else cache).shape)


def _round_as(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """p rounded to the cache's compute dtype, carried in f32."""
    return p.to(dtype).to(_F32)


def fixed_cache_route(device_type: str, t: int, hq: int, hk: int, d: int,
                      q_dtype: torch.dtype, k_dtype: torch.dtype | None,
                      v_dtype: torch.dtype | None, scale: float | None = None,
                      softcap: float | None = None, window=None) -> str:
    """"kernel" or "plain": the route of ``sdpa_fixed_cache_fn`` (module
    docstring) for T query rows of Hq heads over caches of Hk heads of
    ``k_dtype``/``v_dtype`` (None for an int8 dict), the window already
    through ``effective_window``. Reads shapes and dtypes, nothing else."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if (device_type == "cuda" and t == 1 and _flash_decode_supports(hq, hk, d)
            and k_dtype in (torch.bfloat16, _F32) and q_dtype == k_dtype == v_dtype
            and softcap is None and window is None and _kernel_scale(scale, d)):
        return "kernel"
    return "plain"


def sdpa_fixed_cache_fn(q, k_cache, v_cache, ctx_len, scale: float | None = None,
                        softcap: float | None = None, window=None) -> torch.Tensor:
    """Decode attention over a fixed cache: q [T, Hq, D] (T > 1 for a
    lookahead window), caches [MAX, Hk, D]; query row i attends positions
    below ``ctx_len - (T - 1) + i`` (an int or a one-element tensor). Long caches take the kv-chunk route
    (module docstring); on the card one query row may launch the
    flash_decode kernel (route in the module docstring)."""
    t, h, d = q.shape
    window = effective_window(window, _kv_shape(k_cache)[0])
    dicts = isinstance(k_cache, dict) or isinstance(v_cache, dict)
    if fixed_cache_route(q.device.type, t, h, _kv_shape(k_cache)[1], d, q.dtype,
                         None if dicts else k_cache.dtype,
                         None if dicts else v_cache.dtype, scale, softcap,
                         window) == "kernel":
        return _flash_decode_kernel(q, k_cache, v_cache, ctx_len)
    if _decode_backend(_kv_shape(k_cache)[0]) == "chunked":
        return sdpa_fixed_cache_chunked_fn(q, k_cache, v_cache, ctx_len, scale,
                                           softcap=softcap, window=window)
    return _sdpa_fixed_cache_full(q, k_cache, v_cache, ctx_len, scale,
                                  softcap=softcap, window=window)


def _grouped_q(q: torch.Tensor, hk: int) -> torch.Tensor:
    t, h, d = q.shape
    return q.reshape(t, hk, h // hk, d).permute(1, 2, 0, 3).to(_F32)    # [Hk, G, T, D]


def _ctx_scalar(ctx_len):
    """``ctx_len`` as a host int, or as a 0-d int64 tensor where it is a
    tensor (the device position: never read on the host)."""
    if isinstance(ctx_len, torch.Tensor):
        return ctx_len.reshape(()).to(torch.long)
    return int(ctx_len)


def _limit(ctx_len, t: int, device) -> torch.Tensor:
    return _ctx_scalar(ctx_len) - (t - 1) + torch.arange(t, device=device)[None, None, :, None]


def _sdpa_fixed_cache_full(q, k_cache, v_cache, ctx_len, scale: float | None = None,
                           softcap: float | None = None, window=None) -> torch.Tensor:
    k_cache, v_cache = _kv_load(k_cache), _kv_load(v_cache)
    t, h, d = q.shape
    max_len, hk, _ = k_cache.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kk = k_cache.permute(1, 0, 2)                                       # [Hk, MAX, D]
    vv = v_cache.permute(1, 0, 2)
    scores = torch.einsum("hgtd,hkd->hgtk", _grouped_q(q, hk), kk.to(_F32)) * scale
    scores = _apply_softcap(scores, softcap)
    kv_idx = torch.arange(max_len, device=q.device)[None, None, None, :]
    limit = _limit(ctx_len, t, q.device)
    mask = kv_idx >= limit
    w_eff = _window_or_inf(window)
    if w_eff is not None:
        mask = mask | (kv_idx < limit - w_eff)
    scores = torch.where(mask, torch.full_like(scores, _NEG_INF), scores)
    probs = _round_as(torch.softmax(scores, dim=-1), vv.dtype)
    out = torch.einsum("hgtk,hkd->hgtd", probs, vv.to(_F32))
    return out.permute(2, 0, 1, 3).reshape(t, h, d).to(q.dtype)


def _cache_rows(cache, start: int, chunk: int):
    if isinstance(cache, dict):
        return {"q": cache["q"][start:start + chunk], "s": cache["s"][start:start + chunk]}
    return cache[start:start + chunk]


def sdpa_fixed_cache_chunked_fn(q, k_cache, v_cache, ctx_len, scale: float | None = None,
                                chunk: int | None = None, softcap: float | None = None,
                                window=None) -> torch.Tensor:
    """kv-chunk online-softmax decode: only the ceil(ctx / chunk) live
    chunks are read (and dequantised), each chunk's dead rows masked with
    p = 0; f32 running max, sum and accumulator, P rounded to the cache's
    compute dtype before P.V, as the reference's loop. ``ctx_len`` a
    tensor (the device position): every chunk is read, and a chunk the
    host loop would not reach (past the context, or wholly before a
    sliding window) leaves the running max, sum and accumulator as they
    were, selected on the device, so the result is the host loop's bits."""
    t, h, d = q.shape
    max_len, hk, _ = _kv_shape(k_cache)
    g = h // hk
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    chunk = min(chunk if chunk is not None else _flash_chunk(), max_len)
    n_chunks = -(-max_len // chunk)
    ctx = _ctx_scalar(ctx_len)
    on_device = isinstance(ctx, torch.Tensor)
    qh = _grouped_q(q, hk)
    limit = _limit(ctx, t, q.device)
    w_eff = _window_or_inf(window)
    if on_device:
        first = (torch.zeros((), dtype=torch.long, device=q.device) if w_eff is None else
                 torch.clamp_min(torch.div(ctx - t - w_eff + 1, chunk,
                                           rounding_mode="floor"), 0))
        i = 0
    else:
        i = 0 if w_eff is None else max(0, (ctx - t - w_eff + 1) // chunk)
    m = torch.full((hk, g, t, 1), _NEG_INF, dtype=_F32, device=q.device)
    l_sum = torch.zeros((hk, g, t, 1), dtype=_F32, device=q.device)
    acc = torch.zeros((hk, g, t, d), dtype=_F32, device=q.device)
    while i < n_chunks and (on_device or i * chunk < ctx):
        start_log = i * chunk
        start = min(start_log, max_len - chunk)
        k_blk = _kv_load(_cache_rows(k_cache, start, chunk))
        v_blk = _kv_load(_cache_rows(v_cache, start, chunk))
        s = torch.einsum("hgtd,hkd->hgtk", qh, k_blk.permute(1, 0, 2).to(_F32)) * scale
        s = _apply_softcap(s, softcap)
        kv_idx = start + torch.arange(chunk, device=q.device)[None, None, None, :]
        dead = (kv_idx >= limit) | (kv_idx < start_log)
        if w_eff is not None:
            dead = dead | (kv_idx < limit - w_eff)
        s = torch.where(dead, torch.full_like(s, _NEG_INF), s)
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        p = torch.where(dead, torch.zeros_like(s), torch.exp(s - m_new))
        alpha = torch.exp(m - m_new)
        l_new = l_sum * alpha + torch.sum(p, dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum("hgtk,hkd->hgtd", _round_as(p, v_blk.dtype),
                                             v_blk.permute(1, 0, 2).to(_F32))
        if on_device:
            live = (i >= first) & (start_log < ctx)
            m_new = torch.where(live, m_new, m)
            l_new = torch.where(live, l_new, l_sum)
            acc_new = torch.where(live, acc_new, acc)
        m, l_sum, acc = m_new, l_new, acc_new
        i += 1
    out = acc / torch.clamp_min(l_sum, 1e-30)
    return out.permute(2, 0, 1, 3).reshape(t, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Array-facing wrappers
# ---------------------------------------------------------------------------

def sdpa_causal(q, k, v, scale: float | None = None, *,
                out: Array | None = None) -> Array:
    return apply_op(functools.partial(sdpa_causal_fn, scale=scale), q, k, v, out=out)


def flash_attention(q, k, v, scale: float | None = None, chunk_size: int = 512,
                    *, out: Array | None = None) -> Array:
    return apply_op(functools.partial(flash_attention_fn, scale=scale,
                                      chunk_size=chunk_size), q, k, v, out=out)


def sdpa_causal_fixed_cache(q, k_cache, v_cache, ctx_len: int,
                            scale: float | None = None, *,
                            out: Array | None = None) -> Array:
    return apply_op(lambda a, b, c: sdpa_fixed_cache_fn(a, b, c, ctx_len, scale),
                    q, k_cache, v_cache, out=out)
