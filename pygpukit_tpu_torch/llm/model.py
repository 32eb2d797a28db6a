"""Unified causal LM: the serving slice of ``pygpukit_tpu/llm/model.py``.

Parameters keep the reference's stacked layout: every per-layer leaf is one
``[L, ...]`` tensor, and a layer is a free view ``leaf[i]``. PyTorch runs
eagerly, so the layer loop is a Python loop and a cache update is an
in-place write (the reference threads donated buffers through ``fori_loop``).

Route rule (the one place it is written down, with ``batch_decode_step_fn``).
Weight leaves by kind, rows = activation rows of the call:

- int4 ``{"q_packed" [N, K/2], "scale"}``, INT4_MODE=w4a8 (default):
  ``w4a8_matmul``, the w4a8 GEMV kernel for rows <= 8 and the GEMM kernel
  above (the head included: it is never int4);
- int4, INT4_MODE=w4a16: ``w4a16_matmul`` for rows <= 8, dequant + matmul
  above;
- int4_block ``{"q_packed" [K/2, N], "scale_block" [K/B, N]}``,
  INT4_BLOCK=w4a8 (default): ``block_w4a8_matmul`` for rows <= 8, dequant +
  matmul above;
- int4_block, INT4_BLOCK=w4a16: ``block_w4a16_matmul``, dequant + matmul
  above;
- fp8 ``{"q" e4m3fn/e5m2 [K, N], "scale"}``: ``conv_matmul`` for rows <= 8,
  convert + matmul above and for the head;
- int8 ``{"q" [K, N], "scale"}``, INT8_MODE=w8a8 (default): w8a8 at every
  row count (``torch._int_mm`` on the card, an int32 product on the CPU;
  the reference leaves it to XLA);
- int8, INT8_MODE=w8a16: ``conv_matmul`` for rows <= 8, convert + matmul
  above and for the head;
- dense [K, N]: ``torch.matmul``, bf16 x bf16 -> bf16 on the card, in f32
  otherwise.

The switches are the environment variables ``PYGPUKIT_INT4_MODE``,
``PYGPUKIT_INT4_BLOCK`` and ``PYGPUKIT_INT8_MODE``, read per call. The
head (``_logits`` passes ``out_dtype=torch.float32``) never takes a bf16
GEMV: an fp8 or w8a16 head is the plain convert + matmul with f32 logits,
as the reference's 2-D head always takes its XLA route. "dequant + matmul"
and "convert + matmul" are the kernels' plain versions with the output in
``out_dtype`` (the reference's XLA routes).

The batch-rows decode step always uses ``kernels.kv_rows_write`` and
``kernels.batch_decode_attention``; single-stream decode is that step with
B = 1 over a ``[1, L, MAX, Hk*D]`` pool. Cached prefill attends with the
plain f32 softmax (``_prefill_attn``). The uncached forward
(``forward_fn``, ``get_logits``, ``generate(use_cache=False)``) attends
through ``ops.nn.flash_attention_fn``: on CUDA tensors the
``kernels.flash_attention`` kernel at every length, bf16 or f32, unless the
layer has a softcap, a window or a non-default scale, which take the plain
route (as the reference sends them to XLA); its weight leaves follow the
rows > 8 routes above (the forward is M = S rows, as prefill is).

The device picks only the implementation: the kernel for CUDA tensors, the
plain version for CPU tensors. The reference's size and regime gates
(``on_tpu``, minimum weight sizes, exact tiles, the M >= 256 rule for
layer-sliced operands, the XLA default of its fp8 GEMV, the MAX >= 1024
attention gate, the bf16-only S >= 8192 flash-attention gate) work around
TPU compilers and are not ported: the port always computes what the TPU
kernels compute.
"""

from __future__ import annotations

import math
import os
from collections.abc import Iterator

import numpy as np
import torch
from torch import nn

from ..core.backend import resolve_device
from ..core.dtypes import resolve_dtype
from ..core.numerics import true_div
from ..kernels import (batch_decode_attention, block_w4a8_matmul,
                       block_w4a16_matmul, block_w4a16_matmul_plain, conv_matmul,
                       conv_matmul_plain, kv_rows_write, w4a8_matmul,
                       w4a16_matmul, w4a16_matmul_plain)
from ..kernels.gemv_quant import GEMV_MAX_ROWS
from ..ops.embedding import kv_cache_zeros, kv_leaf, kv_write
from ..ops.matmul import int8_dot
from ..ops.nn import (apply_rope_fn, flash_attention_fn, rmsnorm_fn,
                      rope_tables, swiglu_fn)
from ..ops.sampling import (sample_greedy_fn, sample_temperature_fn,
                            sample_topk_fn, sample_topp_fn)
from .config import TransformerConfig

_F32 = torch.float32
_NEG_INF = -1e30


def check_supported(cfg: TransformerConfig) -> None:
    """Raise NotImplementedError for architecture features this slice has
    not ported, instead of computing something else silently."""
    missing = [name for name, on in (
        ("layernorm", cfg.norm_type != "rmsnorm"),
        ("MoE", cfg.is_moe), ("qk norm", cfg.use_qk_norm),
        ("post norms", cfg.use_post_norms), ("post-norm-only blocks", not cfg.pre_norms),
        ("parallel blocks", cfg.parallel_block),
        ("interleaved rope", cfg.rope_interleaved),
        ("partial rotary", cfg.rope_partial_factor != 1.0),
        ("scaled rope", bool(cfg.rope_scaling)),
        ("per-layer rope tables", cfg.rope_layers is not None
         or cfg.rope_local_theta is not None),
        ("residual multiplier", cfg.residual_multiplier is not None),
        ("learned position embeddings", cfg.use_position_embed),
        ("embedding scale", cfg.embed_scale is not None),
        ("logit scale or softcap", cfg.logit_scale is not None
         or cfg.final_logit_softcap is not None),
        (f"activation {cfg.activation!r}", cfg.activation != "silu"),
    ) if on]
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


#: the leaves the slice reads; a param tree with others (biases, MoE or
#: norm variants) is refused rather than partly ignored
_LAYER_LEAVES = {"w_qkv", "w_q", "w_k", "w_v", "w_o", "w_gate_up", "w_gate",
                 "w_up", "w_down", "attn_norm_w", "mlp_norm_w", "attn_window"}
_TOP_LEAVES = {"embed", "final_norm_w", "lm_head", "layers", "rope_cos",
               "rope_sin"}


#: weight leaf kinds: dict keys -> the storage dtypes of "q"/"q_packed"
_LEAF_KINDS = {
    frozenset({"q_packed", "scale"}): {torch.uint8},                 # int4
    frozenset({"q_packed", "scale_block"}): {torch.uint8},           # int4_block
    frozenset({"q", "scale"}): {torch.int8, torch.float8_e4m3fn,     # int8, fp8
                                torch.float8_e5m2},
}


def _check_params(params: dict) -> None:
    extra = (set(params) - _TOP_LEAVES) | (set(params["layers"]) - _LAYER_LEAVES)
    if extra:
        raise NotImplementedError(f"param leaves not ported yet: {sorted(extra)}")
    leaves = dict(params["layers"], lm_head=params.get("lm_head"))
    for name, leaf in leaves.items():
        if not isinstance(leaf, dict):
            continue
        dtypes = _LEAF_KINDS.get(frozenset(leaf))
        q = leaf.get("q", leaf.get("q_packed"))
        if dtypes is None or q.dtype not in dtypes:
            raise NotImplementedError(
                f"weight leaf {name} ({sorted(leaf)}, "
                f"{getattr(q, 'dtype', None)}) is not a ported kind")


# ---------------------------------------------------------------------------
# Matmul routing
# ---------------------------------------------------------------------------

def _w8a8(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-row int8 activation quant, int8 dot, f32 epilogue
    ``(acc * sx) * scale`` (the reference's TPU w8a8 route)."""
    x2 = x.reshape(-1, x.shape[-1])
    amax = torch.amax(torch.abs(x2), dim=-1, keepdim=True).to(_F32)
    sx = torch.clamp_min(true_div(amax, 127.0), 1e-12)
    xi = torch.round(x2.to(_F32) / sx).to(torch.int8)
    y = (int8_dot(xi, q).to(_F32) * sx) * scale.to(_F32)
    return y.reshape(*x.shape[:-1], q.shape[-1])


#: the route switches: environment variable -> (default, choices)
SWITCHES = {"PYGPUKIT_INT4_MODE": ("w4a8", ("w4a8", "w4a16")),
            "PYGPUKIT_INT4_BLOCK": ("w4a8", ("w4a8", "w4a16")),
            "PYGPUKIT_INT8_MODE": ("w8a8", ("w8a8", "w8a16"))}


def _switch(name: str) -> str:
    default, choices = SWITCHES[name]
    value = os.environ.get(name, default)
    if value not in choices:
        raise ValueError(f"{name}={value!r}; one of {choices}")
    return value


def _mm(x: torch.Tensor, w, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Matmul against a weight leaf (see the route rule above); x [..., K].
    ``out_dtype`` defaults to x's; an explicit f32 marks the head."""
    head = out_dtype == _F32
    out_dtype = out_dtype or x.dtype
    if not isinstance(w, dict):
        if x.is_cuda and x.dtype == w.dtype == out_dtype == torch.bfloat16:
            return torch.matmul(x, w)
        return torch.matmul(x.to(_F32), w.to(_F32)).to(out_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    gemv = x2.shape[0] <= GEMV_MAX_ROWS and not head
    if "scale_block" in w:
        if not gemv:
            y = block_w4a16_matmul_plain(x2, w["q_packed"], w["scale_block"], out_dtype)
        elif _switch("PYGPUKIT_INT4_BLOCK") == "w4a8":
            y = block_w4a8_matmul(x2, w["q_packed"], w["scale_block"])
        else:
            y = block_w4a16_matmul(x2, w["q_packed"], w["scale_block"])
    elif "q_packed" in w:
        if _switch("PYGPUKIT_INT4_MODE") == "w4a8":
            y = w4a8_matmul(x2, w["q_packed"], w["scale"])
        elif gemv:
            y = w4a16_matmul(x2, w["q_packed"], w["scale"])
        else:
            y = w4a16_matmul_plain(x2, w["q_packed"], w["scale"], out_dtype)
    elif w["q"].dtype == torch.int8 and _switch("PYGPUKIT_INT8_MODE") == "w8a8":
        y = _w8a8(x2, w["q"], w["scale"])
    elif gemv:
        y = conv_matmul(x2, w["q"], w["scale"])
    else:
        y = conv_matmul_plain(x2, w["q"], w["scale"], out_dtype)
    return y.reshape(*lead, y.shape[-1]).to(out_dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _slice_layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s views of the stacked [L, ...] leaves (free in torch)."""
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                else v[i]) for k, v in layers.items()}


def _rope_rows_for(params: dict, pos, t: int):
    """Rope table rows. ``pos`` an int: rows pos..pos+t-1, the start clamped
    to [0, n - t]; a [B] tensor: one row per slot, clamped to [0, n - 1]
    (the clamps of ``lax.dynamic_slice`` in the reference: a free slot
    decoding past the table stays in range)."""
    cos, sin = params["rope_cos"], params["rope_sin"]
    n = cos.shape[0]
    if isinstance(pos, torch.Tensor):
        rows = torch.clamp(pos.to(torch.long), 0, n - 1)
        return cos[rows], sin[rows]
    start = min(max(int(pos), 0), n - t)
    return cos[start:start + t], sin[start:start + t]


def _norm(cfg: TransformerConfig, x, w):
    return rmsnorm_fn(x, w, cfg.norm_eps)


def _attn_in(cfg: TransformerConfig, lp: dict, h):
    return _norm(cfg, h, lp["attn_norm_w"])


def _rope(cfg: TransformerConfig, x, cos, sin):
    return apply_rope_fn(x, cos, sin)


def _project_qkv(cfg: TransformerConfig, lp: dict, x):
    """x [S, E] -> q [S, Hq, D], k and v [S, Hk, D] in x's dtype."""
    s = x.shape[0]
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "w_qkv" in lp:
        qkv = _mm(x, lp["w_qkv"]).to(_F32)
        q, k, v = qkv[:, :hq * d], qkv[:, hq * d:(hq + hk) * d], qkv[:, (hq + hk) * d:]
    else:
        q, k, v = (_mm(x, lp[n]).to(_F32) for n in ("w_q", "w_k", "w_v"))
    return (q.to(x.dtype).reshape(s, hq, d), k.to(x.dtype).reshape(s, hk, d),
            v.to(x.dtype).reshape(s, hk, d))


def _out_proj(lp: dict, attn, s: int, dtype):
    return _mm(attn.reshape(s, -1), lp["w_o"]).to(dtype)


def _mlp(cfg: TransformerConfig, lp: dict, y):
    if "w_gate_up" in lp:
        gate, up = torch.chunk(_mm(y, lp["w_gate_up"]), 2, dim=-1)
    else:
        gate, up = _mm(y, lp["w_gate"]), _mm(y, lp["w_up"])
    return _mm(swiglu_fn(gate, up), lp["w_down"])


def _residual_tail(cfg: TransformerConfig, lp: dict, h, attn, s: int):
    """Out-projection + residual, then the MLP sublayer + residual."""
    h = h + _out_proj(lp, attn, s, h.dtype)
    return h + _mlp(cfg, lp, _norm(cfg, h, lp["mlp_norm_w"]))


def _embed_tokens(cfg: TransformerConfig, params: dict, tokens):
    return params["embed"][tokens.to(torch.long)]


def _logits(cfg: TransformerConfig, params: dict, h):
    head = params.get("lm_head")
    if isinstance(head, dict):
        logits = _mm(h, head, out_dtype=_F32)
    elif head is not None:
        logits = torch.matmul(h.to(_F32), head.to(_F32))
    else:                                   # tied embeddings
        logits = torch.matmul(h.to(_F32), params["embed"].to(_F32).t())
    return logits


def _layer_window(cfg: TransformerConfig, i: int) -> int | None:
    wins = cfg.layer_windows()
    return None if wins is None or wins[i] <= 0 else wins[i]


# ---------------------------------------------------------------------------
# Forward (no cache)
# ---------------------------------------------------------------------------

def layer_stack_fn(cfg: TransformerConfig, layers: dict, h: torch.Tensor,
                   rope_cos, rope_sin) -> torch.Tensor:
    """Run h [S, E] through the stacked layers (a Python loop over the layer
    views); attention through ``flash_attention_fn`` (route rule above)."""
    s = h.shape[0]
    for i in range(layers["attn_norm_w"].shape[0]):
        lp = _slice_layer_params(layers, i)
        x = _attn_in(cfg, lp, h)
        q, k, v = _project_qkv(cfg, lp, x)
        if cfg.use_rope:
            q = _rope(cfg, q, rope_cos[:s], rope_sin[:s])
            k = _rope(cfg, k, rope_cos[:s], rope_sin[:s])
        attn = flash_attention_fn(q, k, v, scale=cfg.attn_scale,
                                  softcap=cfg.attn_logit_softcap,
                                  window=_layer_window(cfg, i))
        h = _residual_tail(cfg, lp, h, attn, s)
    return h


def forward_fn(cfg: TransformerConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [S] -> f32 logits [S, V], every position, no cache."""
    h = _embed_tokens(cfg, params, tokens)
    h = layer_stack_fn(cfg, params["layers"], h, params.get("rope_cos"),
                       params.get("rope_sin"))
    h = _norm(cfg, h, params["final_norm_w"])
    return _logits(cfg, params, h)


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

def _prefill_attn(q, k, v, true_len: int, scale=None, softcap=None, window=None):
    """Causal attention within the padded prompt, f32; positions >= true_len
    are masked out."""
    s, hq, d = q.shape
    hk = k.shape[1]
    if hk != hq:
        k = k.repeat_interleave(hq // hk, dim=1)
        v = v.repeat_interleave(hq // hk, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qh, kh, vh = (t.transpose(0, 1).to(_F32) for t in (q, k, v))
    scores = torch.matmul(qh, kh.transpose(1, 2)) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores * (1.0 / softcap))
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = (j > i) | (j >= true_len)
    if window is not None:
        mask = mask | (j <= i - window)
    scores = torch.where(mask, torch.full_like(scores, _NEG_INF), scores)
    out = torch.matmul(torch.softmax(scores, dim=-1), vh)
    return out.transpose(0, 1).to(q.dtype)


def prefill_fn(cfg: TransformerConfig, params: dict, k_cache, v_cache,
               tokens: torch.Tensor, true_len: int) -> torch.Tensor:
    """Prefill padded ``tokens`` [S]; write rows [0, S) of every layer of the
    slot caches ``[L, MAX, Hk*D]`` (or int8 dicts) in place; return the f32
    logits [V] of position ``true_len - 1``."""
    s = tokens.shape[0]
    h = _embed_tokens(cfg, params, tokens)
    rc, rs = _rope_rows_for(params, 0, s) if cfg.use_rope else (None, None)
    for i in range(kv_leaf(k_cache).shape[0]):
        lp = _slice_layer_params(params["layers"], i)
        x = _attn_in(cfg, lp, h)
        q, k, v = _project_qkv(cfg, lp, x)
        if cfg.use_rope:
            q, k = _rope(cfg, q, rc, rs), _rope(cfg, k, rc, rs)
        kv_write(k_cache, k.reshape(1, s, -1), (i, 0, 0))
        kv_write(v_cache, v.reshape(1, s, -1), (i, 0, 0))
        attn = _prefill_attn(q, k, v, true_len, cfg.attn_scale,
                             cfg.attn_logit_softcap, _layer_window(cfg, i))
        h = _residual_tail(cfg, lp, h, attn, s)
    h = _norm(cfg, h, params["final_norm_w"])
    return _logits(cfg, params, h[true_len - 1])


def batch_decode_step_fn(cfg: TransformerConfig, params: dict, k_pool, v_pool,
                         tokens: torch.Tensor, poss: torch.Tensor) -> torch.Tensor:
    """One decode step for all B slots with the hidden rows batched through
    every weight matmul (one weight stream per projection for all rows).

    Pools ``[B, L, MAX, Hk*D]`` are updated in place; tokens [B], poss [B]
    int32 device tensors (a free slot passes its stale position: rope rows,
    the row write and the attention bound all clamp). Returns f32 logits
    [B, V]. Always the two serving kernels (route rule above)."""
    b = tokens.shape[0]
    h = _embed_tokens(cfg, params, tokens)
    c, sn = _rope_rows_for(params, poss, 1) if cfg.use_rope else (None, None)
    lens = poss + 1
    for i in range(kv_leaf(k_pool).shape[1]):
        lp = _slice_layer_params(params["layers"], i)
        x = _attn_in(cfg, lp, h)
        q, k, v = _project_qkv(cfg, lp, x)                    # [B, H, D]
        if cfg.use_rope:
            q, k = _rope(cfg, q, c, sn), _rope(cfg, k, c, sn)
        kv_rows_write(k_pool, v_pool, k, v, i, poss)
        attn = batch_decode_attention(
            q[:, None], k_pool, v_pool, i, lens, scale=cfg.attn_scale,
            softcap=cfg.attn_logit_softcap, window=_layer_window(cfg, i))
        h = _residual_tail(cfg, lp, h, attn.reshape(b, -1), b)
    h = _norm(cfg, h, params["final_norm_w"])
    return _logits(cfg, params, h)


def decode_step_fn(cfg: TransformerConfig, params: dict, k_pool, v_pool,
                   token: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One single-stream decode step: the batch-rows step with B = 1 over
    one-slot pools ``[1, L, MAX, Hk*D]``, so it runs the same two serving
    kernels (route rule above). token [1], pos [1] int32 -> f32 logits [V]."""
    return batch_decode_step_fn(cfg, params, k_pool, v_pool, token, pos)[0]


def sample_logits(logits: torch.Tensor, temperature: float = 0.0, top_k: int = 0,
                  generator: torch.Generator | None = None,
                  top_p: float = 0.0) -> torch.Tensor:
    """Greedy argmax (first index on ties), or a tempered draw from
    ``generator``: top-k when ``top_k > 0``, else the top-p nucleus when
    ``0 < top_p < 1``, else the whole softmax (the reference's
    ``generate_stream`` order). logits [..., V] -> [...] int64."""
    if temperature <= 0.0:
        return sample_greedy_fn(logits)
    if top_k > 0:
        return sample_topk_fn(logits, generator, top_k, temperature)
    if 0.0 < top_p < 1.0:
        return sample_topp_fn(logits, generator, top_p, temperature)
    return sample_temperature_fn(logits, generator, temperature)


def batch_generate_scan_fn(cfg: TransformerConfig, n_steps: int,
                           temperature: float, top_k: int, params: dict,
                           k_pool, v_pool, tokens: torch.Tensor,
                           poss: torch.Tensor, generator=None,
                           on_logits=None) -> torch.Tensor:
    """``n_steps`` batch-rows decode steps; returns tokens [B, n_steps] on
    the device (no host sync). ``on_logits`` sees each step's logits."""
    out = []
    for _ in range(n_steps):
        logits = batch_decode_step_fn(cfg, params, k_pool, v_pool, tokens, poss)
        if on_logits is not None:
            on_logits(logits)
        tokens = sample_logits(logits, temperature, top_k, generator)
        out.append(tokens)
        poss = poss + 1
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def fuse_params(params: dict) -> dict:
    """Fuse per-layer q/k/v into ``w_qkv`` and gate/up into ``w_gate_up``
    along the out axis: dense leaves and int8/fp8 ``{"q","scale"}`` on the
    last dim (scales broadcast to ``[L, 1, N]``), packed int4 ``[L, N, K/2]``
    on the N axis (split-half packing is per out-column, so this is
    layout-exact), int4_block ``[L, K/2, N]`` and its ``[L, K/B, N]`` scales
    on the last axis; biases likewise."""
    layers = dict(params["layers"])

    def fusable(keys):
        if not all(k in layers for k in keys):
            return False
        leaves = [layers[k] for k in keys]
        if all(not isinstance(v, dict) for v in leaves):
            return True
        if all(isinstance(v, dict) and "q" in v for v in leaves):
            return len({v["q"].dtype for v in leaves}) == 1
        if all(isinstance(v, dict) and "scale_block" in v for v in leaves):
            return (len({v["q_packed"].shape[-2] for v in leaves}) == 1
                    and len({v["scale_block"].shape[-2] for v in leaves}) == 1)
        if all(isinstance(v, dict) and "q_packed" in v and "scale_block" not in v
               for v in leaves):
            return len({v["q_packed"].shape[-1] for v in leaves}) == 1
        return False

    def cat(keys):
        leaves = [layers.pop(k) for k in keys]
        if isinstance(leaves[0], dict) and "scale_block" in leaves[0]:
            return {"q_packed": torch.cat([v["q_packed"] for v in leaves], dim=-1),
                    "scale_block": torch.cat([v["scale_block"] for v in leaves], dim=-1)}
        if isinstance(leaves[0], dict) and "q_packed" in leaves[0]:
            return {"q_packed": torch.cat([v["q_packed"] for v in leaves], dim=-2),
                    "scale": torch.cat([v["scale"].to(_F32) for v in leaves], dim=-1)}
        if isinstance(leaves[0], dict):
            scales = [v["scale"].expand(*v["q"].shape[:-2], 1, v["q"].shape[-1]).to(_F32)
                      for v in leaves]
            return {"q": torch.cat([v["q"] for v in leaves], dim=-1),
                    "scale": torch.cat(scales, dim=-1)}
        return torch.cat(leaves, dim=-1)

    if fusable(("w_q", "w_k", "w_v")):
        layers["w_qkv"] = cat(("w_q", "w_k", "w_v"))
        if "b_q" in layers:
            layers["b_qkv"] = torch.cat(
                [layers.pop("b_q"), layers.pop("b_k"), layers.pop("b_v")], dim=-1)
    if fusable(("w_gate", "w_up")):
        layers["w_gate_up"] = cat(("w_gate", "w_up"))
    out = dict(params)
    out["layers"] = layers
    return out


def init_params(cfg: TransformerConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Random params (std 0.02, norms at one) in the reference's stacked
    layout (``_build_random_params``), drawn on ``device`` (the card unless
    the caller names one) from a ``torch.Generator`` seeded with ``seed``.
    Values differ from the reference's init (another generator); the layout
    is the same."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=device, dtype=_F32)
                * 0.02).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=_F32, device=device)

    nl, e, inter = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lp = {"w_q": w(nl, e, hq * d), "w_k": w(nl, e, hk * d),
          "w_v": w(nl, e, hk * d), "w_o": w(nl, hq * d, e),
          "attn_norm_w": ones(nl, e), "mlp_norm_w": ones(nl, e),
          "w_gate": w(nl, e, inter), "w_up": w(nl, e, inter),
          "w_down": w(nl, inter, e)}
    return {"embed": w(cfg.vocab_size, e), "final_norm_w": ones(e),
            "lm_head": None if cfg.tie_word_embeddings else w(e, cfg.vocab_size),
            "layers": lp}


def _bucket(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def slot_cache(pool, slot: int):
    """Slot ``slot``'s ``[L, MAX, Hk*D]`` view of a pool (dict-safe)."""
    if isinstance(pool, dict):
        return {"q": pool["q"][slot], "s": pool["s"][slot]}
    return pool[slot]


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class CausalTransformerModel(nn.Module):
    """Unified causal LM with a fixed KV cache. Stacked leaves are module
    buffers; ``params`` rebuilds the reference-shaped nested dict over them.
    The single-stream cache is a one-slot serving pool ``[1, L, MAX,
    Hk*D]``, so decode runs the serving kernels with B = 1."""

    def __init__(self, config: TransformerConfig, params: dict,
                 dtype: torch.dtype = torch.bfloat16, kv_dtype=None):
        super().__init__()
        check_supported(config)
        self.config = config
        self.dtype = dtype
        self.kv_dtype = resolve_dtype(kv_dtype) if kv_dtype is not None else dtype
        params = dict(params)
        _check_params(params)
        if config.use_rope and "rope_cos" not in params:
            params["rope_cos"], params["rope_sin"] = rope_tables(
                config.max_position_embeddings, config.head_dim,
                config.rope_theta, device=params["embed"].device)
        self._paths = []
        for path, t in _flatten(params):
            name = "__".join(path)
            self._paths.append((path, name if t is not None else None))
            if t is not None:
                self.register_buffer(name, t)
        self.max_seq_len: int | None = None
        self.k_pool = self.v_pool = None
        self.pos = 0
        self._nonfinite = None

    @property
    def params(self) -> dict:
        out: dict = {}
        for path, name in self._paths:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = None if name is None else getattr(self, name)
        return out

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init_fixed_cache(self, max_seq_len: int) -> None:
        """Zeroed one-slot pools of capacity ``max_seq_len``."""
        cfg = self.config
        shape = (1, cfg.num_layers, max_seq_len, cfg.num_kv_heads * cfg.head_dim)
        self.k_pool = kv_cache_zeros(shape, self.kv_dtype, device=self.device)
        self.v_pool = kv_cache_zeros(shape, self.kv_dtype, device=self.device)
        self.max_seq_len = max_seq_len
        self.pos = 0
        # set on the device by any non-finite logit since this cache was
        # made; read without a sync per step (logits_finite())
        self._nonfinite = torch.zeros((), dtype=torch.bool, device=self.device)

    def _note_logits(self, logits: torch.Tensor) -> None:
        self._nonfinite |= ~torch.isfinite(logits).all()

    def logits_finite(self) -> bool:
        """True when every logit since the last ``init_fixed_cache`` (or the
        cache ``generate`` made) was finite."""
        return self._nonfinite is None or not bool(self._nonfinite)

    @torch.no_grad()
    def forward(self, input_ids) -> torch.Tensor:
        """The uncached forward: token ids [S] -> f32 logits [S, V] on the
        model's device (``model(ids)``)."""
        ids = torch.as_tensor(np.asarray(input_ids, np.int64).reshape(-1))
        return forward_fn(self.config, self.params, ids.to(self.device))

    def get_logits(self, input_ids) -> np.ndarray:
        """``forward`` as a numpy f32 array [S, V]."""
        return self(input_ids).cpu().numpy().astype(np.float32, copy=False)

    @torch.no_grad()
    def prefill(self, input_ids) -> torch.Tensor:
        """Run the prompt through cached prefill; f32 logits [V] of its
        last position."""
        ids = torch.as_tensor(np.asarray(input_ids, np.int64).reshape(-1))
        n = ids.numel()
        if self.k_pool is None:
            self.init_fixed_cache(_bucket(max(n * 2, 256)))
        if n > self.max_seq_len:
            raise ValueError(f"prompt ({n}) exceeds cache ({self.max_seq_len})")
        bucket = min(_bucket(n), self.max_seq_len)
        padded = torch.zeros(bucket, dtype=torch.long)
        padded[:n] = ids
        logits = prefill_fn(self.config, self.params, slot_cache(self.k_pool, 0),
                            slot_cache(self.v_pool, 0), padded.to(self.device), n)
        self._note_logits(logits)
        self.pos = n
        return logits

    @torch.no_grad()
    def decode_step(self, token) -> torch.Tensor:
        """One cached decode step; f32 logits [V] for the next position."""
        tok = torch.as_tensor(token, device=self.device).reshape(1)
        poss = torch.tensor([self.pos], dtype=torch.int32, device=self.device)
        logits = decode_step_fn(self.config, self.params, self.k_pool,
                                self.v_pool, tok, poss)
        self._note_logits(logits)
        self.pos += 1
        return logits

    @torch.no_grad()
    def decode_chunk(self, token, n_steps: int, temperature: float = 0.0,
                     top_k: int = 0, generator=None) -> torch.Tensor:
        """``n_steps`` decode steps; the generated tokens [n_steps] stay on
        the device."""
        tok = torch.as_tensor(token, device=self.device).reshape(1)
        poss = torch.tensor([self.pos], dtype=torch.int32, device=self.device)
        toks = batch_generate_scan_fn(self.config, n_steps, temperature, top_k,
                                      self.params, self.k_pool, self.v_pool,
                                      tok, poss, generator, self._note_logits)
        self.pos += n_steps
        return toks[0]

    def _ensure_cache(self, n_ids: int, max_new_tokens: int) -> None:
        """A cache for the prompt and the new tokens, unless one exists."""
        if self.k_pool is None:
            self.init_fixed_cache(_bucket(max(n_ids + max_new_tokens + 1, 256)))

    def _sampler(self, temperature: float, seed: int):
        if temperature <= 0:
            return None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 eos_token_id: int | None = None, seed: int = 0,
                 use_cache: bool = True, chunk_size: int = 32) -> list[int]:
        """Greedy or temperature/top-k generation with one host read per
        ``chunk_size`` tokens; stops at ``eos_token_id`` (kept) or when the
        cache is full. Uncached generation and top-p sampling (temperature
        > 0, no top-k) take the per-token ``generate_stream``, as the
        reference routes them."""
        if not use_cache or (temperature > 0 and not (top_k > 0 or top_p == 0.0)):
            return list(self.generate_stream(input_ids, max_new_tokens, temperature,
                                             top_k, top_p, eos_token_id, seed,
                                             use_cache))
        ids = np.asarray(input_ids, np.int64).reshape(-1)
        self._ensure_cache(len(ids), max_new_tokens)
        gen = self._sampler(temperature, seed)
        logits = self.prefill(ids)
        out = [int(sample_logits(logits, temperature, top_k, gen))]
        while len(out) < max_new_tokens and out[-1] != eos_token_id:
            n = min(max_new_tokens - len(out), chunk_size,
                    self.max_seq_len - self.pos)
            if n <= 0:
                break
            toks = self.decode_chunk(out[-1], n, temperature, top_k, gen).tolist()
            if eos_token_id is not None and eos_token_id in toks:
                toks = toks[:toks.index(eos_token_id) + 1]
            out.extend(toks)
        return out[:max_new_tokens]

    @torch.no_grad()
    def generate_stream(self, input_ids, max_new_tokens: int = 32,
                        temperature: float = 0.0, top_k: int = 0,
                        top_p: float = 0.0, eos_token_id: int | None = None,
                        seed: int = 0, use_cache: bool = True) -> Iterator[int]:
        """One token at a time, each drawn from a generator seeded with
        ``seed``. Uncached: the forward over the growing id list, sampling
        its last row. Cached: prefill, then one decode step per token,
        stopping when the cache is full."""
        gen = self._sampler(temperature, seed)

        def sample(logits):
            return int(sample_logits(logits, temperature, top_k, gen, top_p))

        if not use_cache:
            ids = [int(t) for t in np.asarray(input_ids, np.int64).reshape(-1)]
            for _ in range(max_new_tokens):
                tok = sample(self(ids)[-1])
                yield tok
                ids.append(tok)
                if eos_token_id is not None and tok == eos_token_id:
                    return
            return
        self._ensure_cache(np.asarray(input_ids).size, max_new_tokens)
        logits = self.prefill(input_ids)
        for _ in range(max_new_tokens):
            tok = sample(logits)
            yield tok
            if eos_token_id is not None and tok == eos_token_id:
                return
            if self.pos >= self.max_seq_len:
                return
            logits = self.decode_step(tok)
