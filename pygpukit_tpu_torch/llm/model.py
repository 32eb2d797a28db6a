"""Unified causal LM: the serving slice of ``pygpukit_tpu/llm/model.py``.

Parameters keep the reference's stacked layout: every per-layer leaf is one
``[L, ...]`` tensor, and a layer is a free view ``leaf[i]``. PyTorch runs
eagerly, so the layer loop is a Python loop and a cache update is an
in-place write (the reference threads donated buffers through ``fori_loop``).

Route rule (the one place it is written down, with ``batch_decode_step_fn``).
Weight leaves by kind, rows = activation rows of the call:

- int4 ``{"q_packed" [N, K/2], "scale"}``, INT4_MODE=w4a8 (default), as
  the reference's TPU route takes a layer-sliced operand: the w4a8 GEMV
  kernel (``w4a8_matmul``) for rows <= 8, the bf16 dequant + matmul with
  no activation quant (``w4a16_matmul_plain``) for 9 <= rows < 256, the
  w4a8 GEMM kernel (``w4a8_matmul``) for rows >= 256; the head takes
  ``w4a8_matmul`` at every row count, as the reference's unsliced 2-D
  leaf does (the reference never quantizes the head to int4);
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
``PYGPUKIT_INT4_BLOCK``, ``PYGPUKIT_INT8_MODE``, ``PYGPUKIT_INT8_HEAD`` (an
int8 head's mode, ``PYGPUKIT_INT8_MODE``'s when unset) and
``PYGPUKIT_ACT_QUANT`` (w8a8's activation chain), read per call. The
head (``_logits`` passes ``out_dtype=torch.float32``) never takes a bf16
GEMV: an fp8 or w8a16 head is the plain convert + matmul with f32 logits,
as the reference's 2-D head always takes its XLA route. "dequant + matmul"
and "convert + matmul" are the kernels' plain versions with the output in
``out_dtype`` (the reference's XLA routes).

The batch-rows decode step (the serving engines) writes its rows and
attends through ``kernels.kv_write_attention``: on CUDA pools one
``batch_decode_attention`` launch that stores the rows first, on CPU pools
the plain row write, then the plain attention; a shape the kernel is not
built for takes the plain pair on the card too (``batch_attention_route``:
a head dim outside 64, 80, 96, 128 and 256, more than 16 query heads a kv
head), as the paged step does (``serving_paged.paged_attention_route``),
the uncached forward (``flash_attention_route``) and the single-stream step
(``fixed_cache_route``). The
single-stream step (``decode_step_fn``) runs over the model's fixed caches
``[L, MAX, Hk, D]`` and attends through ``ops.nn.sdpa_fixed_cache_fn``: on
CUDA tensors one query row over a bf16 or f32 cache (of a shape the kernel
is built for) launches
``kernels.flash_decode``, anything else takes the plain route (that
function's rule). Under ``PYGPUKIT_DECODE=fused`` (read per call) an
eligible model (``fused_decode_eligible``) with a bf16 cache runs the step
between the embedding and the head as one ``kernels.fused_decode`` launch,
or its plain version for CPU tensors. The single-stream position is a
host int or a one-element int32 device tensor, with the same bits; with
the tensor nothing is read on the host, so ``core.capture`` records the
step once (``CausalTransformerModel._ensure_decode_exe``) and a replay
serves every position. The model's entry points replay captured programs,
keyed as the reference compiles them, in one shared pool
(``CausalTransformerModel.graphs``): ``prefill`` one per bucket (the true
length a device tensor), ``decode_step`` one per route, ``decode_window``
one per T, ``decode_chunk_device`` one per (n_steps, temperature, top_k)
and ``decode_spec_chunk`` one per (n_rounds, gamma, n_draft). Their
logits and tokens are static outputs that the next replay overwrites; the
callers here consume them first. Cached prefill attends with the
plain f32 softmax (``_prefill_attn``). The uncached forward
(``forward_fn``, ``get_logits``, ``generate(use_cache=False)``) attends
through ``ops.nn.flash_attention_fn``: on CUDA tensors the
``kernels.flash_attention`` kernel at every length, bf16 or f32, unless the
layer has a softcap, a window or a non-default scale, which take the plain
route (as the reference sends them to XLA); its weight leaves follow the
rows > 8 routes above (the forward is M = S rows, as prefill is).

A MoE config (``num_experts > 1``) runs ``_moe_mlp`` in place of the MLP
in every path: the router as a full f32 product, then the formulation of
``ops.moe.select_moe_fn`` for the call's T rows at top-k: on CUDA tensors
``moe_gmm_fn`` (three ``kernels.gmm`` launches) from T * k >= 128, else
``moe_gather_fn`` up to T 4 and ``moe_dense_fn`` above; CPU tensors take
gather up to T 4 and dense above; ``PYGPUKIT_MOE=dense`` (read per call)
forces dense. So a prefill or forward of 64 tokens and more at top-2
launches the kernel, a single-stream decode step gathers and a batch-8
decode step takes the dense route.

The device picks only the implementation: the kernel for CUDA tensors, the
plain version for CPU tensors. The reference's size and regime gates
(``on_tpu``, minimum weight sizes, exact tiles, the XLA default of its fp8
GEMV, the MAX >= 1024 attention gate, the bf16-only S >= 8192
flash-attention gate, the fused kernel's VMEM and tile gates) work around
TPU compilers and are not ported: the port always computes what the TPU
kernels compute. The MoE route's 128-row minimum stays: the three
formulations round at different points, so the rule decides the bits.
"""

from __future__ import annotations

import functools
import math
import os
from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..core.backend import resolve_device
from ..core.executable import Executable, ExecutableCache
from ..core.host import tensor_from_numpy, tensor_to_numpy
from ..core.numerics import require_full_f32, true_div
from ..kernels import (batch_decode_attention_plain, block_w4a8_matmul,
                       block_w4a16_matmul, block_w4a16_matmul_plain, conv_matmul,
                       conv_matmul_plain, kv_rows_write_plain, kv_write_attention,
                       w4a8_matmul, w4a16_matmul, w4a16_matmul_plain)
from ..kernels.batch_decode_attention import supports as batch_attention_supports
from ..kernels.fused_decode import fused_decode
from ..kernels.fused_decode import supports as fused_decode_supports
from ..kernels.gemv_quant import GEMV_MAX_ROWS
from ..ops.embedding import kv_cache_zeros, kv_leaf, kv_write
from ..ops.matmul import int8_dot
from ..ops.moe import select_moe_fn
from ..ops.nn import (apply_rope_fn, apply_rope_interleaved_fn, flash_attention_fn,
                      gelu_fn, layernorm_fn, rmsnorm_fn, rope_tables, rope_tables_linear,
                      rope_tables_llama3, rope_tables_longrope, rope_tables_ntk_aware,
                      rope_tables_yarn, sdpa_fixed_cache_fn, swiglu_fn)
from ..ops.sampling import (sample_greedy_fn, sample_temperature_fn,
                            sample_topk_fn, sample_topp_fn)
from .buffers import DecodeBuffers, PrefillBuffers
from .config import ModelSpec, TransformerConfig

_F32 = torch.float32
_NEG_INF = -1e30
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
#: int4 layer operands take the w4a8 GEMM from this many rows (below it,
#: from 9 rows, the dequant matmul), as the reference's TPU route does
W4A8_GEMM_MIN_ROWS = 256


#: the KV-cache storage names ``resolve_kv_dtype`` accepts (the reference's)
KV_DTYPES = {"fp8": torch.float8_e4m3fn, "fp8_e4m3": torch.float8_e4m3fn,
             "e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2,
             "e5m2": torch.float8_e5m2, "int8": torch.int8, "bf16": torch.bfloat16,
             "bfloat16": torch.bfloat16, "f32": _F32, "float32": _F32}


def resolve_kv_dtype(kv_dtype, model_dtype: torch.dtype) -> torch.dtype:
    """The KV-cache storage dtype (reference ``resolve_kv_dtype``): the
    argument, else ``PYGPUKIT_KV_DTYPE`` (read per call; empty means unset),
    else the model dtype. A name must be one of ``KV_DTYPES`` (ValueError
    otherwise); a torch dtype is taken as it is."""
    if kv_dtype is None:
        kv_dtype = os.environ.get("PYGPUKIT_KV_DTYPE", "") or None
    if kv_dtype is None:
        return model_dtype
    if isinstance(kv_dtype, str):
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}; one of {sorted(KV_DTYPES)}")
        return KV_DTYPES[kv_dtype]
    return kv_dtype


def check_supported(cfg: TransformerConfig) -> None:
    """Raise NotImplementedError for architecture features this slice has
    not ported, instead of computing something else silently: the one place
    for such refusals. Every block form, norm, activation and head
    convention that ``TransformerConfig`` can express is ported: the
    Llama/Mistral/Mixtral block, Qwen2 (biases), Qwen3 and Qwen3-MoE
    (per-head q/k norm), GPT-2 (layernorm, learned positions, gelu),
    Gemma-2/3 (sandwich norms, embedding scale, softcaps, local rope tables,
    GeGLU), every rope variant (scaled tables, interleaved and partial
    rotary, NoPE layers), OLMo-2 (post-norm-only blocks, whole-width q/k
    norms), Cohere and Phi (parallel blocks, logit scale, lm-head bias),
    Granite (residual multiplier), Nemotron (relu2) and Apertus (xIELU).
    So it refuses only an activation name outside the config's own set."""
    if cfg.activation not in ("silu", "gelu", "gelu_tanh", "relu2", "xielu"):
        raise NotImplementedError(f"not ported yet: activation {cfg.activation!r}")


#: the MoE expert stacks [L, E, in, out]: bf16 or f32 tensors, or
#: {"q", "scale"} fp8/int8 dicts
_EXPERT_LEAVES = {"w_experts_gate", "w_experts_up", "w_experts_down"}
#: the leaves the slice takes (``attn_window``, ``use_local_rope`` and
#: ``use_rope_layer`` hold what the config states, which the steps read;
#: ``act_*`` are Apertus's learned xIELU parameters, [L, 1] each); a param
#: tree with others is refused rather than partly ignored
_LAYER_LEAVES = {"w_qkv", "w_q", "w_k", "w_v", "w_o", "w_gate_up", "w_gate",
                 "w_up", "w_down", "attn_norm_w", "mlp_norm_w", "attn_window",
                 "w_qkv_cat", "w_gu_cat", "w_router",
                 "b_q", "b_k", "b_v", "b_qkv", "b_o", "w_q_norm", "w_k_norm",
                 "post_attn_norm_w", "post_mlp_norm_w", "attn_norm_b", "mlp_norm_b",
                 "w_fc1", "w_fc2", "b_fc1", "b_fc2", "use_local_rope",
                 "use_rope_layer", "act_alpha_p", "act_alpha_n", "act_beta",
                 "act_eps"} | _EXPERT_LEAVES
_TOP_LEAVES = {"embed", "final_norm_w", "lm_head", "lm_head_b", "layers", "rope_cos",
               "rope_sin", "pos_embed", "final_norm_b", "rope_cos_local",
               "rope_sin_local", "rope_cos_long", "rope_sin_long", "rope_long_threshold"}


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
    for name in _EXPERT_LEAVES & set(params["layers"]):
        leaf = params["layers"][name]
        quantized = isinstance(leaf, dict) and set(leaf) == {"q", "scale"}
        q = leaf["q"] if quantized else leaf
        if (not isinstance(q, torch.Tensor) or q.dim() != 4
                or not (quantized or q.dtype in (torch.bfloat16, _F32))):
            raise NotImplementedError(f"expert stack {name} must be a bf16 or f32 [L, E, in, "
                                      "out] tensor or an fp8/int8 {q, scale} dict")


# ---------------------------------------------------------------------------
# Matmul routing
# ---------------------------------------------------------------------------

def _w8a8(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-row int8 activation quant, int8 dot, f32 epilogue
    ``(acc * sx) * scale`` (the reference's TPU w8a8 route). Under
    ``PYGPUKIT_ACT_QUANT=bf16`` (read per call; ``f32`` the default) the
    reference's experimental lean chain: the row quantized in bf16 against
    126 / amax (a bf16 quotient and bf16 products), ``sx = amax * (1 /
    126)``, epilogue ``acc * (sx * scale)``."""
    x2 = x.reshape(-1, x.shape[-1])
    if _switch("PYGPUKIT_ACT_QUANT") == "bf16":
        xb = x2.to(torch.bfloat16)
        amax = torch.clamp_min(torch.amax(torch.abs(xb), dim=-1, keepdim=True),
                               torch.tensor(1e-8, dtype=torch.bfloat16).item())
        inv = torch.full_like(amax, 126.0) / amax
        xi = torch.round(xb * inv).to(torch.int8)
        sx = amax.to(_F32) * (1.0 / 126.0)
        y = int8_dot(xi, q).to(_F32) * (sx * scale.to(_F32))
        return y.reshape(*x.shape[:-1], q.shape[-1])
    amax = torch.amax(torch.abs(x2), dim=-1, keepdim=True).to(_F32)
    sx = torch.clamp_min(true_div(amax, 127.0), 1e-12)
    xi = torch.round(x2.to(_F32) / sx).to(torch.int8)
    y = (int8_dot(xi, q).to(_F32) * sx) * scale.to(_F32)
    return y.reshape(*x.shape[:-1], q.shape[-1])


#: the route switches: environment variable -> (default, choices); a None
#: default means unset (``PYGPUKIT_INT8_HEAD``: the head follows
#: ``PYGPUKIT_INT8_MODE``)
SWITCHES = {"PYGPUKIT_INT4_MODE": ("w4a8", ("w4a8", "w4a16")),
            "PYGPUKIT_INT4_BLOCK": ("w4a8", ("w4a8", "w4a16")),
            "PYGPUKIT_INT8_MODE": ("w8a8", ("w8a8", "w8a16")),
            "PYGPUKIT_INT8_HEAD": (None, ("w8a8", "w8a16")),
            "PYGPUKIT_ACT_QUANT": ("f32", ("f32", "bf16"))}


def _switch(name: str) -> str | None:
    default, choices = SWITCHES[name]
    value = os.environ.get(name) or default
    if value is not None and value not in choices:
        raise ValueError(f"{name}={value!r}; one of {choices}")
    return value


def _mm(x: torch.Tensor, w, out_dtype: torch.dtype | None = None,
        int8_mode: str | None = None) -> torch.Tensor:
    """Matmul against a weight leaf (see the route rule above); x [..., K].
    ``out_dtype`` defaults to x's; an explicit f32 marks the head.
    ``int8_mode`` ("w8a8"/"w8a16") overrides ``PYGPUKIT_INT8_MODE`` for an
    int8 leaf (``_logits`` passes ``PYGPUKIT_INT8_HEAD``)."""
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
            if head or gemv or x2.shape[0] >= W4A8_GEMM_MIN_ROWS:
                y = w4a8_matmul(x2, w["q_packed"], w["scale"])
            else:
                y = w4a16_matmul_plain(x2, w["q_packed"], w["scale"], out_dtype)
        elif gemv:
            y = w4a16_matmul(x2, w["q_packed"], w["scale"])
        else:
            y = w4a16_matmul_plain(x2, w["q_packed"], w["scale"], out_dtype)
    elif w["q"].dtype == torch.int8 and (int8_mode or _switch("PYGPUKIT_INT8_MODE")) == "w8a8":
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


def _table_rows(table: torch.Tensor, pos, t: int) -> torch.Tensor:
    """Rows pos..pos+t-1 of a position table, the start clamped to [0, n -
    t] (the clamps of ``lax.dynamic_slice`` in the reference: a free slot
    decoding past the table stays in range). ``pos`` an int: a slice; a [B]
    tensor (the batch-rows step's positions at t = 1, or the single-stream
    device position [1]): gathered on the device, [B * t] rows."""
    n = table.shape[0]
    if isinstance(pos, torch.Tensor):
        start = torch.clamp(pos.reshape(-1).to(torch.long), 0, n - t)
        rows = (start[:, None] + torch.arange(t, device=pos.device)).reshape(-1)
        return table[rows]
    start = min(max(int(pos), 0), n - t)
    return table[start:start + t]


def _take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)`` with its default fill mode: indices
    in [-n, 0) count from the end, rows of indices outside [-n, n) are NaN
    (the reference's learned positions in the batch-rows step)."""
    n = table.shape[0]
    i = idx.reshape(-1).to(torch.long)
    i = torch.where(i < 0, i + n, i)
    ok = (i >= 0) & (i < n)
    rows = table[torch.clamp(i, 0, n - 1)]
    return torch.where(ok[:, None], rows, torch.full_like(rows, float("nan")))


def rope_tables_for(cfg: TransformerConfig, device) -> dict:
    """The model's rope leaves (reference ``CausalTransformerModel.__init__``),
    [max_position_embeddings, rope_dim] f32 on ``device``: ``rope_cos`` /
    ``rope_sin`` from ``rope_scaling``'s type (yarn, llama3, longrope's
    short factors, linear, ntk or dynamic, else standard); for longrope
    with max_position_embeddings past original_max, the long factors'
    ``rope_cos_long`` / ``rope_sin_long`` and ``rope_long_threshold`` (the
    original_max, an int32 scalar); for Gemma-3 the unscaled local tables
    ``rope_cos_local`` / ``rope_sin_local``. Partial rotary builds them at
    ``rope_dim``."""
    scaling = cfg.rope_scaling or {}
    st = scaling.get("type", scaling.get("rope_type", ""))
    n, d, theta = cfg.max_position_embeddings, cfg.rope_dim, cfg.rope_theta
    out: dict = {}
    if st == "yarn":
        cos, sin = rope_tables_yarn(
            n, d, theta, scaling.get("factor", 1.0),
            scaling.get("original_max_position_embeddings", n),
            beta_fast=scaling.get("beta_fast") or 32.0,
            beta_slow=scaling.get("beta_slow") or 1.0, mscale=scaling.get("mscale"),
            mscale_all_dim=scaling.get("mscale_all_dim"),
            attention_factor=scaling.get("attention_factor"),
            truncate=scaling.get("truncate", True), device=device)
    elif st == "llama3":
        cos, sin = rope_tables_llama3(
            n, d, theta, scaling.get("factor", 8.0),
            scaling.get("original_max_position_embeddings", 8192),
            scaling.get("low_freq_factor", 1.0), scaling.get("high_freq_factor", 4.0),
            device=device)
    elif st == "longrope":
        # HF switches the factor set per forward by its total length
        # against original_max: both pairs, and the threshold, are leaves
        orig = int(scaling.get("original_max_position_embeddings", n))
        factor = n / orig
        attn_f = scaling.get("attention_factor")
        if attn_f is None:
            attn_f = (1.0 if factor <= 1.0 else
                      math.sqrt(1 + math.log(factor) / math.log(orig)))
        cos, sin = rope_tables_longrope(n, d, theta,
                                        scaling.get("short_factor", [1.0] * (d // 2)),
                                        attn_f, device=device)
        if n > orig and "long_factor" in scaling:
            out["rope_cos_long"], out["rope_sin_long"] = rope_tables_longrope(
                n, d, theta, scaling["long_factor"], attn_f, device=device)
            out["rope_long_threshold"] = torch.tensor(orig, dtype=torch.int32,
                                                      device=device)
    elif st == "linear":
        cos, sin = rope_tables_linear(n, d, theta, scaling.get("factor", 1.0), device=device)
    elif st in ("ntk", "dynamic"):
        cos, sin = rope_tables_ntk_aware(n, d, theta, scaling.get("factor", 1.0),
                                         device=device)
    else:
        cos, sin = rope_tables(n, d, theta, device=device)
    out["rope_cos"], out["rope_sin"] = cos, sin
    if cfg.rope_local_theta is not None:
        out["rope_cos_local"], out["rope_sin_local"] = rope_tables(
            n, d, cfg.rope_local_theta, device=device)
    return out


@dataclass
class _RopeRows:
    """The rope rows of a step: the global tables' and, for a model with
    local tables (Gemma-3), the local ones (None otherwise)."""
    cos: torch.Tensor
    sin: torch.Tensor
    cos_local: torch.Tensor | None = None
    sin_local: torch.Tensor | None = None


def _long_select(params: dict, rows: torch.Tensor, name: str, pos, t: int,
                 total_len) -> torch.Tensor:
    """LongRoPE's switch: ``name``'s rows where ``total_len`` (an int, or a
    device tensor of one length or of one per row) passes the threshold,
    ``rows`` elsewhere. A device-side select: no host read, so one captured
    program serves both regimes."""
    use_long = params["rope_long_threshold"] < total_len
    return torch.where(use_long.reshape(-1, 1), _table_rows(params[name], pos, t), rows)


def _rope_rows_for(params: dict, pos, t: int, total_len) -> _RopeRows:
    """Rope rows pos..pos+t-1 of every table (``_table_rows``' clamps) for a
    forward whose total length is ``total_len`` (reference
    ``_rope_rows_for``): a LongRoPE model (Phi-3) takes its long tables'
    rows where that length exceeds ``rope_long_threshold``, HF's per-forward
    switch; for the batch-rows steps ``pos`` and ``total_len`` are [B]
    tensors and each row decides alone."""
    local = "rope_cos_local" in params
    cos = _table_rows(params["rope_cos"], pos, t)
    sin = _table_rows(params["rope_sin"], pos, t)
    if "rope_cos_long" in params:
        cos = _long_select(params, cos, "rope_cos_long", pos, t, total_len)
        sin = _long_select(params, sin, "rope_sin_long", pos, t, total_len)
    return _RopeRows(
        cos, sin,
        _table_rows(params["rope_cos_local"], pos, t) if local else None,
        _table_rows(params["rope_sin_local"], pos, t) if local else None)


def _layer_rope(cfg: TransformerConfig, i: int, rows: _RopeRows):
    """(cos, sin) of layer ``i`` (reference ``_layer_rope``): Gemma-3's
    sliding layers rotate with the local tables, SmolLM3's NoPE layers
    with identity tables (cos 1, sin 0: a rotation by zero). Both choices
    are the config's (``layer_types`` and ``rope_layers``, as the
    ``use_local_rope`` and ``use_rope_layer`` leaves hold them), made on the
    host, as ``_layer_window`` makes the window's."""
    if cfg.rope_layers is not None and not cfg.rope_layers[i]:
        return torch.ones_like(rows.cos), torch.zeros_like(rows.sin)
    if (rows.cos_local is not None and cfg.layer_types is not None
            and cfg.layer_types[i] == "sliding_attention"):
        return rows.cos_local, rows.sin_local
    return rows.cos, rows.sin


def _norm(cfg: TransformerConfig, x, w, b=None):
    if cfg.norm_type == "rmsnorm":
        return rmsnorm_fn(x, w, cfg.norm_eps)
    return layernorm_fn(x, w, b, cfg.norm_eps)


def _attn_in(cfg: TransformerConfig, lp: dict, h):
    """The attention sublayer's input: the pre-norm of the residual stream,
    or the raw stream where the blocks have no input norms (OLMo-2)."""
    if not cfg.pre_norms:
        return h
    return _norm(cfg, h, lp["attn_norm_w"], lp.get("attn_norm_b"))


def _final_norm(cfg: TransformerConfig, params: dict, h):
    return _norm(cfg, h, params["final_norm_w"], params.get("final_norm_b"))


def _rope(cfg: TransformerConfig, x, cos, sin):
    """Rope in the model's convention (reference ``_rope``): split-half, or
    interleaved even/odd pairs (GLM-4, Ernie 4.5); with partial rotary
    (GLM-4) only the first ``rope_dim`` dims rotate and the tail passes
    through (the tables are [S, rope_dim])."""
    rd = cfg.rope_dim
    x_rot = x if rd == x.shape[-1] else x[..., :rd]
    fn = apply_rope_interleaved_fn if cfg.rope_interleaved else apply_rope_fn
    out = fn(x_rot, cos, sin)
    if rd != x.shape[-1]:
        out = torch.cat([out, x[..., rd:]], dim=-1)
    return out


def _rope_qk(cfg: TransformerConfig, i: int, rows: _RopeRows | None, q, k):
    """q and k rotated with layer ``i``'s tables (unchanged without rope)."""
    if rows is None:
        return q, k
    c, sn = _layer_rope(cfg, i, rows)
    return _rope(cfg, q, c, sn), _rope(cfg, k, c, sn)


def _qk_headnorm(x, w, eps: float, subtract_mean: bool = False):
    """Norm over the last dim in f32: per head over head_dim (Qwen3's
    q_norm/k_norm, w [D]; Cohere's per-head weights [H, D]), or over the
    whole projection width (OLMo-2, w [H*D]); RMS, or mean-centred first
    where ``subtract_mean`` (Cohere's flavour)."""
    xf = x.to(_F32)
    if subtract_mean:
        xf = xf - torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(_F32)).to(x.dtype)


def _project_qkv(cfg: TransformerConfig, lp: dict, x):
    """x [S, E] -> q [S, Hq, D], k and v [S, Hk, D] in x's dtype: the fused
    or separate projections, their biases added in f32, then the q/k norms:
    OLMo-2's over the whole ``Hq*D`` / ``Hk*D`` width before the head
    reshape (the mean runs across the heads), the others per head."""
    s = x.shape[0]
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "w_qkv" in lp:
        qkv = _mm(x, lp["w_qkv"]).to(_F32)
        q, k, v = qkv[:, :hq * d], qkv[:, hq * d:(hq + hk) * d], qkv[:, (hq + hk) * d:]
    else:
        q, k, v = (_mm(x, lp[n]).to(_F32) for n in ("w_q", "w_k", "w_v"))
    if "b_qkv" in lp:
        b = lp["b_qkv"].to(_F32)
        q, k, v = q + b[:hq * d], k + b[hq * d:(hq + hk) * d], v + b[(hq + hk) * d:]
    elif "b_q" in lp:
        q, k, v = (t + lp[n].to(_F32) for t, n in ((q, "b_q"), (k, "b_k"), (v, "b_v")))
    wide = cfg.use_qk_norm and cfg.qk_norm_wide
    if wide:
        q = _qk_headnorm(q.to(x.dtype), lp["w_q_norm"], cfg.norm_eps)
        k = _qk_headnorm(k.to(x.dtype), lp["w_k_norm"], cfg.norm_eps)
    q, k, v = (q.to(x.dtype).reshape(s, hq, d), k.to(x.dtype).reshape(s, hk, d),
               v.to(x.dtype).reshape(s, hk, d))
    if cfg.use_qk_norm and not wide:
        sm = cfg.norm_type == "layernorm"
        q = _qk_headnorm(q, lp["w_q_norm"], cfg.norm_eps, subtract_mean=sm)
        k = _qk_headnorm(k, lp["w_k_norm"], cfg.norm_eps, subtract_mean=sm)
    return q, k, v


def _out_proj(lp: dict, attn, s: int, dtype):
    o = _mm(attn.reshape(s, -1), lp["w_o"])
    if "b_o" in lp:
        o = o.to(_F32) + lp["b_o"].to(_F32)
    return o.to(dtype)


def _moe_mlp(cfg: TransformerConfig, lp: dict, y):
    """Top-k routed expert MLP (reference ``_moe_mlp``): the router logits
    as a full-precision f32 product, then the formulation
    ``ops.moe.select_moe_fn`` picks for y's rows and device."""
    require_full_f32(y, "the MoE router")
    router = torch.matmul(y.to(_F32), lp["w_router"].to(_F32))         # [T, E]
    k = cfg.num_experts_per_tok
    fn = select_moe_fn(y.shape[0], k, y.device.type)
    out = fn(y, lp["w_experts_gate"], lp["w_experts_up"], lp["w_experts_down"], router, k)
    return out.to(y.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` in x's dtype, its order of
    operations: x * 0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715 x^3)))."""
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x ** 3))))
    return x * cdf


def _xielu(lp: dict, h: torch.Tensor) -> torch.Tensor:
    """Apertus's xIELU on f32 ``h`` with the layer's learned ``act_*``
    leaves, in the reference's order: alpha_p = softplus(a_p), alpha_n =
    beta + softplus(a_n); ``alpha_p h^2 + beta h`` where h > 0, else
    ``(expm1(min(h, eps)) - h) alpha_n + beta h``."""
    ap = nn.functional.softplus(lp["act_alpha_p"].to(_F32))
    beta = lp["act_beta"].to(_F32)
    an = beta + nn.functional.softplus(lp["act_alpha_n"].to(_F32))
    eps = lp["act_eps"].to(_F32)
    return torch.where(h > 0, ap * h * h + beta * h,
                       (torch.expm1(torch.minimum(h, eps)) - h) * an + beta * h)


def _mlp(cfg: TransformerConfig, lp: dict, y):
    """The gated MLP (SwiGLU, or Gemma's GeGLU with the tanh gelu on the
    gate in f32), or the gateless fc1 -> activation -> fc2 with f32 biases:
    gelu (GPT-2, Phi), relu^2 in f32 (Nemotron) or xIELU in f32
    (Apertus)."""
    if cfg.is_moe:
        return _moe_mlp(cfg, lp, y)
    if "w_gate_up" in lp or "w_gate" in lp:
        if "w_gate_up" in lp:
            gate, up = torch.chunk(_mm(y, lp["w_gate_up"]), 2, dim=-1)
        else:
            gate, up = _mm(y, lp["w_gate"]), _mm(y, lp["w_up"])
        if cfg.activation == "gelu_tanh":
            act = (_gelu_tanh(gate.to(_F32)) * up.to(_F32)).to(y.dtype)
        else:
            act = swiglu_fn(gate, up)
        return _mm(act, lp["w_down"])
    h = _mm(y, lp["w_fc1"]).to(_F32)
    if "b_fc1" in lp:
        h = h + lp["b_fc1"].to(_F32)
    if cfg.activation == "relu2":
        h = torch.square(torch.relu(h)).to(y.dtype)
    elif cfg.activation == "xielu":
        h = _xielu(lp, h).to(y.dtype)
    else:
        h = gelu_fn(h.to(y.dtype))
    out = _mm(h, lp["w_fc2"]).to(_F32)
    if "b_fc2" in lp:
        out = out + lp["b_fc2"].to(_F32)
    return out.to(y.dtype)


def _residual_tail(cfg: TransformerConfig, lp: dict, h, attn, s: int, x):
    """Out-projection + residual, then the MLP sublayer + residual, with the
    sandwich norms on the sublayer outputs (``use_post_norms``: Gemma,
    GLM-4, OLMo-2). ``x`` is the attention's input (``_attn_in``): a
    parallel block (Cohere, Phi) runs its MLP off it too, ``h + o +
    mlp(x)``. Granite's ``residual_multiplier`` rm scales the sublayers as
    the reference does: ``h + rm * (o + m)`` in a parallel block, ``h + rm
    * o`` then ``h + rm * m`` in a sequential one. Without input norms
    (OLMo-2) the MLP reads the raw stream."""
    o = _out_proj(lp, attn, s, h.dtype)
    rm = cfg.residual_multiplier
    if cfg.parallel_block:
        m = _mlp(cfg, lp, x)
        return h + o + m if rm is None else h + rm * (o + m)
    if cfg.use_post_norms:
        o = _norm(cfg, o, lp["post_attn_norm_w"])
    h = h + o if rm is None else h + rm * o
    y = _norm(cfg, h, lp["mlp_norm_w"], lp.get("mlp_norm_b")) if cfg.pre_norms else h
    m = _mlp(cfg, lp, y)
    if cfg.use_post_norms:
        m = _norm(cfg, m, lp["post_mlp_norm_w"])
    return h + m if rm is None else h + rm * m


def _embed_tokens(cfg: TransformerConfig, params: dict, tokens):
    """Embedding rows, times ``embed_scale`` (Gemma) rounded to the
    activation dtype first, as HF casts the normalizer before the
    multiply."""
    h = params["embed"][tokens.to(torch.long)]
    if cfg.embed_scale is not None:
        h = h * torch.tensor(cfg.embed_scale, dtype=h.dtype).item()
    return h


def _logits(cfg: TransformerConfig, params: dict, h):
    """f32 logits of the final rows h: the head (quantized, dense or the
    tied embedding), then the reference's order of the head conventions:
    the lm-head bias in f32, the logit scale, the final softcap."""
    head = params.get("lm_head")
    if isinstance(head, dict):
        logits = _mm(h, head, out_dtype=_F32, int8_mode=_switch("PYGPUKIT_INT8_HEAD"))
    elif head is not None:
        logits = torch.matmul(h.to(_F32), head.to(_F32))
    else:                                   # tied embeddings
        logits = torch.matmul(h.to(_F32), params["embed"].to(_F32).t())
    if params.get("lm_head_b") is not None:  # Phi's biased head
        logits = logits + params["lm_head_b"].to(_F32)
    if cfg.logit_scale is not None:         # Cohere's scale, Granite's 1/logits_scaling
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits * (1.0 / cap))
    return logits


def _num_layers(layers: dict) -> int:
    """The depth of a stacked layer tree: its out-projection's leading dim
    (every block has one, with or without input norms; quantized or not)."""
    w = layers["w_o"]
    if isinstance(w, dict):
        w = w.get("q", w.get("q_packed"))
    return w.shape[0]


def _layer_window(cfg: TransformerConfig, i: int) -> int | None:
    wins = cfg.layer_windows()
    return None if wins is None or wins[i] <= 0 else wins[i]


# ---------------------------------------------------------------------------
# Forward (no cache)
# ---------------------------------------------------------------------------

def layer_stack_fn(cfg: TransformerConfig, layers: dict, h: torch.Tensor,
                   rope_cos, rope_sin, rope_cos_local=None,
                   rope_sin_local=None) -> torch.Tensor:
    """Run h [S, E] through the stacked layers (a Python loop over the layer
    views); attention through ``flash_attention_fn`` (route rule above).
    The tables' first S rows rotate positions 0..S-1 (``forward_fn`` passes
    LongRoPE's rows already chosen); the local tables (Gemma-3) rotate the
    sliding layers."""
    s = h.shape[0]
    rows = None
    if cfg.use_rope:
        rows = _RopeRows(rope_cos[:s], rope_sin[:s],
                         None if rope_cos_local is None else rope_cos_local[:s],
                         None if rope_sin_local is None else rope_sin_local[:s])
    for i in range(_num_layers(layers)):
        lp = _slice_layer_params(layers, i)
        x = _attn_in(cfg, lp, h)
        q, k, v = _project_qkv(cfg, lp, x)
        q, k = _rope_qk(cfg, i, rows, q, k)
        attn = flash_attention_fn(q, k, v, scale=cfg.attn_scale,
                                  softcap=cfg.attn_logit_softcap,
                                  window=_layer_window(cfg, i))
        h = _residual_tail(cfg, lp, h, attn, s, x)
    return h


def forward_fn(cfg: TransformerConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [S] -> f32 logits [S, V], every position, no cache."""
    h = _embed_tokens(cfg, params, tokens)
    if cfg.use_position_embed:
        h = h + params["pos_embed"][:tokens.shape[0]]
    rc, rs = params.get("rope_cos"), params.get("rope_sin")
    if cfg.use_rope and "rope_cos_long" in params:
        rows = _rope_rows_for(params, 0, tokens.shape[0], tokens.shape[0])
        rc, rs = rows.cos, rows.sin
    h = layer_stack_fn(cfg, params["layers"], h, rc, rs, params.get("rope_cos_local"),
                       params.get("rope_sin_local"))
    return _logits(cfg, params, _final_norm(cfg, params, h))


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

#: the f32 scores one pass of ``_prefill_attn`` may hold: past it the heads
#: go in groups (Phi-3.5's 32 heads at a bucket of 8192 rows: 8.6 GB, four
#: heads a pass)
PREFILL_SCORE_BYTES = 1 << 30


def _prefill_attn(q, k, v, true_len, scale=None, softcap=None, window=None):
    """Causal attention within the padded prompt, f32; positions >= true_len
    (an int or a one-element device tensor) are masked out. The [heads, S,
    S] scores are scaled, capped and masked in place, for as many heads at
    a time as ``PREFILL_SCORE_BYTES`` holds."""
    s, hq, d = q.shape
    hk = k.shape[1]
    if hk != hq:
        k = k.repeat_interleave(hq // hk, dim=1)
        v = v.repeat_interleave(hq // hk, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qh, kh, vh = (t.transpose(0, 1).to(_F32) for t in (q, k, v))
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = (j > i) | (j >= true_len)
    if window is not None:
        mask = mask | (j <= i - window)
    step = max(1, PREFILL_SCORE_BYTES // (s * s * 4))
    outs = []
    for h0 in range(0, hq, step):
        scores = torch.matmul(qh[h0:h0 + step], kh[h0:h0 + step].transpose(1, 2)).mul_(scale)
        if softcap is not None:
            scores.mul_(1.0 / softcap).tanh_().mul_(softcap)
        scores.masked_fill_(mask, _NEG_INF)
        outs.append(torch.matmul(torch.softmax(scores, dim=-1), vh[h0:h0 + step]))
        del scores
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.transpose(0, 1).to(q.dtype)


def _last_row(h: torch.Tensor, true_len) -> torch.Tensor:
    """Row ``true_len - 1`` of ``h``: indexed for an int, gathered for a
    one-element device tensor (no host read), the same bits."""
    if isinstance(true_len, torch.Tensor):
        return h.index_select(0, true_len.reshape(1).to(torch.long) - 1)[0]
    return h[true_len - 1]


def prefill_fn(cfg: TransformerConfig, params: dict, k_cache, v_cache,
               tokens: torch.Tensor, true_len, slot=None) -> torch.Tensor:
    """Prefill padded ``tokens`` [S]; write rows [0, S) of every layer of the
    slot caches ``[L, MAX, Hk*D]`` (or int8 dicts) in place; return the f32
    logits [V] of position ``true_len - 1``. ``true_len`` is an int or a
    one-element int32 tensor on the device (the mask broadcasts, the last
    row is gathered: the int path's bits, no host read). With ``slot``, a
    one-element integer device tensor, the caches are the pools ``[B, L,
    MAX, Hk*D]`` and the rows land in that slot by an index copy."""
    s = tokens.shape[0]
    h = _embed_tokens(cfg, params, tokens)
    if cfg.use_position_embed:
        h = h + params["pos_embed"][:s]
    rows = _rope_rows_for(params, 0, s, true_len) if cfg.use_rope else None
    for i in range(kv_leaf(k_cache).shape[0 if slot is None else 1]):
        lp = _slice_layer_params(params["layers"], i)
        x = _attn_in(cfg, lp, h)
        q, k, v = _project_qkv(cfg, lp, x)
        q, k = _rope_qk(cfg, i, rows, q, k)
        if slot is None:
            kv_write(k_cache, k.reshape(1, s, -1), (i, 0, 0))
            kv_write(v_cache, v.reshape(1, s, -1), (i, 0, 0))
        else:
            kv_write(k_cache, k.reshape(1, 1, s, -1), (slot, i, 0, 0))
            kv_write(v_cache, v.reshape(1, 1, s, -1), (slot, i, 0, 0))
        attn = _prefill_attn(q, k, v, true_len, cfg.attn_scale,
                             cfg.attn_logit_softcap, _layer_window(cfg, i))
        h = _residual_tail(cfg, lp, h, attn, s, x)
    return _logits(cfg, params, _last_row(_final_norm(cfg, params, h), true_len))


def batch_attention_route(device_type: str, hq: int, hk: int, d: int) -> str:
    """"kernel" or "plain": the batch-rows step's write and attention for
    pools on a ``device_type`` device, by the shape alone: CUDA pools of a
    shape the kernel is built for (``kernels.batch_decode_attention.
    supports``) take ``kv_write_attention``'s one launch; other shapes, and
    CPU pools, the plain row write and attention (the reference takes its
    XLA formulation where its kernel is not eligible)."""
    if device_type == "cuda" and batch_attention_supports(hq, hk, d):
        return "kernel"
    return "plain"


def _write_attend(q, k_pool, v_pool, k, v, layer: int, poss, lens, scale, softcap,
                  window):
    """Write k/v [B, Hk, D] at ``poss`` into layer ``layer`` of the pools and
    attend q [B, 1, Hq, D] over ``lens`` (route: ``batch_attention_route``)."""
    if batch_attention_route(kv_leaf(k_pool).device.type, q.shape[2], k.shape[1],
                             q.shape[3]) == "kernel":
        return kv_write_attention(q, k_pool, v_pool, k, v, layer, poss, lens,
                                  scale=scale, softcap=softcap, window=window)
    kv_rows_write_plain(k_pool, v_pool, k, v, layer, poss)
    return batch_decode_attention_plain(q, k_pool, v_pool, layer, lens, scale, softcap,
                                        window)


def batch_decode_step_fn(cfg: TransformerConfig, params: dict, k_pool, v_pool,
                         tokens: torch.Tensor, poss: torch.Tensor) -> torch.Tensor:
    """One decode step for all B slots with the hidden rows batched through
    every weight matmul (one weight stream per projection for all rows).

    Pools ``[B, L, MAX, Hk*D]`` are updated in place; tokens [B], poss [B]
    int32 device tensors (a free slot passes its stale position: rope rows,
    the row write and the attention bound all clamp; learned positions
    take the reference's ``jnp.take``, NaN rows past the table, in that
    slot's row alone). Returns f32 logits [B, V]. Always
    ``kv_write_attention`` (route rule above)."""
    b = tokens.shape[0]
    h = _embed_tokens(cfg, params, tokens)
    if cfg.use_position_embed:
        h = h + _take_rows(params["pos_embed"], poss)
    lens = poss + 1
    rows = _rope_rows_for(params, poss, 1, lens) if cfg.use_rope else None
    for i in range(kv_leaf(k_pool).shape[1]):
        lp = _slice_layer_params(params["layers"], i)
        x = _attn_in(cfg, lp, h)
        q, k, v = _project_qkv(cfg, lp, x)                    # [B, H, D]
        q, k = _rope_qk(cfg, i, rows, q, k)
        attn = _write_attend(q[:, None], k_pool, v_pool, k, v, i, poss, lens,
                             cfg.attn_scale, cfg.attn_logit_softcap, _layer_window(cfg, i))
        h = _residual_tail(cfg, lp, h, attn.reshape(b, -1), b, x)
    return _logits(cfg, params, _final_norm(cfg, params, h))


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
# Single-stream decode over the fixed caches [L, MAX, Hk, D]
# ---------------------------------------------------------------------------

def _kv_layer(cache, i: int):
    """Layer ``i``'s ``[MAX, Hk, D]`` view of a fixed cache (dict-safe)."""
    if isinstance(cache, dict):
        return {"q": cache["q"][i], "s": cache["s"][i]}
    return cache[i]


def _merged(cache):
    """The ``[L, MAX, Hk*D]`` view of a fixed cache (free: contiguous), the
    layout ``prefill_fn`` writes; an int8 dict keeps its ``[L, MAX]``
    scales, one per row either way."""
    if isinstance(cache, dict):
        q = cache["q"]
        return {"q": q.view(*q.shape[:2], -1), "s": cache["s"]}
    return cache.view(*cache.shape[:2], -1)


def _token_row(token, device) -> torch.Tensor:
    """A token id (int or device scalar) as a [1] tensor on ``device``."""
    return torch.as_tensor(token, device=device).reshape(1)


def decode_step_fn(cfg: TransformerConfig, params: dict, k_cache, v_cache, token,
                   pos, allow_fused: bool = True) -> torch.Tensor:
    """One single-stream decode step (reference ``decode_step_fn``): write
    the token's k/v at ``pos`` of every layer of the fixed caches ``[L, MAX,
    Hk, D]`` (in place) and return the f32 logits [V] of the next
    position. ``pos`` is a host int (the model tracks it) or a one-element
    int32 tensor on the caches' device (the device position: the step
    then reads nothing on the host, so a CUDA graph of it replays at
    whatever position the tensor holds); ``token`` an int or a device
    scalar. The unfused step is the one-token window, whose
    attention (``sdpa_fixed_cache_fn``, route rule above) launches
    ``flash_decode`` on the card. Under ``PYGPUKIT_DECODE=fused`` an
    eligible model with a bf16 cache takes ``fused_decode_step_fn`` instead
    (``allow_fused=False`` opts a call site out)."""
    if (allow_fused and not isinstance(k_cache, dict)
            and k_cache.dtype == torch.bfloat16
            and use_fused_decode(cfg, params, k_cache.shape[1])):
        return fused_decode_step_fn(cfg, params, k_cache, v_cache, token, pos)
    tokens = _token_row(token, kv_leaf(k_cache).device)
    return decode_window_fn(cfg, params, k_cache, v_cache, tokens, pos)[0]


def decode_window_fn(cfg: TransformerConfig, params: dict, k_cache, v_cache,
                     tokens: torch.Tensor, pos) -> torch.Tensor:
    """Lookahead decode (reference ``decode_window_fn``): ``tokens`` [T]
    written at positions pos..pos+T-1 of the fixed caches (in place), f32
    logits [T, V] for all T positions; token t attends cache positions
    below pos + t + 1. ``pos`` an int, or a one-element int32 tensor on the
    caches' device: then the rope rows are gathered, the rows written by
    an index copy at the clamped start and the attention bounded by a
    device tensor, with the int path's bits. Rows past an accepted prefix are left behind and
    masked by every later step. The layer loop is bounded by the cache's
    layer dim, not ``cfg.num_layers``, so sliced layer stacks run their own
    depth."""
    t = tokens.shape[0]
    h = _embed_tokens(cfg, params, tokens)                    # [T, E]
    if cfg.use_position_embed:
        h = h + _table_rows(params["pos_embed"], pos, t)
    rows = _rope_rows_for(params, pos, t, pos + t) if cfg.use_rope else None
    for i in range(kv_leaf(k_cache).shape[0]):
        lp = _slice_layer_params(params["layers"], i)
        x = _attn_in(cfg, lp, h)
        q, k, v = _project_qkv(cfg, lp, x)                    # [T, H, D]
        q, k = _rope_qk(cfg, i, rows, q, k)
        kv_write(k_cache, k[None], (i, pos, 0, 0))
        kv_write(v_cache, v[None], (i, pos, 0, 0))
        attn = sdpa_fixed_cache_fn(q, _kv_layer(k_cache, i), _kv_layer(v_cache, i), pos + t,
                                   scale=cfg.attn_scale, softcap=cfg.attn_logit_softcap,
                                   window=_layer_window(cfg, i))
        h = _residual_tail(cfg, lp, h, attn, t, x)
    return _logits(cfg, params, _final_norm(cfg, params, h))


def generate_scan_fn(cfg: TransformerConfig, n_steps: int, temperature: float,
                     top_k: int, params: dict, k_cache, v_cache, token, pos,
                     generator=None, on_logits=None,
                     allow_fused: bool = True) -> torch.Tensor:
    """``n_steps`` decode steps from ``token`` at ``pos`` (reference
    ``generate_scan_fn``): each step's token is the argmax, or a tempered
    (top-k) draw from ``generator`` (``sample_logits``). Returns the int32
    tokens [n_steps] on the device; nothing is read back. ``on_logits``
    sees each step's logits. ``pos`` is passed to each step as it is
    given plus the step's index (an int stays an int)."""
    out = []
    tok = token
    for i in range(n_steps):
        logits = decode_step_fn(cfg, params, k_cache, v_cache, tok, pos + i,
                                allow_fused=allow_fused)
        if on_logits is not None:
            on_logits(logits)
        tok = sample_logits(logits, temperature, top_k, generator).to(torch.int32)
        out.append(tok)
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=kv_leaf(k_cache).device)
    return torch.stack(out)


def use_fused_decode(cfg: TransformerConfig, params: dict, max_seq: int) -> bool:
    """True when the single-stream step takes the fused kernel: opted in
    with ``PYGPUKIT_DECODE=fused`` (read per call) and an eligible model.
    The device then picks the implementation (the kernel for CUDA tensors,
    the plain fused step for CPU tensors) where the reference also
    requires a TPU backend."""
    if os.environ.get("PYGPUKIT_DECODE", "") != "fused":
        return False
    return fused_decode_eligible(cfg, params, max_seq)


def fused_decode_eligible(cfg: TransformerConfig, params: dict, max_seq: int) -> bool:
    """The reference's architecture checks (``pygpukit_tpu/llm/model.py:
    780-797``): no gemma, olmo2, cohere, glm4 or granite conventions (so
    no interleaved or partial rope; scaled tables qualify, since the kernel
    rotates with the rows it is given), separate dense bf16 ``w_q`` ...
    ``w_down`` leaves (so ``fuse_params`` output never qualifies), no
    biases, no ``attn_window`` leaf, and, where the reference lets them
    through, no NoPE layers (the kernel rotates every layer); then
    ``kernels.fused_decode.supports``, which keeps the architecture checks
    and states the CUDA kernel's own limits in place of the TPU's VMEM and
    tile gates (no ``max_seq`` limit)."""
    if (cfg.use_post_norms or cfg.attn_logit_softcap is not None
            or cfg.final_logit_softcap is not None
            or cfg.sliding_window is not None
            or cfg.embed_scale is not None or cfg.query_scale is not None):
        return False
    if (not cfg.pre_norms or cfg.parallel_block or cfg.rope_interleaved
            or cfg.rope_partial_factor != 1.0
            or cfg.residual_multiplier is not None or cfg.logit_scale is not None):
        return False
    if cfg.rope_layers is not None and not all(cfg.rope_layers):
        return False    # the kernel rotates every layer: NoPE layers stay off it
    lp = params["layers"]
    for leaf in ("w_q", "w_k", "w_v", "w_o", "w_gate", "w_up", "w_down"):
        if leaf not in lp or isinstance(lp[leaf], dict) or lp[leaf].dtype != torch.bfloat16:
            return False
    if "b_q" in lp or "b_qkv" in lp or "attn_window" in lp:
        return False
    return fused_decode_supports(
        hidden=cfg.hidden_size, intermediate=cfg.intermediate_size,
        n_heads=cfg.num_heads, n_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        max_seq=max_seq, norm_type=cfg.norm_type, activation=cfg.activation,
        use_rope=cfg.use_rope, has_bias=False, use_qk_norm=cfg.use_qk_norm,
        is_moe=cfg.is_moe)


def prepare_fused_decode_params(cfg: TransformerConfig, params: dict) -> dict:
    """Add the fused kernel's consolidated leaves: ``w_qkv_cat`` (q|k|v on
    N, ``[L, H, H + 2 Hk D]``) and ``w_gu_cat`` (gate|up, ``[L, H, 2 I]``);
    ``w_o`` and ``w_down`` serve as they are. The originals stay (prefill
    and the unfused step read them). The reference's ``[L, NT, K, C]`` tile
    arenas feed the TPU's DMA engines and are not made."""
    layers = dict(params["layers"])
    layers["w_qkv_cat"] = torch.cat([layers["w_q"], layers["w_k"], layers["w_v"]], dim=-1)
    layers["w_gu_cat"] = torch.cat([layers["w_gate"], layers["w_up"]], dim=-1)
    out = dict(params)
    out["layers"] = layers
    return out


def fused_decode_step_fn(cfg: TransformerConfig, params: dict, k_cache, v_cache, token,
                         pos) -> torch.Tensor:
    """``decode_step_fn`` through ``kernels.fused_decode`` (reference
    ``fused_decode_step_fn``): the embedding row in bf16, the rope row at
    ``pos`` in f32 (LongRoPE's long row past its threshold, chosen on the
    device as the unfused step chooses it, where the reference's fused
    step reads the short tables alone) and ``pos`` as a device int32
    [1]. ``pos`` is a host int
    (made into that tensor by a fill, without a host transfer) or that
    tensor itself, one int32 element on the caches' device, taken as it
    is (the kernel reads it; the host never does). Then the
    kernel, then k_new/v_new cast to the cache dtype and scattered at
    ``pos`` clamped into the cache (as ``dynamic_update_slice``), then the
    head on the final row in the cache dtype. Needs the leaves of
    ``prepare_fused_decode_params`` (``init_fixed_cache`` adds them)."""
    lp = params["layers"]
    if "w_qkv_cat" not in lp or "w_gu_cat" not in lp:
        raise ValueError("fused decode needs the consolidated leaves of "
                         "prepare_fused_decode_params (init_fixed_cache adds them "
                         "under PYGPUKIT_DECODE=fused)")
    n_layers, max_len, hk, d = k_cache.shape
    dev = k_cache.device
    h = params["embed"][_token_row(token, dev).to(torch.long)].to(torch.bfloat16)   # [1, H]
    if isinstance(pos, torch.Tensor):
        if pos.numel() != 1 or pos.dtype != torch.int32 or pos.device != dev:
            raise ValueError(f"fused decode takes pos as an int or one int32 element on "
                             f"{dev}, got {pos.dtype} {tuple(pos.shape)} on {pos.device}")
        pos_t = pos.reshape(1)
    else:
        pos_t = torch.full((1,), int(pos), dtype=torch.int32, device=dev)
    rows = _rope_rows_for(params, pos_t, 1, pos_t + 1)
    cos, sin = rows.cos.to(_F32), rows.sin.to(_F32)
    kc = k_cache.view(n_layers, max_len, hk * d)
    vc = v_cache.view(n_layers, max_len, hk * d)
    h_out, k_new, v_new = fused_decode(
        h, cos, sin, pos_t, lp["w_qkv_cat"], lp["w_o"], lp["w_gu_cat"], lp["w_down"],
        lp["attn_norm_w"].to(_F32), lp["mlp_norm_w"].to(_F32),
        params["final_norm_w"].to(_F32).reshape(1, -1), kc, vc,
        n_heads=cfg.num_heads, n_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        eps=cfg.norm_eps)
    at = torch.clamp(pos_t, 0, max_len - 1).to(torch.long)
    kc.index_copy_(1, at, k_new[:, None, :].to(kc.dtype))
    vc.index_copy_(1, at, v_new[:, None, :].to(vc.dtype))
    return _logits(cfg, params, h_out[0].to(k_cache.dtype))


def _first_layers(cache, n: int):
    """The first ``n`` layers of a fixed cache, as views (dict-safe)."""
    if isinstance(cache, dict):
        return {"q": cache["q"][:n], "s": cache["s"][:n]}
    return cache[:n]


def speculative_scan_fn(cfg: TransformerConfig, n_rounds: int, gamma: int, n_draft: int,
                        params: dict, k_cache, v_cache, token, pos: torch.Tensor,
                        on_logits=None):
    """``n_rounds`` rounds of self-speculative greedy decoding with the
    position on the device (reference ``speculative_scan_fn``). Each round:
    ``gamma`` greedy draft steps through the first ``n_draft`` layers
    (``decode_step_fn``, ``allow_fused=False``); one verify window over
    ``[cur, d1..dγ]`` through every layer (``decode_window_fn``); the
    leading agreements ``accepted`` (cumprod of proposals == predictions),
    the correction or bonus token ``preds[accepted]``, and the round's
    tokens padded with -1. The position advances on the device by
    ``accepted + 1``: nothing is read on the host.

    The draft's KV rows are written straight into the shared caches'
    first ``n_draft`` layers, where the reference keeps them in a snapshot
    of those rows: every row a draft step writes (pos..pos+gamma-1) is
    rewritten by the verify window before any attention reads it, since
    ``decode_window_fn`` writes layer i's rows before layer i's attention,
    and the draft steps read exactly the rows the snapshot would hold.

    ``pos`` is a one-element int32 tensor on the caches' device; the caller
    leaves room for the all-accept worst case, pos + n_rounds * (gamma + 1)
    <= MAX. Returns (toks [n_rounds, gamma + 1] int32, -1 padded, counts
    [n_rounds] int32, the final position [1] int32), all on the device.
    ``on_logits`` sees each verify window's logits."""
    draft = slice_layers(params, n_draft)
    kd, vd = _first_layers(k_cache, n_draft), _first_layers(v_cache, n_draft)
    dev = kv_leaf(k_cache).device
    idx = torch.arange(gamma + 1, device=dev)
    cur = (token.reshape(1).to(torch.int32) if isinstance(token, torch.Tensor) else
           torch.full((1,), int(token), dtype=torch.int32, device=dev))
    p = pos.reshape(1)
    toks, counts = [], []
    for _ in range(n_rounds):
        props, tok = [], cur
        for j in range(gamma):
            logits = decode_step_fn(cfg, draft, kd, vd, tok, p + j, allow_fused=False)
            tok = torch.argmax(logits).reshape(1).to(torch.int32)
            props.append(tok)
        proposals = torch.cat(props)
        logits = decode_window_fn(cfg, params, k_cache, v_cache,
                                  torch.cat([cur, proposals]), p)
        if on_logits is not None:
            on_logits(logits)
        preds = torch.argmax(logits, dim=-1).to(torch.int32)             # [gamma + 1]
        agree = (proposals == preds[:gamma]).to(torch.int32)
        accepted = torch.cumprod(agree, 0).sum().reshape(1).to(torch.int32)
        nxt = preds.index_select(0, accepted)      # correction, or bonus on full accept
        props_pad = torch.cat([proposals, torch.zeros(1, dtype=torch.int32, device=dev)])
        minus = torch.full_like(props_pad, -1)
        toks.append(torch.where(idx < accepted, props_pad,
                                torch.where(idx == accepted, nxt, minus)))
        counts.append(accepted + 1)
        cur, p = nxt, p + accepted + 1
    return torch.stack(toks), torch.cat(counts), p


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
    """Random params (std 0.02, norm weights at one, norm and MLP biases at
    zero) in the reference's stacked layout (``_build_random_params``),
    drawn on ``device`` (the card unless the caller names one) from a
    ``torch.Generator`` seeded with ``seed``. Values differ from the
    reference's init (another generator); the leaves are the same: the
    input norms where the blocks have them (none for OLMo-2, one for a
    parallel block), the layernorm biases, per-head or whole-width (OLMo-2)
    q/k norms, sandwich norms, per-layer windows, Gemma-3's
    ``use_local_rope`` and SmolLM3's ``use_rope_layer`` switches, the
    gateless fc1/fc2 MLP with Apertus's xIELU leaves at their initial
    values, and learned positions where the config has them (no attention
    or lm-head biases: a checkpoint brings those). A MoE config gets an f32
    router ``[L, H, E]`` and expert stacks ``[L, E, H, I]`` / ``[L, E, I,
    H]`` in place of the dense MLP,
    drawn one expert matrix at a time (an f32 temporary of one matrix, not
    of the whole stack)."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def w(*shape, dt=dtype):
        return (torch.randn(shape, generator=gen, device=device, dtype=_F32)
                * 0.02).to(dt)

    def stack(*shape):
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            for j in range(shape[1]):
                out[i, j] = w(*shape[2:])
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=_F32, device=device)

    def zeros(*shape, dt=_F32):
        return torch.zeros(shape, dtype=dt, device=device)

    nl, e, inter = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lp = {"w_q": w(nl, e, hq * d), "w_k": w(nl, e, hk * d),
          "w_v": w(nl, e, hk * d), "w_o": w(nl, hq * d, e)}
    if cfg.pre_norms:                   # OLMo-2 has none; a parallel block one
        lp["attn_norm_w"] = ones(nl, e)
        if cfg.norm_type == "layernorm":
            lp["attn_norm_b"] = zeros(nl, e)
        if not cfg.parallel_block:
            lp["mlp_norm_w"] = ones(nl, e)
            if cfg.norm_type == "layernorm":
                lp["mlp_norm_b"] = zeros(nl, e)
    if cfg.use_qk_norm:
        wide = cfg.qk_norm_wide
        lp.update(w_q_norm=ones(nl, hq * d if wide else d),
                  w_k_norm=ones(nl, hk * d if wide else d))
    if cfg.use_post_norms:
        lp.update(post_attn_norm_w=ones(nl, e), post_mlp_norm_w=ones(nl, e))
    wins = cfg.layer_windows()
    if wins is not None:
        lp["attn_window"] = torch.tensor(wins, dtype=torch.int32, device=device)
    if cfg.rope_local_theta is not None and cfg.layer_types is not None:
        lp["use_local_rope"] = torch.tensor(
            [1 if t == "sliding_attention" else 0 for t in cfg.layer_types],
            dtype=torch.int32, device=device)
    if cfg.rope_layers is not None:
        lp["use_rope_layer"] = torch.tensor(cfg.rope_layers, dtype=torch.int32, device=device)
    if cfg.is_moe:
        ne, mi = cfg.num_experts, cfg.moe_intermediate_size
        lp["w_router"] = w(nl, e, ne, dt=_F32)
        lp["w_experts_gate"] = stack(nl, ne, e, mi)
        lp["w_experts_up"] = stack(nl, ne, e, mi)
        lp["w_experts_down"] = stack(nl, ne, mi, e)
    elif cfg.activation in ("silu", "gelu_tanh"):
        lp.update(w_gate=w(nl, e, inter), w_up=w(nl, e, inter), w_down=w(nl, inter, e))
    else:
        lp.update(w_fc1=w(nl, e, inter), w_fc2=w(nl, inter, e),
                  b_fc1=zeros(nl, inter, dt=dtype), b_fc2=zeros(nl, e, dt=dtype))
        if cfg.activation == "xielu":   # XIELUActivation's initial values
            for leaf, v in (("act_alpha_p", math.log(math.expm1(0.8))),
                            ("act_alpha_n", math.log(math.expm1(0.3))),
                            ("act_beta", 0.5), ("act_eps", -1e-6)):
                lp[leaf] = torch.full((nl, 1), v, dtype=_F32, device=device)
    params = {"embed": w(cfg.vocab_size, e), "final_norm_w": ones(e),
              "lm_head": None if cfg.tie_word_embeddings else w(e, cfg.vocab_size),
              "layers": lp}
    if cfg.norm_type == "layernorm":
        params["final_norm_b"] = zeros(e)
    if cfg.use_position_embed:
        params["pos_embed"] = w(cfg.max_position_embeddings, e)
    return params


def slice_layers(params: dict, n_layers: int) -> dict:
    """The first ``n_layers`` of the stacked layer leaves, as views (the
    reference's ``slice_layers``: the self-speculative draft)."""
    out = dict(params)
    out["layers"] = {k: ({kk: vv[:n_layers] for kk, vv in v.items()}
                         if isinstance(v, dict) else v[:n_layers])
                     for k, v in params["layers"].items()}
    return out


def _note_nonfinite(nonfinite: torch.Tensor, logits: torch.Tensor) -> None:
    """Set the sticky flag when any logit is not finite (in place)."""
    nonfinite |= ~torch.isfinite(logits).all()


def _graph_decode_step(cfg: TransformerConfig, params: dict, k_cache, v_cache, token,
                       pos, nonfinite, logits_out, sampled_out):
    """The captured greedy decode step: ``decode_step_fn`` at the device
    position, the non-finite flag updated, the logits and their argmax
    written into the ``DecodeBuffers`` outputs."""
    logits = decode_step_fn(cfg, params, k_cache, v_cache, token, pos)
    _note_nonfinite(nonfinite, logits)
    logits_out.copy_(logits)
    sampled_out.copy_(torch.argmax(logits).reshape(1))
    return logits_out, sampled_out


def _graph_prefill(cfg: TransformerConfig, params: dict, k_cache, v_cache, tokens,
                   true_len, nonfinite) -> torch.Tensor:
    """The captured prefill of the model's fixed caches (``prefill_fn``
    over their merged views)."""
    logits = prefill_fn(cfg, params, _merged(k_cache), _merged(v_cache), tokens, true_len)
    _note_nonfinite(nonfinite, logits)
    return logits


def _graph_window(cfg: TransformerConfig, params: dict, k_cache, v_cache, tokens, pos,
                  nonfinite) -> torch.Tensor:
    """The captured lookahead window (``decode_window_fn``)."""
    logits = decode_window_fn(cfg, params, k_cache, v_cache, tokens, pos)
    _note_nonfinite(nonfinite, logits)
    return logits


def _graph_chunk(cfg: TransformerConfig, n_steps: int, temperature: float, top_k: int,
                 generator, params: dict, k_cache, v_cache, token, pos,
                 nonfinite) -> torch.Tensor:
    """The captured decode chunk (``generate_scan_fn``)."""
    return generate_scan_fn(cfg, n_steps, temperature, top_k, params, k_cache, v_cache,
                            token, pos, generator,
                            functools.partial(_note_nonfinite, nonfinite))


def _graph_spec(cfg: TransformerConfig, n_rounds: int, gamma: int, n_draft: int,
                params: dict, k_cache, v_cache, token, pos, nonfinite):
    """The captured self-speculative chunk (``speculative_scan_fn``)."""
    return speculative_scan_fn(cfg, n_rounds, gamma, n_draft, params, k_cache, v_cache,
                               token, pos, functools.partial(_note_nonfinite, nonfinite))


def _token_arg(token):
    """A token for a captured program: an int as it is (written into the
    static input), a device scalar as an int32 [1] tensor (copied in)."""
    if isinstance(token, torch.Tensor):
        return token.reshape(1).to(torch.int32)
    return int(token)


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

@dataclass
class KVSnapshot:
    """Host copy of the fixed caches and the position (reference
    ``KVSnapshot``). Leaves are numpy arrays in the storage dtype (bf16 and
    fp8 as ``ml_dtypes`` arrays); where ``ml_dtypes`` is missing, bf16 and
    fp8 leaves stay torch CPU tensors. An int8 cache is a ``{"q", "s"}``
    dict of them."""
    k: object
    v: object
    pos: int


def _to_host(leaf: torch.Tensor):
    """A host copy (never a view of a CPU cache)."""
    copy = leaf.detach().to("cpu", copy=True)
    try:
        return tensor_to_numpy(copy)
    except TypeError:                       # bf16 / fp8 without ml_dtypes
        return copy


def _from_host(leaf, device, dtype=None) -> torch.Tensor:
    t = leaf if isinstance(leaf, torch.Tensor) else tensor_from_numpy(leaf)
    return t.to(device=device, dtype=dtype or t.dtype, copy=True)


class CausalTransformerModel(nn.Module):
    """Unified causal LM with a fixed KV cache. Stacked leaves are module
    buffers; ``params`` rebuilds the reference-shaped nested dict over them.
    The single-stream caches are the reference's ``[L, MAX, Hk, D]``
    (``k_cache``/``v_cache``, int8 ``{"q", "s"}`` dicts for an int8
    ``kv_dtype``), updated in place."""

    def __init__(self, config: TransformerConfig, params: dict,
                 spec: ModelSpec | None = None, dtype: torch.dtype = torch.bfloat16,
                 kv_dtype=None):
        super().__init__()
        check_supported(config)
        self.config = config
        self.spec = spec
        self.dtype = dtype
        self.kv_dtype = resolve_kv_dtype(kv_dtype, dtype)
        self._paths = []
        self.max_seq_len: int | None = None
        self.k_cache = self.v_cache = None
        self.pos = 0
        self._nonfinite = None
        self.decode_buffers: DecodeBuffers | None = None
        self.prefill_buffers: PrefillBuffers | None = None
        # every captured program of the model, one shared pool; the
        # sampled chunks' generators, one per executable
        self.graphs = ExecutableCache(shared_pool=True)
        self._chunk_generators: dict = {}
        self.params = params

    def _register(self, params: dict) -> None:
        """Make the leaves of ``params`` not yet registered module buffers."""
        known = {path for path, _ in self._paths}
        for path, t in _flatten(params):
            if path in known:
                continue
            name = "__".join(path)
            self._paths.append((path, name if t is not None else None))
            if t is not None:
                self.register_buffer(name, t)

    @property
    def params(self) -> dict:
        out: dict = {}
        for path, name in self._paths:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = None if name is None else getattr(self, name)
        return out

    @params.setter
    def params(self, params: dict) -> None:
        """Take a new param tree, as the reference's attribute does
        (``model.params = quantize_model_params(model.params, "int4")``):
        its leaves replace every registered one (the rope leaves of
        ``rope_tables_for`` are made when the tree has none). The captured programs bind the old weights
        by address, so they are released with the decode and prefill
        buffers; the old tensors are never written. The caches and the
        position stay."""
        params = dict(params)
        _check_params(params)
        cfg = self.config
        if cfg.use_rope and "rope_cos" not in params:
            params.update(rope_tables_for(cfg, params["embed"].device))
        self._drop_executables()
        for _, name in self._paths:
            if name is not None:
                delattr(self, name)
        self._paths = []
        self._register(params)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init_fixed_cache(self, max_seq_len: int) -> None:
        """Zeroed caches ``[L, MAX, Hk, D]`` of capacity ``max_seq_len`` in
        ``kv_dtype``; position 0. Under ``PYGPUKIT_DECODE=fused`` an
        eligible model gains the fused kernel's consolidated leaves here,
        once (``prepare_fused_decode_params``). The captured programs are
        released: they were bound to the old caches."""
        cfg = self.config
        self._drop_executables()
        shape = (cfg.num_layers, max_seq_len, cfg.num_kv_heads, cfg.head_dim)
        self.k_cache = kv_cache_zeros(shape, self.kv_dtype, device=self.device, merged=False)
        self.v_cache = kv_cache_zeros(shape, self.kv_dtype, device=self.device, merged=False)
        self.max_seq_len = max_seq_len
        self.pos = 0
        # set on the device by any non-finite logit since this cache was
        # made; read without a sync per step (logits_finite())
        self._nonfinite = torch.zeros((), dtype=torch.bool, device=self.device)
        params = self.params
        if use_fused_decode(cfg, params, max_seq_len) and "w_qkv_cat" not in params["layers"]:
            self._register(prepare_fused_decode_params(cfg, params))

    def _drop_executables(self) -> None:
        self.graphs.reset()
        self._chunk_generators = {}
        self.decode_buffers = self.prefill_buffers = None

    def _ensure_decode_exe(self) -> Executable:
        """The greedy decode step captured at the model's caches (``core.
        capture``): ``decode_step_fn`` with ``decode_buffers.token`` and
        ``.position`` as its inputs and ``.logits``/``.sampled`` as its
        outputs, the caches and the non-finite flag donated. It takes the
        route ``decode_step_fn`` takes now: fused when
        ``PYGPUKIT_DECODE=fused`` makes the model eligible, else unfused;
        one executable per route, until ``init_fixed_cache``."""
        if self.k_cache is None:
            raise RuntimeError("capture the decode step after init_fixed_cache")
        fused = (not isinstance(self.k_cache, dict) and self.k_cache.dtype == torch.bfloat16
                 and use_fused_decode(self.config, self.params, self.max_seq_len))
        exe = self.graphs.get(("decode", fused))
        if exe is None:
            if self.decode_buffers is None:
                self.decode_buffers = DecodeBuffers.allocate(self.config, self.dtype,
                                                             self.device)
            b = self.decode_buffers
            with torch.no_grad():
                exe = self.graphs.get_or_capture(
                    ("decode", fused), functools.partial(_graph_decode_step, self.config),
                    self.params, self.k_cache, self.v_cache, b.token, b.position,
                    self._nonfinite, b.logits, b.sampled, donate_argnums=(1, 2, 5, 6, 7),
                    bound_argnums=(0,),
                    name="decode_step_fused" if fused else "decode_step")
        return exe

    def _ensure_prefill_exe(self, bucket: int) -> Executable:
        """The prefill of ``bucket`` padded tokens, captured once per bucket
        (the reference's ``prefill_{bucket}``): the tokens through
        ``prefill_buffers``, the true length a one-element device tensor."""
        if self.prefill_buffers is None:
            self.prefill_buffers = PrefillBuffers.allocate(self.config, self.max_seq_len,
                                                           self.device)
        return self.graphs.get_or_capture(
            ("prefill", bucket), functools.partial(_graph_prefill, self.config),
            self.params, self.k_cache, self.v_cache, self.prefill_buffers.tokens[:bucket],
            1, self._nonfinite, donate_argnums=(1, 2, 5), bound_argnums=(0,),
            name=f"prefill_{bucket}")

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
        """Run the prompt through cached prefill, the executable of its
        bucket; f32 logits [V] of its last position, a static output that
        the next replay of the model's programs overwrites."""
        ids = torch.as_tensor(np.asarray(input_ids, np.int64).reshape(-1))
        n = ids.numel()
        if self.k_cache is None:
            self.init_fixed_cache(_bucket(max(n * 2, 256)))
        if n > self.max_seq_len:
            raise ValueError(f"prompt ({n}) exceeds cache ({self.max_seq_len})")
        bucket = min(_bucket(n), self.max_seq_len)
        exe = self._ensure_prefill_exe(bucket)
        padded = torch.zeros(bucket, dtype=torch.int32)
        padded[:n] = ids
        tokens = self.prefill_buffers.tokens[:bucket]
        tokens.copy_(padded)
        logits = exe.replay(self.params, self.k_cache, self.v_cache, tokens, n,
                            self._nonfinite)
        self.pos = n
        return logits

    @torch.no_grad()
    def decode_step(self, token) -> torch.Tensor:
        """One cached decode step, a replay of the captured step
        (``_ensure_decode_exe``): the token and the model's position written
        into ``decode_buffers``, the position advanced. Returns
        ``decode_buffers.logits`` (f32 [V] for the next position), which the
        next replay overwrites."""
        exe = self._ensure_decode_exe()
        b = self.decode_buffers
        logits, _ = exe.replay(self.params, self.k_cache, self.v_cache, _token_arg(token),
                               self.pos, self._nonfinite, b.logits, b.sampled)
        self.pos += 1
        return logits

    @torch.no_grad()
    def decode_window(self, tokens, advance: int | None = None) -> torch.Tensor:
        """Lookahead window decode: T tokens in, f32 logits [T, V] out, one
        executable per T (``decode_window_{T}``, its logits a static output);
        ``pos`` advances by ``advance`` (default T). Rows of rejected tokens
        are masked by later steps."""
        toks = torch.as_tensor(np.asarray(tokens, np.int64).reshape(-1))
        t = toks.numel()
        exe = self.graphs.get_or_capture(
            ("window", t), functools.partial(_graph_window, self.config), self.params,
            self.k_cache, self.v_cache, torch.zeros(t, dtype=torch.long, device=self.device),
            0, self._nonfinite, donate_argnums=(1, 2, 5), bound_argnums=(0,),
            name=f"decode_window_{t}")
        logits = exe.replay(self.params, self.k_cache, self.v_cache, toks.to(self.device),
                            self.pos, self._nonfinite)
        self.pos += t if advance is None else advance
        return logits

    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    @torch.no_grad()
    def decode_chunk(self, token, n_steps: int, temperature: float = 0.0,
                     top_k: int = 0, seed: int = 0) -> np.ndarray:
        """``n_steps`` decode steps; the generated tokens as numpy int32."""
        return self.decode_chunk_device(token, n_steps, temperature, top_k,
                                        seed).cpu().numpy()

    @torch.no_grad()
    def decode_chunk_device(self, token, n_steps: int, temperature: float = 0.0,
                            top_k: int = 0, seed: int = 0) -> torch.Tensor:
        """``decode_chunk`` without the read back: int32 tokens [n_steps]
        on the device (a static output), one executable per (n_steps,
        temperature, top_k) (``generate_{n_steps}``); ``token`` may be a
        device scalar. A sampled chunk draws from its executable's
        registered generator, reseeded with ``seed + pos`` before each
        replay (the reference folds ``PRNGKey(seed + pos)``)."""
        key = ("generate", n_steps, float(temperature), int(top_k))
        gen = None
        if temperature > 0:
            gen = self._chunk_generators.get(key)
            if gen is None:
                gen = self._chunk_generators[key] = torch.Generator(device=self.device)
        exe = self.graphs.get_or_capture(
            key, functools.partial(_graph_chunk, self.config, n_steps, float(temperature),
                                   int(top_k), gen),
            self.params, self.k_cache, self.v_cache, 0, 0, self._nonfinite,
            donate_argnums=(1, 2, 5), bound_argnums=(0,), generators=() if gen is None else (gen,),
            name=f"generate_{n_steps}")
        if gen is not None:
            gen.manual_seed(seed + self.pos)
        toks = exe.replay(self.params, self.k_cache, self.v_cache, _token_arg(token),
                          self.pos, self._nonfinite)
        self.pos += n_steps
        return toks

    @torch.no_grad()
    def decode_spec_chunk(self, token, n_rounds: int, gamma: int,
                          n_draft: int) -> tuple[np.ndarray, np.ndarray]:
        """``n_rounds`` self-speculative rounds (``speculative_scan_fn``,
        one executable per (n_rounds, gamma, n_draft)) with the position on
        the device; the tokens, counts and final
        position are read back once, at the end. Returns (toks [n_rounds,
        gamma + 1] with -1 padding, counts [n_rounds]) as numpy int32 and
        advances ``pos`` by the accepted totals. ValueError when the
        all-accept worst case, pos + n_rounds * (gamma + 1), passes the
        cache."""
        if self.pos + n_rounds * (gamma + 1) > self.max_seq_len:
            raise ValueError(
                f"speculative chunk worst case ({n_rounds}x{gamma + 1} from "
                f"pos {self.pos}) exceeds cache ({self.max_seq_len})")
        exe = self.graphs.get_or_capture(
            ("spec", n_rounds, gamma, n_draft),
            functools.partial(_graph_spec, self.config, n_rounds, gamma, n_draft),
            self.params, self.k_cache, self.v_cache, 0, 0, self._nonfinite,
            donate_argnums=(1, 2, 5), bound_argnums=(0,),
            name=f"spec_{n_rounds}x{gamma}_d{n_draft}")
        toks, counts, pos = exe.replay(self.params, self.k_cache, self.v_cache,
                                       _token_arg(token), self.pos, self._nonfinite)
        host = torch.cat([toks.reshape(-1), counts, pos]).cpu().numpy()
        self.pos = int(host[-1])
        return (host[:toks.numel()].reshape(n_rounds, gamma + 1),
                host[toks.numel():-1])

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 eos_token_id: int | None = None, seed: int = 0,
                 use_cache: bool = True, chunk_size: int = 32) -> list[int]:
        """Greedy or temperature/top-k generation, the reference's route:
        prefill, the first token sampled on the device (a generator seeded
        with ``seed``), then ``decode_chunk_device`` chunks of up to
        ``chunk_size`` tokens with one host read each (the first chunk also
        returns the first token, so an EOS first token is seen one chunk
        late); stops at ``eos_token_id`` (kept) or a full cache. Uncached
        generation and top-p sampling (temperature > 0, no top-k) take the
        per-token ``generate_stream``."""
        if not use_cache or (temperature > 0 and not (top_k > 0 or top_p == 0.0)):
            return list(self.generate_stream(input_ids, max_new_tokens, temperature,
                                             top_k, top_p, eos_token_id, seed,
                                             use_cache))
        ids = np.asarray(input_ids, np.int64).reshape(-1)
        if self.k_cache is None:
            self.init_fixed_cache(_bucket(max(len(ids) + max_new_tokens + 1, 256)))
        logits = self.prefill(ids)
        if temperature <= 0:
            cur = torch.argmax(logits)
        else:
            cur = sample_logits(logits, temperature, top_k, self._generator(seed))
        cur = cur.to(torch.int32)
        out: list[int] = []
        first = True
        while len(out) < max_new_tokens:
            n = min(max_new_tokens - len(out) - (1 if first else 0), chunk_size,
                    self.max_seq_len - self.pos)
            if n <= 0:
                if first:
                    out.append(int(cur))
                break
            toks_d = self.decode_chunk_device(cur, n, temperature, top_k, seed)
            if first:
                toks_d = torch.cat([cur.reshape(1), toks_d])
                first = False
            toks = toks_d.tolist()
            if eos_token_id is not None and eos_token_id in toks:
                out.extend(toks[:toks.index(eos_token_id) + 1])
                return out[:max_new_tokens]
            out.extend(toks)
            cur = toks[-1]
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
        gen = self._generator(seed) if temperature > 0 else None

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
        logits = self.prefill(input_ids)
        for _ in range(max_new_tokens):
            tok = sample(logits)
            yield tok
            if eos_token_id is not None and tok == eos_token_id:
                return
            if self.pos >= self.max_seq_len:
                return
            logits = self.decode_step(tok)

    # -- KV snapshot / restore --------------------------------------------

    def snapshot_kv_cache(self) -> KVSnapshot:
        """A host copy of the caches and the position."""
        def host(cache):
            if isinstance(cache, dict):
                return {k: _to_host(v) for k, v in cache.items()}
            return _to_host(cache)
        return KVSnapshot(k=host(self.k_cache), v=host(self.v_cache), pos=self.pos)

    def restore_kv_cache(self, snap: KVSnapshot) -> None:
        """Copy a snapshot back into fresh caches on the model's device: an
        int8 dict in its storage dtypes, a plain array converted to the
        model's ``kv_dtype``. TypeError when the snapshot's structure (dict
        or array) does not match ``kv_dtype``."""
        want_dict = self.kv_dtype == torch.int8
        have_dict = isinstance(snap.k, dict)
        if want_dict != have_dict:
            raise TypeError(
                f"KV snapshot structure ({'int8 dict' if have_dict else 'array'}) "
                f"does not match model kv_dtype={self.kv_dtype} "
                f"({'int8 dict' if want_dict else 'array'} pools); "
                "re-quantize or rebuild the model with the matching kv_dtype")
        if want_dict:
            self.k_cache = {k: _from_host(v, self.device) for k, v in snap.k.items()}
            self.v_cache = {k: _from_host(v, self.device) for k, v in snap.v.items()}
        else:
            self.k_cache = _from_host(snap.k, self.device, self.kv_dtype)
            self.v_cache = _from_host(snap.v, self.device, self.kv_dtype)
        self.max_seq_len = kv_leaf(self.k_cache).shape[1]
        self.pos = snap.pos
        self._drop_executables()
        if self._nonfinite is None:
            self._nonfinite = torch.zeros((), dtype=torch.bool, device=self.device)
