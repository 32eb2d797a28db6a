"""Weight quantization (counterpart of ``pygpukit_tpu/llm/quant.py``).

Leaves are byte-for-byte the reference's:

- int8 ``{"q" [.., in, out] int8, "scale" [.., 1, out] f32}``;
- fp8 ``{"q" [.., in, out] float8_e4m3fn, "scale" [.., 1, out] f32}``,
  ``scale = amax/448``;
- packed int4 ``{"q_packed" [.., out, in/2] uint8, "scale" [.., 1, out]
  f32}``, split-half along the in-dim (low nibble = first half);
- int4_block (alias nvf4) ``{"q_packed" [.., K/2, out] uint8,
  "scale_block" [.., K/B, out] bf16}``: K-major split-half storage with one
  scale per (K-block of B rows, column); K is the in-dim padded to a
  multiple of B, and the scale is rounded to bf16 before quantizing.

Rounding is half to even against an IEEE f32 divide, as ``jnp.round`` does.

The checkpoint metadata (``FP8QuantConfig`` ... ``QuantizationMetadata``)
and ``kv_dtype_from_quant_config`` are the reference's, word for word.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Literal

import torch
import torch.nn.functional as F

from ..core.numerics import true_div

_F32 = torch.float32
FP8_E4M3_MAX = 448.0

_QUANT_KEYS = {
    "w_q", "w_k", "w_v", "w_o", "w_qkv", "w_gate", "w_up", "w_gate_up",
    "w_down", "w_fc1", "w_fc2",
}
# MoE expert stacks [L, E, in, out], quantized for fp8 and int8 only (the
# packed 4-bit layouts serve the decode GEMVs, which the expert matmuls do
# not use)
_MOE_QUANT_KEYS = {"w_experts_gate", "w_experts_up", "w_experts_down"}
_PACKED4 = ("int4", "int4_block", "nvf4")


# ---------------------------------------------------------------------------
# Checkpoint metadata
# ---------------------------------------------------------------------------

@dataclass
class FP8QuantConfig:
    fmt: Literal["e4m3", "e5m2"] = "e4m3"
    scale_granularity: Literal["tensor", "channel", "block"] = "channel"
    block_size: int = 128


@dataclass
class QATConfig:
    enabled: bool = False
    bits: int = 8
    symmetric: bool = True


@dataclass
class PruningConfig:
    sparsity: float = 0.0
    structured: bool = False
    pattern: str = "2:4"


@dataclass
class SparsityConfig:
    """Structured-sparsity metadata carried on checkpoints (descriptive:
    inference does not read it)."""
    pattern: str = "2:4"
    sparsity: float = 0.5
    structured: bool = True


@dataclass
class ModelOptimizationInfo:
    """Aggregate optimization metadata of a checkpoint."""
    quantization: "FP8QuantConfig | None" = None
    qat: "QATConfig | None" = None
    pruning: "PruningConfig | None" = None
    sparsity: "SparsityConfig | None" = None


@dataclass
class QuantizationMetadata:
    method: str = "none"
    fp8: FP8QuantConfig = field(default_factory=FP8QuantConfig)
    qat: QATConfig = field(default_factory=QATConfig)
    pruning: PruningConfig = field(default_factory=PruningConfig)
    #: the KV-cache quantization algo of the checkpoint's
    #: quantization_config; "FP8" maps to a float8_e4m3fn cache
    #: (``model.resolve_kv_dtype``)
    kv_cache_quant_algo: str | None = None


#: the reference's alias
QATQuantConfig = QATConfig


def kv_dtype_from_quant_config(qc: dict | None) -> str | None:
    """A HF quantization_config's ``kv_cache_quant_algo`` as a kv_dtype name
    that ``model.resolve_kv_dtype`` accepts (None: no KV quantization). An
    algo it does not know warns and gives None: the weights load either
    way, and the KV algo is an optimisation hint."""
    algo = (qc or {}).get("kv_cache_quant_algo")
    if algo is None:
        return None
    a = str(algo).lower()
    if "e5m2" in a:
        return "fp8_e5m2"
    if "fp8" in a or "e4m3" in a:
        return "fp8_e4m3"
    if "int8" in a:
        return "int8"
    warnings.warn(f"unsupported kv_cache_quant_algo {algo!r}; "
                  "using the model dtype for the KV cache")
    return None


def _pack_split_half(q: torch.Tensor, dim: int) -> torch.Tensor:
    """Signed nibbles along ``dim`` (even length) -> uint8, low nibble =
    first half."""
    lo, hi = torch.chunk(q.to(torch.int16), 2, dim=dim)
    return ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8).contiguous()


def quantize_weight(w: torch.Tensor, mode: str = "fp8",
                    block_size: int = 32) -> dict:
    """One weight [..., in, out] -> a quantized leaf (``mode`` "int4",
    "int8", "fp8", "int4_block" or "nvf4"); ``block_size`` is B of the
    block mode."""
    wf = w.to(_F32)
    if mode in ("int4_block", "nvf4"):
        b = block_size
        kpad = (-wf.shape[-2]) % b
        if kpad:
            wf = F.pad(wf, (0, 0, 0, kpad))
        *lead, k, n = wf.shape
        blk = wf.reshape(*lead, k // b, b, n)
        amax = torch.amax(torch.abs(blk), dim=-2, keepdim=True)   # [.., K/B, 1, N]
        scale = torch.clamp_min(true_div(amax, 7.0), 1e-12) \
            .to(torch.bfloat16).to(_F32)
        q = torch.clamp(torch.round(blk / scale), -7, 7).reshape(*lead, k, n)
        return {"q_packed": _pack_split_half(q, -2),
                "scale_block": scale[..., 0, :].to(torch.bfloat16).contiguous()}
    amax = torch.amax(torch.abs(wf), dim=-2, keepdim=True)       # [..., 1, out]
    if mode == "fp8":
        # |wf / scale| <= 448 * (1 + 2^-23), which rounds to 448: torch's
        # saturating cast and the reference's NaN-on-overflow cast agree
        scale = torch.clamp_min(true_div(amax, FP8_E4M3_MAX), 1e-12)
        return {"q": (wf / scale).to(torch.float8_e4m3fn), "scale": scale}
    if mode == "int8":
        scale = torch.clamp_min(true_div(amax, 127.0), 1e-12)
        q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale}
    if mode != "int4":
        raise ValueError(f"unknown quant mode {mode!r}")
    scale = torch.clamp_min(true_div(amax, 7.0), 1e-12)
    q = torch.clamp(torch.round(wf / scale), -7, 7)
    if q.shape[-2] % 2:                             # odd in-dim: pack-pad
        q = F.pad(q, (0, 0, 0, 1))
    return {"q_packed": _pack_split_half(q.transpose(-1, -2), -1), "scale": scale}


def unpack_int4(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Split-half nibble unpack along ``axis``: int4 ``[..., N, K/2]``
    (axis -1) -> ``[..., N, K]``; int4_block ``[..., K/2, N]`` (axis -2) ->
    ``[..., K, N]``. int8 values, low nibbles first, any pack padding
    included."""
    lo = (packed << 4).view(torch.int8) >> 4
    hi = packed.view(torch.int8) >> 4
    return torch.cat([lo, hi], dim=axis)


def dequantize_block(packed: torch.Tensor, scale_block: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """int4_block ``[..., K/2, N]`` + ``[..., K/B, N]`` -> ``[..., K, N]``:
    ``nibble * scale`` in f32, then ``dtype``."""
    q = unpack_int4(packed, axis=-2)
    *lead, k, n = q.shape
    nb = scale_block.shape[-2]
    blk = q.reshape(*lead, nb, k // nb, n).to(_F32)
    return (blk * scale_block.to(_F32)[..., :, None, :]).reshape(*lead, k, n).to(dtype)


def dequantize_weight(wq: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """A quantized leaf back to a dense [..., in, out] weight (any pack or
    block padding of the in-dim included)."""
    if "scale_block" in wq:
        return dequantize_block(wq["q_packed"], wq["scale_block"], dtype)
    if "q_packed" in wq:
        q = unpack_int4(wq["q_packed"]).transpose(-1, -2)        # [..., K, N]
        return (q.to(_F32) * wq["scale"]).to(dtype)
    return (wq["q"].to(_F32) * wq["scale"]).to(dtype)


def quantize_model_params(params: dict, mode: str = "fp8",
                          keys: set[str] | None = None,
                          head: bool | str = True) -> dict:
    """Quantize a model's projection leaves in place of their dense ones,
    and the MoE expert stacks for fp8 and int8 (never for the packed 4-bit
    modes). An untied head is quantized too: int8 for the packed 4-bit
    modes (int4 logit error shifts greedy order), ``mode`` otherwise;
    ``head=False`` keeps it dense, a mode string overrides."""
    if keys is None:
        keys = _QUANT_KEYS | (set() if mode in _PACKED4 else _MOE_QUANT_KEYS)
    out = dict(params)
    layers = dict(params["layers"])
    for k in list(layers):
        if k in keys and not isinstance(layers[k], dict):
            layers[k] = quantize_weight(layers[k], mode)
    out["layers"] = layers
    if head and isinstance(out.get("lm_head"), torch.Tensor):
        head_mode = head if isinstance(head, str) else (
            "int8" if mode in _PACKED4 else mode)
        out["lm_head"] = quantize_weight(out["lm_head"], head_mode)
    return out


def dequantize_model_params(params: dict, dtype=torch.bfloat16) -> dict:
    """Every quantized layer leaf and a quantized head back to dense
    ``dtype`` weights (``dequantize_weight``); other leaves as they are."""
    out = dict(params)
    layers = dict(params["layers"])
    for k, v in layers.items():
        if isinstance(v, dict) and ("q" in v or "q_packed" in v):
            layers[k] = dequantize_weight(v, dtype)
    out["layers"] = layers
    if isinstance(out.get("lm_head"), dict):
        out["lm_head"] = dequantize_weight(out["lm_head"], dtype)
    return out


def model_quant_bytes(params: dict) -> tuple[int, int]:
    """(bytes of the layer stack and head as stored, bytes of the same
    weights dense): a quantized leaf counts its ``q``/``q_packed`` bytes
    (not its scales) against 2 bytes a value (``q``) or 4 bytes a packed
    byte (two values); a dense leaf counts its bytes on both sides."""
    qb = db = 0
    leaves = dict(params["layers"])
    if isinstance(params.get("lm_head"), dict):
        leaves["lm_head"] = params["lm_head"]
    for v in leaves.values():
        if isinstance(v, dict) and ("q" in v or "q_packed" in v):
            q = v.get("q", v.get("q_packed"))
            n = q.numel()
            qb += n * q.element_size()
            db += n * 2 if "q" in v else n * 4
        else:
            sz = v.numel() * v.element_size()
            qb += sz
            db += sz
    return qb, db
