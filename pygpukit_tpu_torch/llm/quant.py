"""Weight quantization (counterpart of ``pygpukit_tpu/llm/quant.py``).

Leaves are byte-for-byte the reference's: int8 ``{"q" [.., in, out] int8,
"scale" [.., 1, out] f32}`` and packed int4 ``{"q_packed" [.., out, in/2]
uint8, "scale" [.., 1, out] f32}`` with split-half packing (low nibble =
first half of the in-dim). Rounding is half to even against an f32 divide,
as ``jnp.round`` does. The fp8 and int4_block rungs come with their kernels.
"""

from __future__ import annotations

import torch

from ..core.numerics import true_div

_F32 = torch.float32

_QUANT_KEYS = {
    "w_q", "w_k", "w_v", "w_o", "w_qkv", "w_gate", "w_up", "w_gate_up",
    "w_down", "w_fc1", "w_fc2",
}


def quantize_weight(w: torch.Tensor, mode: str = "int4") -> dict:
    """One weight [..., in, out] -> a quantized leaf with per-column scales
    (``mode`` "int4" or "int8")."""
    wf = w.to(_F32)
    amax = torch.amax(torch.abs(wf), dim=-2, keepdim=True)       # [..., 1, out]
    if mode == "int8":
        scale = torch.clamp_min(true_div(amax, 127.0), 1e-12)
        q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale}
    if mode != "int4":
        raise NotImplementedError(f"quant mode {mode!r} is not ported yet")
    scale = torch.clamp_min(true_div(amax, 7.0), 1e-12)
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int16)
    if q.shape[-2] % 2:                             # odd in-dim: pack-pad
        q = torch.nn.functional.pad(q, (0, 0, 0, 1))
    qt = q.transpose(-1, -2)                        # [..., out, in]
    half = qt.shape[-1] // 2
    packed = ((qt[..., :half] & 0xF) | ((qt[..., half:] & 0xF) << 4))
    return {"q_packed": packed.to(torch.uint8).contiguous(), "scale": scale}


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Split-half nibble unpack along the last dim: [..., N, K/2] uint8 ->
    [..., N, K] int8 (low nibbles first). Includes any pack padding."""
    lo = (packed << 4).view(torch.int8) >> 4
    hi = packed.view(torch.int8) >> 4
    return torch.cat([lo, hi], dim=-1)


def dequantize_weight(wq: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """A quantized leaf back to a dense [..., in, out] weight."""
    if "q_packed" in wq:
        q = unpack_int4(wq["q_packed"]).transpose(-1, -2)        # [..., K, N]
        return (q.to(_F32) * wq["scale"]).to(dtype)
    return (wq["q"].to(_F32) * wq["scale"]).to(dtype)


def quantize_model_params(params: dict, mode: str = "int4",
                          keys: set[str] | None = None,
                          head: bool | str = True) -> dict:
    """Quantize a model's projection leaves in place of their dense ones.
    An untied head is quantized too: int8 for the packed int4 mode (int4
    logit error shifts greedy order), ``mode`` otherwise; ``head=False``
    keeps it dense, a mode string overrides."""
    keys = _QUANT_KEYS if keys is None else keys
    out = dict(params)
    layers = dict(params["layers"])
    for k in list(layers):
        if k in keys and not isinstance(layers[k], dict):
            layers[k] = quantize_weight(layers[k], mode)
    out["layers"] = layers
    if head and isinstance(out.get("lm_head"), torch.Tensor):
        head_mode = head if isinstance(head, str) else (
            "int8" if mode == "int4" else mode)
        out["lm_head"] = quantize_weight(out["lm_head"], head_mode)
    return out
