"""The layer classes (counterpart of ``pygpukit_tpu/llm/layers.py``):
``nn.Module``s over the port's functional ops, for building a model a layer
at a time. The model itself stays functional (``llm/model.py``); these
classes call the same functions (``model._mm`` and its routes,
``flash_attention_fn``, ``sdpa_fixed_cache_fn``, the norms, ``select_moe_fn``),
so a CUDA tensor reaches the same kernels. Weights are module buffers; a
quantized weight is its dict of buffers. Projections are ``[in, out]``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.moe import select_moe_fn
from ..ops.nn import (apply_rope_fn, flash_attention_fn, gelu_fn, layernorm_fn,
                      rmsnorm_fn, rope_tables, sdpa_fixed_cache_fn, swiglu_fn)

_F32 = torch.float32


def precompute_freqs_cis(max_seq: int, head_dim: int, theta: float = 10000.0,
                         device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE cos/sin tables ``[S, D]`` f32 (the HF duplicated-frequency
    layout) on ``device`` (the card unless the caller names one)."""
    return rope_tables(max_seq, head_dim, theta, device=device)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


class Linear(nn.Module):
    """``x @ w + b`` with a dense ``[in, out]`` weight or a quantized leaf
    (int8/fp8 ``{"q", "scale"}``, int4 ``{"q_packed", "scale"}``,
    int4_block ``{"q_packed", "scale_block"}``), through ``model._mm``."""

    def __init__(self, w, b=None):
        super().__init__()
        self._keys = tuple(w) if isinstance(w, dict) else None
        if self._keys is None:
            self.register_buffer("weight", _tensor(w))
        else:
            for k in self._keys:
                self.register_buffer(f"weight_{k}", _tensor(w[k]))
        self.register_buffer("bias", None if b is None else _tensor(b))

    @property
    def w(self):
        if self._keys is None:
            return self.weight
        return {k: getattr(self, f"weight_{k}") for k in self._keys}

    @property
    def b(self):
        return self.bias

    @property
    def quantized(self) -> bool:
        return self._keys is not None

    @property
    def out_features(self) -> int:
        w = self.w
        if not isinstance(w, dict):
            return w.shape[-1]
        if "q_packed" in w and "scale" in w:          # int4: [N, K/2]
            return w["q_packed"].shape[-2]
        return w.get("q", w.get("q_packed")).shape[-1]

    def forward(self, x):
        from .model import _mm
        y = _mm(_tensor(x), self.w)
        return y if self.bias is None else y + self.bias.to(y.dtype)


LinearBF16 = Linear


class LinearFP8(Linear):
    """fp8 storage: a dense weight is quantized (``quantize_weight(w,
    "fp8")``)."""

    def __init__(self, w, b=None):
        if not isinstance(w, dict):
            from .quant import quantize_weight
            w = quantize_weight(_tensor(w), "fp8")
        super().__init__(w, b)


class RMSNorm(nn.Module):
    def __init__(self, weight, eps: float = 1e-5):
        super().__init__()
        self.register_buffer("w", _tensor(weight))
        self.eps = eps

    def forward(self, x):
        return rmsnorm_fn(_tensor(x), self.w, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, weight, bias=None, eps: float = 1e-5):
        super().__init__()
        self.register_buffer("w", _tensor(weight))
        self.register_buffer("b", None if bias is None else _tensor(bias))
        self.eps = eps

    def forward(self, x):
        return layernorm_fn(_tensor(x), self.w, self.b, self.eps)


def Norm(kind: str, weight, bias=None, eps: float = 1e-5) -> nn.Module:
    """``RMSNorm`` for ``"rmsnorm"``, else ``LayerNorm``."""
    if kind == "rmsnorm":
        return RMSNorm(weight, eps)
    return LayerNorm(weight, bias, eps)


class Attention(nn.Module):
    """Causal self-attention with GQA and RoPE, and an optional fixed KV
    cache. Prefill: ``attn(x)`` (``flash_attention_fn``). Decode:
    ``init_fixed_cache``, then ``forward_fixed_cache(x_t, pos)`` (the rows
    written in place, ``sdpa_fixed_cache_fn``)."""

    def __init__(self, w_q: Linear, w_k: Linear, w_v: Linear, w_o: Linear,
                 n_heads: int, n_kv_heads: int | None = None,
                 rope_cos=None, rope_sin=None):
        super().__init__()
        self.q, self.k, self.v, self.o = w_q, w_k, w_v, w_o
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        self.register_buffer("rope_cos", None if rope_cos is None else _tensor(rope_cos))
        self.register_buffer("rope_sin", None if rope_sin is None else _tensor(rope_sin))
        self.register_buffer("k_cache", None)
        self.register_buffer("v_cache", None)
        self.pos = 0

    def _heads(self, x):
        s = x.shape[0]
        q = self.q(x).reshape(s, self.n_heads, -1)
        k = self.k(x).reshape(s, self.n_kv_heads, -1)
        v = self.v(x).reshape(s, self.n_kv_heads, -1)
        return q, k, v

    def forward(self, x):
        x = _tensor(x)
        s = x.shape[0]
        q, k, v = self._heads(x)
        if self.rope_cos is not None:
            q = apply_rope_fn(q, self.rope_cos[:s], self.rope_sin[:s])
            k = apply_rope_fn(k, self.rope_cos[:s], self.rope_sin[:s])
        attn = flash_attention_fn(q, k, v)
        return self.o(attn.reshape(s, -1))

    def init_fixed_cache(self, max_seq_len: int, dtype=torch.bfloat16) -> None:
        """Zeroed caches ``[max_seq_len, Hk, D]`` on the weights' device."""
        d = self.k.out_features // self.n_kv_heads
        dev = next(self.k.buffers()).device
        self.k_cache = torch.zeros((max_seq_len, self.n_kv_heads, d), dtype=dtype, device=dev)
        self.v_cache = torch.zeros((max_seq_len, self.n_kv_heads, d), dtype=dtype, device=dev)
        self.pos = 0

    def forward_fixed_cache(self, x_t, pos: int | None = None):
        """One decode step: x_t ``[1, E]`` -> ``[1, E]``; the row is written
        at ``pos`` (the tracked position unless given; the rope row and the
        write clamp into range, as the reference's dynamic slices do)."""
        pos = self.pos if pos is None else pos
        q, k, v = self._heads(_tensor(x_t))
        if self.rope_cos is not None:
            r = min(max(pos, 0), self.rope_cos.shape[0] - 1)
            q = apply_rope_fn(q, self.rope_cos[r:r + 1], self.rope_sin[r:r + 1])
            k = apply_rope_fn(k, self.rope_cos[r:r + 1], self.rope_sin[r:r + 1])
        at = min(max(pos, 0), self.k_cache.shape[0] - 1)
        self.k_cache[at:at + 1] = k.to(self.k_cache.dtype)
        self.v_cache[at:at + 1] = v.to(self.v_cache.dtype)
        attn = sdpa_fixed_cache_fn(q, self.k_cache, self.v_cache, pos + 1)
        self.pos = pos + 1
        return self.o(attn.reshape(1, -1))


CausalSelfAttention = Attention
LlamaAttention = Attention


class MLP(nn.Module):
    """SwiGLU (``gate``, up ``fc1``, down ``fc2``) or, without ``gate``,
    GELU (``fc1``, ``fc2``)."""

    def __init__(self, fc1: Linear, fc2: Linear, gate: Linear | None = None,
                 activation: str = "silu"):
        super().__init__()
        self.gate = gate
        self.up = fc1
        self.down = fc2
        self.activation = activation

    def forward(self, x):
        x = _tensor(x)
        if self.gate is not None:
            return self.down(swiglu_fn(self.gate(x), self.up(x)))
        return self.down(gelu_fn(self.up(x)))


LlamaMLP = MLP


class MoELayer(nn.Module):
    """Top-k routed expert MLP over expert stacks ``[E, in, out]``; the
    formulation is ``ops.moe.select_moe_fn``'s for the call's rows and
    device."""

    def __init__(self, router: Linear, w_gate, w_up, w_down, top_k: int = 2):
        super().__init__()
        self.router = router
        self.register_buffer("w_gate", _tensor(w_gate))
        self.register_buffer("w_up", _tensor(w_up))
        self.register_buffer("w_down", _tensor(w_down))
        self.top_k = top_k

    def forward(self, x):
        x = _tensor(x)
        logits = self.router(x).to(_F32)
        fn = select_moe_fn(x.shape[0], self.top_k, x.device.type)
        out = fn(x, self.w_gate, self.w_up, self.w_down, logits, self.top_k)
        return out.to(x.dtype)


class TransformerBlock(nn.Module):
    """norm -> attention -> residual -> norm -> MLP -> residual."""

    def __init__(self, attn: Attention, mlp, attn_norm, mlp_norm):
        super().__init__()
        self.attn = attn
        self.mlp = mlp
        self.attn_norm = attn_norm
        self.mlp_norm = mlp_norm

    def forward(self, h):
        h = _tensor(h)
        h = h + self.attn(self.attn_norm(h)).to(h.dtype)
        return h + self.mlp(self.mlp_norm(h)).to(h.dtype)


LlamaBlock = TransformerBlock
