"""Llama-4 and Llama-Guard-4, the dense text model (counterpart of
``pygpukit_tpu/llm/models/llama4.py``, transformers' modeling_llama4).

- Interleaved-pair rope (``ops.nn.apply_rope_interleaved_fn``) on the
  rope layers, followed there by the parameterless QK norm
  (``ops.nn.qk_l2norm_fn`` at ``rms_norm_eps``); NoPE layers
  (``no_rope_layers`` 0) keep raw q and k and take the iRoPE temperature
  (``ops.nn.llama4.sdpa_irope_fn`` at ``attn_scale``; the rope layers call
  it at 0, a temperature of exactly 1).
- Causal attention in f32, GQA by repeat; a SwiGLU MLP at
  ``intermediate_size_mlp``.

The reference decides each layer's rope with ``jnp.where`` over both
attentions because its layer loop is a ``lax.scan``; here the flags come
from the config on the host (the ``use_rope`` leaf must agree), so a layer
computes only the attention it uses, with the same numbers. ``generate``
is the reference's: no KV cache, the whole forward again for every new
token.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ...core.backend import resolve_device
from ...ops.nn import (apply_rope_interleaved_fn, qk_l2norm_fn, rmsnorm_fn, rope_tables,
                       swiglu_fn)
from ...ops.nn.llama4 import sdpa_irope_fn
from ..model import _mm, _slice_layer_params
from ._standalone import head_logits, random_normal

_F32 = torch.float32


@dataclass
class Llama4Config:
    vocab_size: int = 202048
    hidden_size: int = 5120
    intermediate_size: int = 8192
    num_hidden_layers: int = 48
    num_attention_heads: int = 40
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    attn_scale: float = 0.1
    floor_scale: float = 8192.0
    use_qk_norm: bool = True
    max_position_embeddings: int = 8192
    no_rope_layers: list | None = None   # 0 = NoPE at that layer, 1 = RoPE

    @classmethod
    def from_json(cls, path) -> "Llama4Config":
        """A transformers ``config.json``: its ``text_config`` where it has
        one; the dense MLP width is ``intermediate_size_mlp``
        (``intermediate_size`` is the MoE experts')."""
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        tc = data.get("text_config", data)
        return cls(
            vocab_size=tc.get("vocab_size", 202048),
            hidden_size=tc.get("hidden_size", 5120),
            intermediate_size=tc.get("intermediate_size_mlp", tc.get("intermediate_size", 8192)),
            num_hidden_layers=tc.get("num_hidden_layers", 48),
            num_attention_heads=tc.get("num_attention_heads", 40),
            num_key_value_heads=tc.get("num_key_value_heads", 8),
            head_dim=tc.get("head_dim", 128),
            rms_norm_eps=tc.get("rms_norm_eps", 1e-5),
            rope_theta=tc.get("rope_theta", 500000.0),
            attn_scale=tc.get("attn_scale", 0.1),
            floor_scale=tc.get("floor_scale", 8192.0),
            use_qk_norm=tc.get("use_qk_norm", True),
            max_position_embeddings=min(tc.get("max_position_embeddings", 8192), 1 << 20),
            no_rope_layers=tc.get("no_rope_layers"),
        )

    def rope_flags(self) -> list[int]:
        """Each layer's flag: 1 rope, 0 NoPE (every layer ropes when the
        config names none)."""
        return list(self.no_rope_layers or [1] * self.num_hidden_layers)


def _block(cfg: Llama4Config, lp: dict, h, positions, cos, sin, use_rope: bool):
    s = h.shape[0]
    hq, hk, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    x = rmsnorm_fn(h, lp["attn_norm_w"], cfg.rms_norm_eps)
    q = _mm(x, lp["w_q"]).reshape(s, hq, d)
    k = _mm(x, lp["w_k"]).reshape(s, hk, d)
    v = _mm(x, lp["w_v"]).reshape(s, hk, d)
    if use_rope:
        q, k = apply_rope_interleaved_fn(q, cos, sin), apply_rope_interleaved_fn(k, cos, sin)
        if cfg.use_qk_norm:
            q, k = qk_l2norm_fn(q, cfg.rms_norm_eps), qk_l2norm_fn(k, cfg.rms_norm_eps)
    attn = sdpa_irope_fn(q, k, v, positions, cfg.attn_scale if not use_rope else 0.0,
                         cfg.floor_scale)
    h = h + _mm(attn.reshape(s, hq * d), lp["w_o"]).to(h.dtype)
    y = rmsnorm_fn(h, lp["mlp_norm_w"], cfg.rms_norm_eps)
    mlp = _mm(swiglu_fn(_mm(y, lp["w_gate"]), _mm(y, lp["w_up"])), lp["w_down"])
    return h + mlp.to(y.dtype)


def llama4_forward_fn(cfg: Llama4Config, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [S] -> f32 logits [S, V]. Each layer's rope from
    ``cfg.rope_flags()``."""
    s = tokens.shape[0]
    h = p["embed"][tokens.to(torch.long)]
    positions = torch.arange(s, device=h.device)
    cos, sin = p["rope_cos"][:s], p["rope_sin"][:s]
    for i, flag in enumerate(cfg.rope_flags()):
        h = _block(cfg, _slice_layer_params(p["layers"], i), h, positions, cos, sin, flag > 0)
    return head_logits(p, rmsnorm_fn(h, p["final_norm_w"], cfg.rms_norm_eps))


def init_params(cfg: Llama4Config, seed: int = 0, dtype=torch.float32, device=None) -> dict:
    """Random weights from ``seed`` (normal, std 0.02, drawn a slab at a
    time; norms ones, an untied head of None as the reference's) in the
    stacked tree ``from_safetensors`` builds, on ``device`` (the card
    unless named)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    e, n, i_ = cfg.hidden_size, cfg.num_hidden_layers, cfg.intermediate_size
    hq, hk, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def w(*shape):
        return random_normal(shape, g, dtype)

    layers = {"attn_norm_w": torch.ones((n, e), dtype=_F32, device=dev),
              "mlp_norm_w": torch.ones((n, e), dtype=_F32, device=dev),
              "w_q": w(n, e, hq * d), "w_k": w(n, e, hk * d), "w_v": w(n, e, hk * d),
              "w_o": w(n, hq * d, e), "w_gate": w(n, e, i_), "w_up": w(n, e, i_),
              "w_down": w(n, i_, e),
              "use_rope": torch.tensor(cfg.rope_flags(), dtype=torch.int32, device=dev)}
    return {"embed": w(cfg.vocab_size, e), "final_norm_w": torch.ones(e, dtype=_F32, device=dev),
            "lm_head": None, "layers": layers}


class Llama4Model:
    """The Llama-4 text model over a stacked params tree (``init_params``,
    ``from_safetensors``)."""

    def __init__(self, config: Llama4Config, params: dict):
        flags = params["layers"]["use_rope"].reshape(-1).tolist()
        if flags != config.rope_flags():
            raise ValueError(f"the use_rope leaf {flags} is not the config's "
                             f"{config.rope_flags()}")
        self.config = config
        if "rope_cos" not in params:
            params["rope_cos"], params["rope_sin"] = rope_tables(
                config.max_position_embeddings, config.head_dim, config.rope_theta,
                device=params["embed"].device)
        self.params = params

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    @torch.no_grad()
    def forward(self, input_ids) -> torch.Tensor:
        """f32 logits [S, V]."""
        ids = torch.as_tensor(np.asarray(input_ids, np.int64).reshape(-1))
        return llama4_forward_fn(self.config, self.params, ids.to(self.device))

    __call__ = forward

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: int | None = None) -> list[int]:
        """Greedy generation without a cache (the reference's): the whole
        forward again for each new token, its last row's argmax taken."""
        ids = [int(t) for t in np.asarray(input_ids, np.int64).reshape(-1)]
        out = []
        for _ in range(max_new_tokens):
            tok = int(torch.argmax(self.forward(ids)[-1]))
            out.append(tok)
            ids.append(tok)
            if eos_token_id is not None and tok == eos_token_id:
                break
        return out

    @classmethod
    def init_random(cls, config: Llama4Config, seed: int = 0, dtype=torch.float32,
                    device=None) -> "Llama4Model":
        return cls(config, init_params(config, seed, dtype, device))

    @classmethod
    def from_safetensors(cls, model_path, dtype=torch.bfloat16, device=None) -> "Llama4Model":
        """A transformers Llama-4 text checkpoint (names under
        ``language_model.model.`` or ``model.``, the MLP under
        ``feed_forward.`` or ``mlp.``): projections transposed to [in, out]
        in ``dtype``, norms in f32, layers stacked; on ``device`` (the card
        unless named)."""
        from ..safetensors import load_safetensors
        dev = resolve_device(device)
        mp = Path(model_path)
        st = load_safetensors(mp)
        cfg = (Llama4Config.from_json(mp / "config.json") if (mp / "config.json").exists()
               else Llama4Config())
        names = set(st.keys())
        pre = ("language_model.model."
               if any(n.startswith("language_model.") for n in names) else "model.")

        def t(name, transpose=False, dt=dtype):
            a = st.tensor(name).to(device=dev, dtype=dt)
            return a.t().contiguous() if transpose else a

        lps = []
        for i in range(cfg.num_hidden_layers):
            b = f"{pre}layers.{i}"
            mlp = "feed_forward" if f"{b}.feed_forward.gate_proj.weight" in names else "mlp"
            lps.append({
                "attn_norm_w": t(f"{b}.input_layernorm.weight").to(_F32),
                "mlp_norm_w": t(f"{b}.post_attention_layernorm.weight").to(_F32),
                "w_q": t(f"{b}.self_attn.q_proj.weight", True),
                "w_k": t(f"{b}.self_attn.k_proj.weight", True),
                "w_v": t(f"{b}.self_attn.v_proj.weight", True),
                "w_o": t(f"{b}.self_attn.o_proj.weight", True),
                "w_gate": t(f"{b}.{mlp}.gate_proj.weight", True),
                "w_up": t(f"{b}.{mlp}.up_proj.weight", True),
                "w_down": t(f"{b}.{mlp}.down_proj.weight", True)})
        layers = {k: torch.stack([lp[k] for lp in lps]) for k in lps[0]}
        layers["use_rope"] = torch.tensor(cfg.rope_flags(), dtype=torch.int32, device=dev)
        head = next((n for n in ("language_model.lm_head.weight", "lm_head.weight")
                     if n in names), None)
        p = {"embed": t(f"{pre}embed_tokens.weight"),
             "final_norm_w": t(f"{pre}norm.weight").to(_F32),
             "lm_head": t(head, True) if head is not None else None,
             "layers": layers}
        return cls(cfg, p)
