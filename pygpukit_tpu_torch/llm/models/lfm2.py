"""LFM2 (LiquidAI LFM2-350M/700M/1.2B): gated short-conv layers beside
attention layers (counterpart of ``pygpukit_tpu/llm/models/lfm2.py``,
transformers' modeling_lfm2).

- **Gated short conv** (``_conv_mix_full``, ``_conv_mix_step``): in_proj
  -> (B, C, x) thirds, Bx = B * x, a depthwise causal conv over the
  sequence with kernel L_cache (the newest input multiplies the LAST
  column), y = C * conv_out, out_proj. Decode keeps a [E, L_cache] state a
  conv layer, rolled one slot a token.
- **Attention layers** (``layer_types`` "full_attention"): GQA with
  per-head q/k RMS norms, split-half rope, ``out_proj``. The prefill
  attends in f32 within the padded block (``_base.attn_block_causal``);
  decode attends over the fixed [MAX, Hk, D] caches through
  ``ops.nn.attention.sdpa_fixed_cache_fn``, so one bf16 or f32 query row
  on the card launches the ``flash_decode`` kernel.
- **MLP**: w1/w3/w2 SwiGLU; ``block_auto_adjust_ff_dim`` recomputes the
  checkpoint's width (two thirds, the multiplier, ``block_multiple_of``).
- Norms: ``operator_norm`` before the mixer, ``ffn_norm`` before the MLP;
  the final norm is ``embedding_norm`` and runs after the layers.

The caches are a list of per-layer dicts (``init_caches``), written in
place (``_base.StandaloneCachedModel``). The conv state rolls in the
steady state: transformers clamps its decode write to slot L_cache - 1,
which places the state differently only after a prompt shorter than
L_cache - 1 tokens, as the reference notes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.nn.functional as F

from ...core.backend import resolve_device
from ...ops.embedding import kv_write
from ...ops.nn import apply_rope_fn, rmsnorm_fn, rope_tables
from ...ops.nn.attention import sdpa_fixed_cache_fn
from ..model import _table_rows
from ._base import (StandaloneCachedModel, attn_block_causal, causal_depthwise_conv,
                    conv_state_tail, greedy_scan, last_row, lm_head, mm, qk_headnorm)
from ._standalone import random_normal

_F32 = torch.float32


@dataclass
class Lfm2Config:
    vocab_size: int = 65536
    hidden_size: int = 1024
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 4096
    layer_types: tuple = ()
    conv_l_cache: int = 3
    conv_bias: bool = False
    rope_theta: float = 1000000.0
    norm_eps: float = 1e-5
    max_position_embeddings: int = 128000
    tie_word_embeddings: bool = True

    @classmethod
    def from_hf(cls, hf: dict) -> "Lfm2Config":
        """A transformers ``config.json``; under ``block_auto_adjust_ff_dim``
        the MLP width is int(2/3 of it), times ``block_ffn_dim_multiplier``
        where given, rounded up to ``block_multiple_of``."""
        inter = hf.get("intermediate_size", 4096)
        if hf.get("block_auto_adjust_ff_dim", False):
            inter = int(2 * inter / 3)
            mult = hf.get("block_ffn_dim_multiplier")
            if mult is not None:
                inter = int(mult * inter)
            mo = hf.get("block_multiple_of", 256)
            inter = mo * ((inter + mo - 1) // mo)
        n_layers = hf.get("num_hidden_layers", 16)
        heads = hf.get("num_attention_heads", 16)
        hidden = hf.get("hidden_size", 1024)
        return cls(
            vocab_size=hf.get("vocab_size", 65536),
            hidden_size=hidden,
            num_layers=n_layers,
            num_heads=heads,
            num_kv_heads=hf.get("num_key_value_heads", heads),
            head_dim=hf.get("head_dim") or hidden // heads,
            intermediate_size=inter,
            layer_types=tuple(hf.get("layer_types") or ["full_attention"] * n_layers),
            conv_l_cache=hf.get("conv_L_cache", 3),
            conv_bias=hf.get("conv_bias", False),
            rope_theta=hf.get("rope_theta", 1000000.0),
            norm_eps=hf.get("norm_eps", 1e-5),
            max_position_embeddings=hf.get("max_position_embeddings", 128000),
            tie_word_embeddings=hf.get("tie_word_embeddings", True),
        )

    def is_attn(self, layer: int) -> bool:
        return self.layer_types[layer] == "full_attention"


# ----------------------------------------------------------------- blocks --

def _mlp(lp: dict, y: torch.Tensor) -> torch.Tensor:
    gate, up = mm(y, lp["w1"]), mm(y, lp["w3"])
    return mm((F.silu(gate.to(_F32)) * up.to(_F32)).to(y.dtype), lp["w2"])


def _conv_in(lp: dict, x: torch.Tensor):
    bcx = mm(x, lp["w_in"])
    if "b_in" in lp:
        bcx = bcx + lp["b_in"]
    return bcx.chunk(3, dim=-1)


def _conv_out(lp: dict, x: torch.Tensor, c: torch.Tensor, conv: torch.Tensor):
    y = mm((c.to(_F32) * conv).to(x.dtype), lp["w_out"])
    if "b_out" in lp:
        y = y + lp["b_out"]
    return y


def _conv_mix_full(cfg: Lfm2Config, lp: dict, x: torch.Tensor):
    """The gated short conv over a block x [S, E]. Returns (out [S, E],
    Bx [S, E]: the inputs the decode state keeps)."""
    b, c, xx = _conv_in(lp, x)
    bx = b * xx
    return _conv_out(lp, x, c, causal_depthwise_conv(bx, lp["conv_w"], lp.get("conv_b"))), bx


def _conv_mix_step(cfg: Lfm2Config, lp: dict, x: torch.Tensor, state: torch.Tensor):
    """One decode step: x [1, E], state [E, L] -> (out [1, E], state)."""
    b, c, xx = _conv_in(lp, x)
    bx = (b * xx)[0]
    state = torch.cat([state[:, 1:], bx[:, None].to(state.dtype)], dim=-1)
    conv = torch.sum(state.to(_F32) * lp["conv_w"].to(_F32), dim=-1)
    if "conv_b" in lp:
        conv = conv + lp["conv_b"].to(_F32)
    return _conv_out(lp, x, c, conv[None]), state


def _attn_qkv(cfg: Lfm2Config, lp: dict, x: torch.Tensor, cos, sin):
    s = x.shape[0]
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = qk_headnorm(mm(x, lp["w_q"]).reshape(s, hq, d), lp["w_q_norm"], cfg.norm_eps)
    k = qk_headnorm(mm(x, lp["w_k"]).reshape(s, hk, d), lp["w_k_norm"], cfg.norm_eps)
    v = mm(x, lp["w_v"]).reshape(s, hk, d)
    return apply_rope_fn(q, cos, sin), apply_rope_fn(k, cos, sin), v


def _layer_tail(cfg: Lfm2Config, lp: dict, h, mix):
    h = h + mix
    return h + _mlp(lp, rmsnorm_fn(h, lp["ffn_norm_w"], cfg.norm_eps))


# ----------------------------------------------------------------- passes --

def init_caches(cfg: Lfm2Config, max_seq_len: int, dtype=torch.float32, device=None) -> list:
    """The hybrid cache list: {"k", "v"} [MAX, Hk, D] on attention layers,
    {"conv"} [E, L_cache] on conv layers, zeros in ``dtype``."""
    dev = resolve_device(device)
    caches = []
    for i in range(cfg.num_layers):
        if cfg.is_attn(i):
            shape = (max_seq_len, cfg.num_kv_heads, cfg.head_dim)
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                           "v": torch.zeros(shape, dtype=dtype, device=dev)})
        else:
            caches.append({"conv": torch.zeros((cfg.hidden_size, cfg.conv_l_cache),
                                               dtype=dtype, device=dev)})
    return caches


def forward_fn(cfg: Lfm2Config, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [S] -> f32 logits [S, V] (uncached)."""
    s = tokens.shape[0]
    h = p["embed"][tokens.to(torch.long)]
    cos, sin = p["rope_cos"][:s], p["rope_sin"][:s]
    for i, lp in enumerate(p["layers"]):
        x = rmsnorm_fn(h, lp["operator_norm_w"], cfg.norm_eps)
        if cfg.is_attn(i):
            mix = mm(attn_block_causal(*_attn_qkv(cfg, lp, x, cos, sin), s), lp["w_out"])
        else:
            mix, _ = _conv_mix_full(cfg, lp, x)
        h = _layer_tail(cfg, lp, h, mix)
    return lm_head(p, rmsnorm_fn(h, p["final_norm_w"], cfg.norm_eps))


def prefill_fn(cfg: Lfm2Config, p: dict, caches: list, tokens, true_len):
    """Prefill padded ``tokens`` [S]: K/V rows [0, S) and the conv states
    (the last L_cache valid Bx rows, zeros before the prompt) written in
    place. Returns (caches, f32 logits [V] of position ``true_len - 1``)."""
    s = tokens.shape[0]
    h = p["embed"][tokens.to(torch.long)]
    cos, sin = p["rope_cos"][:s], p["rope_sin"][:s]
    for i, (lp, cache) in enumerate(zip(p["layers"], caches)):
        x = rmsnorm_fn(h, lp["operator_norm_w"], cfg.norm_eps)
        if cfg.is_attn(i):
            q, k, v = _attn_qkv(cfg, lp, x, cos, sin)
            kv_write(cache["k"], k, (0, 0, 0))
            kv_write(cache["v"], v, (0, 0, 0))
            mix = mm(attn_block_causal(q, k, v, true_len), lp["w_out"])
        else:
            mix, bx = _conv_mix_full(cfg, lp, x)
            cache["conv"].copy_(conv_state_tail(bx, true_len, cfg.conv_l_cache,
                                                cache["conv"].dtype))
        h = _layer_tail(cfg, lp, h, mix)
    h = rmsnorm_fn(h, p["final_norm_w"], cfg.norm_eps)
    return caches, lm_head(p, last_row(h, true_len))


def decode_step_fn(cfg: Lfm2Config, p: dict, caches: list, token, pos):
    """One decode step at ``pos`` (an int or a one-element int32 device
    tensor): K/V written at ``pos``, the conv states rolled, in place.
    Returns (caches, f32 logits [V])."""
    dev = p["embed"].device
    h = p["embed"][torch.as_tensor(token, device=dev).reshape(1).to(torch.long)]
    cos, sin = _table_rows(p["rope_cos"], pos, 1), _table_rows(p["rope_sin"], pos, 1)
    for i, (lp, cache) in enumerate(zip(p["layers"], caches)):
        x = rmsnorm_fn(h, lp["operator_norm_w"], cfg.norm_eps)
        if cfg.is_attn(i):
            q, k, v = _attn_qkv(cfg, lp, x, cos, sin)
            kv_write(cache["k"], k, (pos, 0, 0))
            kv_write(cache["v"], v, (pos, 0, 0))
            attn = sdpa_fixed_cache_fn(q, cache["k"], cache["v"], pos + 1)
            mix = mm(attn.reshape(1, -1), lp["w_out"])
        else:
            mix, state = _conv_mix_step(cfg, lp, x, cache["conv"])
            cache["conv"].copy_(state)
        h = _layer_tail(cfg, lp, h, mix)
    return caches, lm_head(p, rmsnorm_fn(h, p["final_norm_w"], cfg.norm_eps)[0])


def generate_scan_fn(cfg: Lfm2Config, n_steps: int, p: dict, caches: list, token,
                     pos) -> torch.Tensor:
    """``n_steps`` greedy decode steps; int32 tokens [n_steps]."""
    return greedy_scan(decode_step_fn, cfg, n_steps, p, caches, token, pos)


def init_params(cfg: Lfm2Config, seed: int = 0, dtype=torch.bfloat16, device=None) -> dict:
    """Random weights from ``seed`` (normal, std 0.02, drawn a slab at a
    time; norms ones) in the tree ``from_safetensors`` builds, on
    ``device`` (the card unless named); the rope tables are the model's."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    e, d, hq, hk = cfg.hidden_size, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads

    def w(*shape, dt=dtype):
        return random_normal(shape, g, dt)

    def ones(n):
        return torch.ones(n, dtype=_F32, device=dev)

    layers = []
    for i in range(cfg.num_layers):
        lp = {"operator_norm_w": ones(e), "ffn_norm_w": ones(e),
              "w1": w(e, cfg.intermediate_size), "w3": w(e, cfg.intermediate_size),
              "w2": w(cfg.intermediate_size, e)}
        if cfg.is_attn(i):
            lp.update(w_q=w(e, hq * d), w_k=w(e, hk * d), w_v=w(e, hk * d), w_out=w(hq * d, e),
                      w_q_norm=ones(d), w_k_norm=ones(d))
        else:
            lp.update(conv_w=w(e, cfg.conv_l_cache), w_in=w(e, 3 * e), w_out=w(e, e))
            if cfg.conv_bias:
                lp.update(conv_b=w(e), b_in=w(3 * e), b_out=w(e))
        layers.append(lp)
    return {"embed": w(cfg.vocab_size, e), "final_norm_w": ones(e),
            "lm_head": None if cfg.tie_word_embeddings else w(e, cfg.vocab_size),
            "layers": layers}


class Lfm2Model(StandaloneCachedModel):
    """LFM2 with its hybrid cache (``_base.StandaloneCachedModel``)."""

    _prefill_fn = staticmethod(prefill_fn)
    _generate_scan_fn = staticmethod(generate_scan_fn)
    _forward_fn = staticmethod(forward_fn)
    _init_caches = staticmethod(init_caches)
    _decode_step_fn = staticmethod(decode_step_fn)
    _name = "lfm2"

    def __init__(self, config: Lfm2Config, params: dict, dtype=torch.float32):
        self.config = config
        self.dtype = dtype
        if "rope_cos" not in params:
            params["rope_cos"], params["rope_sin"] = rope_tables(
                config.max_position_embeddings, config.head_dim, config.rope_theta,
                device=params["embed"].device)
        self.params = params
        self._setup()

    @classmethod
    def from_safetensors(cls, path, dtype=torch.float32, device=None) -> "Lfm2Model":
        """A transformers LFM2 checkpoint: projections transposed to [in,
        out] in ``dtype``, norms in f32, the conv [E, 1, L] as [E, L]; on
        ``device`` (the card unless named)."""
        from ..safetensors import load_safetensors
        dev = resolve_device(device)
        st = load_safetensors(path)
        cj = Path(path if Path(path).is_dir() else Path(path).parent) / "config.json"
        cfg = Lfm2Config.from_hf(json.loads(cj.read_text()) if cj.exists() else {})

        def t(name, transpose=False, dt=dtype):
            a = st.tensor(name).to(device=dev, dtype=dt)
            return a.t().contiguous() if transpose else a

        lps = []
        for i in range(cfg.num_layers):
            pre = f"model.layers.{i}."
            lp = {"operator_norm_w": t(pre + "operator_norm.weight", dt=_F32),
                  "ffn_norm_w": t(pre + "ffn_norm.weight", dt=_F32)}
            for n in ("w1", "w3", "w2"):
                lp[n] = t(pre + f"feed_forward.{n}.weight", True)
            if cfg.is_attn(i):
                a = pre + "self_attn."
                lp.update(w_q=t(a + "q_proj.weight", True), w_k=t(a + "k_proj.weight", True),
                          w_v=t(a + "v_proj.weight", True),
                          w_out=t(a + "out_proj.weight", True),
                          w_q_norm=t(a + "q_layernorm.weight", dt=_F32),
                          w_k_norm=t(a + "k_layernorm.weight", dt=_F32))
            else:
                lp.update(conv_w=t(pre + "conv.conv.weight")[:, 0, :].contiguous(),
                          w_in=t(pre + "conv.in_proj.weight", True),
                          w_out=t(pre + "conv.out_proj.weight", True))
                if cfg.conv_bias:
                    lp.update(conv_b=t(pre + "conv.conv.bias"),
                              b_in=t(pre + "conv.in_proj.bias"),
                              b_out=t(pre + "conv.out_proj.bias"))
            lps.append(lp)
        p = {"embed": t("model.embed_tokens.weight"),
             "final_norm_w": t("model.embedding_norm.weight", dt=_F32),
             "lm_head": (t("lm_head.weight", True)
                         if "lm_head.weight" in st and not cfg.tie_word_embeddings else None),
             "layers": lps}
        return cls(cfg, p, dtype=dtype)
