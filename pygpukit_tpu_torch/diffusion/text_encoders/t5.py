"""T5 encoder (counterpart of ``pygpukit_tpu/diffusion/text_encoders/t5.py``):
FLUX's and SD3's T5-XXL conditioning, from single or sharded
(``model.safetensors.index.json``) checkpoints.

T5's specifics: RMSNorm without bias, the bidirectional relative position
buckets (integers, the reference's bits), layer 0's bias table shared by
every layer, gated-GELU (tanh form, T5's "gelu_new") or ReLU feed-forward,
and no 1/sqrt(d) on the scores (T5 folds the scale into its weights).
Params: the reference's tree (``tok_embed``, ``rel_bias``, ``final_ln.w``,
stacked ``layers`` of ``ln1.w``, ``q.w`` ..., ``wi0.w``, ``wi1.w``,
``wo.w``, projections ``[in, out]``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ...core.backend import resolve_device
from ...core.numerics import true_div
from ...llm.models._standalone import random_normal
from ...llm.safetensors import load_safetensors
from ...ops.precision import f32_matmul_context
from .._common import attention_heads, dot, gelu_tanh, layer

_F32 = torch.float32


@dataclass
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 1024
    num_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"

    @classmethod
    def from_hf(cls, hf: dict) -> "T5Config":
        return cls(
            vocab_size=hf.get("vocab_size", 32128),
            d_model=hf.get("d_model", 512),
            d_kv=hf.get("d_kv", 64),
            d_ff=hf.get("d_ff", 1024),
            num_layers=hf.get("num_layers", 6),
            num_heads=hf.get("num_heads", 8),
            relative_attention_num_buckets=hf.get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=hf.get("relative_attention_max_distance", 128),
            layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-6),
            feed_forward_proj=hf.get("feed_forward_proj", "gated-gelu"),
        )


def t5_rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(_F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(_F32)).to(x.dtype)


def _relative_buckets(rel_pos: torch.Tensor, num_buckets: int,
                      max_distance: int) -> torch.Tensor:
    """Bidirectional T5 relative-position buckets (int64), the reference's
    f32 steps: n / max_exact as an IEEE division, + 1e-9, log, / the f32
    log(max_distance / max_exact), x the large buckets, truncated."""
    num_buckets //= 2
    ret = torch.where(rel_pos > 0, num_buckets, 0)
    n = torch.abs(rel_pos)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    ratio = true_div(n.to(_F32), float(max_exact)) + 1e-9
    denom = torch.full_like(ratio, np.float32(np.log(max_distance / max_exact)))
    val_large = max_exact + (torch.log(ratio) / denom * (num_buckets - max_exact)).to(torch.int32)
    val_large = torch.clamp_max(val_large, num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


def t5_encoder_fn(cfg: T5Config, p: dict, ids: torch.Tensor) -> torch.Tensor:
    """ids [S] -> hidden [S, d_model]."""
    s = ids.shape[0]
    x = p["tok_embed"][ids.to(torch.int64)]
    pos = torch.arange(s, device=ids.device)
    buckets = _relative_buckets(pos[None, :] - pos[:, None],
                                cfg.relative_attention_num_buckets,
                                cfg.relative_attention_max_distance)
    pos_bias = p["rel_bias"][buckets].permute(2, 0, 1).to(_F32)     # [H, S, S]
    h_heads, dk = cfg.num_heads, cfg.d_kv
    layers = p["layers"]
    for li in range(layers["ln1.w"].shape[0]):
        lp = layer(layers, li)
        h = t5_rmsnorm(x, lp["ln1.w"], cfg.layer_norm_epsilon)
        q, k, v = (dot(h, lp[f"{nm}.w"]).reshape(s, h_heads, dk).transpose(0, 1)
                   for nm in "qkv")
        att = attention_heads(q, k, v, scale=False, bias=pos_bias)
        att = att.transpose(0, 1).reshape(s, -1).to(x.dtype)
        x = x + dot(att, lp["o.w"])
        h = t5_rmsnorm(x, lp["ln2.w"], cfg.layer_norm_epsilon)
        if "wi1.w" in lp:                                        # gated gelu
            ff = dot(gelu_tanh(dot(h, lp["wi0.w"])) * dot(h, lp["wi1.w"]), lp["wo.w"])
        else:
            ff = dot(F.relu(dot(h, lp["wi0.w"])), lp["wo.w"])
        x = x + ff
    return t5_rmsnorm(x, p["final_ln.w"], cfg.layer_norm_epsilon)


def _layer_leaves(gated: bool):
    """(our leaf, Hugging Face suffix under ``block.{i}.``, transposed)."""
    yield "ln1.w", "layer.0.layer_norm.weight", False
    yield "ln2.w", "layer.1.layer_norm.weight", False
    for nm in "qkvo":
        yield f"{nm}.w", f"layer.0.SelfAttention.{nm}.weight", True
    yield "wo.w", "layer.1.DenseReluDense.wo.weight", True
    if gated:
        yield "wi0.w", "layer.1.DenseReluDense.wi_0.weight", True
        yield "wi1.w", "layer.1.DenseReluDense.wi_1.weight", True
    else:
        yield "wi0.w", "layer.1.DenseReluDense.wi.weight", True


def hf_tensors(params: dict, cfg: T5Config, prefix: str = "encoder.") -> dict:
    """``params`` under their Hugging Face T5EncoderModel names,
    projections back to [out, in]: what ``from_safetensors`` reads."""
    out = {"shared.weight": params["tok_embed"],
           f"{prefix}final_layer_norm.weight": params["final_ln.w"],
           f"{prefix}block.0.layer.0.SelfAttention.relative_attention_bias.weight":
               params["rel_bias"]}
    layers = params["layers"]
    for i in range(layers["ln1.w"].shape[0]):
        for ours, theirs, tr in _layer_leaves("gated" in cfg.feed_forward_proj):
            t = layers[ours][i]
            out[f"{prefix}block.{i}.{theirs}"] = t.T.contiguous() if tr else t
    return out


class T5Encoder:
    """T5's encoder on one device (reference: ``T5Encoder``)."""

    def __init__(self, config: T5Config, params: dict):
        self.config = config
        self.params = params
        self.device = params["tok_embed"].device

    def __call__(self, ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        with f32_matmul_context(self.params):
            return t5_encoder_fn(self.config, self.params, ids)

    @classmethod
    def init_random(cls, config: T5Config | None = None, seed: int = 0, dtype=_F32,
                    device=None) -> "T5Encoder":
        """Random params on ``device`` (the card unless named) from a torch
        generator seeded with ``seed``: the embedding N(0, 1), projections
        N(0, 1 / in), the bias table N(0, 0.1^2), norms 1."""
        cfg = config or T5Config()
        dev = resolve_device(device)
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        e, inner, f, n = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff, cfg.num_layers
        shapes = {"q.w": (e, inner), "k.w": (e, inner), "v.w": (e, inner), "o.w": (inner, e),
                  "wi0.w": (e, f), "wi1.w": (e, f), "wo.w": (f, e)}

        def rnd(shape, std):
            return random_normal(shape, g, dtype, std)
        p = {"tok_embed": rnd((cfg.vocab_size, e), 1.0),
             "rel_bias": rnd((cfg.relative_attention_num_buckets, cfg.num_heads), 0.1),
             "final_ln.w": torch.ones(e, dtype=dtype, device=dev)}
        layers = {}
        for ours, _, tr in _layer_leaves("gated" in cfg.feed_forward_proj):
            if tr:
                layers[ours] = rnd((n, *shapes[ours]), shapes[ours][0] ** -0.5)
            else:
                layers[ours] = torch.ones((n, e), dtype=dtype, device=dev)
        p["layers"] = layers
        return cls(cfg, p)

    @classmethod
    def from_safetensors(cls, path, dtype=_F32, device=None) -> "T5Encoder":
        """A Hugging Face T5 checkpoint, single or sharded, names with or
        without "encoder.", and its sibling config.json, in ``dtype`` (f32
        by default) on ``device`` (the card unless named)."""
        dev = resolve_device(device)
        p_dir = Path(path if Path(path).is_dir() else Path(path).parent)
        cj = p_dir / "config.json"
        cfg = T5Config.from_hf(json.loads(cj.read_text()) if cj.exists() else {})
        with load_safetensors(path) as st:
            pre = ("encoder." if "encoder.block.0.layer.0.SelfAttention.q.weight" in st
                   else "")

            def t(name: str, transposed: bool = False) -> torch.Tensor:
                x = st.tensor(name).to(dev, copy=True).to(dtype)
                return x.T.contiguous() if transposed else x
            emb = "shared.weight" if "shared.weight" in st else f"{pre}embed_tokens.weight"
            p = {"tok_embed": t(emb), "final_ln.w": t(f"{pre}final_layer_norm.weight"),
                 "rel_bias": t(f"{pre}block.0.layer.0.SelfAttention."
                               "relative_attention_bias.weight")}
            layers = {}
            for ours, theirs, tr in _layer_leaves("gated" in cfg.feed_forward_proj):
                first = t(f"{pre}block.0.{theirs}", tr)
                buf = torch.empty((cfg.num_layers, *first.shape), dtype=dtype, device=dev)
                buf[0] = first
                for i in range(1, cfg.num_layers):
                    buf[i] = t(f"{pre}block.{i}.{theirs}", tr)
                layers[ours] = buf
            p["layers"] = layers
        return cls(cfg, p)
