"""CLIP text encoder (counterpart of
``pygpukit_tpu/diffusion/text_encoders/clip.py``): sequence and pooled
embeddings for SD3 and FLUX conditioning, over a Hugging Face
``CLIPTextModel`` / ``CLIPTextModelWithProjection`` checkpoint.

Params: the reference's tree (``tok_embed``, ``pos_embed``, ``final_ln.w``,
stacked ``layers`` ``[L, ...]`` of ``ln1.w``, ``q.w`` ... with projections
``[in, out]``, an optional ``text_projection.w``). ``__call__`` scopes
``ops.precision.f32_matmul_context`` over the params (TF32 off for an f32
encoder).

The MLP's activation follows the checkpoint's ``hidden_act`` as
transformers reads it: "quick_gelu" (CLIP-L's), "gelu" the exact erf form
(OpenCLIP's bigG, SD3's second encoder), "gelu_new" / "gelu_pytorch_tanh"
the tanh form. The reference takes the tanh form for every name but
"quick_gelu" (ROADMAP C.16).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ...core.backend import resolve_device
from ...llm.safetensors import load_safetensors
from ...ops.nn.norm import layernorm_fn
from ...ops.precision import f32_matmul_context
from .._common import attention_heads, dot, layer

_F32 = torch.float32
_ACTS = ("quick_gelu", "gelu", "gelu_new", "gelu_pytorch_tanh", "gelu_fast")


@dataclass
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    eos_token_id: int = 49407
    hidden_act: str = "quick_gelu"

    def __post_init__(self):
        if self.hidden_act not in _ACTS:
            raise NotImplementedError(f"hidden_act {self.hidden_act!r}: the port runs {_ACTS}")

    @classmethod
    def from_hf(cls, hf: dict) -> "CLIPTextConfig":
        tc = hf.get("text_config", hf)
        return cls(
            vocab_size=tc.get("vocab_size", 49408),
            hidden_size=tc.get("hidden_size", 768),
            num_layers=tc.get("num_hidden_layers", 12),
            num_heads=tc.get("num_attention_heads", 12),
            intermediate_size=tc.get("intermediate_size", 3072),
            max_position_embeddings=tc.get("max_position_embeddings", 77),
            eos_token_id=tc.get("eos_token_id", 49407),
            hidden_act=tc.get("hidden_act", "quick_gelu"),
        )


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x, approximate="none" if name == "gelu" else "tanh")


def _block(cfg: CLIPTextConfig, lp: dict, x, causal):
    s = x.shape[0]
    n_heads = cfg.num_heads
    d = cfg.hidden_size // n_heads
    h = layernorm_fn(x, lp["ln1.w"], lp["ln1.b"])
    q, k, v = ((dot(h, lp[f"{nm}.w"]) + lp[f"{nm}.b"]).reshape(s, n_heads, d).transpose(0, 1)
               for nm in "qkv")
    att = attention_heads(q, k, v, mask=causal)
    att = att.transpose(0, 1).reshape(s, -1).to(x.dtype)
    x = x + dot(att, lp["out.w"]) + lp["out.b"]
    h = layernorm_fn(x, lp["ln2.w"], lp["ln2.b"])
    h = _act(cfg.hidden_act, dot(h, lp["fc1.w"]) + lp["fc1.b"])
    return x + dot(h, lp["fc2.w"]) + lp["fc2.b"]


def clip_text_fn(cfg: CLIPTextConfig, p: dict, ids: torch.Tensor, penultimate: bool = False):
    """ids [S] -> (hidden [S, E], pooled [E]).

    ``penultimate=True`` returns the second-to-last layer's hidden states
    (before the final LayerNorm), SD3's and SDXL's conditioning; pooled is
    always the final layer's hidden at the first EOS (transformers' argmax
    over ``ids == eos``), through ``text_projection`` when the checkpoint
    has one. SD3's tokenizers pad with EOS, so the first match is the
    true end."""
    s = ids.shape[0]
    ids = ids.to(torch.int64)
    x = p["tok_embed"][ids] + p["pos_embed"][:s]
    i = torch.arange(s, device=ids.device)
    causal = (i[None, :] > i[:, None])[None]
    layers = p["layers"]
    n = layers["ln1.w"].shape[0]
    hidden_out = None
    for li in range(n):
        if penultimate and li == n - 1:
            hidden_out = x
        x = _block(cfg, layer(layers, li), x, causal)
    x = layernorm_fn(x, p["final_ln.w"], p["final_ln.b"])
    eos_pos = torch.argmin(torch.where(ids == cfg.eos_token_id, i, s))
    pooled = x[eos_pos]
    if "text_projection.w" in p:
        pooled = dot(pooled, p["text_projection.w"])
    return (hidden_out if penultimate else x), pooled


def hf_tensors(params: dict, prefix: str = "text_model.") -> dict:
    """``params`` under their Hugging Face names, projections back to
    [out, in]: what ``from_safetensors`` reads."""
    out = {f"{prefix}embeddings.token_embedding.weight": params["tok_embed"],
           f"{prefix}embeddings.position_embedding.weight": params["pos_embed"],
           f"{prefix}final_layer_norm.weight": params["final_ln.w"],
           f"{prefix}final_layer_norm.bias": params["final_ln.b"]}
    if "text_projection.w" in params:
        out["text_projection.weight"] = params["text_projection.w"].T.contiguous()
    layers = params["layers"]
    for i in range(layers["ln1.w"].shape[0]):
        b = f"{prefix}encoder.layers.{i}"
        for ours, theirs, tr in _layer_leaves():
            t = layers[ours][i]
            out[f"{b}.{theirs}"] = t.T.contiguous() if tr else t
    return out


def _layer_leaves():
    """(our leaf, Hugging Face suffix, transposed) of one layer."""
    for ours, theirs in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
        yield f"{ours}.w", f"{theirs}.weight", False
        yield f"{ours}.b", f"{theirs}.bias", False
    for ours, theirs in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                         ("v", "self_attn.v_proj"), ("out", "self_attn.out_proj"),
                         ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
        yield f"{ours}.w", f"{theirs}.weight", True
        yield f"{ours}.b", f"{theirs}.bias", False


class CLIPTextEncoder:
    """CLIP's text tower on one device (reference: ``CLIPTextEncoder``)."""

    def __init__(self, config: CLIPTextConfig, params: dict):
        self.config = config
        self.params = params
        self.device = params["tok_embed"].device

    def __call__(self, ids, penultimate: bool = False):
        ids = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        with f32_matmul_context(self.params):
            return clip_text_fn(self.config, self.params, ids, penultimate=penultimate)

    @classmethod
    def init_random(cls, config: CLIPTextConfig | None = None, seed: int = 0,
                    device=None, projection: int | None = None) -> "CLIPTextEncoder":
        """Random f32 params on ``device`` (the card unless named) from a
        torch generator seeded with ``seed``: embeddings and projections
        N(0, 0.02^2), LayerNorms (1, 0), biases 0; a ``text_projection`` of
        ``projection`` columns when given."""
        cfg = config or CLIPTextConfig()
        dev = resolve_device(device)
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        e, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev) * 0.02

        def ones(*shape):
            return torch.ones(shape, device=dev)

        def zeros(*shape):
            return torch.zeros(shape, device=dev)
        p = {"tok_embed": rnd(cfg.vocab_size, e), "pos_embed": rnd(cfg.max_position_embeddings, e),
             "final_ln.w": ones(e), "final_ln.b": zeros(e)}
        if projection:
            p["text_projection.w"] = rnd(e, projection)
        shapes = {"fc1": (e, f), "fc2": (f, e)}
        layers = {}
        for ours, _, tr in _layer_leaves():
            name = ours.split(".")[0]
            if ours.startswith("ln"):
                layers[ours] = ones(n, e) if ours.endswith(".w") else zeros(n, e)
            elif tr:
                layers[ours] = rnd(n, *shapes.get(name, (e, e)))
            else:
                layers[ours] = zeros(n, shapes.get(name, (e, e))[1])
        p["layers"] = layers
        return cls(cfg, p)

    @classmethod
    def from_safetensors(cls, path, device=None) -> "CLIPTextEncoder":
        """A Hugging Face CLIP text checkpoint (names with or without
        "text_model.") and its sibling config.json, f32 on ``device`` (the
        card unless named), the layers written into their stacks."""
        dev = resolve_device(device)
        p_dir = Path(path if Path(path).is_dir() else Path(path).parent)
        cj = p_dir / "config.json"
        cfg = CLIPTextConfig.from_hf(json.loads(cj.read_text()) if cj.exists() else {})
        with load_safetensors(path) as st:
            pre = ("text_model." if "text_model.embeddings.token_embedding.weight" in st
                   else "")

            def t(name: str, transposed: bool = False) -> torch.Tensor:
                x = st.tensor(name).to(dev, copy=True).to(_F32)
                return x.T.contiguous() if transposed else x
            p = {"tok_embed": t(f"{pre}embeddings.token_embedding.weight"),
                 "pos_embed": t(f"{pre}embeddings.position_embedding.weight"),
                 "final_ln.w": t(f"{pre}final_layer_norm.weight"),
                 "final_ln.b": t(f"{pre}final_layer_norm.bias")}
            if "text_projection.weight" in st:
                p["text_projection.w"] = t("text_projection.weight", True)
            layers = {}
            for ours, theirs, tr in _layer_leaves():
                first = t(f"{pre}encoder.layers.0.{theirs}", tr)
                buf = torch.empty((cfg.num_layers, *first.shape), dtype=_F32, device=dev)
                buf[0] = first
                for i in range(1, cfg.num_layers):
                    buf[i] = t(f"{pre}encoder.layers.{i}.{theirs}", tr)
                layers[ours] = buf
            p["layers"] = layers
        return cls(cfg, p)
