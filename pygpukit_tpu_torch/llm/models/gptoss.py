"""gpt-oss-20b / gpt-oss-120b: MoE with attention sinks, alternating
sliding and full layers, yarn rope (counterpart of
``pygpukit_tpu/llm/models/gptoss.py``, transformers' modeling_gpt_oss).

- **Attention sinks** (``_sink_softmax``): a learned logit per head joins
  the softmax's denominator as one more column and is dropped after the
  normalization.
- **Windows** (``_attn_windowed``): the per-layer ``attn_window`` leaf
  (an int32 tensor; 0 means full attention), from ``layer_types``.
- **Experts** (``_moe``): the router's softmax over its top-k logits (with
  the router bias); gate and up interleaved in one ``gate_up`` stack
  (``gate = gu[..., 0::2]``) with their biases, the gate clamped above at
  ``swiglu_limit`` and up both ways, ``(up + 1) * gate * sigmoid(alpha *
  gate)``, then down and its bias. The plain version is the reference's
  dense one-hot formula in f32 over every expert (CPU tensors); CUDA
  tensors take ``ops.moe.moe_route``'s rule with this router and
  activation: ``gmm_experts`` (two ``kernels.gmm`` launches, the biases
  and the clamped activation between them, the down bias after) from T *
  k >= 128 rows, ``gather_experts`` up to T 4, the one-hot formula between.
- yarn rope with ``truncate`` as the config says (False in the
  checkpoints).

Decode runs fixed ``[L, MAX, Hk, D]`` caches written in place; positions
are ints or one-element device tensors (as ``deepseek.py``), so the
prefill, the decode chunks and the hybrid engine's programs are captured.
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ...core.backend import resolve_device
from ...core.executable import ExecutableCache
from ...ops.embedding import kv_write
from ...ops.moe import gather_experts, gmm_experts, moe_route, top_k_fn
from ...ops.nn import apply_rope_fn, rmsnorm_fn
from ..model import _last_row, _mm, _slice_layer_params, _table_rows, sample_logits
from ._standalone import generate_chunked, head_logits, random_normal, rope_tables_from

_F32 = torch.float32
_NEG_INF = -1e30


@dataclass
class GptOssConfig:
    vocab_size: int = 201088
    hidden_size: int = 2880
    num_layers: int = 24
    num_heads: int = 64
    num_kv_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 2880
    num_experts: int = 32
    num_experts_per_tok: int = 4
    sliding_window: int = 128
    layer_types: tuple = ()
    rope_theta: float = 150000.0
    rope_scaling: dict | None = None
    norm_eps: float = 1e-5
    max_position_embeddings: int = 131072
    swiglu_alpha: float = 1.702
    swiglu_limit: float = 7.0
    tie_word_embeddings: bool = False

    @classmethod
    def from_hf(cls, hf: dict) -> "GptOssConfig":
        """A transformers ``config.json``; ``layer_types`` alternate
        sliding and full from layer 0 where the file has none."""
        n_layers = hf.get("num_hidden_layers", 24)
        lt = hf.get("layer_types") or [
            "sliding_attention" if i % 2 == 0 else "full_attention" for i in range(n_layers)]
        return cls(
            vocab_size=hf.get("vocab_size", 201088),
            hidden_size=hf.get("hidden_size", 2880),
            num_layers=n_layers,
            num_heads=hf.get("num_attention_heads", 64),
            num_kv_heads=hf.get("num_key_value_heads", 8),
            head_dim=hf.get("head_dim", 64),
            intermediate_size=hf.get("intermediate_size", 2880),
            num_experts=hf.get("num_local_experts", 32),
            num_experts_per_tok=hf.get("num_experts_per_tok", 4),
            sliding_window=hf.get("sliding_window", 128),
            layer_types=tuple(lt),
            rope_theta=hf.get("rope_theta", 150000.0),
            rope_scaling=hf.get("rope_scaling"),
            norm_eps=hf.get("rms_norm_eps", 1e-5),
            max_position_embeddings=hf.get("max_position_embeddings", 131072),
            swiglu_limit=hf.get("swiglu_limit", 7.0),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
        )

    def layer_windows(self) -> list[int]:
        """Each layer's window: ``sliding_window`` on sliding layers, else 0."""
        return [self.sliding_window if t == "sliding_attention" else 0
                for t in self.layer_types]


def _build_rope(cfg: GptOssConfig, device=None):
    """The (cos, sin) tables [max_position_embeddings, head_dim]: yarn
    (``truncate`` as configured) or standard."""
    return rope_tables_from(cfg.rope_scaling, cfg.max_position_embeddings, cfg.head_dim,
                            cfg.rope_theta, device)


def _qkv(cfg: GptOssConfig, lp: dict, x):
    """Biased q, k, v projections of x [T, E], [T, H*, D] in x's dtype."""
    t, d = x.shape[0], cfg.head_dim
    q = (_mm(x, lp["w_q"]) + lp["b_q"]).reshape(t, cfg.num_heads, d)
    k = (_mm(x, lp["w_k"]) + lp["b_k"]).reshape(t, cfg.num_kv_heads, d)
    v = (_mm(x, lp["w_v"]) + lp["b_v"]).reshape(t, cfg.num_kv_heads, d)
    return q, k, v


def _sink_softmax(scores, sinks, mask):
    """scores [H, T, S], sinks [H], mask [.., T, S] -> weights [H, T, S]:
    the sink one more softmax column per head, dropped after the
    normalization."""
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    snk = sinks.to(_F32)[:, None, None]
    m = torch.maximum(torch.amax(scores, -1, keepdim=True), snk)
    e = torch.exp(scores - m)
    return e / (torch.sum(e, -1, keepdim=True) + torch.exp(snk - m))


def _attn_windowed(cfg: GptOssConfig, lp: dict, q, k, v, pos_q, ctx_len):
    """Sink attention of q [T, Hq, D] (positions pos_q..) over k/v [S, Hk,
    D]: keys after the query, at or past ``ctx_len`` and, where the
    layer's ``attn_window`` leaf is above 0, at or before the query's
    position less the window, masked. f32 [T, Hq * D]."""
    t, s = q.shape[0], k.shape[0]
    dev = q.device
    kpos = torch.arange(s, device=dev)[None, :]
    qpos = pos_q + torch.arange(t, device=dev)[:, None]
    base = (kpos <= qpos) & (kpos < ctx_len)
    win = lp["attn_window"]
    wmask = torch.where(win > 0, kpos > qpos - win, torch.ones_like(base))
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = hq // hk
    qh = q.to(_F32).reshape(t, hk, g, d)
    scores = torch.einsum("tkgd,skd->kgts", qh, k.to(_F32)) * (d ** -0.5)
    w = _sink_softmax(scores.reshape(hq, t, s), lp["sinks"], (base & wmask)[None])
    out = torch.einsum("kgts,skd->tkgd", w.reshape(hk, g, t, s), v.to(_F32))
    return out.reshape(t, hq * d)


def _expert_act(cfg: GptOssConfig, lp: dict, dtype):
    """The activation between the two expert products for the gmm and
    gather routes: the gate/up bias by expert, the clamps and the gated
    product, in f32, rounded to ``dtype``."""
    bias = lp["b_experts_gate_up"]

    def act(outs, eids):
        gu = outs[0] + bias[eids].to(_F32)
        gate = torch.clamp(gu[..., 0::2], max=cfg.swiglu_limit)
        up = torch.clamp(gu[..., 1::2], -cfg.swiglu_limit, cfg.swiglu_limit)
        return ((up + 1.0) * (gate * torch.sigmoid(gate * cfg.swiglu_alpha))).to(dtype)
    return act


def _moe(cfg: GptOssConfig, lp: dict, x):
    """The router (softmax over the top-k biased logits) and the clamped
    SwiGLU experts with biases, by the route of the module docstring; in
    x's dtype."""
    logits = (torch.matmul(x.to(_F32), lp["w_router"].to(_F32))
              + lp["b_router"].to(_F32)[None, :])                     # [T, N]
    topv, topi = top_k_fn(logits, cfg.num_experts_per_tok)
    topw = torch.softmax(topv, dim=-1)
    route = moe_route(x.shape[0], cfg.num_experts_per_tok, x.device.type)
    if x.is_cuda and route != "dense":
        experts = gmm_experts if route == "gmm" else gather_experts
        out = experts(x, (lp["w_experts_gate_up"],), lp["w_experts_down"], topw, topi,
                      _expert_act(cfg, lp, x.dtype), down_bias=lp["b_experts_down"])
        return out.to(x.dtype)
    wts = torch.zeros((x.shape[0], cfg.num_experts), dtype=_F32,
                      device=x.device).scatter(1, topi, topw)
    gu = torch.einsum("te,nei->tni", x.to(_F32), lp["w_experts_gate_up"].to(_F32))
    gu = gu + lp["b_experts_gate_up"].to(_F32)[None]
    gate = torch.clamp(gu[..., 0::2], max=cfg.swiglu_limit)
    up = torch.clamp(gu[..., 1::2], -cfg.swiglu_limit, cfg.swiglu_limit)
    act = (up + 1.0) * (gate * torch.sigmoid(gate * cfg.swiglu_alpha))
    yo = torch.einsum("tni,nie->tne", act, lp["w_experts_down"].to(_F32))
    yo = yo + lp["b_experts_down"].to(_F32)[None]
    return torch.einsum("tne,tn->te", yo, wts).to(x.dtype)


def _layer_tail(cfg: GptOssConfig, lp: dict, h, attn):
    o = _mm(attn.to(h.dtype), lp["w_o"]) + lp["b_o"]
    h = h + o.to(h.dtype)
    return h + _moe(cfg, lp, rmsnorm_fn(h, lp["mlp_norm_w"], cfg.norm_eps))


def _head(cfg: GptOssConfig, p: dict, h):
    """f32 logits of h (``_standalone.head_logits``)."""
    return head_logits(p, h)


def _layers(p: dict):
    """(index, views) of each stacked layer."""
    layers = p["layers"]
    for i in range(layers["w_o"].shape[0]):
        yield i, _slice_layer_params(layers, i)


def forward_fn(cfg: GptOssConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [S] -> f32 logits [S, V] (uncached)."""
    s = tokens.shape[0]
    h = p["embed"][tokens.to(torch.long)]
    cos, sin = p["rope_cos"][:s], p["rope_sin"][:s]
    for _, lp in _layers(p):
        q, k, v = _qkv(cfg, lp, rmsnorm_fn(h, lp["attn_norm_w"], cfg.norm_eps))
        q, k = apply_rope_fn(q, cos, sin), apply_rope_fn(k, cos, sin)
        h = _layer_tail(cfg, lp, h, _attn_windowed(cfg, lp, q, k, v, 0, s))
    return _head(cfg, p, rmsnorm_fn(h, p["final_norm_w"], cfg.norm_eps))


def prefill_fn(cfg: GptOssConfig, p: dict, k_cache, v_cache, tokens, true_len):
    """Prefill padded ``tokens`` [S]: rows [0, S) of every layer of the
    caches [L, MAX, Hk, D] written in place; f32 logits [V] of position
    ``true_len - 1``."""
    s = tokens.shape[0]
    h = p["embed"][tokens.to(torch.long)]
    cos, sin = p["rope_cos"][:s], p["rope_sin"][:s]
    for i, lp in _layers(p):
        q, k, v = _qkv(cfg, lp, rmsnorm_fn(h, lp["attn_norm_w"], cfg.norm_eps))
        q, k = apply_rope_fn(q, cos, sin), apply_rope_fn(k, cos, sin)
        kv_write(k_cache, k[None], (i, 0, 0, 0))
        kv_write(v_cache, v[None], (i, 0, 0, 0))
        h = _layer_tail(cfg, lp, h, _attn_windowed(cfg, lp, q, k, v, 0, true_len))
    h = rmsnorm_fn(h, p["final_norm_w"], cfg.norm_eps)
    return _head(cfg, p, _last_row(h, true_len))


def decode_step_fn(cfg: GptOssConfig, p: dict, k_cache, v_cache, token, pos):
    """One decode step: the token's k/v written at ``pos`` of every layer
    (in place), f32 logits [V] of the next position. ``token`` and
    ``pos`` are ints or one-element device tensors."""
    dev = k_cache.device
    h = p["embed"][torch.as_tensor(token, device=dev).reshape(1).to(torch.long)]
    cos, sin = _table_rows(p["rope_cos"], pos, 1), _table_rows(p["rope_sin"], pos, 1)
    for i, lp in _layers(p):
        q, k, v = _qkv(cfg, lp, rmsnorm_fn(h, lp["attn_norm_w"], cfg.norm_eps))
        q, k = apply_rope_fn(q, cos, sin), apply_rope_fn(k, cos, sin)
        kv_write(k_cache, k[None], (i, pos, 0, 0))
        kv_write(v_cache, v[None], (i, pos, 0, 0))
        attn = _attn_windowed(cfg, lp, q, k_cache[i], v_cache[i], pos, pos + 1)
        h = _layer_tail(cfg, lp, h, attn)
    return _head(cfg, p, rmsnorm_fn(h, p["final_norm_w"], cfg.norm_eps)[0])


def generate_scan_fn(cfg: GptOssConfig, n_steps: int, p: dict, k_cache, v_cache, token,
                     pos) -> torch.Tensor:
    """``n_steps`` greedy decode steps; int32 tokens [n_steps] on the device."""
    out, tok = [], token
    for i in range(n_steps):
        tok = sample_logits(decode_step_fn(cfg, p, k_cache, v_cache, tok, pos + i))
        tok = tok.to(torch.int32)
        out.append(tok.reshape(1))
    return torch.cat(out)


def init_params(cfg: GptOssConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None) -> dict:
    """Random weights from ``seed`` (normal, std 0.02, drawn a slab at a
    time; norms ones, sinks and biases small normals) in the tree
    ``from_safetensors`` builds, on ``device`` (the card unless named)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def w(*shape, dt=dtype):
        return random_normal(shape, g, dt)

    n, e, d, ne = cfg.num_layers, cfg.hidden_size, cfg.head_dim, cfg.num_experts
    i_, hq, hk = cfg.intermediate_size, cfg.num_heads, cfg.num_kv_heads
    layers = {
        "attn_norm_w": torch.ones((n, e), dtype=_F32, device=dev),
        "mlp_norm_w": torch.ones((n, e), dtype=_F32, device=dev),
        "w_q": w(n, e, hq * d), "b_q": w(n, hq * d), "w_k": w(n, e, hk * d),
        "b_k": w(n, hk * d), "w_v": w(n, e, hk * d), "b_v": w(n, hk * d),
        "w_o": w(n, hq * d, e), "b_o": w(n, e), "sinks": w(n, hq, dt=_F32),
        "w_router": w(n, e, ne, dt=_F32), "b_router": w(n, ne, dt=_F32),
        "w_experts_gate_up": w(n, ne, e, 2 * i_), "b_experts_gate_up": w(n, ne, 2 * i_),
        "w_experts_down": w(n, ne, i_, e), "b_experts_down": w(n, ne, e),
        "attn_window": torch.tensor(cfg.layer_windows(), dtype=torch.int32, device=dev),
    }
    return {"embed": w(cfg.vocab_size, e), "final_norm_w": torch.ones(e, dtype=_F32, device=dev),
            "lm_head": None if cfg.tie_word_embeddings else w(e, cfg.vocab_size),
            "layers": layers}


class GptOssModel:
    """gpt-oss with cached sink-attention decode over ``k_cache`` /
    ``v_cache`` [L, MAX, Hk, D] in the model's dtype; ``graphs`` holds the
    captured prefills and decode chunks, one shared pool."""

    _name = "gptoss"

    # -- hybrid-engine hooks (llm/serving_hybrid.py): one {"k", "v"} pytree

    @staticmethod
    def _init_caches(cfg: GptOssConfig, max_seq_len: int, dtype=torch.float32,
                     device=None) -> dict:
        shape = (cfg.num_layers, max_seq_len, cfg.num_kv_heads, cfg.head_dim)
        dev = resolve_device(device)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    @staticmethod
    def _prefill_fn(cfg: GptOssConfig, p: dict, caches: dict, tokens, true_len):
        return caches, prefill_fn(cfg, p, caches["k"], caches["v"], tokens, true_len)

    @staticmethod
    def _decode_step_fn(cfg: GptOssConfig, p: dict, caches: dict, token, pos):
        return caches, decode_step_fn(cfg, p, caches["k"], caches["v"], token, pos)

    def __init__(self, config: GptOssConfig, params: dict, dtype=torch.float32):
        self.config = config
        self.dtype = dtype
        if "rope_cos" not in params:
            params["rope_cos"], params["rope_sin"] = _build_rope(config,
                                                                 params["embed"].device)
        self.params = params
        self.k_cache = self.v_cache = None
        self.max_seq_len: int | None = None
        self.pos = 0
        self.graphs = ExecutableCache(shared_pool=True)

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    @torch.no_grad()
    def forward(self, input_ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(input_ids, np.int64).reshape(-1))
        return forward_fn(self.config, self.params, ids.to(self.device))

    def get_logits(self, input_ids) -> np.ndarray:
        return self.forward(input_ids).cpu().numpy().astype(np.float32, copy=False)

    def init_fixed_cache(self, max_seq_len: int) -> None:
        """Zeroed caches of ``max_seq_len`` rows, position 0; the captured
        programs are released."""
        self.graphs.reset()
        caches = self._init_caches(self.config, max_seq_len, self.dtype, self.device)
        self.k_cache, self.v_cache = caches["k"], caches["v"]
        self.max_seq_len = max_seq_len
        self.pos = 0

    def _fixed_caches(self) -> tuple:
        return self.k_cache, self.v_cache

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 chunk_size: int = 64) -> list[int]:
        """Greedy generation (``_standalone.generate_chunked``)."""
        return generate_chunked(self, functools.partial(prefill_fn, self.config),
                                functools.partial(generate_scan_fn, self.config),
                                input_ids, max_new_tokens, chunk_size)

    @classmethod
    def from_safetensors(cls, path, dtype=torch.float32, device=None) -> "GptOssModel":
        """A transformers gpt-oss checkpoint with its experts in ``dtype``
        (stacked ``[N, E, 2I]`` / ``[N, I, E]`` as shipped, so not
        transposed), projections transposed to [in, out], norms, sinks and
        the router in f32; on ``device`` (the card unless named)."""
        from ..safetensors import load_safetensors
        dev = resolve_device(device)
        st = load_safetensors(path)
        cj = Path(path if Path(path).is_dir() else Path(path).parent) / "config.json"
        cfg = GptOssConfig.from_hf(json.loads(cj.read_text()) if cj.exists() else {})

        def t(name, transpose=False, dt=dtype):
            a = st.tensor(name).to(device=dev, dtype=dt)
            return a.t().contiguous() if transpose else a

        lps = []
        for pre in (f"model.layers.{i}." for i in range(cfg.num_layers)):
            lp = {"attn_norm_w": t(pre + "input_layernorm.weight", dt=_F32),
                  "mlp_norm_w": t(pre + "post_attention_layernorm.weight", dt=_F32),
                  "sinks": t(pre + "self_attn.sinks", dt=_F32),
                  "w_router": t(pre + "mlp.router.weight", True, _F32),
                  "b_router": t(pre + "mlp.router.bias", dt=_F32),
                  "w_experts_gate_up": t(pre + "mlp.experts.gate_up_proj"),
                  "b_experts_gate_up": t(pre + "mlp.experts.gate_up_proj_bias"),
                  "w_experts_down": t(pre + "mlp.experts.down_proj"),
                  "b_experts_down": t(pre + "mlp.experts.down_proj_bias")}
            for n in "qkvo":
                lp[f"w_{n}"] = t(pre + f"self_attn.{n}_proj.weight", True)
                lp[f"b_{n}"] = t(pre + f"self_attn.{n}_proj.bias")
            lps.append(lp)
        layers = {k: torch.stack([lp[k] for lp in lps]) for k in lps[0]}
        layers["attn_window"] = torch.tensor(cfg.layer_windows(), dtype=torch.int32,
                                             device=dev)
        p = {"embed": t("model.embed_tokens.weight"),
             "final_norm_w": t("model.norm.weight", dt=_F32),
             "lm_head": t("lm_head.weight", True) if "lm_head.weight" in st else None,
             "layers": layers}
        return cls(cfg, p, dtype=dtype)
