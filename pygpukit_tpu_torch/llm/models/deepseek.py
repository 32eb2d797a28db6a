"""DeepSeek-V3/R1 and DeepSeek-V2/V2-Lite: Multi-head Latent Attention and
MoE (counterpart of ``pygpukit_tpu/llm/models/deepseek.py``).

- **MLA.** The query is low-rank (``w_qa``, its norm, ``w_qb``) or plain
  (``w_q``, V2-Lite); the keys and values come from one normed latent
  ``c_kv`` [kv_lora_rank] and a rope key [qk_rope_head_dim] shared by the
  heads (``_mla_qkv``). The forward and the prefill expand the latent to
  per-head K/V (``_mla_attn_naive``, transformers' formulation); the
  caches hold only the compressed ``[L, MAX, kv_lora_rank]`` latent and
  the ``[L, MAX, qk_rope_head_dim]`` rope keys, and decode runs the
  absorbed form off them (``_mla_attn_absorbed``): the query projected
  into latent space through ``w_uk`` and the output out of it through
  ``w_uv``, both views of ``w_kvb``; no per-head K/V is made.
- **Layers** come in two stacked groups, the dense prefix
  (``dense_layers``, the first ``first_k_dense``) and the MoE group
  (``moe_layers``), each ``[L_group, ...]`` leaves; a layer is a view.
- **Routers** (``_router``): ``noaux_tc`` (V3/R1: sigmoid scores, the
  correction bias for selection only, groups ranked by their top-2 sum,
  weights from the scores before the bias, normalized, times
  ``routed_scaling_factor``), ``greedy`` and ``group_limited_greedy``
  (V2: softmax scores, plain or group-max top-k, never normalized, as
  transformers' V2 gate). Ties take ``lax.top_k``'s order
  (``ops.moe.top_k_fn``).
- **Routed experts** (``ops.moe.routed_experts``). The plain version is
  the reference's dense one-hot formula in f32 over every expert
  (``_experts_plain``): the route of CPU tensors. CUDA tensors take
  ``ops.moe.moe_route``'s rule (Mixtral's) with this router and the SiLU
  product: ``ops.moe.gmm_experts`` (three ``kernels.gmm`` launches) from
  T * k >= 128 rows, ``gather_experts`` up to T 4, the one-hot formula
  between (and under ``PYGPUKIT_MOE=dense``).
  Shared experts are a dense MLP beside them.

Positions (``pos``, ``true_len``) are host ints or one-element int32
tensors on the caches' device (rope rows gathered, rows written by an
index copy, masks against the tensor: nothing is read on the host), so
the model captures its prefill and its decode chunks (``core.capture``)
and the hybrid engine (``llm/serving_hybrid.py``) its admission and chunk
programs. The model's tensors live on the card unless a device is named.
"""

from __future__ import annotations

import functools
import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ...core.backend import resolve_device
from ...core.executable import ExecutableCache
from ...ops.embedding import kv_write
from ...ops.moe import routed_experts, top_k_fn
from ...ops.nn import apply_rope_fn, apply_rope_interleaved_fn, rmsnorm_fn
from ..model import _last_row, _mm, _slice_layer_params, _table_rows, sample_logits
from ._standalone import generate_chunked, head_logits, random_normal, rope_tables_from

_F32 = torch.float32
_NEG_INF = -1e30


@dataclass
class DeepseekV3Config:
    vocab_size: int = 129280
    hidden_size: int = 7168
    num_layers: int = 61
    num_heads: int = 128
    q_lora_rank: int | None = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 18432
    moe_intermediate_size: int = 2048
    n_routed_experts: int = 256
    n_shared_experts: int = 1
    num_experts_per_tok: int = 8
    n_group: int = 8
    topk_group: int = 4
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.5
    first_k_dense: int = 3
    # "noaux_tc" (V3/R1), "greedy" (V2-Lite) or "group_limited_greedy" (V2)
    router_mode: str = "noaux_tc"
    rope_theta: float = 10000.0
    rope_interleave: bool = True
    rope_scaling: dict | None = None
    norm_eps: float = 1e-6
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def attn_scale(self) -> float:
        """qk_head_dim^-0.5, times the yarn mscale squared when the
        scaling names ``mscale_all_dim`` and a factor above 1."""
        s = self.qk_head_dim ** -0.5
        if self.rope_scaling:
            m_all = self.rope_scaling.get("mscale_all_dim", 0)
            factor = self.rope_scaling.get("factor", 1.0)
            if m_all and factor > 1.0:
                ms = 0.1 * m_all * math.log(factor) + 1.0
                s = s * ms * ms
        return s

    @classmethod
    def from_hf(cls, hf: dict) -> "DeepseekV3Config":
        """A transformers ``config.json`` (model_type deepseek_v3 or
        deepseek_v2; V2's defaults where the file omits a key)."""
        v2 = hf.get("model_type") == "deepseek_v2"
        return cls(
            vocab_size=hf.get("vocab_size", 129280),
            hidden_size=hf.get("hidden_size", 7168),
            num_layers=hf.get("num_hidden_layers", 61),
            num_heads=hf.get("num_attention_heads", 128),
            q_lora_rank=hf.get("q_lora_rank"),
            kv_lora_rank=hf.get("kv_lora_rank", 512),
            qk_nope_head_dim=hf.get("qk_nope_head_dim", 128),
            qk_rope_head_dim=hf.get("qk_rope_head_dim", 64),
            v_head_dim=hf.get("v_head_dim", 128),
            intermediate_size=hf.get("intermediate_size", 18432),
            moe_intermediate_size=hf.get("moe_intermediate_size", 2048),
            n_routed_experts=hf.get("n_routed_experts", 256),
            n_shared_experts=hf.get("n_shared_experts", 1),
            num_experts_per_tok=hf.get("num_experts_per_tok", 8),
            n_group=hf.get("n_group", 8),
            topk_group=hf.get("topk_group", 4),
            norm_topk_prob=hf.get("norm_topk_prob", not v2),
            routed_scaling_factor=hf.get("routed_scaling_factor", 1.0 if v2 else 2.5),
            first_k_dense=hf.get("first_k_dense_replace", 0 if v2 else 3),
            router_mode=hf.get("topk_method", "greedy" if v2 else "noaux_tc"),
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_interleave=hf.get("rope_interleave", True),
            rope_scaling=hf.get("rope_scaling"),
            norm_eps=hf.get("rms_norm_eps", 1e-6),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
        )


def rope_tables_for(cfg: DeepseekV3Config, device=None):
    """The (cos, sin) tables [max_position_embeddings, qk_rope_head_dim]:
    yarn (its attention factor on the tables, the softmax's mscale^2 in
    ``attn_scale``, as transformers splits them) or standard."""
    return rope_tables_from(cfg.rope_scaling, cfg.max_position_embeddings,
                            cfg.qk_rope_head_dim, cfg.rope_theta, device)


def _rope(cfg: DeepseekV3Config, x, cos, sin):
    fn = apply_rope_interleaved_fn if cfg.rope_interleave else apply_rope_fn
    return fn(x, cos, sin)


def _mla_qkv(cfg: DeepseekV3Config, lp: dict, x, cos, sin):
    """x [T, E] -> q_nope [T, H, dn], q_pe [T, H, dr] (roped), c_kv [T, c]
    (the normed latent), k_pe [T, dr] (the roped shared key)."""
    t = x.shape[0]
    hq, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if "w_qa" in lp:
        qa = rmsnorm_fn(_mm(x, lp["w_qa"]), lp["w_qa_norm"], cfg.norm_eps)
        q = _mm(qa, lp["w_qb"]).reshape(t, hq, dn + dr)
    else:
        q = _mm(x, lp["w_q"]).reshape(t, hq, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = _mm(x, lp["w_kva"])                                 # [T, c + dr]
    c_kv = rmsnorm_fn(ckv[:, :cfg.kv_lora_rank], lp["w_kva_norm"], cfg.norm_eps)
    k_pe = ckv[:, cfg.kv_lora_rank:]
    q_pe = _rope(cfg, q_pe, cos, sin)
    k_pe = _rope(cfg, k_pe[:, None, :], cos, sin)[:, 0, :]
    return q_nope, q_pe, c_kv, k_pe


def _mla_attn_naive(cfg: DeepseekV3Config, lp: dict, q_nope, q_pe, c_kv, k_pe, true_len):
    """Prefill attention: the latent expanded to per-head K/V, f32 scores
    over the nope and rope parts, causal and past ``true_len`` masked.
    f32 [T, H * dv]."""
    t = q_nope.shape[0]
    hq, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    kv = _mm(c_kv, lp["w_kvb"]).reshape(t, hq, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    s_nope = torch.einsum("thd,shd->hts", q_nope.to(_F32), k_nope.to(_F32))
    s_rope = torch.einsum("thd,sd->hts", q_pe.to(_F32), k_pe.to(_F32))
    scores = (s_nope + s_rope) * cfg.attn_scale
    idx = torch.arange(t, device=q_nope.device)
    mask = (idx[:, None] >= idx[None, :]) & (idx[None, :] < true_len)
    scores = torch.where(mask[None], scores, torch.full_like(scores, _NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("hts,shd->thd", p, v.to(_F32))
    return out.reshape(t, hq * dv)


def _mla_attn_absorbed(cfg: DeepseekV3Config, lp: dict, q_nope, q_pe, ckv_cache,
                       kpe_cache, ctx_len):
    """Decode attention straight off the compressed caches ckv [MAX, c] and
    kpe [MAX, dr] for q_* [1, H, *]: ``w_kvb`` [c, H * (dn + dv)] viewed as
    w_uk [c, H, dn] (absorbed into the query) and w_uv [c, H, dv] (into the
    output); rows at and past ``ctx_len`` masked. f32 [1, H * dv]."""
    hq, dn, dv, c = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    wkvb = lp["w_kvb"].reshape(c, hq, dn + dv)
    w_uk, w_uv = wkvb[..., :dn], wkvb[..., dn:]
    q_lat = torch.einsum("hd,chd->hc", q_nope[0].to(_F32), w_uk.to(_F32))
    ckv = ckv_cache.to(_F32)
    s_lat = torch.einsum("hc,sc->hs", q_lat, ckv)
    s_pe = torch.einsum("hd,sd->hs", q_pe[0].to(_F32), kpe_cache.to(_F32))
    scores = (s_lat + s_pe) * cfg.attn_scale
    live = torch.arange(ckv_cache.shape[0], device=ckv.device) < ctx_len
    scores = torch.where(live[None], scores, torch.full_like(scores, _NEG_INF))
    p = torch.softmax(scores, dim=-1)
    attn_lat = torch.einsum("hs,sc->hc", p, ckv)
    out = torch.einsum("hc,chd->hd", attn_lat, w_uv.to(_F32))
    return out.reshape(1, hq * dv)


def _silu(g: torch.Tensor) -> torch.Tensor:
    return g * torch.sigmoid(g)


def _dense_mlp(lp: dict, x):
    """SwiGLU in x's dtype: ``(silu(g) in f32 rounded) * u``, then down."""
    g, u = _mm(x, lp["w_gate"]), _mm(x, lp["w_up"])
    return _mm(_silu(g.to(_F32)).to(x.dtype) * u, lp["w_down"])


def _group_mask(sel_scores, per: int, topk_group: int):
    """Boolean [T, N] mask of the experts inside the ``topk_group`` groups
    that rank highest by ``sel_scores`` [T, G]."""
    _, gidx = top_k_fn(sel_scores, topk_group)
    gmask = torch.zeros(sel_scores.shape, dtype=torch.bool,
                        device=sel_scores.device).scatter(1, gidx, True)
    return gmask.repeat_interleave(per, dim=-1)


def _router(cfg: DeepseekV3Config, lp: dict, x):
    """The routing of x [T, E]: (weights f32 [T, k], expert ids [T, k]),
    the router logits a full f32 product (module docstring)."""
    t, n = x.shape[0], cfg.n_routed_experts
    logits = torch.matmul(x.to(_F32), lp["w_router"].to(_F32))          # [T, N]
    if cfg.router_mode == "noaux_tc":
        g = cfg.n_group
        per = n // g
        scores = torch.sigmoid(logits)
        sfc = scores + lp["b_router"].to(_F32)[None, :]
        top2, _ = top_k_fn(sfc.reshape(t, g, per), min(2, per))
        emask = _group_mask(top2.sum(-1), per, cfg.topk_group)
        masked = torch.where(emask, sfc, torch.zeros_like(sfc))
        _, eidx = top_k_fn(masked, cfg.num_experts_per_tok)
        w = torch.gather(scores, -1, eidx)                             # before the bias
    else:
        scores = torch.softmax(logits, dim=-1)
        if cfg.router_mode == "group_limited_greedy":
            g = cfg.n_group
            per = n // g
            gmax = scores.reshape(t, g, per).amax(-1)
            emask = _group_mask(gmax, per, cfg.topk_group)
            masked = torch.where(emask, scores, torch.zeros_like(scores))
        else:
            masked = scores
        w, eidx = top_k_fn(masked, cfg.num_experts_per_tok)
    # transformers' V2 gate never normalizes (its flag is stored, unused)
    if cfg.norm_topk_prob and cfg.router_mode == "noaux_tc":
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * cfg.routed_scaling_factor, eidx


def _experts_plain(lp: dict, x, w, eidx):
    """The reference's dense one-hot formula: every expert over every
    token in f32, combined by the one-hot weights. f32 [T, E]."""
    n = lp["w_experts_gate"].shape[0]
    dense = torch.zeros((x.shape[0], n), dtype=_F32, device=x.device).scatter(1, eidx, w)
    xf = x.to(_F32)
    xg = torch.einsum("te,nei->tni", xf, lp["w_experts_gate"].to(_F32))
    xu = torch.einsum("te,nei->tni", xf, lp["w_experts_up"].to(_F32))
    yo = torch.einsum("tni,nie->tne", _silu(xg) * xu, lp["w_experts_down"].to(_F32))
    return torch.einsum("tne,tn->te", yo, dense)


def _moe_mlp(cfg: DeepseekV3Config, lp: dict, x):
    """Routed experts plus the shared experts, in x's dtype."""
    w, eidx = _router(cfg, lp, x)
    routed = routed_experts(x, (lp["w_experts_gate"], lp["w_experts_up"]),
                            lp["w_experts_down"], w, eidx,
                            lambda outs, _: _silu(outs[0]).mul_(outs[1]).to(x.dtype),
                            functools.partial(_experts_plain, lp))
    shared = _dense_mlp({"w_gate": lp["w_shared_gate"], "w_up": lp["w_shared_up"],
                         "w_down": lp["w_shared_down"]}, x)
    return routed.to(x.dtype) + shared


def _block(cfg: DeepseekV3Config, lp: dict, h, attn, moe: bool):
    h = h + _mm(attn.to(h.dtype), lp["w_o"]).to(h.dtype)
    y = rmsnorm_fn(h, lp["mlp_norm_w"], cfg.norm_eps)
    return h + (_moe_mlp(cfg, lp, y) if moe else _dense_mlp(lp, y)).to(h.dtype)


def _groups(p: dict):
    """(layer index offset, stacked group, is MoE) of the dense prefix and
    the MoE group, each where the tree has it."""
    out, off = [], 0
    for name, moe in (("dense_layers", False), ("moe_layers", True)):
        group = p.get(name)
        if group is not None:
            out.append((off, group, moe))
            off += group["w_o"].shape[0]
    return out


def forward_fn(cfg: DeepseekV3Config, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [S] -> f32 logits [S, V] (uncached, naive attention)."""
    s = tokens.shape[0]
    h = p["embed"][tokens.to(torch.long)]
    cos, sin = p["rope_cos"][:s], p["rope_sin"][:s]
    for _, group, moe in _groups(p):
        for i in range(group["w_o"].shape[0]):
            lp = _slice_layer_params(group, i)
            x = rmsnorm_fn(h, lp["attn_norm_w"], cfg.norm_eps)
            qn, qp, ckv, kpe = _mla_qkv(cfg, lp, x, cos, sin)
            h = _block(cfg, lp, h, _mla_attn_naive(cfg, lp, qn, qp, ckv, kpe, s), moe)
    return head_logits(p, rmsnorm_fn(h, p["final_norm_w"], cfg.norm_eps))


def prefill_fn(cfg: DeepseekV3Config, p: dict, ckv_cache, kpe_cache, tokens, true_len):
    """Prefill padded ``tokens`` [S]: naive attention, and rows [0, S) of
    every layer of the compressed caches [L, MAX, c] / [L, MAX, dr] written
    in place. f32 logits [V] of position ``true_len - 1``."""
    s = tokens.shape[0]
    h = p["embed"][tokens.to(torch.long)]
    cos, sin = p["rope_cos"][:s], p["rope_sin"][:s]
    for off, group, moe in _groups(p):
        for i in range(group["w_o"].shape[0]):
            lp = _slice_layer_params(group, i)
            x = rmsnorm_fn(h, lp["attn_norm_w"], cfg.norm_eps)
            qn, qp, ckv, kpe = _mla_qkv(cfg, lp, x, cos, sin)
            kv_write(ckv_cache, ckv[None], (off + i, 0, 0))
            kv_write(kpe_cache, kpe[None], (off + i, 0, 0))
            h = _block(cfg, lp, h, _mla_attn_naive(cfg, lp, qn, qp, ckv, kpe, true_len), moe)
    h = rmsnorm_fn(h, p["final_norm_w"], cfg.norm_eps)
    return head_logits(p, _last_row(h, true_len))


def decode_step_fn(cfg: DeepseekV3Config, p: dict, ckv_cache, kpe_cache, token, pos):
    """One absorbed-MLA decode step: the token's latent and rope key
    written at ``pos`` of every layer (in place), f32 logits [V] of the
    next position. ``token`` and ``pos`` are ints or one-element device
    tensors."""
    dev = ckv_cache.device
    h = p["embed"][torch.as_tensor(token, device=dev).reshape(1).to(torch.long)]
    cos, sin = _table_rows(p["rope_cos"], pos, 1), _table_rows(p["rope_sin"], pos, 1)
    for off, group, moe in _groups(p):
        for i in range(group["w_o"].shape[0]):
            lp = _slice_layer_params(group, i)
            x = rmsnorm_fn(h, lp["attn_norm_w"], cfg.norm_eps)
            qn, qp, ckv, kpe = _mla_qkv(cfg, lp, x, cos, sin)
            kv_write(ckv_cache, ckv[None], (off + i, pos, 0))
            kv_write(kpe_cache, kpe[None], (off + i, pos, 0))
            attn = _mla_attn_absorbed(cfg, lp, qn, qp, ckv_cache[off + i],
                                      kpe_cache[off + i], pos + 1)
            h = _block(cfg, lp, h, attn, moe)
    return head_logits(p, rmsnorm_fn(h, p["final_norm_w"], cfg.norm_eps)[0])


def generate_scan_fn(cfg: DeepseekV3Config, n_steps: int, p: dict, ckv_cache, kpe_cache,
                     token, pos) -> torch.Tensor:
    """``n_steps`` greedy decode steps from ``token`` at ``pos``; int32
    tokens [n_steps] on the device, nothing read back."""
    out, tok = [], token
    for i in range(n_steps):
        tok = sample_logits(decode_step_fn(cfg, p, ckv_cache, kpe_cache, tok, pos + i))
        tok = tok.to(torch.int32)
        out.append(tok.reshape(1))
    return torch.cat(out)


def init_params(cfg: DeepseekV3Config, seed: int = 0, dtype=torch.bfloat16,
                device=None) -> dict:
    """Random weights from ``seed`` (normal, std 0.02, drawn a slab at a
    time; norms ones; the router bias zero) in the tree
    ``from_safetensors`` builds, on ``device`` (the card unless named)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def w(*shape):
        return random_normal(shape, g, dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=_F32, device=dev)

    e, c, dr = cfg.hidden_size, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    hq, qd = cfg.num_heads, cfg.qk_head_dim
    hv = cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)

    def layers(n: int, moe: bool) -> dict:
        lp = {"attn_norm_w": ones(n, e), "mlp_norm_w": ones(n, e),
              "w_kva": w(n, e, c + dr), "w_kva_norm": ones(n, c), "w_kvb": w(n, c, hv),
              "w_o": w(n, hq * cfg.v_head_dim, e)}
        if cfg.q_lora_rank:
            lp.update(w_qa=w(n, e, cfg.q_lora_rank), w_qa_norm=ones(n, cfg.q_lora_rank),
                      w_qb=w(n, cfg.q_lora_rank, hq * qd))
        else:
            lp["w_q"] = w(n, e, hq * qd)
        if moe:
            ne, mi = cfg.n_routed_experts, cfg.moe_intermediate_size
            si = mi * cfg.n_shared_experts
            lp.update(w_router=w(n, e, ne).to(_F32),
                      b_router=torch.zeros((n, ne), dtype=_F32, device=dev),
                      w_experts_gate=w(n, ne, e, mi), w_experts_up=w(n, ne, e, mi),
                      w_experts_down=w(n, ne, mi, e), w_shared_gate=w(n, e, si),
                      w_shared_up=w(n, e, si), w_shared_down=w(n, si, e))
        else:
            i_ = cfg.intermediate_size
            lp.update(w_gate=w(n, e, i_), w_up=w(n, e, i_), w_down=w(n, i_, e))
        return lp

    kd = min(cfg.first_k_dense, cfg.num_layers)
    p = {"embed": w(cfg.vocab_size, e), "final_norm_w": ones(e),
         "lm_head": None if cfg.tie_word_embeddings else w(e, cfg.vocab_size)}
    if kd > 0:
        p["dense_layers"] = layers(kd, False)
    if cfg.num_layers > kd:
        p["moe_layers"] = layers(cfg.num_layers - kd, True)
    return p


class DeepseekV3Model:
    """DeepSeek-V3/R1 and V2 with absorbed-MLA cached decode. The
    compressed caches ``ckv_cache`` [L, MAX, kv_lora_rank] and
    ``kpe_cache`` [L, MAX, qk_rope_head_dim] are in the model's dtype;
    ``graphs`` holds the captured prefills (one per bucket) and decode
    chunks (one per length), in one shared pool."""

    _name = "deepseek"

    # -- hybrid-engine hooks (llm/serving_hybrid.py): one {"ckv", "kpe"}
    # pytree of the compressed caches

    @staticmethod
    def _init_caches(cfg: DeepseekV3Config, max_seq_len: int, dtype=torch.float32,
                     device=None) -> dict:
        dev = resolve_device(device)
        return {"ckv": torch.zeros((cfg.num_layers, max_seq_len, cfg.kv_lora_rank),
                                   dtype=dtype, device=dev),
                "kpe": torch.zeros((cfg.num_layers, max_seq_len, cfg.qk_rope_head_dim),
                                   dtype=dtype, device=dev)}

    @staticmethod
    def _prefill_fn(cfg: DeepseekV3Config, p: dict, caches: dict, tokens, true_len):
        logits = prefill_fn(cfg, p, caches["ckv"], caches["kpe"], tokens, true_len)
        return caches, logits

    @staticmethod
    def _decode_step_fn(cfg: DeepseekV3Config, p: dict, caches: dict, token, pos):
        return caches, decode_step_fn(cfg, p, caches["ckv"], caches["kpe"], token, pos)

    def __init__(self, config: DeepseekV3Config, params: dict, dtype=torch.float32):
        self.config = config
        self.dtype = dtype
        if "rope_cos" not in params:
            params["rope_cos"], params["rope_sin"] = rope_tables_for(
                config, params["embed"].device)
        self.params = params
        self.ckv_cache = self.kpe_cache = None
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
        """Zeroed compressed caches of ``max_seq_len`` rows, position 0; the
        captured programs (bound to the old caches) are released."""
        self.graphs.reset()
        caches = self._init_caches(self.config, max_seq_len, self.dtype, self.device)
        self.ckv_cache, self.kpe_cache = caches["ckv"], caches["kpe"]
        self.max_seq_len = max_seq_len
        self.pos = 0

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 chunk_size: int = 64) -> list[int]:
        """Greedy generation (reference ``generate``): the prompt through
        the captured prefill of its bucket (a power of two, 16 at least),
        the first token taken on the device, then captured chunks of up to
        ``chunk_size`` steps, one host read each."""
        return generate_chunked(self, functools.partial(prefill_fn, self.config),
                                functools.partial(generate_scan_fn, self.config),
                                input_ids, max_new_tokens, chunk_size)

    def _fixed_caches(self) -> tuple:
        return self.ckv_cache, self.kpe_cache

    @classmethod
    def from_safetensors(cls, path, dtype=torch.float32, device=None) -> "DeepseekV3Model":
        """A transformers DeepSeek-V2/V3 checkpoint (``config.json`` beside
        it): projections transposed to [in, out] in ``dtype``, norms and
        the router in f32, experts stacked [N, in, out]; on ``device`` (the
        card unless named)."""
        from ..safetensors import load_safetensors
        dev = resolve_device(device)
        st = load_safetensors(path)
        cj = Path(path if Path(path).is_dir() else Path(path).parent) / "config.json"
        cfg = DeepseekV3Config.from_hf(json.loads(cj.read_text()) if cj.exists() else {})

        def t(name, transpose=False, dt=dtype):
            a = st.tensor(name).to(device=dev, dtype=dt)
            return a.t().contiguous() if transpose else a

        def layer(pre: str, moe: bool) -> dict:
            lp = {"attn_norm_w": t(pre + "input_layernorm.weight", dt=_F32),
                  "mlp_norm_w": t(pre + "post_attention_layernorm.weight", dt=_F32),
                  "w_kva": t(pre + "self_attn.kv_a_proj_with_mqa.weight", True),
                  "w_kva_norm": t(pre + "self_attn.kv_a_layernorm.weight", dt=_F32),
                  "w_kvb": t(pre + "self_attn.kv_b_proj.weight", True),
                  "w_o": t(pre + "self_attn.o_proj.weight", True)}
            if cfg.q_lora_rank:
                lp["w_qa"] = t(pre + "self_attn.q_a_proj.weight", True)
                lp["w_qa_norm"] = t(pre + "self_attn.q_a_layernorm.weight", dt=_F32)
                lp["w_qb"] = t(pre + "self_attn.q_b_proj.weight", True)
            else:
                lp["w_q"] = t(pre + "self_attn.q_proj.weight", True)
            if not moe:
                for k, n in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                             ("w_down", "down_proj")):
                    lp[k] = t(pre + f"mlp.{n}.weight", True)
                return lp
            lp["w_router"] = t(pre + "mlp.gate.weight", True, _F32)
            bias = pre + "mlp.gate.e_score_correction_bias"
            lp["b_router"] = (t(bias, dt=_F32) if bias in st else
                              torch.zeros((cfg.n_routed_experts,), dtype=_F32, device=dev))
            for k, n in (("gate", "gate_proj"), ("up", "up_proj"), ("down", "down_proj")):
                lp[f"w_experts_{k}"] = torch.stack(
                    [t(pre + f"mlp.experts.{e}.{n}.weight", True)
                     for e in range(cfg.n_routed_experts)])
                lp[f"w_shared_{k}"] = t(pre + f"mlp.shared_experts.{n}.weight", True)
            return lp

        def stack(ls: list) -> dict:
            return {k: torch.stack([lp[k] for lp in ls]) for k in ls[0]}

        kd = cfg.first_k_dense
        p: dict = {"embed": t("model.embed_tokens.weight"),
                   "final_norm_w": t("model.norm.weight", dt=_F32),
                   "lm_head": (t("lm_head.weight", True) if "lm_head.weight" in st else None)}
        if kd > 0:
            p["dense_layers"] = stack([layer(f"model.layers.{i}.", False) for i in range(kd)])
        if cfg.num_layers > kd:
            p["moe_layers"] = stack([layer(f"model.layers.{i}.", True)
                                     for i in range(kd, cfg.num_layers)])
        return cls(cfg, p, dtype=dtype)

