"""Qwen3-Next (Qwen3-Next-80B-A3B): gated DeltaNet layers beside gated
full-attention layers, an MoE with a gated shared expert (counterpart of
``pygpukit_tpu/llm/models/qwen3next.py``, transformers'
modeling_qwen3_next).

- **Gated DeltaNet** (``_gdn_full``, ``_gdn_step``): ``in_proj_qkvz`` and
  ``in_proj_ba`` pack q|k|v|z and b|a per K-head group (``_gdn_project``);
  a depthwise causal conv (kernel 4) and SiLU over cat(q, k, v); beta =
  sigmoid(b), decay g = -exp(A_log) * softplus(a + dt_bias), both f32; q
  and k L2-normalized by the sum of squares (``_l2norm``) and repeated
  over the ``nv // nk`` value heads of their group; a per-value-head
  [Dk, Dv] f32 state updated by the gated delta rule
      S_t = S_{t-1} exp(g_t);  delta = (v_t - k_t S_t) beta_t
      S_t += k_t (x) delta;    o_t = (q_t / sqrt(Dk)) S_t
  then a gated RMS norm (the norm first, then times silu(z)) and
  ``out_proj``. The prefill and the forward solve the rule in chunks of
  ``DELTA_CHUNK`` (``_delta_chunked``: a UT transform per chunk, its
  triangular inverse built row by row by forward substitution); decode
  takes recurrent steps (``_delta_scan``). The inverse amplifies product
  error about 1000x, so every product of the rule is a full f32 product
  (TF32 off: ``core.backend.set_deterministic_numerics``).
- **Gated attention** (``_attn_qkvg``, ``_attn_out``): ``q_proj`` emits
  the query and a gate per head; per-head q/k RMS norms; split-half rope
  on the first ``rope_dim`` dims (``partial_rotary_factor``); the output
  times sigmoid(gate) before ``o_proj``. The prefill attends in f32
  within the padded block (``_base.attn_block_causal``); decode attends
  over the fixed [MAX, Hk, D] caches through
  ``ops.nn.attention.sdpa_fixed_cache_fn``: one bf16 or f32 query row on
  the card launches the ``flash_decode`` kernel.
- **MoE** (``_moe_mlp``): a softmax over every expert in f32, the top k,
  renormalized under ``norm_topk_prob`` (``_router``), plus a shared
  expert scaled by sigmoid(``shared_expert_gate``). The routed experts
  (``ops.moe.routed_experts``, as the DeepSeek family's): CPU tensors the
  reference's dense one-hot formula (``_experts_plain``, the plain
  version); CUDA tensors ``ops.moe.gmm_experts`` (three ``kernels.gmm``
  launches) from T * k >= 128 rows, ``gather_experts`` up to T 4, the
  one-hot formula between.

The caches are a list of per-layer dicts (``init_caches``), written in
place by the hooks (``_base.StandaloneCachedModel``). The prefill starts
its recurrent state from zeros, so it is not stateful; padded prompt rows
are zeroed and made identity steps (g 0, beta 0), so the states are those
at ``true_len``. ``Qwen3NextConfig.from_hf`` derives ``layer_types`` from
``full_attention_interval`` where a config omits them, as transformers
does; the reference makes every such layer full attention (ROADMAP C.10).
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.nn.functional as F

from ...core.backend import resolve_device
from ...ops.embedding import kv_write
from ...ops.moe import routed_experts, top_k_fn
from ...ops.nn import apply_rope_fn, rmsnorm_fn, rope_tables
from ...ops.nn.attention import sdpa_fixed_cache_fn
from ..model import _table_rows
from ._base import (StandaloneCachedModel, attn_block_causal, causal_depthwise_conv,
                    conv_state_tail, greedy_scan, last_row, lm_head, mm, qk_headnorm)
from ._standalone import random_normal

_F32 = torch.float32

#: the chunk width of the prefill's delta rule (transformers' default)
DELTA_CHUNK = 64


@dataclass
class Qwen3NextConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    num_layers: int = 48
    num_heads: int = 16
    num_kv_heads: int = 2
    head_dim: int = 256
    intermediate_size: int = 5120
    layer_types: tuple = ()
    linear_num_value_heads: int = 32
    linear_num_key_heads: int = 16
    linear_key_head_dim: int = 128
    linear_value_head_dim: int = 128
    linear_conv_kernel_dim: int = 4
    num_experts: int = 0
    num_experts_per_tok: int = 10
    moe_intermediate_size: int = 512
    shared_expert_intermediate_size: int = 512
    norm_topk_prob: bool = True
    mlp_only_layers: tuple = ()
    decoder_sparse_step: int = 1
    rope_theta: float = 10000000.0
    partial_rotary_factor: float = 0.25
    norm_eps: float = 1e-6
    max_position_embeddings: int = 262144
    tie_word_embeddings: bool = False

    @classmethod
    def from_hf(cls, hf: dict) -> "Qwen3NextConfig":
        """A transformers ``config.json``. Without ``layer_types``, every
        ``full_attention_interval``-th layer (4 unless given) is full
        attention and the others linear, as transformers derives them."""
        n_layers = hf.get("num_hidden_layers", 48)
        heads = hf.get("num_attention_heads", 16)
        hidden = hf.get("hidden_size", 2048)
        every = hf.get("full_attention_interval", 4)
        types = hf.get("layer_types") or [
            "linear_attention" if (i + 1) % every else "full_attention"
            for i in range(n_layers)]
        return cls(
            vocab_size=hf.get("vocab_size", 151936),
            hidden_size=hidden,
            num_layers=n_layers,
            num_heads=heads,
            num_kv_heads=hf.get("num_key_value_heads", 2),
            head_dim=hf.get("head_dim") or hidden // heads,
            intermediate_size=hf.get("intermediate_size", 5120),
            layer_types=tuple(types),
            linear_num_value_heads=hf.get("linear_num_value_heads", 32),
            linear_num_key_heads=hf.get("linear_num_key_heads", 16),
            linear_key_head_dim=hf.get("linear_key_head_dim", 128),
            linear_value_head_dim=hf.get("linear_value_head_dim", 128),
            linear_conv_kernel_dim=hf.get("linear_conv_kernel_dim", 4),
            num_experts=hf.get("num_experts", 0) or 0,
            num_experts_per_tok=hf.get("num_experts_per_tok", 10),
            moe_intermediate_size=hf.get("moe_intermediate_size", 512),
            shared_expert_intermediate_size=hf.get("shared_expert_intermediate_size", 512),
            norm_topk_prob=hf.get("norm_topk_prob", True),
            mlp_only_layers=tuple(hf.get("mlp_only_layers", [])),
            decoder_sparse_step=hf.get("decoder_sparse_step", 1),
            rope_theta=hf.get("rope_theta", 10000000.0),
            partial_rotary_factor=hf.get("partial_rotary_factor", 0.25),
            norm_eps=hf.get("rms_norm_eps", 1e-6),
            max_position_embeddings=hf.get("max_position_embeddings", 262144),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
        )

    def is_attn(self, layer: int) -> bool:
        return self.layer_types[layer] == "full_attention"

    def is_moe_layer(self, layer: int) -> bool:
        return (self.num_experts > 0 and layer not in self.mlp_only_layers
                and (layer + 1) % self.decoder_sparse_step == 0)

    @property
    def rope_dim(self) -> int:
        rd = int(self.head_dim * self.partial_rotary_factor)
        return rd - (rd % 2)

    @property
    def conv_dim(self) -> int:
        return (2 * self.linear_num_key_heads * self.linear_key_head_dim
                + self.linear_num_value_heads * self.linear_value_head_dim)


# ---------------------------------------------------------------- helpers --

def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(sum(x^2) + eps) over the last axis: the sum, not the mean."""
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def _gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor, eps: float):
    """rms(x) * w, then times silu(z), in f32; x's dtype out."""
    xf = x.to(_F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * w.to(_F32)
    return (y * F.silu(z.to(_F32))).to(x.dtype)


def _rope_partial(cfg: Qwen3NextConfig, x: torch.Tensor, cos, sin) -> torch.Tensor:
    rd = cfg.rope_dim
    return torch.cat([apply_rope_fn(x[..., :rd], cos, sin), x[..., rd:]], dim=-1)


# ---------------------------------------------------------- gated deltanet --

def _gdn_project(cfg: Qwen3NextConfig, lp: dict, x: torch.Tensor):
    """(q [S, nk, Dk], k, v [S, nv, Dv], z, b [S, nv], a): ``in_proj_qkvz``
    and ``in_proj_ba`` unpacked per K-head group."""
    s = x.shape[0]
    nk, nv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
    r = nv // nk
    qkvz = mm(x, lp["w_qkvz"]).reshape(s, nk, 2 * dk + 2 * r * dv)
    ba = mm(x, lp["w_ba"]).reshape(s, nk, 2 * r)
    q = qkvz[:, :, :dk]
    k = qkvz[:, :, dk:2 * dk]
    v = qkvz[:, :, 2 * dk:2 * dk + r * dv].reshape(s, nv, dv)
    z = qkvz[:, :, 2 * dk + r * dv:].reshape(s, nv, dv)
    return q, k, v, z, ba[:, :, :r].reshape(s, nv), ba[:, :, r:].reshape(s, nv)


def _gdn_gates(lp: dict, a: torch.Tensor, b: torch.Tensor):
    """(beta, g) [S, nv] in f32."""
    beta = torch.sigmoid(b.to(_F32))
    g = -torch.exp(lp["A_log"].to(_F32)) * F.softplus(a.to(_F32) + lp["dt_bias"].to(_F32))
    return beta, g


def _delta_scan(q, k, v, g, beta, state0):
    """The gated delta rule step by step over [S, nv, D*] f32 inputs from
    ``state0`` [nv, Dk, Dv]. Returns (out [S, nv, Dv], the final state)."""
    q = _l2norm(q) * (q.shape[-1] ** -0.5)
    k = _l2norm(k)
    state, outs = state0, []
    for t in range(q.shape[0]):
        state = state * torch.exp(g[t])[:, None, None]
        kv_mem = torch.einsum("hkv,hk->hv", state, k[t])
        delta = (v[t] - kv_mem) * beta[t][:, None]
        state = state + k[t][:, :, None] * delta[:, None, :]
        outs.append(torch.einsum("hkv,hk->hv", state, q[t]))
    return torch.stack(outs), state


def _delta_chunked(q, k, v, g, beta, state0, chunk: int = DELTA_CHUNK):
    """The gated delta rule in chunks (transformers'
    torch_chunk_gated_delta_rule): within a chunk the recurrence is solved
    in closed form by a UT transform, a triangular inverse built by forward
    substitution row by row (each row from the rows already rewritten), so
    S sequential steps become S / chunk steps of [C, C] and [C, D]
    products. Inputs [S, nv, D*] f32 (padded rows carry beta 0 and g 0:
    identity steps); returns (out [S, nv, Dv], final state [nv, Dk, Dv])."""
    s, nh, dk = q.shape
    dv = v.shape[-1]
    q = _l2norm(q) * (dk ** -0.5)
    k = _l2norm(k)
    pad = (-s) % chunk
    nc = (s + pad) // chunk

    def to_chunks(x):
        return F.pad(x.permute(1, 0, 2), (0, 0, 0, pad)).reshape(nh, nc, chunk, x.shape[-1])

    qc, kc, vc = to_chunks(q), to_chunks(k), to_chunks(v)
    gc = F.pad(g.t(), (0, pad)).reshape(nh, nc, chunk)
    bc = F.pad(beta.t(), (0, pad)).reshape(nh, nc, chunk)
    v_beta = vc * bc[..., None]
    k_beta = kc * bc[..., None]
    gcs = torch.cumsum(gc, dim=-1)                                     # [H, NC, C]
    i = torch.arange(chunk, device=q.device)
    tril_s = i[:, None] >= i[None, :]                                  # the diagonal in
    tril = i[:, None] > i[None, :]
    diff = gcs[..., :, None] - gcs[..., None, :]
    # the inner where keeps exp from overflowing above the diagonal
    decay = torch.where(tril_s, torch.exp(torch.where(tril_s, diff, 0.0)), 0.0)
    attn = -torch.where(tril, torch.einsum("hnik,hnjk->hnij", k_beta, kc) * decay, 0.0)
    for ii in range(1, chunk):
        row = attn[..., ii, :]
        attn[..., ii, :] = row + torch.einsum("hnj,hnjk->hnk", row, attn)
    attn = attn + torch.eye(chunk, dtype=attn.dtype, device=q.device)
    value = torch.einsum("hnij,hnjv->hniv", attn, v_beta)
    k_cumdecay = torch.einsum("hnij,hnjk->hnik", attn, k_beta * torch.exp(gcs)[..., None])
    state, outs = state0, []
    for n in range(nc):
        q_i, k_i, g_i = qc[:, n], kc[:, n], gcs[:, n]
        a = torch.where(tril_s, torch.einsum("hik,hjk->hij", q_i, k_i) * decay[:, n], 0.0)
        v_new = value[:, n] - torch.einsum("hik,hkv->hiv", k_cumdecay[:, n], state)
        inter = torch.einsum("hik,hkv->hiv", q_i * torch.exp(g_i)[..., None], state)
        outs.append(inter + torch.einsum("hij,hjv->hiv", a, v_new))
        g_last = g_i[:, -1]
        state = (state * torch.exp(g_last)[:, None, None]
                 + torch.einsum("hik,hiv->hkv",
                                k_i * torch.exp(g_last[:, None] - g_i)[..., None], v_new))
    out = torch.stack(outs, dim=1).reshape(nh, nc * chunk, dv)[:, :s]
    return out.permute(1, 0, 2), state


def _gdn_full(cfg: Qwen3NextConfig, lp: dict, x: torch.Tensor, true_len):
    """The DeltaNet over a block x [S, E] (rows at or past ``true_len``
    already zeroed by the prefill). Returns (out [S, E], conv state
    [conv_dim, K] from the raw conv inputs, recurrent state f32)."""
    s = x.shape[0]
    nk, nv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
    q, k, v, z, b, a = _gdn_project(cfg, lp, x)
    qkv = torch.cat([q.reshape(s, -1), k.reshape(s, -1), v.reshape(s, -1)], dim=-1)
    act = F.silu(causal_depthwise_conv(qkv, lp["conv_w"])).to(qkv.dtype)
    conv_state = conv_state_tail(qkv, true_len, cfg.linear_conv_kernel_dim, x.dtype)
    q = act[:, :nk * dk].reshape(s, nk, dk)
    k = act[:, nk * dk:2 * nk * dk].reshape(s, nk, dk)
    v = act[:, 2 * nk * dk:].reshape(s, nv, dv)
    beta, g = _gdn_gates(lp, a, b)
    if nv // nk > 1:
        q = torch.repeat_interleave(q, nv // nk, dim=1)
        k = torch.repeat_interleave(k, nv // nk, dim=1)
    # padded rows are identity steps of the recurrence: g 0, beta 0
    valid = (torch.arange(s, device=x.device) < true_len)[:, None]
    g = torch.where(valid, g, 0.0)
    beta = torch.where(valid, beta, 0.0)
    state0 = torch.zeros((nv, dk, dv), dtype=_F32, device=x.device)
    out, state = _delta_chunked(q.to(_F32), k.to(_F32), v.to(_F32), g, beta, state0)
    out = _gated_rmsnorm(out.to(x.dtype), z, lp["norm_w"], cfg.norm_eps)
    return mm(out.reshape(s, -1), lp["w_out"]), conv_state, state


def _gdn_step(cfg: Qwen3NextConfig, lp: dict, x: torch.Tensor, conv_state, rec_state):
    """One decode step of x [1, E]: the conv state rolled one slot, an f32
    K-tap sum and SiLU, one recurrent step. Returns (out [1, E], conv
    state, recurrent state)."""
    nk, nv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
    q, k, v, z, b, a = _gdn_project(cfg, lp, x)
    qkv = torch.cat([q.reshape(1, -1), k.reshape(1, -1), v.reshape(1, -1)], dim=-1)[0]
    conv_state = torch.cat([conv_state[:, 1:], qkv[:, None].to(conv_state.dtype)], dim=-1)
    act = F.silu(torch.sum(conv_state.to(_F32) * lp["conv_w"].to(_F32), dim=-1))
    q = act[:nk * dk].reshape(1, nk, dk)
    k = act[nk * dk:2 * nk * dk].reshape(1, nk, dk)
    v = act[2 * nk * dk:].reshape(1, nv, dv)
    beta, g = _gdn_gates(lp, a, b)
    if nv // nk > 1:
        q = torch.repeat_interleave(q, nv // nk, dim=1)
        k = torch.repeat_interleave(k, nv // nk, dim=1)
    out, rec_state = _delta_scan(q, k, v, g, beta, rec_state)
    out = _gated_rmsnorm(out.to(x.dtype), z, lp["norm_w"], cfg.norm_eps)
    return mm(out.reshape(1, -1), lp["w_out"]), conv_state, rec_state


# -------------------------------------------------------------- attention --

def _attn_qkvg(cfg: Qwen3NextConfig, lp: dict, x: torch.Tensor, cos, sin):
    """(q [S, Hq, D], k, v [S, Hk, D], gate [S, Hq * D]): per-head norms,
    then partial rope on q and k."""
    s = x.shape[0]
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qg = mm(x, lp["w_q"]).reshape(s, hq, 2 * d)
    q, gate = qg[..., :d], qg[..., d:]
    k = mm(x, lp["w_k"]).reshape(s, hk, d)
    v = mm(x, lp["w_v"]).reshape(s, hk, d)
    q = _rope_partial(cfg, qk_headnorm(q, lp["w_q_norm"], cfg.norm_eps), cos, sin)
    k = _rope_partial(cfg, qk_headnorm(k, lp["w_k_norm"], cfg.norm_eps), cos, sin)
    return q, k, v, gate.reshape(s, hq * d)


def _attn_out(lp: dict, attn: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    return mm(attn * torch.sigmoid(gate.to(_F32)).to(attn.dtype), lp["w_o"])


# -------------------------------------------------------------------- mlp --

def _dense_mlp(lp: dict, y: torch.Tensor, pre: str = "") -> torch.Tensor:
    gate, up = mm(y, lp[pre + "w_gate"]), mm(y, lp[pre + "w_up"])
    return mm((F.silu(gate.to(_F32)) * up.to(_F32)).to(y.dtype), lp[pre + "w_down"])


def _router(cfg: Qwen3NextConfig, lp: dict, y: torch.Tensor):
    """(weights f32 [T, k], expert ids [T, k]): a softmax over every
    expert of the f32 router logits, the top k in ``lax.top_k``'s order,
    renormalized under ``norm_topk_prob``."""
    probs = torch.softmax(torch.matmul(y.to(_F32), lp["w_router"].to(_F32)), dim=-1)
    w, eidx = top_k_fn(probs, cfg.num_experts_per_tok)
    if cfg.norm_topk_prob:
        w = w / torch.sum(w, dim=-1, keepdim=True)
    return w, eidx


def _experts_plain(lp: dict, y: torch.Tensor, w, eidx) -> torch.Tensor:
    """The reference's dense one-hot formula: every expert over every
    token, gate/up and down rounded to y's dtype, combined in f32 by the
    one-hot weights. f32 [T, E]."""
    n = lp["w_experts_gate"].shape[0]
    dense = torch.zeros((y.shape[0], n), dtype=_F32, device=y.device).scatter(1, eidx, w)
    yf = y.to(_F32)
    g = torch.einsum("si,eih->seh", yf, lp["w_experts_gate"].to(_F32)).to(y.dtype)
    u = torch.einsum("si,eih->seh", yf, lp["w_experts_up"].to(_F32)).to(y.dtype)
    act = (F.silu(g.to(_F32)) * u.to(_F32)).to(y.dtype)
    out = torch.einsum("seh,ehi->sei", act.to(_F32), lp["w_experts_down"].to(_F32))
    return torch.einsum("sei,se->si", out.to(y.dtype).to(_F32), dense)


def _moe_mlp(cfg: Qwen3NextConfig, lp: dict, y: torch.Tensor) -> torch.Tensor:
    """Routed experts plus the gated shared expert, in y's dtype."""
    w, eidx = _router(cfg, lp, y)
    routed = routed_experts(y, (lp["w_experts_gate"], lp["w_experts_up"]),
                            lp["w_experts_down"], w, eidx,
                            lambda outs, _: (F.silu(outs[0]) * outs[1]).to(y.dtype),
                            functools.partial(_experts_plain, lp)).to(y.dtype)
    shared = _dense_mlp(lp, y, pre="shared_")
    sg = torch.sigmoid(torch.matmul(y.to(_F32), lp["w_shared_gate"].to(_F32)))
    return routed + sg.to(y.dtype) * shared


def _layer_tail(cfg: Qwen3NextConfig, layer: int, lp: dict, h, mix):
    h = h + mix
    y = rmsnorm_fn(h, lp["mlp_norm_w"], cfg.norm_eps)
    return h + (_moe_mlp(cfg, lp, y) if cfg.is_moe_layer(layer) else _dense_mlp(lp, y))


# ----------------------------------------------------------------- passes --

def init_caches(cfg: Qwen3NextConfig, max_seq_len: int, dtype=torch.float32,
                device=None) -> list:
    """The hybrid cache list, zeros: {"k", "v"} [MAX, Hk, D] in ``dtype`` on
    attention layers; {"conv"} [conv_dim, K] in ``dtype`` and {"rec"} [nv,
    Dk, Dv] in f32 on DeltaNet layers."""
    dev = resolve_device(device)
    caches = []
    for i in range(cfg.num_layers):
        if cfg.is_attn(i):
            shape = (max_seq_len, cfg.num_kv_heads, cfg.head_dim)
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                           "v": torch.zeros(shape, dtype=dtype, device=dev)})
        else:
            caches.append({
                "conv": torch.zeros((cfg.conv_dim, cfg.linear_conv_kernel_dim), dtype=dtype,
                                    device=dev),
                "rec": torch.zeros((cfg.linear_num_value_heads, cfg.linear_key_head_dim,
                                    cfg.linear_value_head_dim), dtype=_F32, device=dev)})
    return caches


def forward_fn(cfg: Qwen3NextConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [S] -> f32 logits [S, V] (uncached)."""
    s = tokens.shape[0]
    h = p["embed"][tokens.to(torch.long)]
    cos, sin = p["rope_cos"][:s], p["rope_sin"][:s]
    for i, lp in enumerate(p["layers"]):
        x = rmsnorm_fn(h, lp["attn_norm_w"], cfg.norm_eps)
        if cfg.is_attn(i):
            q, k, v, gate = _attn_qkvg(cfg, lp, x, cos, sin)
            mix = _attn_out(lp, attn_block_causal(q, k, v, s), gate)
        else:
            mix, _, _ = _gdn_full(cfg, lp, x, s)
        h = _layer_tail(cfg, i, lp, h, mix)
    return lm_head(p, rmsnorm_fn(h, p["final_norm_w"], cfg.norm_eps))


def prefill_fn(cfg: Qwen3NextConfig, p: dict, caches: list, tokens, true_len):
    """Prefill padded ``tokens`` [S] from zero states: K/V rows [0, S), the
    conv states (the last K raw conv inputs before ``true_len``) and the
    recurrent states at ``true_len`` written in place. Returns (caches,
    f32 logits [V] of position ``true_len - 1``)."""
    s = tokens.shape[0]
    h = p["embed"][tokens.to(torch.long)]
    valid = (torch.arange(s, device=h.device) < true_len)[:, None]
    cos, sin = p["rope_cos"][:s], p["rope_sin"][:s]
    for i, (lp, cache) in enumerate(zip(p["layers"], caches)):
        x = rmsnorm_fn(h, lp["attn_norm_w"], cfg.norm_eps)
        if cfg.is_attn(i):
            q, k, v, gate = _attn_qkvg(cfg, lp, x, cos, sin)
            kv_write(cache["k"], k, (0, 0, 0))
            kv_write(cache["v"], v, (0, 0, 0))
            mix = _attn_out(lp, attn_block_causal(q, k, v, true_len), gate)
        else:
            # padded rows zeroed, so they write into neither state
            mix, conv, rec = _gdn_full(cfg, lp, torch.where(valid, x, torch.zeros_like(x)),
                                       true_len)
            cache["conv"].copy_(conv)
            cache["rec"].copy_(rec)
        h = _layer_tail(cfg, i, lp, h, mix)
    h = rmsnorm_fn(h, p["final_norm_w"], cfg.norm_eps)
    return caches, lm_head(p, last_row(h, true_len))


def decode_step_fn(cfg: Qwen3NextConfig, p: dict, caches: list, token, pos):
    """One decode step at ``pos`` (an int or a one-element int32 device
    tensor): K/V written at ``pos``, the conv and recurrent states
    advanced, in place. Returns (caches, f32 logits [V])."""
    dev = p["embed"].device
    h = p["embed"][torch.as_tensor(token, device=dev).reshape(1).to(torch.long)]
    cos, sin = _table_rows(p["rope_cos"], pos, 1), _table_rows(p["rope_sin"], pos, 1)
    for i, (lp, cache) in enumerate(zip(p["layers"], caches)):
        x = rmsnorm_fn(h, lp["attn_norm_w"], cfg.norm_eps)
        if cfg.is_attn(i):
            q, k, v, gate = _attn_qkvg(cfg, lp, x, cos, sin)
            kv_write(cache["k"], k, (pos, 0, 0))
            kv_write(cache["v"], v, (pos, 0, 0))
            attn = sdpa_fixed_cache_fn(q, cache["k"], cache["v"], pos + 1)
            mix = _attn_out(lp, attn.reshape(1, -1), gate)
        else:
            mix, conv, rec = _gdn_step(cfg, lp, x, cache["conv"], cache["rec"])
            cache["conv"].copy_(conv)
            cache["rec"].copy_(rec)
        h = _layer_tail(cfg, i, lp, h, mix)
    return caches, lm_head(p, rmsnorm_fn(h, p["final_norm_w"], cfg.norm_eps)[0])


def generate_scan_fn(cfg: Qwen3NextConfig, n_steps: int, p: dict, caches: list, token,
                     pos) -> torch.Tensor:
    """``n_steps`` greedy decode steps; int32 tokens [n_steps]."""
    return greedy_scan(decode_step_fn, cfg, n_steps, p, caches, token, pos)


def init_params(cfg: Qwen3NextConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None) -> dict:
    """Random weights from ``seed`` (normal, std 0.02, drawn a slab at a
    time; norms ones; the router and shared-expert gate f32) in the tree
    ``from_safetensors`` builds, on ``device`` (the card unless named);
    the rope tables are the model's."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    e, d, hq, hk = cfg.hidden_size, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    nk, nv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
    r = nv // nk

    def w(*shape, dt=dtype):
        return random_normal(shape, g, dt)

    def ones(n):
        return torch.ones(n, dtype=_F32, device=dev)

    layers = []
    for i in range(cfg.num_layers):
        lp = {"attn_norm_w": ones(e), "mlp_norm_w": ones(e)}
        if cfg.is_attn(i):
            lp.update(w_q=w(e, hq * 2 * d), w_k=w(e, hk * d), w_v=w(e, hk * d),
                      w_o=w(hq * d, e), w_q_norm=ones(d), w_k_norm=ones(d))
        else:
            lp.update(w_qkvz=w(e, nk * (2 * dk + 2 * r * dv)), w_ba=w(e, nk * 2 * r),
                      conv_w=w(cfg.conv_dim, cfg.linear_conv_kernel_dim),
                      dt_bias=w(nv, dt=_F32), A_log=w(nv, dt=_F32), norm_w=ones(dv),
                      w_out=w(nv * dv, e))
        if cfg.is_moe_layer(i):
            n, mi, si = cfg.num_experts, cfg.moe_intermediate_size, \
                cfg.shared_expert_intermediate_size
            lp.update(w_router=w(e, n, dt=_F32), w_experts_gate=w(n, e, mi),
                      w_experts_up=w(n, e, mi), w_experts_down=w(n, mi, e),
                      shared_w_gate=w(e, si), shared_w_up=w(e, si), shared_w_down=w(si, e),
                      w_shared_gate=w(e, 1, dt=_F32))
        else:
            lp.update(w_gate=w(e, cfg.intermediate_size), w_up=w(e, cfg.intermediate_size),
                      w_down=w(cfg.intermediate_size, e))
        layers.append(lp)
    return {"embed": w(cfg.vocab_size, e), "final_norm_w": ones(e),
            "lm_head": None if cfg.tie_word_embeddings else w(e, cfg.vocab_size),
            "layers": layers}


class Qwen3NextModel(StandaloneCachedModel):
    """Qwen3-Next with its hybrid cache (``_base.StandaloneCachedModel``)."""

    _prefill_fn = staticmethod(prefill_fn)
    _generate_scan_fn = staticmethod(generate_scan_fn)
    _forward_fn = staticmethod(forward_fn)
    _init_caches = staticmethod(init_caches)
    _decode_step_fn = staticmethod(decode_step_fn)
    _name = "qwen3next"

    def __init__(self, config: Qwen3NextConfig, params: dict, dtype=torch.float32):
        self.config = config
        self.dtype = dtype
        if "rope_cos" not in params:
            params["rope_cos"], params["rope_sin"] = rope_tables(
                config.max_position_embeddings, config.rope_dim, config.rope_theta,
                device=params["embed"].device)
        self.params = params
        self._setup()

    @classmethod
    def from_safetensors(cls, path, dtype=torch.float32, device=None) -> "Qwen3NextModel":
        """A transformers Qwen3-Next checkpoint: projections transposed to
        [in, out] in ``dtype``, norms, the router, the shared-expert gate,
        ``dt_bias`` and ``A_log`` in f32, the conv [C, 1, K] as [C, K], the
        experts stacked; every RMS norm but the gated one stores w - 1, so
        1 is added; on ``device`` (the card unless named)."""
        from ..safetensors import load_safetensors
        dev = resolve_device(device)
        st = load_safetensors(path)
        cj = Path(path if Path(path).is_dir() else Path(path).parent) / "config.json"
        cfg = Qwen3NextConfig.from_hf(json.loads(cj.read_text()) if cj.exists() else {})

        def t(name, transpose=False, dt=dtype):
            a = st.tensor(name).to(device=dev, dtype=dt)
            return a.t().contiguous() if transpose else a

        lps = []
        for i in range(cfg.num_layers):
            pre = f"model.layers.{i}."
            lp = {"attn_norm_w": t(pre + "input_layernorm.weight", dt=_F32) + 1.0,
                  "mlp_norm_w": t(pre + "post_attention_layernorm.weight", dt=_F32) + 1.0}
            if cfg.is_attn(i):
                a = pre + "self_attn."
                lp.update(w_q=t(a + "q_proj.weight", True), w_k=t(a + "k_proj.weight", True),
                          w_v=t(a + "v_proj.weight", True), w_o=t(a + "o_proj.weight", True),
                          w_q_norm=t(a + "q_norm.weight", dt=_F32) + 1.0,
                          w_k_norm=t(a + "k_norm.weight", dt=_F32) + 1.0)
            else:
                a = pre + "linear_attn."
                lp.update(w_qkvz=t(a + "in_proj_qkvz.weight", True),
                          w_ba=t(a + "in_proj_ba.weight", True),
                          conv_w=t(a + "conv1d.weight")[:, 0, :].contiguous(),
                          dt_bias=t(a + "dt_bias", dt=_F32), A_log=t(a + "A_log", dt=_F32),
                          norm_w=t(a + "norm.weight", dt=_F32),
                          w_out=t(a + "out_proj.weight", True))
            m = pre + "mlp."
            if cfg.is_moe_layer(i):
                stacks = {}
                for leaf, proj in (("w_experts_gate", "gate_proj"), ("w_experts_up", "up_proj"),
                                   ("w_experts_down", "down_proj")):
                    stacks[leaf] = torch.stack([t(m + f"experts.{j}.{proj}.weight", True)
                                                for j in range(cfg.num_experts)])
                lp.update(stacks, w_router=t(m + "gate.weight", True, _F32),
                          shared_w_gate=t(m + "shared_expert.gate_proj.weight", True),
                          shared_w_up=t(m + "shared_expert.up_proj.weight", True),
                          shared_w_down=t(m + "shared_expert.down_proj.weight", True),
                          w_shared_gate=t(m + "shared_expert_gate.weight", True, _F32))
            else:
                lp.update(w_gate=t(m + "gate_proj.weight", True),
                          w_up=t(m + "up_proj.weight", True),
                          w_down=t(m + "down_proj.weight", True))
            lps.append(lp)
        p = {"embed": t("model.embed_tokens.weight"),
             "final_norm_w": t("model.norm.weight", dt=_F32) + 1.0,
             "lm_head": (t("lm_head.weight", True)
                         if "lm_head.weight" in st and not cfg.tie_word_embeddings else None),
             "layers": lps}
        return cls(cfg, p, dtype=dtype)
