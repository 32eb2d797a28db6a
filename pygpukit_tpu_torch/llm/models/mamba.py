"""Mamba and FalconMamba: the selective state-space (S6) decoder
(counterpart of ``pygpukit_tpu/llm/models/mamba.py``, transformers'
modeling_mamba ``slow_forward``).

Every layer is one mixer: norm -> mixer -> residual. The cache is O(1) in
the context: a conv state [d_inner, K] and an SSM state [d_inner, N] a
layer, one dict each in a list (``_base.StandaloneCachedModel``).

- in_proj -> (x | gate); the depthwise causal conv (kernel K, bias) and
  SiLU over x.
- Selection (``_selection``): x_proj -> (time step | B | C), dt =
  softplus(dt_proj(time step)), A = -exp(A_log); da = exp(dt A), dbu = dt
  B x, each [S, d_inner, N] in f32.
- The recurrence h_t = da_t h_{t-1} + dbu_t, y_t = h_t . C_t + D x_t, out
  = out_proj(y * silu(gate)). The prefill and the forward run it as a
  parallel scan over the (a, b) pairs (``ops.scan.linear_scan``: the
  odd/even recursion of ``jax.lax.associative_scan``, log-depth, static
  shapes, no host read, so it captures into a CUDA graph); decode takes one step off
  the cached state.
- The prefill is stateful: it continues from the caches it is given (the
  conv reads its left context from the carried raw inputs, and the
  carried SSM state is folded in closed form with the scan's cumulative
  coefficient, h_t += (prod_{i<=t} a_i) h_init), so ``generate`` streams a
  prompt longer than ``_prefill_block`` through the prefill in blocks,
  bounding the [block, d_inner, N] operands. Padded rows of a bucket are
  identity steps (a 1, b 0) and their raw inputs are zeroed before the
  conv.
- FalconMamba (``model_type`` falcon_mamba): weightless RMS norms on B, C
  and dt before the discretisation (``mixer_rms_eps``).

The scan is plain PyTorch on the card as in the reference, which has no
kernel for it (ROADMAP B).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.nn.functional as F

from ...core.backend import resolve_device
from ...ops.nn import rmsnorm_fn
from ...ops.scan import linear_scan
from ._base import (StandaloneCachedModel, causal_depthwise_conv, conv_state_tail, greedy_scan,
                    last_row, lm_head, mm)
from ._standalone import random_normal

_F32 = torch.float32


@dataclass
class MambaConfig:
    vocab_size: int = 50280
    hidden_size: int = 768
    num_layers: int = 24
    state_size: int = 16
    intermediate_size: int = 1536
    conv_kernel: int = 4
    time_step_rank: int = 48
    use_conv_bias: bool = True
    use_bias: bool = False           # in/out_proj biases
    # FalconMamba: weightless RMS norms on B/C/dt before the recurrence
    mixer_rms_eps: float | None = None
    norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 1 << 20   # no positional encoding

    @classmethod
    def from_hf(cls, hf: dict) -> "MambaConfig":
        """A transformers ``config.json`` (``time_step_rank`` "auto" is
        ceil(hidden / 16))."""
        hidden = hf.get("hidden_size", 768)
        tsr = hf.get("time_step_rank", "auto")
        if tsr == "auto" or tsr is None:
            tsr = math.ceil(hidden / 16)
        return cls(
            vocab_size=hf.get("vocab_size", 50280),
            hidden_size=hidden,
            num_layers=hf.get("num_hidden_layers", 24),
            state_size=hf.get("state_size", 16),
            intermediate_size=hf.get("intermediate_size", 2 * hidden),
            conv_kernel=hf.get("conv_kernel", 4),
            time_step_rank=int(tsr),
            use_conv_bias=hf.get("use_conv_bias", True),
            use_bias=hf.get("use_bias", False),
            mixer_rms_eps=(hf.get("mixer_rms_eps", 1e-6)
                           if hf.get("model_type") == "falcon_mamba" else None),
            norm_eps=hf.get("layer_norm_epsilon", 1e-5),
            tie_word_embeddings=hf.get("tie_word_embeddings", True),
        )


# ------------------------------------------------------------------ mixer --

def _rms_nw(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Weightless RMS norm over the last dim (FalconMamba's rms_forward)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def _selection(cfg: MambaConfig, lp: dict, u: torch.Tensor):
    """u [S, d_inner] (after the conv, f32) -> (da [S, E, N], dbu [S, E,
    N], C [S, N]), f32."""
    ssm = mm(u.to(lp["w_x"].dtype), lp["w_x"])                 # [S, R + 2N]
    r, n = cfg.time_step_rank, cfg.state_size
    ts = ssm[:, :r]
    b = ssm[:, r:r + n].to(_F32)
    c = ssm[:, r + n:].to(_F32)
    if cfg.mixer_rms_eps is not None:
        ts = _rms_nw(ts.to(_F32), cfg.mixer_rms_eps).to(ts.dtype)
        b = _rms_nw(b, cfg.mixer_rms_eps)
        c = _rms_nw(c, cfg.mixer_rms_eps)
    dt = F.softplus((mm(ts, lp["w_dt"]) + lp["b_dt"]).to(_F32))   # [S, E]
    a = -torch.exp(lp["A_log"].to(_F32))                          # [E, N]
    da = torch.exp(dt[:, :, None] * a[None])
    dbu = dt[:, :, None] * b[:, None, :] * u[:, :, None]
    return da, dbu, c


def _in_proj(lp: dict, x: torch.Tensor):
    proj = mm(x, lp["w_in"])
    if "b_in" in lp:
        proj = proj + lp["b_in"]
    return proj.chunk(2, dim=-1)


def _out(cfg: MambaConfig, lp: dict, x, y, u, gate):
    """(y + D u) * silu(gate) through out_proj, in x's dtype."""
    y = y + u * lp["D"].to(_F32)
    y = y * F.silu(gate.to(_F32))
    out = mm(y.to(x.dtype), lp["w_out"])
    if "b_out" in lp:
        out = out + lp["b_out"]
    return out


def _mixer_full(cfg: MambaConfig, lp: dict, x, true_len, conv_state=None, ssm_state=None):
    """The mixer over a block x [S, E_model] of ``true_len`` valid rows, by
    the parallel scan, continuing from ``conv_state`` [E, K] and
    ``ssm_state`` [E, N] where given (zero states give the unblocked bits).
    Returns (out [S, E_model], conv_state, ssm_state)."""
    s, k = x.shape[0], cfg.conv_kernel
    u_raw, gate = _in_proj(lp, x)
    valid = (torch.arange(s, device=x.device) < true_len)[:, None]
    u_raw = torch.where(valid, u_raw, torch.zeros_like(u_raw))
    if conv_state is not None and k > 1:
        ext = torch.cat([conv_state.t()[-(k - 1):].to(u_raw.dtype), u_raw])
        u = F.silu(causal_depthwise_conv(ext, lp["conv_w"], lp.get("conv_b")))[k - 1:]
    else:
        u = F.silu(causal_depthwise_conv(u_raw, lp["conv_w"], lp.get("conv_b")))
    u = torch.where(valid, u, torch.zeros_like(u))
    da, dbu, c = _selection(cfg, lp, u)
    pad = ~valid[..., None]
    da.masked_fill_(pad, 1.0)                # padded rows: identity steps
    dbu.masked_fill_(pad, 0.0)
    a_acc, h = linear_scan(da, dbu)
    del da, dbu
    if ssm_state is not None:
        h = h + a_acc * ssm_state[None]
    del a_acc
    y = torch.bmm(h, c[:, :, None])[..., 0]                       # [S, E] f32
    out = _out(cfg, lp, x, y, u, gate)
    if conv_state is not None:
        ext_raw = torch.cat([conv_state.t().to(u_raw.dtype), u_raw])
        new_conv = conv_state_tail(ext_raw, true_len + k, k, x.dtype)
    else:
        new_conv = conv_state_tail(u_raw, true_len, k, x.dtype)
    return out, new_conv, last_row(h, true_len)


def _mixer_step(cfg: MambaConfig, lp: dict, x, conv_state, ssm_state):
    """One decode step of x [1, E_model] off the carried states. Returns
    (out [1, E_model], conv_state, ssm_state)."""
    u_raw, gate = _in_proj(lp, x)
    conv_state = torch.cat([conv_state[:, 1:], u_raw.t().to(conv_state.dtype)], dim=-1)
    u = torch.sum(conv_state.to(_F32) * lp["conv_w"].to(_F32), dim=-1)
    if "conv_b" in lp:
        u = u + lp["conv_b"].to(_F32)
    u = F.silu(u)[None]                                           # [1, E]
    da, dbu, c = _selection(cfg, lp, u)
    ssm_state = da[0] * ssm_state + dbu[0]                        # [E, N]
    y = torch.matmul(ssm_state, c[0])[None]
    return _out(cfg, lp, x, y, u, gate), conv_state, ssm_state


# ----------------------------------------------------------------- passes --

def init_caches(cfg: MambaConfig, max_seq_len: int, dtype=torch.float32,
                device=None) -> list:
    """A {"conv": [E, K] in ``dtype``, "ssm": [E, N] f32} dict a layer
    (``max_seq_len`` is unused: the state is O(1) in the context)."""
    dev = resolve_device(device)
    e = cfg.intermediate_size
    return [{"conv": torch.zeros((e, cfg.conv_kernel), dtype=dtype, device=dev),
             "ssm": torch.zeros((e, cfg.state_size), dtype=_F32, device=dev)}
            for _ in range(cfg.num_layers)]


def _embed(p: dict, tokens) -> torch.Tensor:
    return p["embed"][tokens.to(torch.long)]


def forward_fn(cfg: MambaConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [S] -> f32 logits [S, V] (uncached)."""
    h = _embed(p, tokens)
    s = tokens.shape[0]
    for lp in p["layers"]:
        mix, _, _ = _mixer_full(cfg, lp, rmsnorm_fn(h, lp["norm_w"], cfg.norm_eps), s)
        h = h + mix
    return lm_head(p, rmsnorm_fn(h, p["final_norm_w"], cfg.norm_eps))


def prefill_fn(cfg: MambaConfig, p: dict, caches: list, tokens, true_len):
    """The stateful prefill of padded ``tokens`` [S] (``true_len`` valid),
    continuing from ``caches`` and writing the states back in place.
    Returns (caches, f32 logits [V] of position ``true_len - 1``)."""
    h = _embed(p, tokens)
    for lp, cache in zip(p["layers"], caches):
        x = rmsnorm_fn(h, lp["norm_w"], cfg.norm_eps)
        mix, conv, ssm = _mixer_full(cfg, lp, x, true_len, cache["conv"], cache["ssm"])
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(ssm)
        h = h + mix
    h = rmsnorm_fn(h, p["final_norm_w"], cfg.norm_eps)
    return caches, lm_head(p, last_row(h, true_len))


def decode_step_fn(cfg: MambaConfig, p: dict, caches: list, token, pos):
    """One decode step (``pos`` unused: no positional encoding); the states
    written in place. Returns (caches, f32 logits [V])."""
    dev = p["embed"].device
    h = _embed(p, torch.as_tensor(token, device=dev).reshape(1))
    for lp, cache in zip(p["layers"], caches):
        x = rmsnorm_fn(h, lp["norm_w"], cfg.norm_eps)
        mix, conv, ssm = _mixer_step(cfg, lp, x, cache["conv"], cache["ssm"])
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(ssm)
        h = h + mix
    return caches, lm_head(p, rmsnorm_fn(h, p["final_norm_w"], cfg.norm_eps)[0])


def generate_scan_fn(cfg: MambaConfig, n_steps: int, p: dict, caches: list, token,
                     pos) -> torch.Tensor:
    """``n_steps`` greedy decode steps; int32 tokens [n_steps]."""
    return greedy_scan(decode_step_fn, cfg, n_steps, p, caches, token, pos)


def init_params(cfg: MambaConfig, seed: int = 0, dtype=torch.bfloat16, device=None) -> dict:
    """Random weights from ``seed`` in the tree ``from_safetensors`` builds,
    on ``device`` (the card unless named): projections and the conv normal
    with std 0.02 (drawn a slab at a time), norms and D ones, A_log =
    log(1..N) and the dt bias the inverse softplus of a log-uniform step in
    [0.001, 0.1] (transformers' MambaMixer initialisation)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    e, di, n, r = cfg.hidden_size, cfg.intermediate_size, cfg.state_size, cfg.time_step_rank

    def w(*shape, dt=dtype):
        return random_normal(shape, g, dt)

    a_log = torch.log(torch.arange(1, n + 1, dtype=_F32, device=dev)).expand(di, n)
    layers = []
    for _ in range(cfg.num_layers):
        step = torch.exp(torch.rand(di, generator=g, device=dev)
                         * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        lp = {"norm_w": torch.ones(e, dtype=_F32, device=dev), "w_in": w(e, 2 * di),
              "w_x": w(di, r + 2 * n), "w_dt": w(r, di),
              "b_dt": (step + torch.log(-torch.expm1(-step))).to(dtype),
              "w_out": w(di, e), "conv_w": w(di, cfg.conv_kernel),
              "A_log": a_log.contiguous(), "D": torch.ones(di, dtype=_F32, device=dev)}
        if cfg.use_conv_bias:
            lp["conv_b"] = w(di)
        if cfg.use_bias:
            lp["b_in"], lp["b_out"] = w(2 * di), w(e)
        layers.append(lp)
    return {"embed": w(cfg.vocab_size, e), "final_norm_w": torch.ones(e, dtype=_F32, device=dev),
            "lm_head": None if cfg.tie_word_embeddings else w(e, cfg.vocab_size),
            "layers": layers}


class MambaModel(StandaloneCachedModel):
    """Mamba with its O(1) conv + SSM cache (``_base.StandaloneCachedModel``);
    a prompt longer than ``_prefill_block`` streams through the stateful
    prefill in blocks."""

    _prefill_fn = staticmethod(prefill_fn)
    _generate_scan_fn = staticmethod(generate_scan_fn)
    _forward_fn = staticmethod(forward_fn)
    _init_caches = staticmethod(init_caches)
    _decode_step_fn = staticmethod(decode_step_fn)
    _stateful_prefill = True
    _prefill_block = 4096
    _name = "mamba"

    def __init__(self, config: MambaConfig, params: dict, dtype=torch.float32):
        self.config = config
        self.params = params
        self.dtype = dtype
        self._setup()

    @classmethod
    def from_safetensors(cls, path, dtype=torch.float32, device=None) -> "MambaModel":
        """A transformers Mamba or FalconMamba checkpoint: projections
        transposed to [in, out] in ``dtype``, norms, A_log and D in f32, the
        conv [E, 1, K] as [E, K]; on ``device`` (the card unless named)."""
        from ..safetensors import load_safetensors
        dev = resolve_device(device)
        st = load_safetensors(path)
        cj = Path(path if Path(path).is_dir() else Path(path).parent) / "config.json"
        cfg = MambaConfig.from_hf(json.loads(cj.read_text()) if cj.exists() else {})

        def t(name, transpose=False, dt=dtype):
            a = st.tensor(name).to(device=dev, dtype=dt)
            return a.t().contiguous() if transpose else a

        lps = []
        for pre in (f"backbone.layers.{i}." for i in range(cfg.num_layers)):
            lp = {"norm_w": t(pre + "norm.weight", dt=_F32),
                  "w_in": t(pre + "mixer.in_proj.weight", True),
                  "w_x": t(pre + "mixer.x_proj.weight", True),
                  "w_dt": t(pre + "mixer.dt_proj.weight", True),
                  "b_dt": t(pre + "mixer.dt_proj.bias"),
                  "w_out": t(pre + "mixer.out_proj.weight", True),
                  "conv_w": t(pre + "mixer.conv1d.weight")[:, 0, :].contiguous(),
                  "A_log": t(pre + "mixer.A_log", dt=_F32),
                  "D": t(pre + "mixer.D", dt=_F32)}
            if cfg.use_conv_bias:
                lp["conv_b"] = t(pre + "mixer.conv1d.bias")
            if cfg.use_bias:
                lp["b_in"] = t(pre + "mixer.in_proj.bias")
                lp["b_out"] = t(pre + "mixer.out_proj.bias")
            lps.append(lp)
        p = {"embed": t("backbone.embeddings.weight"),
             "final_norm_w": t("backbone.norm_f.weight", dt=_F32),
             "lm_head": (t("lm_head.weight", True)
                         if "lm_head.weight" in st and not cfg.tie_word_embeddings else None),
             "layers": lps}
        return cls(cfg, p, dtype=dtype)
