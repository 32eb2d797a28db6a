"""Stable Diffusion 3 MMDiT over the diffusers checkpoint layout
(counterpart of ``pygpukit_tpu/diffusion/models/sd3.py``): joint
dual-stream blocks (latent and text tokens each get AdaLayerNormZero
modulation, attend in one joint attention and keep separate MLPs), the last
block without the context stream's output, AdaLayerNormContinuous and
proj_out as the head; SD3.5's per-stream RMS q/k norms as an option.

``state_dict_spec`` enumerates every checkpoint key and shape;
``params_from_state_dict`` maps a flat state dict (numpy arrays or
tensors) to the reference's param tree (projections ``[in, out]``, the
blocks a list: the last block has another leaf set).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ...core.backend import resolve_device
from ...llm.safetensors import SafeTensorsFile
from ...ops.precision import full_f32_context
from .._common import attention_heads, gelu_tanh, linear, ln, silu, tensor_on
from .flux import timestep_embedding

_F32 = torch.float32


@dataclass
class SD3Config:
    sample_size: int = 128          # latent H=W (1024px model: 128)
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    hidden_size: int = 1536         # 24 heads * 64 (sd3-medium)
    depth: int = 24
    num_heads: int = 24
    context_dim: int = 4096         # T5 + CLIP-concat hidden
    pooled_dim: int = 2048          # CLIP-L + CLIP-G pooled
    pos_embed_max_size: int = 192
    qk_norm: bool = False           # SD3.5 uses RMS qk-norm

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# -------------------------------------------------------------- key layout --

def state_dict_spec(cfg: SD3Config | None = None) -> dict[str, tuple]:
    c = cfg or SD3Config()
    h = c.hidden_size
    keys: dict[str, tuple] = {
        "pos_embed.proj.weight": (h, c.in_channels, c.patch_size, c.patch_size),
        "pos_embed.proj.bias": (h,),
        "pos_embed.pos_embed": (1, c.pos_embed_max_size ** 2, h),
        "time_text_embed.timestep_embedder.linear_1.weight": (h, 256),
        "time_text_embed.timestep_embedder.linear_1.bias": (h,),
        "time_text_embed.timestep_embedder.linear_2.weight": (h, h),
        "time_text_embed.timestep_embedder.linear_2.bias": (h,),
        "time_text_embed.text_embedder.linear_1.weight": (h, c.pooled_dim),
        "time_text_embed.text_embedder.linear_1.bias": (h,),
        "time_text_embed.text_embedder.linear_2.weight": (h, h),
        "time_text_embed.text_embedder.linear_2.bias": (h,),
        "context_embedder.weight": (h, c.context_dim),
        "context_embedder.bias": (h,),
        "norm_out.linear.weight": (2 * h, h),
        "norm_out.linear.bias": (2 * h,),
        "proj_out.weight": (c.patch_size ** 2 * c.out_channels, h),
        "proj_out.bias": (c.patch_size ** 2 * c.out_channels,),
    }
    for n in range(c.depth):
        b = f"transformer_blocks.{n}"
        last = n == c.depth - 1
        keys[f"{b}.norm1.linear.weight"] = (6 * h, h)
        keys[f"{b}.norm1.linear.bias"] = (6 * h,)
        m = 2 if last else 6
        keys[f"{b}.norm1_context.linear.weight"] = (m * h, h)
        keys[f"{b}.norm1_context.linear.bias"] = (m * h,)
        for proj in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            keys[f"{b}.attn.{proj}.weight"] = (h, h)
            keys[f"{b}.attn.{proj}.bias"] = (h,)
        keys[f"{b}.attn.to_out.0.weight"] = (h, h)
        keys[f"{b}.attn.to_out.0.bias"] = (h,)
        if not last:
            keys[f"{b}.attn.to_add_out.weight"] = (h, h)
            keys[f"{b}.attn.to_add_out.bias"] = (h,)
        if c.qk_norm:
            for nq in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
                keys[f"{b}.attn.{nq}.weight"] = (c.head_dim,)
        keys[f"{b}.ff.net.0.proj.weight"] = (4 * h, h)
        keys[f"{b}.ff.net.0.proj.bias"] = (4 * h,)
        keys[f"{b}.ff.net.2.weight"] = (h, 4 * h)
        keys[f"{b}.ff.net.2.bias"] = (h,)
        if not last:
            keys[f"{b}.ff_context.net.0.proj.weight"] = (4 * h, h)
            keys[f"{b}.ff_context.net.0.proj.bias"] = (4 * h,)
            keys[f"{b}.ff_context.net.2.weight"] = (h, 4 * h)
            keys[f"{b}.ff_context.net.2.bias"] = (h,)
    return keys


# ---------------------------------------------------------------- forward --

def _rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(_F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def patch_embed(latent: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                patch: int) -> torch.Tensor:
    """The patch conv in f32: latent [C, H, W] -> tokens [H/p * W/p, hidden]."""
    x = F.conv2d(latent[None].to(_F32), w.to(_F32), stride=patch)[0]
    return x.reshape(x.shape[0], -1).T + b


def unpatch(x: torch.Tensor, ph: int, pw: int, patch: int, out_ch: int) -> torch.Tensor:
    """tokens [ph*pw, p*p*C] -> [C, ph*p, pw*p] (``einsum("hwpqc->chpwq")``)."""
    x = x.reshape(ph, pw, patch, patch, out_ch)
    return x.permute(4, 0, 2, 1, 3).reshape(out_ch, ph * patch, pw * patch)


def _joint_attn(cfg: SD3Config, lp: dict, xh, ch, last: bool):
    heads, d = cfg.num_heads, cfg.head_dim
    t_ctx = ch.shape[0]

    def proj(src, name):
        return linear(lp, name, src).reshape(-1, heads, d)

    q_img, k_img = proj(xh, "q"), proj(xh, "k")
    q_ctx, k_ctx = proj(ch, "aq"), proj(ch, "ak")
    if cfg.qk_norm:
        # SD3.5: norm_q / norm_k normalise the image stream, norm_added_q /
        # norm_added_k the context stream
        q_img, k_img = _rms(q_img, lp["nq"]), _rms(k_img, lp["nk"])
        q_ctx, k_ctx = _rms(q_ctx, lp["naq"]), _rms(k_ctx, lp["nak"])
    q = torch.cat([q_ctx, q_img]).transpose(0, 1)
    k = torch.cat([k_ctx, k_img]).transpose(0, 1)
    v = torch.cat([proj(ch, "av"), proj(xh, "v")]).transpose(0, 1)
    out = attention_heads(q, k, v).transpose(0, 1).reshape(-1, cfg.hidden_size)
    ctx_out, img_out = out[:t_ctx], out[t_ctx:]
    return linear(lp, "o", img_out), (None if last else linear(lp, "ao", ctx_out))


def sd3_forward_fn(cfg: SD3Config, p: dict, latent, timestep, context, pooled):
    """latent [C, H, W], timestep a 0-d f32 tensor (0..1000), context [Tc,
    ctx_dim], pooled [pooled_dim] -> prediction [C, H, W]."""
    c = cfg
    ph, pw = latent.shape[1] // c.patch_size, latent.shape[2] // c.patch_size
    x = patch_embed(latent, p["patch.w"], p["patch.b"], c.patch_size)
    # the cropped learned position embedding (diffusers cropped_pos_embed)
    m = c.pos_embed_max_size
    top, left = (m - ph) // 2, (m - pw) // 2
    pe = p["pos_embed"].reshape(m, m, c.hidden_size)
    x = x + pe[top:top + ph, left:left + pw].reshape(ph * pw, c.hidden_size)

    temb = linear(p, "t.out", silu(linear(p, "t.in", timestep_embedding(timestep, 256))))
    pemb = linear(p, "pool.out", silu(linear(p, "pool.in", pooled)))
    temb = silu(temb + pemb)                                        # [hid]
    ctx = linear(p, "ctx", context)                                  # [Tc, hid]

    n_blocks = len(p["blocks"])
    for i, lp in enumerate(p["blocks"]):
        last = i == n_blocks - 1
        sh1, sc1, g1, sh2, sc2, g2 = linear(lp, "mod", temb).chunk(6, dim=-1)
        if last:
            csh, csc = linear(lp, "cmod", temb).chunk(2, dim=-1)
            ch = ln(ctx) * (1 + csc) + csh
        else:
            csh1, csc1, cg1, csh2, csc2, cg2 = linear(lp, "cmod", temb).chunk(6, dim=-1)
            ch = ln(ctx) * (1 + csc1) + csh1
        img_attn, ctx_attn = _joint_attn(cfg, lp, ln(x) * (1 + sc1) + sh1, ch, last)
        x = x + g1 * img_attn
        h = ln(x) * (1 + sc2) + sh2
        x = x + g2 * linear(lp, "ff.out", gelu_tanh(linear(lp, "ff.in", h)))
        if not last:
            ctx = ctx + cg1 * ctx_attn
            hc = ln(ctx) * (1 + csc2) + csh2
            ctx = ctx + cg2 * linear(lp, "cff.out", gelu_tanh(linear(lp, "cff.in", hc)))

    sh, sc = linear(p, "final_mod", silu(temb)).chunk(2, dim=-1)
    x = linear(p, "out", ln(x) * (1 + sc) + sh)
    return unpatch(x, ph, pw, c.patch_size, c.out_channels)


# ---------------------------------------------------------------- loading --

def as_f32(a, device=None) -> torch.Tensor:
    """A numpy array (on the host) or a tensor as f32, on ``device`` when
    given, else where it is."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device if device is not None else t.device, dtype=_F32)


#: our leaf -> its diffusers name (linears: ".w" transposed, ".b")
_TOP = {"t.in": "time_text_embed.timestep_embedder.linear_1",
        "t.out": "time_text_embed.timestep_embedder.linear_2",
        "pool.in": "time_text_embed.text_embedder.linear_1",
        "pool.out": "time_text_embed.text_embedder.linear_2",
        "ctx": "context_embedder", "final_mod": "norm_out.linear", "out": "proj_out"}
_BLOCK = {"mod": "norm1.linear", "cmod": "norm1_context.linear", "q": "attn.to_q",
          "k": "attn.to_k", "v": "attn.to_v", "aq": "attn.add_q_proj",
          "ak": "attn.add_k_proj", "av": "attn.add_v_proj", "o": "attn.to_out.0",
          "ff.in": "ff.net.0.proj", "ff.out": "ff.net.2"}
_NOT_LAST = {"ao": "attn.to_add_out", "cff.in": "ff_context.net.0.proj",
             "cff.out": "ff_context.net.2"}
_QK = {"nq": "attn.norm_q", "nk": "attn.norm_k", "naq": "attn.norm_added_q",
       "nak": "attn.norm_added_k"}


def params_from_state_dict(flat: dict, cfg: SD3Config, device=None) -> dict:
    """A flat diffusers state dict (numpy arrays or tensors) -> the param
    tree in f32, on ``device`` when given, else where each value is (numpy
    on the host)."""
    dev = device

    def lin(dst: dict, ours: str, theirs: str) -> None:
        dst[f"{ours}.w"] = as_f32(flat[f"{theirs}.weight"], dev).T.contiguous()
        dst[f"{ours}.b"] = as_f32(flat[f"{theirs}.bias"], dev)

    p = {"patch.w": as_f32(flat["pos_embed.proj.weight"], dev),
         "patch.b": as_f32(flat["pos_embed.proj.bias"], dev),
         "pos_embed": as_f32(flat["pos_embed.pos_embed"], dev)[0]}
    for ours, theirs in _TOP.items():
        lin(p, ours, theirs)
    blocks = []
    for n in range(cfg.depth):
        b = f"transformer_blocks.{n}"
        lp: dict = {}
        for ours, theirs in {**_BLOCK, **({} if n == cfg.depth - 1 else _NOT_LAST)}.items():
            lin(lp, ours, f"{b}.{theirs}")
        if cfg.qk_norm:
            for ours, theirs in _QK.items():
                lp[ours] = as_f32(flat[f"{b}.{theirs}.weight"], dev)
        blocks.append(lp)
    # the last block has another leaf set: a list, its loop unrolled
    p["blocks"] = blocks
    return p


def init_random_flat(cfg: SD3Config | None = None, seed: int = 0, scale: float = 0.02,
                     device=None) -> dict[str, torch.Tensor]:
    """A random flat state dict in the checkpoint layout, drawn on
    ``device`` (the card unless named) from a torch generator seeded with
    ``seed``: weights N(0, scale^2), biases 0, q/k norm weights 1 (the
    reference's distribution; it draws from numpy)."""
    cfg = cfg or SD3Config()
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    flat = {}
    for name, shape in state_dict_spec(cfg).items():
        if name.endswith("bias"):
            flat[name] = torch.zeros(shape, device=dev)
        elif "norm_q" in name or "norm_k" in name or "norm_added" in name:
            flat[name] = torch.ones(shape, device=dev)
        else:
            flat[name] = torch.randn(shape, generator=g, device=dev) * scale
    return flat


class SD3Transformer:
    """The SD3 MMDiT denoiser on one device (diffusers-checkpoint
    compatible)."""

    def __init__(self, config: SD3Config, params: dict):
        self.config = config
        self.params = params
        self.device = params["patch.w"].device

    def __call__(self, latent, timestep, context, pooled):
        dev = self.device
        with full_f32_context():
            return sd3_forward_fn(self.config, self.params, tensor_on(latent, dev),
                                  tensor_on(timestep, dev, _F32), tensor_on(context, dev),
                                  tensor_on(pooled, dev))

    @classmethod
    def from_state_dict(cls, flat, config: SD3Config | None = None, device=None):
        cfg = config or SD3Config()
        return cls(cfg, params_from_state_dict(flat, cfg, device))

    @classmethod
    def from_safetensors(cls, path, config: SD3Config | None = None, device=None):
        """transformer/*.safetensors (the first file of a directory) on
        ``device`` (the card unless named)."""
        dev = resolve_device(device)
        path = Path(path)
        if path.is_dir():
            cands = sorted(path.glob("*.safetensors"))
            if not cands:
                raise FileNotFoundError(f"no safetensors under {path}")
            path = cands[0]
        with SafeTensorsFile(path) as st:
            return cls.from_state_dict({k: st.tensor(k) for k in st.keys()}, config, dev)

    @classmethod
    def init_random(cls, config: SD3Config | None = None, seed: int = 0, device=None):
        cfg = config or SD3Config()
        dev = resolve_device(device)
        return cls.from_state_dict(init_random_flat(cfg, seed, device=dev), cfg, dev)
