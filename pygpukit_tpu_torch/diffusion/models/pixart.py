"""PixArt-alpha transformer over the diffusers checkpoint layout
(counterpart of ``pygpukit_tpu/diffusion/models/pixart.py``):
ada_norm_single conditioning (one shared adaLN projection plus per-block
``scale_shift_table`` offsets), self-attention, cross-attention to the
projected T5 caption, the tanh-GELU feed-forward, the learned-sigma
8-channel output; the 1024 checkpoints' resolution and aspect-ratio
embedders as an option.

``state_dict_spec`` enumerates every checkpoint key and shape;
``params_from_state_dict`` maps a flat state dict to the reference's tree
(stacked ``blocks`` ``[L, ...]``; the 2-D sin-cos position table computed
on the host in numpy, the reference's bits).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ...core.backend import resolve_device
from ...llm.safetensors import SafeTensorsFile
from ...ops.precision import full_f32_context
from .._common import attention_heads, gelu_tanh, layer, linear, ln, silu, tensor_on
from .flux import timestep_embedding
from .sd3 import as_f32, patch_embed, unpatch

_F32 = torch.float32


@dataclass
class PixArtConfig:
    sample_size: int = 64            # latent H=W (512px model: 64)
    patch_size: int = 2
    in_channels: int = 4
    out_channels: int = 8            # learned sigma: eps + var
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    caption_dim: int = 4096          # T5-XXL features
    ff_mult: int = 4
    base_size: int = 32              # sample_size // patch of the 512 model
    interpolation_scale: float = 1.0
    #: PixArt-alpha 1024 checkpoints condition on resolution + aspect ratio
    #: (adaln_single.emb.{resolution,aspect_ratio}_embedder)
    use_additional_conditions: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# -------------------------------------------------------------- key layout --

def state_dict_spec(cfg: PixArtConfig | None = None) -> dict[str, tuple]:
    """diffusers PixArtTransformer2DModel key -> shape."""
    c = cfg or PixArtConfig()
    h, ff = c.hidden_size, c.hidden_size * c.ff_mult
    keys: dict[str, tuple] = {
        "pos_embed.proj.weight": (h, c.in_channels, c.patch_size, c.patch_size),
        "pos_embed.proj.bias": (h,),
        "caption_projection.linear_1.weight": (h, c.caption_dim),
        "caption_projection.linear_1.bias": (h,),
        "caption_projection.linear_2.weight": (h, h),
        "caption_projection.linear_2.bias": (h,),
        "adaln_single.emb.timestep_embedder.linear_1.weight": (h, 256),
        "adaln_single.emb.timestep_embedder.linear_1.bias": (h,),
        "adaln_single.emb.timestep_embedder.linear_2.weight": (h, h),
        "adaln_single.emb.timestep_embedder.linear_2.bias": (h,),
        "adaln_single.linear.weight": (6 * h, h),
        "adaln_single.linear.bias": (6 * h,),
    }
    if c.use_additional_conditions:
        # diffusers PixArtAlphaCombinedTimestepSizeEmbeddings: each size
        # scalar embeds 256-sinusoidal -> Linear(256, h//3) -> Linear(h//3,
        # h//3); cat(resolution [2*h//3], aspect [h//3]) adds to the t-emb
        se = h // 3
        for emb in ("resolution_embedder", "aspect_ratio_embedder"):
            keys[f"adaln_single.emb.{emb}.linear_1.weight"] = (se, 256)
            keys[f"adaln_single.emb.{emb}.linear_1.bias"] = (se,)
            keys[f"adaln_single.emb.{emb}.linear_2.weight"] = (se, se)
            keys[f"adaln_single.emb.{emb}.linear_2.bias"] = (se,)
    keys.update({
        "scale_shift_table": (2, h),
        "proj_out.weight": (c.patch_size ** 2 * c.out_channels, h),
        "proj_out.bias": (c.patch_size ** 2 * c.out_channels,),
    })
    for n in range(c.depth):
        b = f"transformer_blocks.{n}"
        keys[f"{b}.scale_shift_table"] = (6, h)
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                keys[f"{b}.{attn}.{proj}.weight"] = (h, h)
                keys[f"{b}.{attn}.{proj}.bias"] = (h,)
            keys[f"{b}.{attn}.to_out.0.weight"] = (h, h)
            keys[f"{b}.{attn}.to_out.0.bias"] = (h,)
        keys[f"{b}.ff.net.0.proj.weight"] = (ff, h)
        keys[f"{b}.ff.net.0.proj.bias"] = (ff,)
        keys[f"{b}.ff.net.2.weight"] = (h, ff)
        keys[f"{b}.ff.net.2.bias"] = (h,)
    return keys


# ------------------------------------------------------------- pos embed --

def _sincos_1d(dim, pos):
    omega = 1.0 / 10000 ** (np.arange(dim // 2) / (dim / 2.0))
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_pos_embed_2d(dim: int, grid: int, base_size: int,
                        interpolation_scale: float) -> np.ndarray:
    """diffusers get_2d_sincos_pos_embed (w-major meshgrid, h-emb first)."""
    coords = np.arange(grid) / (grid / base_size) / interpolation_scale
    gw, gh = np.meshgrid(coords, coords)        # both [h, w]
    emb_h = _sincos_1d(dim // 2, gw)            # grid[0] = w component
    emb_w = _sincos_1d(dim // 2, gh)
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


# --------------------------------------------------------------- forward --

def _attn(x_q, x_kv, lp: dict, prefix: str, n_heads: int) -> torch.Tensor:
    t, e = x_q.shape
    d = e // n_heads
    q, k, v = (linear(lp, f"{prefix}.{nm}", src).reshape(src.shape[0], n_heads, d)
               .transpose(0, 1) for nm, src in (("q", x_q), ("k", x_kv), ("v", x_kv)))
    out = attention_heads(q, k, v).transpose(0, 1).reshape(t, e).to(x_q.dtype)
    return linear(lp, f"{prefix}.o", out)


def pixart_forward_fn(cfg: PixArtConfig, p: dict, latent, timestep, caption,
                      resolution=None, aspect_ratio=None):
    """latent [C, H, W], timestep a 0-d f32 tensor, caption [Tc,
    caption_dim] -> eps and variance [out_channels, H, W]. The 1024
    checkpoints (``use_additional_conditions``) also embed the resolution
    [2] and the aspect ratio [1] (by default the latent's, in pixels)."""
    c = cfg
    dev = latent.device
    ph, pw = latent.shape[1] // c.patch_size, latent.shape[2] // c.patch_size
    x = patch_embed(latent, p["patch.w"], p["patch.b"], c.patch_size)
    x = x + p["pos_embed"][:x.shape[0]]

    # ada_norm_single conditioning
    emb_t = linear(p, "t.out", silu(linear(p, "t.in", timestep_embedding(timestep, 256))))
    if cfg.use_additional_conditions:
        res = (torch.tensor([float(latent.shape[1] * 8), float(latent.shape[2] * 8)],
                            dtype=_F32, device=dev)
               if resolution is None else tensor_on(resolution, dev, _F32))
        ar = (torch.tensor([latent.shape[1] / latent.shape[2]], dtype=_F32, device=dev)
              if aspect_ratio is None else tensor_on(aspect_ratio, dev, _F32))

        def size_emb(vals, pre):
            """Each scalar -> 256-sinusoidal -> 2-layer MLP -> [h//3],
            concatenated over the scalars."""
            return torch.cat([linear(p, f"{pre}.out", silu(linear(
                p, f"{pre}.in", timestep_embedding(vals[i], 256))))
                for i in range(vals.shape[0])])

        emb_t = emb_t + torch.cat([size_emb(res, "res"), size_emb(ar, "ar")])
    cond6 = linear(p, "adaln", silu(emb_t))

    # caption projection: linear -> gelu(tanh) -> linear
    ctx = linear(p, "cap.out", gelu_tanh(linear(p, "cap.in", caption)))   # [Tc, hid]

    blocks = p["blocks"]
    for i in range(blocks["scale_shift_table"].shape[0]):
        lp = layer(blocks, i)
        sh1, sc1, g1, sh2, sc2, g2 = lp["scale_shift_table"] + cond6.reshape(6, -1)
        h = ln(x) * (1 + sc1) + sh1
        x = x + g1 * _attn(h, h, lp, "attn1", c.num_heads)
        x = x + _attn(x, ctx, lp, "attn2", c.num_heads)       # no norm (ada_norm_single)
        h = ln(x) * (1 + sc2) + sh2
        x = x + g2 * linear(lp, "ff.out", gelu_tanh(linear(lp, "ff.in", h)))

    shift, scale = p["scale_shift_table"] + emb_t[None]
    x = linear(p, "out", ln(x) * (1 + scale) + shift)               # [T, pp*out_ch]
    return unpatch(x, ph, pw, c.patch_size, c.out_channels)


# ---------------------------------------------------------------- loading --

_TOP = {"cap.in": "caption_projection.linear_1", "cap.out": "caption_projection.linear_2",
        "t.in": "adaln_single.emb.timestep_embedder.linear_1",
        "t.out": "adaln_single.emb.timestep_embedder.linear_2",
        "adaln": "adaln_single.linear", "out": "proj_out"}
_SIZE = {"res.in": "adaln_single.emb.resolution_embedder.linear_1",
         "res.out": "adaln_single.emb.resolution_embedder.linear_2",
         "ar.in": "adaln_single.emb.aspect_ratio_embedder.linear_1",
         "ar.out": "adaln_single.emb.aspect_ratio_embedder.linear_2"}
_BLOCK = {f"{a}.{s}": f"{a}.{proj}" for a in ("attn1", "attn2")
          for s, proj in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("o", "to_out.0"))}
_BLOCK.update({"ff.in": "ff.net.0.proj", "ff.out": "ff.net.2"})


def params_from_state_dict(flat: dict, cfg: PixArtConfig, device=None) -> dict:
    """A flat diffusers state dict (numpy arrays or tensors) -> the param
    tree in f32, on ``device`` when given, else where each value is (numpy
    on the host); the blocks stacked."""
    dev = device

    def lin(dst: dict, ours: str, theirs: str) -> None:
        dst[f"{ours}.w"] = as_f32(flat[f"{theirs}.weight"], dev).T.contiguous()
        dst[f"{ours}.b"] = as_f32(flat[f"{theirs}.bias"], dev)

    patch_w = as_f32(flat["pos_embed.proj.weight"], dev)
    p = {"patch.w": patch_w, "patch.b": as_f32(flat["pos_embed.proj.bias"], dev),
         "pos_embed": torch.from_numpy(sincos_pos_embed_2d(
             cfg.hidden_size, cfg.sample_size // cfg.patch_size, cfg.base_size,
             cfg.interpolation_scale)).to(patch_w.device),
         "scale_shift_table": as_f32(flat["scale_shift_table"], dev)}
    for ours, theirs in {**_TOP, **(_SIZE if cfg.use_additional_conditions else {})}.items():
        lin(p, ours, theirs)
    per_block = []
    for n in range(cfg.depth):
        b = f"transformer_blocks.{n}"
        lp = {"scale_shift_table": as_f32(flat[f"{b}.scale_shift_table"], dev)}
        for ours, theirs in _BLOCK.items():
            lin(lp, ours, f"{b}.{theirs}")
        per_block.append(lp)
    p["blocks"] = {k: torch.stack([lp[k] for lp in per_block]) for k in per_block[0]}
    return p


def init_random_flat(cfg: PixArtConfig | None = None, seed: int = 0, scale: float = 0.02,
                     device=None) -> dict[str, torch.Tensor]:
    """A random flat state dict in the checkpoint layout, drawn on
    ``device`` (the card unless named) from a torch generator seeded with
    ``seed``: weights and scale-shift tables N(0, scale^2), biases 0 (the
    reference's distribution; it draws from numpy)."""
    cfg = cfg or PixArtConfig()
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return {name: (torch.zeros(shape, device=dev) if name.endswith("bias")
                   else torch.randn(shape, generator=g, device=dev) * scale)
            for name, shape in state_dict_spec(cfg).items()}


def config_from_hf(hf: dict) -> PixArtConfig:
    """A diffusers transformer config.json -> PixArtConfig (the 1024
    checkpoints turn on the size conditioners; base_size is sample_size //
    patch_size, diffusers' PatchEmbed)."""
    heads = hf.get("num_attention_heads", 16)
    sample, patch = hf.get("sample_size", 64), hf.get("patch_size", 2)
    return PixArtConfig(
        sample_size=sample, patch_size=patch, in_channels=hf.get("in_channels", 4),
        out_channels=hf.get("out_channels", 8),
        hidden_size=heads * hf.get("attention_head_dim", 72),
        depth=hf.get("num_layers", 28), num_heads=heads,
        caption_dim=hf.get("caption_channels", 4096), base_size=sample // patch,
        interpolation_scale=hf.get("interpolation_scale", 1.0) or 1.0,
        use_additional_conditions=bool(hf.get("use_additional_conditions", sample == 128)))


class PixArtTransformer:
    """The PixArt-alpha denoiser on one device (diffusers-checkpoint
    compatible)."""

    def __init__(self, config: PixArtConfig, params: dict):
        self.config = config
        self.params = params
        self.device = params["patch.w"].device

    def __call__(self, latent, timestep, caption):
        dev = self.device
        with full_f32_context():
            return pixart_forward_fn(self.config, self.params, tensor_on(latent, dev),
                                     tensor_on(timestep, dev, _F32), tensor_on(caption, dev))

    @classmethod
    def from_state_dict(cls, flat: dict, config: PixArtConfig | None = None,
                        device=None) -> "PixArtTransformer":
        cfg = config or PixArtConfig()
        return cls(cfg, params_from_state_dict(flat, cfg, device))

    @classmethod
    def from_safetensors(cls, path, config: PixArtConfig | None = None,
                         device=None) -> "PixArtTransformer":
        """transformer/*.safetensors (diffusers layout) on ``device`` (the
        card unless named); the dims from the sibling config.json when
        present."""
        dev = resolve_device(device)
        path = Path(path)
        base = path if path.is_dir() else path.parent
        if path.is_dir():
            cands = sorted(path.glob("*.safetensors"))
            if not cands:
                raise FileNotFoundError(f"no safetensors under {path}")
            path = cands[0]
        if config is None and (base / "config.json").exists():
            config = config_from_hf(json.loads((base / "config.json").read_text()))
        with SafeTensorsFile(path) as st:
            return cls.from_state_dict({k: st.tensor(k) for k in st.keys()}, config, dev)

    @classmethod
    def init_random(cls, config: PixArtConfig | None = None, seed: int = 0,
                    device=None) -> "PixArtTransformer":
        cfg = config or PixArtConfig()
        dev = resolve_device(device)
        return cls.from_state_dict(init_random_flat(cfg, seed, device=dev), cfg, dev)
