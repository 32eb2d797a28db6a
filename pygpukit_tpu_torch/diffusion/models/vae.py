"""VAE (AutoencoderKL) for latent diffusion (counterpart of
``pygpukit_tpu/diffusion/models/vae.py``): the decoder for text-to-image,
the encoder for img2img and inpainting, on ``ops.conv.conv2d_fn``.

Params: the reference's flat tree (``conv_in.w``, ``up.0.res1.norm2.b``,
``enc.down.1.down.w``, ``mid.attn.q.w`` ...; attention projections
``[in, out]``), so ``llm.convert.params_from_jax`` carries it across. On
disk the diffusers ``AutoencoderKL`` layout, ``up_blocks.{i}`` in decoder
order. ``decode`` and ``encode`` scope ``ops.precision.f32_matmul_context``
over the VAE's own params: an f32 VAE's convolutions run with TF32 off in
cuDNN whatever the caller's flags (a bf16 FLUX's scope would not cover
them).

Beyond the reference: ``from_safetensors`` also reads the encoder and the
optional ``quant_conv`` / ``post_quant_conv`` 1x1 convolutions (SD's VAEs
have them, the FLUX and SD3 VAEs do not) where the reference reads the
decoder alone (ROADMAP C.15); ``decoder_fn`` / ``encoder_fn`` apply the
two convolutions only when the tree has them, so on the reference's trees
the two packages compute the same function. ``encode`` takes the
posterior's draw as a tensor (``noise``) or draws it from a torch
generator seeded with ``seed``, where the reference takes a ``jax.random``
key.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ...core.backend import resolve_device
from ...llm.safetensors import load_safetensors
from ...ops.conv import conv2d_fn
from ...ops.precision import f32_matmul_context
from .._common import dot, silu, tensor_on

_F32 = torch.float32


@dataclass
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0


def groupnorm_nchw(x, w, b, groups: int, eps: float = 1e-6) -> torch.Tensor:
    n, c, h, wd = x.shape
    xg = x.to(_F32).reshape(n, groups, c // groups, h, wd)
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = xg.var(dim=(2, 3, 4), keepdim=True, correction=0)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(n, c, h, wd)
    return (y * w[None, :, None, None] + b[None, :, None, None]).to(x.dtype)


def _conv(p: dict, name: str, x, stride: int = 1, padding: int = 1):
    return conv2d_fn(x, p[f"{name}.w"], p.get(f"{name}.b"), stride=stride, padding=padding)


def resnet_block(p: dict, prefix: str, x, groups: int):
    h = groupnorm_nchw(x, p[f"{prefix}.norm1.w"], p[f"{prefix}.norm1.b"], groups)
    h = _conv(p, f"{prefix}.conv1", silu(h))
    h = groupnorm_nchw(h, p[f"{prefix}.norm2.w"], p[f"{prefix}.norm2.b"], groups)
    h = _conv(p, f"{prefix}.conv2", silu(h))
    if f"{prefix}.shortcut.w" in p:
        x = _conv(p, f"{prefix}.shortcut", x, padding=0)
    return x + h


def attn_block(p: dict, prefix: str, x, groups: int):
    """Single-head spatial self-attention (the mid blocks)."""
    n, c, h, w = x.shape
    y = groupnorm_nchw(x, p[f"{prefix}.norm.w"], p[f"{prefix}.norm.b"], groups)
    flat = y.reshape(n, c, h * w).transpose(1, 2)                 # [N, HW, C]
    q, k, v = (dot(flat, p[f"{prefix}.{nm}.w"]) + p[f"{prefix}.{nm}.b"] for nm in "qkv")
    scores = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(c)
    att = torch.matmul(torch.softmax(scores, dim=-1), v)
    out = dot(att, p[f"{prefix}.proj.w"]) + p[f"{prefix}.proj.b"]
    return x + out.transpose(1, 2).reshape(n, c, h, w)


def upsample2x(p: dict, prefix: str, x):
    """Nearest 2x (``jax.image.resize`` "nearest": output i reads i // 2),
    then a 3x3 conv."""
    return _conv(p, f"{prefix}.conv", F.interpolate(x, scale_factor=2, mode="nearest"))


def decoder_fn(cfg: VAEConfig, p: dict, z):
    """latents [N, Cz, H, W] -> image [N, 3, 8H, 8W] in [-1, 1]."""
    groups = cfg.norm_groups
    z = z / cfg.scaling_factor + cfg.shift_factor
    if "post_quant_conv.w" in p:
        z = _conv(p, "post_quant_conv", z, padding=0)
    h = _conv(p, "conv_in", z)
    h = resnet_block(p, "mid.res1", h, groups)
    h = attn_block(p, "mid.attn", h, groups)
    h = resnet_block(p, "mid.res2", h, groups)
    n_blocks = len(cfg.block_out_channels)
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block + 1):
            h = resnet_block(p, f"up.{i}.res{j}", h, groups)
        if i < n_blocks - 1:
            h = upsample2x(p, f"up.{i}.upsample", h)
    h = groupnorm_nchw(h, p["norm_out.w"], p["norm_out.b"], groups)
    return _conv(p, "conv_out", silu(h))


def encoder_fn(cfg: VAEConfig, p: dict, x, noise=None, generator=None):
    """image [N, 3, H, W] -> latents [N, Cz, H/8, W/8]: the posterior's mean,
    or a sample of it with ``noise`` (a tensor of the mean's shape) or a
    draw from ``generator``."""
    groups = cfg.norm_groups
    h = _conv(p, "enc.conv_in", x)
    n_blocks = len(cfg.block_out_channels)
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block):
            h = resnet_block(p, f"enc.down.{i}.res{j}", h, groups)
        if i < n_blocks - 1:
            # diffusers Downsample2D: an asymmetric (0, 1) pad, then a
            # stride-2 conv, so H -> H/2 exactly
            h = conv2d_fn(F.pad(h, (0, 1, 0, 1)), p[f"enc.down.{i}.down.w"],
                          p.get(f"enc.down.{i}.down.b"), stride=2, padding=0)
    h = resnet_block(p, "enc.mid.res1", h, groups)
    h = attn_block(p, "enc.mid.attn", h, groups)
    h = resnet_block(p, "enc.mid.res2", h, groups)
    h = groupnorm_nchw(h, p["enc.norm_out.w"], p["enc.norm_out.b"], groups)
    moments = _conv(p, "enc.conv_out", silu(h))
    if "enc.quant_conv.w" in p:
        moments = _conv(p, "enc.quant_conv", moments, padding=0)
    mean, logvar = moments.chunk(2, dim=1)
    if noise is None and generator is not None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    if noise is not None:
        mean = mean + torch.exp(0.5 * torch.clamp(logvar, -30, 20)) * noise
    return (mean - cfg.shift_factor) * cfg.scaling_factor


# ----------------------------------------------------------------- layout --

def _layout(cfg: VAEConfig) -> list[tuple[str, str, str, tuple]]:
    """(our prefix, diffusers prefix, kind, weight shape) of every conv
    ("conv"), norm ("norm") and attention projection ("lin") of the
    decoder, then the encoder: what ``init_random`` draws and
    ``from_safetensors`` reads."""
    out: list = []

    def conv(ours, theirs, ci, co, k=3):
        out.append((ours, theirs, "conv", (co, ci, k, k)))

    def res(ours, theirs, ci, co):
        out.append((f"{ours}.norm1", f"{theirs}.norm1", "norm", (ci,)))
        conv(f"{ours}.conv1", f"{theirs}.conv1", ci, co)
        out.append((f"{ours}.norm2", f"{theirs}.norm2", "norm", (co,)))
        conv(f"{ours}.conv2", f"{theirs}.conv2", co, co)
        if ci != co:
            conv(f"{ours}.shortcut", f"{theirs}.conv_shortcut", ci, co, k=1)

    def mid(ours, theirs, c):
        res(f"{ours}.res1", f"{theirs}.resnets.0", c, c)
        out.append((f"{ours}.attn.norm", f"{theirs}.attentions.0.group_norm", "norm", (c,)))
        for nm, hf in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("proj", "to_out.0")):
            out.append((f"{ours}.attn.{nm}", f"{theirs}.attentions.0.{hf}", "lin", (c, c)))
        res(f"{ours}.res2", f"{theirs}.resnets.1", c, c)

    chans = list(reversed(cfg.block_out_channels))               # decoder order
    d = "decoder"
    conv("conv_in", f"{d}.conv_in", cfg.latent_channels, chans[0])
    mid("mid", f"{d}.mid_block", chans[0])
    cur = chans[0]
    for i, co in enumerate(chans):
        for j in range(cfg.layers_per_block + 1):
            res(f"up.{i}.res{j}", f"{d}.up_blocks.{i}.resnets.{j}", cur, co)
            cur = co
        if i < len(chans) - 1:
            conv(f"up.{i}.upsample.conv", f"{d}.up_blocks.{i}.upsamplers.0.conv", cur, cur)
    out.append(("norm_out", f"{d}.conv_norm_out", "norm", (cur,)))
    conv("conv_out", f"{d}.conv_out", cur, cfg.in_channels)
    e, enc = "encoder", list(cfg.block_out_channels)
    conv("enc.conv_in", f"{e}.conv_in", cfg.in_channels, enc[0])
    cur = enc[0]
    for i, co in enumerate(enc):
        for j in range(cfg.layers_per_block):
            res(f"enc.down.{i}.res{j}", f"{e}.down_blocks.{i}.resnets.{j}", cur, co)
            cur = co
        if i < len(enc) - 1:
            conv(f"enc.down.{i}.down", f"{e}.down_blocks.{i}.downsamplers.0.conv", cur, cur)
    mid("enc.mid", f"{e}.mid_block", cur)
    out.append(("enc.norm_out", f"{e}.conv_norm_out", "norm", (cur,)))
    conv("enc.conv_out", f"{e}.conv_out", cur, 2 * cfg.latent_channels)
    return out


_QUANT = (("post_quant_conv", "post_quant_conv"), ("enc.quant_conv", "quant_conv"))


def diffusers_tensors(params: dict, cfg: VAEConfig) -> dict:
    """``params`` under their diffusers names, attention projections back
    to [out, in]: what ``from_safetensors`` reads."""
    out = {}
    for ours, theirs, kind, _ in _layout(cfg):
        if f"{ours}.w" in params:
            w = params[f"{ours}.w"]
            out[f"{theirs}.weight"] = w.T.contiguous() if kind == "lin" else w
            out[f"{theirs}.bias"] = params[f"{ours}.b"]
    for ours, theirs in _QUANT:
        if f"{ours}.w" in params:
            out[f"{theirs}.weight"], out[f"{theirs}.bias"] = (params[f"{ours}.w"],
                                                             params[f"{ours}.b"])
    return out


class VAE:
    """The VAE on one device (reference: ``VAE``)."""

    def __init__(self, config: VAEConfig, params: dict):
        self.config = config
        self.params = params
        self.device = params["conv_in.w"].device

    def decode(self, latents) -> torch.Tensor:
        with f32_matmul_context(self.params):
            return decoder_fn(self.config, self.params, tensor_on(latents, self.device))

    def encode(self, images, seed: int | None = None, noise=None) -> torch.Tensor:
        """The posterior's mean, or a sample with ``noise`` given or drawn
        from a torch generator seeded with ``seed``."""
        g = None
        if seed is not None and noise is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(seed)
        if noise is not None:
            noise = tensor_on(noise, self.device)
        with f32_matmul_context(self.params):
            return encoder_fn(self.config, self.params, tensor_on(images, self.device),
                              noise, g)

    def decode_to_images(self, latents) -> np.ndarray:
        """-> uint8 [N, H, W, 3] (rounded on the host, as the reference)."""
        img = self.decode(latents).cpu().numpy().astype(np.float32)
        img = np.clip(img / 2 + 0.5, 0, 1)
        return (img.transpose(0, 2, 3, 1) * 255).round().astype(np.uint8)

    # -- init / loading ------------------------------------------------------

    @classmethod
    def init_random(cls, config: VAEConfig | None = None, seed: int = 0,
                    device=None) -> "VAE":
        """Random f32 params drawn on ``device`` (the card unless named) from
        a torch generator seeded with ``seed``, the reference's
        distribution: convs N(0, 0.25 / fan_in), projections N(0, 1 / c),
        biases 0, norms (1, 0)."""
        cfg = config or VAEConfig()
        dev = resolve_device(device)
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        p: dict = {}
        for ours, _, kind, shape in _layout(cfg):
            c = shape[0]
            if kind == "norm":
                p[f"{ours}.w"] = torch.ones(shape, dtype=_F32, device=dev)
            else:
                fan = shape[1] * (shape[2] * shape[3] if kind == "conv" else 1)
                std = (0.5 if kind == "conv" else 1.0) / math.sqrt(fan)
                p[f"{ours}.w"] = torch.randn(shape, generator=g, device=dev) * std
            p[f"{ours}.b"] = torch.zeros((c,), dtype=_F32, device=dev)
        return cls(cfg, p)

    @classmethod
    def from_safetensors(cls, path, config: VAEConfig | None = None, device=None) -> "VAE":
        """A diffusers AutoencoderKL checkpoint on ``device`` (the card
        unless named), f32: the latent channels from ``decoder.conv_in``,
        the scaling and shift factors, the block widths (and, beyond the
        reference, the layers a block, the norm groups and the image
        channels) from the sibling config.json when present; the decoder,
        then the encoder and the quant convolutions where the file has
        them."""
        dev = resolve_device(device)
        with load_safetensors(path) as st:
            if config is None:
                kw = {"latent_channels": int(st.tensor_shape("decoder.conv_in.weight")[1])}
                base = Path(path)
                cj = (base if base.is_dir() else base.parent) / "config.json"
                if cj.exists():
                    hf = json.loads(cj.read_text())
                    kw["scaling_factor"] = hf.get("scaling_factor", 0.18215)
                    kw["shift_factor"] = hf.get("shift_factor", 0.0) or 0.0
                    if "block_out_channels" in hf:
                        kw["block_out_channels"] = tuple(hf["block_out_channels"])
                    for ours, theirs in (("layers_per_block", "layers_per_block"),
                                         ("norm_groups", "norm_num_groups"),
                                         ("in_channels", "in_channels")):
                        if theirs in hf:
                            kw[ours] = hf[theirs]
                config = VAEConfig(**kw)

            def t(name: str, transposed: bool = False) -> torch.Tensor:
                x = st.tensor(name).to(dev, copy=True).to(_F32)
                return x.T.contiguous() if transposed else x
            p: dict = {}
            for ours, theirs, kind, _ in _layout(config):
                if f"{theirs}.weight" not in st:
                    if theirs.startswith("encoder."):
                        continue                        # a decoder-only file
                    raise KeyError(f"{theirs}.weight is not in the checkpoint")
                p[f"{ours}.w"] = t(f"{theirs}.weight", kind == "lin")
                p[f"{ours}.b"] = t(f"{theirs}.bias")
            for ours, theirs in _QUANT:
                if f"{theirs}.weight" in st:
                    p[f"{ours}.w"], p[f"{ours}.b"] = t(f"{theirs}.weight"), t(f"{theirs}.bias")
        return cls(config, p)
