"""DiT with adaLN-Zero (counterpart of ``pygpukit_tpu/diffusion/models/dit.py``):
per-block shift/scale/gate modulation regressed from the timestep (and
class) embedding, the gates zero at init so each block starts as the
identity; optional cross-attention to a text context.

Params: the reference's tree (``x_embed.w``, ``pos_embed``, ``t_embed.in.w``
..., stacked ``blocks`` ``[L, ...]`` of ``adaln.w``, ``qkv.w`` ...).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ...core.backend import resolve_device
from ...ops.precision import full_f32_context
from .._common import attention_heads, gelu_tanh, layer, linear, silu, tensor_on
from .flux import _ln_mod, timestep_embedding

_F32 = torch.float32


@dataclass
class DiTConfig:
    input_size: int = 32            # latent H=W
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 512
    depth: int = 12
    num_heads: int = 8
    mlp_ratio: float = 4.0
    cross_attention: bool = False   # PixArt: cross-attn to text
    context_dim: int = 512
    num_classes: int = 0            # class-conditional DiT

    @property
    def num_patches(self) -> int:
        return (self.input_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _mha(q, k, v, n_heads: int) -> torch.Tensor:
    t, e = q.shape
    d = e // n_heads
    qh, kh, vh = (a.reshape(a.shape[0], n_heads, d).transpose(0, 1) for a in (q, k, v))
    return attention_heads(qh, kh, vh).transpose(0, 1).reshape(t, e)


def _t_embed(p: dict, timestep) -> torch.Tensor:
    return linear(p, "t_embed.out", silu(linear(p, "t_embed.in",
                                                timestep_embedding(timestep, 256))))


def dit_forward_fn(cfg: DiTConfig, p: dict, x_tokens, timestep, context=None):
    """x_tokens [T, P*P*C], timestep a 0-d f32 tensor, context [Tc,
    ctx_dim] (or a 0-d class label) -> [T, P*P*C]."""
    x = linear(p, "x_embed", x_tokens)
    x = x + p["pos_embed"][:x.shape[0]]
    c = _t_embed(p, timestep)
    if cfg.num_classes and context is not None and context.ndim == 0:
        c = c + p["label_embed"][context.to(torch.int64)]
    blocks = p["blocks"]
    for i in range(next(iter(blocks.values())).shape[0]):
        lp = layer(blocks, i)
        sh1, sc1, g1, sh2, sc2, g2 = linear(lp, "adaln", silu(c)).chunk(6, dim=-1)
        q, k, v = linear(lp, "qkv", _ln_mod(x, sh1, sc1)).chunk(3, dim=-1)
        x = x + g1 * linear(lp, "proj", _mha(q, k, v, cfg.num_heads))
        if cfg.cross_attention:
            qx = linear(lp, "xq", x)
            kx, vx = linear(lp, "xk", context), linear(lp, "xv", context)
            x = x + linear(lp, "xproj", _mha(qx, kx, vx, cfg.num_heads))
        mlp = linear(lp, "mlp2", gelu_tanh(linear(lp, "mlp0", _ln_mod(x, sh2, sc2))))
        x = x + g2 * mlp
    sh, sc = linear(p, "final_mod", silu(c)).chunk(2, dim=-1)
    return linear(p, "final", _ln_mod(x, sh, sc))


class DiT:
    """A DiT on one device (reference: ``DiT``)."""

    def __init__(self, config: DiTConfig, params: dict):
        self.config = config
        self.params = params
        self.device = params["x_embed.w"].device

    def __call__(self, x_tokens, timestep, context=None):
        dev = self.device
        with full_f32_context():
            return dit_forward_fn(self.config, self.params, tensor_on(x_tokens, dev),
                                  tensor_on(timestep, dev, _F32),
                                  None if context is None else tensor_on(context, dev))

    @classmethod
    def init_random(cls, config: DiTConfig | None = None, seed: int = 0,
                    device=None) -> "DiT":
        """Random f32 params on ``device`` (the card unless named) from a
        torch generator seeded with ``seed``, the reference's distribution:
        weights N(0, 1/in), the adaLN and final projections zero, positions
        and labels N(0, 0.02^2), biases 0."""
        cfg = config or DiTConfig()
        dev = resolve_device(device)
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        hid = cfg.hidden_size
        mlp = int(hid * cfg.mlp_ratio)
        patch_dim = cfg.patch_size ** 2 * cfg.in_channels

        def lin(dst: dict, name: str, ci: int, co: int, zero: bool = False, n=None):
            lead = () if n is None else (n,)
            w = torch.zeros(lead + (ci, co), device=dev)
            if not zero:
                w = torch.randn(lead + (ci, co), generator=g, device=dev) / math.sqrt(ci)
            dst[f"{name}.w"], dst[f"{name}.b"] = w, torch.zeros(lead + (co,), device=dev)

        p: dict = {"pos_embed": torch.randn((cfg.num_patches, hid), generator=g,
                                            device=dev) * 0.02}
        lin(p, "x_embed", patch_dim, hid)
        lin(p, "t_embed.in", 256, hid)
        lin(p, "t_embed.out", hid, hid)
        if cfg.num_classes:
            p["label_embed"] = torch.randn((cfg.num_classes, hid), generator=g,
                                           device=dev) * 0.02
        lin(p, "final_mod", hid, 2 * hid, zero=True)
        lin(p, "final", hid, patch_dim, zero=True)
        blocks: dict = {}
        n = cfg.depth
        lin(blocks, "adaln", hid, 6 * hid, zero=True, n=n)       # adaLN-Zero
        lin(blocks, "qkv", hid, 3 * hid, n=n)
        lin(blocks, "proj", hid, hid, n=n)
        lin(blocks, "mlp0", hid, mlp, n=n)
        lin(blocks, "mlp2", mlp, hid, n=n)
        if cfg.cross_attention:
            lin(blocks, "xq", hid, hid, n=n)
            lin(blocks, "xk", cfg.context_dim, hid, n=n)
            lin(blocks, "xv", cfg.context_dim, hid, n=n)
            lin(blocks, "xproj", hid, hid, n=n)
        p["blocks"] = blocks
        return cls(cfg, p)
