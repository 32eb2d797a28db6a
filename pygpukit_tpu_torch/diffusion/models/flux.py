"""FLUX.1 transformer (counterpart of ``pygpukit_tpu/diffusion/models/flux.py``:
19 joint (double) blocks and 38 single blocks, 3-axis rope, modulation from
the timestep, the pooled text and the guidance).

Plain functions on tensors over the reference's param tree: top-level
leaves named ``img_in.w``, ``time_in.in.b`` ..., the blocks as stacked
``[L, ...]`` trees under ``double_blocks`` and ``single_blocks``
(projections ``[in, out]``), so ``llm.convert.params_from_jax`` carries the
reference's tree across. The reference scans the stacks; here a Python
loop takes layer views. Weight names on disk follow the BFL checkpoint
layout (``double_blocks.N.img_attn.qkv.weight`` ...).

Products promote as JAX's do (``_common.dot``): a bf16 model's weights
meet f32 activations in f32 products, and ``_ln_mod`` / ``_qk_rmsnorm``
return the activations' dtype, so a bf16 FLUX computes in f32 throughout.
The joint attention's softmax is f32 over the text and image tokens.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ...core.backend import resolve_device
from ...llm.models._standalone import random_normal
from ...llm.safetensors import load_safetensors
from ...ops.precision import full_f32_context
from .._common import attention_heads, gelu_tanh, layer, linear, silu, tensor_on

_F32 = torch.float32


@dataclass
class FluxConfig:
    in_channels: int = 64           # 2x2-patchified 16ch latents
    hidden_size: int = 3072
    num_heads: int = 24
    depth: int = 19                 # double blocks
    depth_single: int = 38
    mlp_ratio: float = 4.0
    context_dim: int = 4096         # T5 features
    pooled_dim: int = 768           # CLIP pooled
    axes_dim: tuple = (16, 56, 56)  # rope dims per id axis
    theta: float = 10000.0
    guidance_embed: bool = True     # dev=True, schnell=False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def timestep_embedding(t, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding [..., dim] of t (cos half, then sin half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=_F32, device=t.device) / half)
    args = t.to(_F32)[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _mlp_embed(p: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return linear(p, f"{prefix}.out", silu(linear(p, f"{prefix}.in", x)))


def rope_3d(ids: torch.Tensor, axes_dim, theta: float):
    """ids [T, n_axes] -> (cos, sin) [T, head_dim/2], the axes concatenated."""
    parts_cos, parts_sin = [], []
    for a, d in enumerate(axes_dim):
        half = d // 2
        freqs = 1.0 / (theta ** (torch.arange(half, dtype=_F32, device=ids.device) / half))
        ang = ids[:, a].to(_F32)[:, None] * freqs[None]
        parts_cos.append(torch.cos(ang))
        parts_sin.append(torch.sin(ang))
    return torch.cat(parts_cos, -1), torch.cat(parts_sin, -1)


def apply_rope_interleaved(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x [T, H, D] rotated in interleaved pairs (the FLUX convention)."""
    xr = x.reshape(*x.shape[:-1], -1, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1).reshape(x.shape)


def _qk_rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.to(_F32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (xf * inv * scale.to(_F32)).to(x.dtype)


def _attention(q, k, v, cos, sin) -> torch.Tensor:
    """q/k/v [T, H, D]: joint rope'd attention -> [T, H*D] (f32 softmax)."""
    t, h, d = q.shape
    q = apply_rope_interleaved(q, cos, sin)
    k = apply_rope_interleaved(k, cos, sin)
    out = attention_heads(q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1))
    return out.transpose(0, 1).reshape(t, h * d)


def _ln_mod(x: torch.Tensor, shift, scale) -> torch.Tensor:
    xf = x.to(_F32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + 1e-6)
    return ((1 + scale) * y + shift).to(x.dtype)


def _heads(x: torch.Tensor, n: int, h: int, d: int):
    """[T, n*h*d] -> n tensors [T, h, d]."""
    return [a.reshape(-1, h, d) for a in x.chunk(n, dim=-1)]


def double_block_fn(cfg: FluxConfig, lp: dict, img, txt, vec, cos, sin):
    """Joint (double-stream) block."""
    h, d = cfg.num_heads, cfg.head_dim
    t_txt = txt.shape[0]
    sv = silu(vec)
    im1, im2 = linear(lp, "img_mod", sv).chunk(2, dim=-1)
    tm1, tm2 = linear(lp, "txt_mod", sv).chunk(2, dim=-1)
    i_shift, i_scale, i_gate = im1.chunk(3, dim=-1)
    i_shift2, i_scale2, i_gate2 = im2.chunk(3, dim=-1)
    t_shift, t_scale, t_gate = tm1.chunk(3, dim=-1)
    t_shift2, t_scale2, t_gate2 = tm2.chunk(3, dim=-1)

    iq, ik, iv = _heads(linear(lp, "img_qkv", _ln_mod(img, i_shift, i_scale)), 3, h, d)
    tq, tk, tv = _heads(linear(lp, "txt_qkv", _ln_mod(txt, t_shift, t_scale)), 3, h, d)
    iq, ik = _qk_rmsnorm(iq, lp["img_q_norm"]), _qk_rmsnorm(ik, lp["img_k_norm"])
    tq, tk = _qk_rmsnorm(tq, lp["txt_q_norm"]), _qk_rmsnorm(tk, lp["txt_k_norm"])
    att = _attention(torch.cat([tq, iq]), torch.cat([tk, ik]), torch.cat([tv, iv]), cos, sin)
    txt_att, img_att = att[:t_txt], att[t_txt:]
    img = img + i_gate * linear(lp, "img_proj", img_att)
    txt = txt + t_gate * linear(lp, "txt_proj", txt_att)

    img_mlp = linear(lp, "img_mlp2", gelu_tanh(linear(lp, "img_mlp0",
                                                      _ln_mod(img, i_shift2, i_scale2))))
    txt_mlp = linear(lp, "txt_mlp2", gelu_tanh(linear(lp, "txt_mlp0",
                                                      _ln_mod(txt, t_shift2, t_scale2))))
    return img + i_gate2 * img_mlp, txt + t_gate2 * txt_mlp


def single_block_fn(cfg: FluxConfig, lp: dict, x, vec, cos, sin):
    """Single-stream block: a fused qkv + MLP input projection, attention
    and MLP in parallel."""
    h, d = cfg.num_heads, cfg.head_dim
    hidden = cfg.hidden_size
    shift, scale, gate = linear(lp, "mod", silu(vec)).chunk(3, dim=-1)
    lin1 = linear(lp, "lin1", _ln_mod(x, shift, scale))
    qkv, mlp = lin1[:, :3 * hidden], lin1[:, 3 * hidden:]
    q, k, v = _heads(qkv, 3, h, d)
    att = _attention(_qk_rmsnorm(q, lp["q_norm"]), _qk_rmsnorm(k, lp["k_norm"]), v, cos, sin)
    return x + gate * linear(lp, "lin2", torch.cat([att, gelu_tanh(mlp)], dim=-1))


def flux_forward_fn(cfg: FluxConfig, p: dict, img, img_ids, txt, txt_ids, timestep,
                    pooled, guidance):
    """img [T_img, 64], txt [T_txt, context_dim], timestep and guidance 0-d
    f32 tensors -> velocity [T_img, 64]."""
    img = linear(p, "img_in", img)
    txt = linear(p, "txt_in", txt)
    vec = _mlp_embed(p, "time_in", timestep_embedding(timestep * 1000.0, 256))
    vec = vec + _mlp_embed(p, "vector_in", pooled)
    if cfg.guidance_embed:
        vec = vec + _mlp_embed(p, "guidance_in", timestep_embedding(guidance * 1000.0, 256))
    cos, sin = rope_3d(torch.cat([txt_ids, img_ids]), cfg.axes_dim, cfg.theta)
    dbl = p["double_blocks"]
    for i in range(next(iter(dbl.values())).shape[0]):
        img, txt = double_block_fn(cfg, layer(dbl, i), img, txt, vec, cos, sin)
    x = torch.cat([txt, img])
    sgl = p["single_blocks"]
    for i in range(next(iter(sgl.values())).shape[0]):
        x = single_block_fn(cfg, layer(sgl, i), x, vec, cos, sin)
    img = x[txt.shape[0]:]
    shift, scale = linear(p, "final_mod", silu(vec)).chunk(2, dim=-1)
    return linear(p, "final", _ln_mod(img, shift, scale))


def make_img_ids(h_patches: int, w_patches: int, device=None) -> torch.Tensor:
    """[T_img, 3] int32 position ids (axis 0 zero, axis 1 the row, axis 2
    the column) on ``device`` (the card unless named)."""
    ys = np.repeat(np.arange(h_patches), w_patches)
    xs = np.tile(np.arange(w_patches), h_patches)
    ids = np.stack([np.zeros_like(ys), ys, xs], axis=-1).astype(np.int32)
    return torch.from_numpy(ids).to(resolve_device(device))


def patchify(latents: torch.Tensor) -> torch.Tensor:
    """[C, H, W] -> [H/2*W/2, C*4] 2x2 patches."""
    c, h, w = latents.shape
    x = latents.reshape(c, h // 2, 2, w // 2, 2)
    return x.permute(1, 3, 0, 2, 4).reshape(h // 2 * (w // 2), c * 4)


def unpatchify(tokens: torch.Tensor, c: int, h: int, w: int) -> torch.Tensor:
    """[H/2*W/2, C*4] -> [C, H, W]."""
    x = tokens.reshape(h // 2, w // 2, c, 2, 2)
    return x.permute(2, 0, 3, 1, 4).reshape(c, h, w)


# ------------------------------------------------------------- parameters --

def _leaf_shapes(cfg: FluxConfig) -> tuple[dict, dict, dict]:
    """(top-level, double-block, single-block) linears as name -> (in, out),
    and the rms-norm scales as name -> None."""
    hid, hd = cfg.hidden_size, cfg.head_dim
    mlp = int(hid * cfg.mlp_ratio)
    top = {"img_in": (cfg.in_channels, hid), "txt_in": (cfg.context_dim, hid),
           "time_in.in": (256, hid), "time_in.out": (hid, hid),
           "vector_in.in": (cfg.pooled_dim, hid), "vector_in.out": (hid, hid)}
    if cfg.guidance_embed:
        top.update({"guidance_in.in": (256, hid), "guidance_in.out": (hid, hid)})
    top.update({"final_mod": (hid, 2 * hid), "final": (hid, cfg.in_channels)})
    dbl: dict = {}
    for side in ("img", "txt"):
        dbl.update({f"{side}_mod": (hid, 6 * hid), f"{side}_qkv": (hid, 3 * hid),
                    f"{side}_proj": (hid, hid), f"{side}_mlp0": (hid, mlp),
                    f"{side}_mlp2": (mlp, hid)})
    dbl.update({nm: (hd,) for nm in ("img_q_norm", "img_k_norm", "txt_q_norm",
                                     "txt_k_norm")})
    sgl = {"mod": (hid, 3 * hid), "lin1": (hid, 3 * hid + mlp), "lin2": (hid + mlp, hid),
           "q_norm": (hd,), "k_norm": (hd,)}
    return top, dbl, sgl


def init_params(cfg: FluxConfig, seed: int = 0, dtype=_F32, device=None) -> dict:
    """Random params of ``cfg`` drawn on ``device`` (the card unless named)
    from a torch generator seeded with ``seed``, the reference's
    distribution: weights N(0, 1/in), biases 0, norm scales 1. The
    reference draws from numpy, so the two packages' random models differ;
    ``llm.convert.params_from_jax`` carries the reference's tree."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def lin(dst: dict, name: str, shape: tuple, n: int | None) -> None:
        lead = () if n is None else (n,)
        if len(shape) == 1:                                 # an rms-norm scale
            dst[name] = torch.ones(lead + shape, dtype=dtype, device=dev)
            return
        dst[f"{name}.w"] = random_normal(lead + shape, g, dtype, 1.0 / math.sqrt(shape[0]))
        dst[f"{name}.b"] = torch.zeros(lead + shape[1:], dtype=dtype, device=dev)

    top, dbl, sgl = _leaf_shapes(cfg)
    p: dict = {}
    for name, shape in top.items():
        lin(p, name, shape, None)
    for key, spec, n in (("double_blocks", dbl, cfg.depth),
                         ("single_blocks", sgl, cfg.depth_single)):
        p[key] = {}
        for name, shape in spec.items():
            lin(p[key], name, shape, n)
    return p


#: top-level linears -> their BFL checkpoint names
_BFL_TOP = {"img_in": "img_in", "txt_in": "txt_in", "time_in.in": "time_in.in_layer",
            "time_in.out": "time_in.out_layer", "vector_in.in": "vector_in.in_layer",
            "vector_in.out": "vector_in.out_layer", "guidance_in.in": "guidance_in.in_layer",
            "guidance_in.out": "guidance_in.out_layer",
            "final_mod": "final_layer.adaLN_modulation.1", "final": "final_layer.linear"}
_BFL_DOUBLE = {"img_mod": "img_mod.lin", "txt_mod": "txt_mod.lin",
               "img_qkv": "img_attn.qkv", "txt_qkv": "txt_attn.qkv",
               "img_proj": "img_attn.proj", "txt_proj": "txt_attn.proj",
               "img_mlp0": "img_mlp.0", "img_mlp2": "img_mlp.2",
               "txt_mlp0": "txt_mlp.0", "txt_mlp2": "txt_mlp.2",
               "img_q_norm": "img_attn.norm.query_norm.scale",
               "img_k_norm": "img_attn.norm.key_norm.scale",
               "txt_q_norm": "txt_attn.norm.query_norm.scale",
               "txt_k_norm": "txt_attn.norm.key_norm.scale"}
_BFL_SINGLE = {"mod": "modulation.lin", "lin1": "linear1", "lin2": "linear2",
               "q_norm": "norm.query_norm.scale", "k_norm": "norm.key_norm.scale"}


def _bfl_leaves(spec: dict, prefix: str):
    """(our leaf, BFL name, transposed) of one tree's linears and norms."""
    for ours, theirs in spec.items():
        if theirs.endswith(".scale"):
            yield ours, f"{prefix}{theirs}", False
        else:
            yield f"{ours}.w", f"{prefix}{theirs}.weight", True
            yield f"{ours}.b", f"{prefix}{theirs}.bias", False


def bfl_tensors(params: dict) -> dict:
    """``params`` under their BFL checkpoint names, linears back to [out,
    in]: what ``from_safetensors`` reads."""
    out = {}
    for key, name, tr in _bfl_leaves({k: v for k, v in _BFL_TOP.items()
                                      if f"{k}.w" in params}, ""):
        out[name] = params[key].T.contiguous() if tr else params[key]
    for stack, spec, blk in (("double_blocks", _BFL_DOUBLE, "double_blocks"),
                             ("single_blocks", _BFL_SINGLE, "single_blocks")):
        tree = params[stack]
        for i in range(next(iter(tree.values())).shape[0]):
            for key, name, tr in _bfl_leaves(spec, f"{blk}.{i}."):
                out[name] = tree[key][i].T.contiguous() if tr else tree[key][i]
    return out


class FluxTransformer:
    """The FLUX transformer on one device (reference: ``FluxTransformer``)."""

    def __init__(self, config: FluxConfig, params: dict):
        self.config = config
        self.params = params
        self.device = params["img_in.w"].device

    def __call__(self, img, img_ids, txt, txt_ids, timestep, pooled, guidance=1.0):
        dev = self.device
        with full_f32_context():
            return flux_forward_fn(
                self.config, self.params, tensor_on(img, dev), tensor_on(img_ids, dev),
                tensor_on(txt, dev), tensor_on(txt_ids, dev), tensor_on(timestep, dev, _F32),
                tensor_on(pooled, dev), tensor_on(guidance, dev, _F32))

    @classmethod
    def init_random(cls, config: FluxConfig | None = None, seed: int = 0,
                    dtype=_F32, device=None) -> "FluxTransformer":
        cfg = config or FluxConfig()
        return cls(cfg, init_params(cfg, seed, dtype, device))

    @classmethod
    def from_safetensors(cls, path, config: FluxConfig | None = None,
                         dtype=torch.bfloat16, device=None) -> "FluxTransformer":
        """A BFL-layout checkpoint (a file, a directory or an index) on
        ``device`` (the card unless named) in ``dtype``. Without ``config``
        the block counts and the guidance embedder are read from the names
        (as the reference reads them) and, beyond the reference, the widths
        from the shapes (in and context channels, hidden, heads by the q/k
        norm's width, pooled, the MLP ratio); ``axes_dim`` and ``theta``
        keep their defaults. Each tensor is copied in its file dtype, then
        converted and transposed on the device, the blocks written into
        their stacks one at a time."""
        dev = resolve_device(device)
        with load_safetensors(path) as st:
            n_dbl = n_sgl = 0
            while f"double_blocks.{n_dbl}.img_attn.qkv.weight" in st:
                n_dbl += 1
            while f"single_blocks.{n_sgl}.linear1.weight" in st:
                n_sgl += 1
            if config is None:
                hid, in_ch = st.tensor_shape("img_in.weight")
                hd = st.tensor_shape("double_blocks.0.img_attn.norm.query_norm.scale")[0] \
                    if n_dbl else FluxConfig().head_dim
                config = FluxConfig(
                    in_channels=in_ch, hidden_size=hid, num_heads=hid // hd, depth=n_dbl,
                    depth_single=n_sgl, context_dim=st.tensor_shape("txt_in.weight")[1],
                    pooled_dim=st.tensor_shape("vector_in.in_layer.weight")[1],
                    mlp_ratio=st.tensor_shape("single_blocks.0.linear2.weight")[1] / hid - 1
                    if n_sgl else FluxConfig().mlp_ratio,
                    guidance_embed="guidance_in.in_layer.weight" in st)
            cfg = config

            def t(name: str, transposed: bool) -> torch.Tensor:
                x = st.tensor(name).to(dev, copy=True).to(dtype)
                return x.T.contiguous() if transposed and x.ndim == 2 else x
            top = {k: v for k, v in _BFL_TOP.items()
                   if cfg.guidance_embed or not k.startswith("guidance_in")}
            p = {key: t(name, tr) for key, name, tr in _bfl_leaves(top, "")}
            for stack, spec, n in (("double_blocks", _BFL_DOUBLE, cfg.depth),
                                   ("single_blocks", _BFL_SINGLE, cfg.depth_single)):
                tree = {}
                for key, name, tr in _bfl_leaves(spec, ""):
                    first = t(f"{stack}.0.{name}", tr)
                    buf = torch.empty((n, *first.shape), dtype=dtype, device=dev)
                    buf[0] = first
                    for i in range(1, n):
                        buf[i] = t(f"{stack}.{i}.{name}", tr)
                    tree[key] = buf
                p[stack] = tree
        return cls(cfg, p)
