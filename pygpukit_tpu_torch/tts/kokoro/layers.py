"""Kokoro (StyleTTS2) layer library (counterpart of
``pygpukit_tpu/tts/kokoro/layers.py``).

Layers are parameter holders with ``__call__`` over tensors, as the
reference's; convolution layouts follow torch (NCW). The reference draws
each layer's init from a ``jax.random`` key; here each layer draws from a
``torch.Generator`` (``gen``) on the device its tensors live on. The
``load`` methods write a checkpoint's arrays into the existing tensors
in place when the shapes agree, so a program captured over a model reads
the new weights (a rebound tensor would leave the graph reading freed
memory).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.audio import hann_window, istft
from ...ops.conv import conv1d_fn, conv_transpose1d_fn
from ...ops.nn.norm import layernorm_fn
from ...ops.nn.recurrent import bilstm_fn, lstm_fn

_F32 = torch.float32


def _randn(gen: torch.Generator, *shape, scale=0.02):
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def _assign(old, new):
    """``new`` (array-like) as f32 on old's device: written into ``old``
    when the shapes agree, else a new tensor."""
    t = torch.as_tensor(np.asarray(new, np.float32))
    if old is not None and tuple(old.shape) == tuple(t.shape):
        return old.copy_(t)
    dev = old.device if old is not None else "cpu"
    return t.to(dev)


class Layer:
    """A parameter holder: its tensors, sub-layers and lists of them are
    its attributes (``model.carry_arrays`` walks them)."""


class Linear(Layer):
    def __init__(self, gen, in_f: int, out_f: int, bias: bool = True):
        self.w = _randn(gen, in_f, out_f, scale=1.0 / math.sqrt(in_f))
        self.b = torch.zeros((out_f,), device=gen.device) if bias else None

    def __call__(self, x):
        y = x.to(_F32) @ self.w
        return y + self.b if self.b is not None else y

    def load(self, w, b=None):
        self.w = _assign(self.w, np.asarray(w).T)   # torch [out,in] -> [in,out]
        if b is not None:
            self.b = _assign(self.b, b)
        return self


class LayerNorm(Layer):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        self.w = torch.ones((dim,), device=device)
        self.b = torch.zeros((dim,), device=device)
        self.eps = eps

    def __call__(self, x):
        return layernorm_fn(x, self.w, self.b, self.eps)

    def load(self, w, b):
        self.w, self.b = _assign(self.w, w), _assign(self.b, b)
        return self


class Conv1d(Layer):
    """torch-layout conv: x [N,C,W], weight [O,I/g,K]."""

    def __init__(self, gen, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = True):
        scale = 1.0 / math.sqrt(in_ch * kernel / groups)
        self.w = _randn(gen, out_ch, in_ch // groups, kernel, scale=scale)
        self.b = torch.zeros((out_ch,), device=gen.device) if bias else None
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups

    def __call__(self, x):
        return conv1d_fn(x, self.w, self.b, self.stride, self.padding,
                         self.dilation, self.groups)

    def load(self, w, b=None):
        self.w = _assign(self.w, w)
        if b is not None:
            self.b = _assign(self.b, b)
        return self


class WeightNormConv1d(Conv1d):
    """Conv1d with weight normalisation folded at load time (reference:
    layers.py:841 — inference folds g * v/||v||)."""

    def load_weight_norm(self, g, v, b=None):
        v = np.asarray(v)
        norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True)) + 1e-12
        self.w = _assign(self.w, np.asarray(g).reshape(-1, 1, 1) * v / norm)
        if b is not None:
            self.b = _assign(self.b, b)
        return self


class ConvTranspose1d(Layer):
    def __init__(self, gen, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        scale = 1.0 / math.sqrt(in_ch * kernel)
        self.w = _randn(gen, in_ch, out_ch, kernel, scale=scale)
        self.b = torch.zeros((out_ch,), device=gen.device) if bias else None
        self.stride, self.padding = stride, padding

    def __call__(self, x):
        return conv_transpose1d_fn(x, self.w, self.b, self.stride, self.padding)

    def load(self, w, b=None):
        self.w = _assign(self.w, w)
        if b is not None:
            self.b = _assign(self.b, b)
        return self


class LSTM(Layer):
    """(bi)LSTM over [S,B,I] (reference: layers.py:159)."""

    def __init__(self, gen, input_size: int, hidden: int,
                 bidirectional: bool = True):
        s = 1.0 / math.sqrt(hidden)
        zeros = torch.zeros((4 * hidden,), device=gen.device)
        self.w_ih_f = _randn(gen, 4 * hidden, input_size, scale=s)
        self.w_hh_f = _randn(gen, 4 * hidden, hidden, scale=s)
        self.b_ih_f, self.b_hh_f = zeros, zeros.clone()
        self.bidirectional = bidirectional
        if bidirectional:
            self.w_ih_b = _randn(gen, 4 * hidden, input_size, scale=s)
            self.w_hh_b = _randn(gen, 4 * hidden, hidden, scale=s)
            self.b_ih_b, self.b_hh_b = zeros.clone(), zeros.clone()

    def __call__(self, x):
        if self.bidirectional:
            return bilstm_fn(x, self.w_ih_f, self.w_hh_f, self.b_ih_f,
                             self.b_hh_f, self.w_ih_b, self.w_hh_b,
                             self.b_ih_b, self.b_hh_b)
        out, _ = lstm_fn(x, self.w_ih_f, self.w_hh_f, self.b_ih_f, self.b_hh_f)
        return out


class InstanceNorm1d(Layer):
    """Per-channel instance norm over W, affine (reference: layers.py:917)."""

    def __init__(self, ch: int, eps: float = 1e-5, device=None):
        self.w = torch.ones((ch,), device=device)
        self.b = torch.zeros((ch,), device=device)
        self.eps = eps

    def __call__(self, x):  # [N,C,W]
        var, mu = torch.var_mean(x, dim=-1, keepdim=True, correction=0)
        y = (x - mu) / torch.sqrt(var + self.eps)
        return y * self.w[None, :, None] + self.b[None, :, None]


class AdaIN(Layer):
    """Adaptive instance norm: style vector modulates per-channel gain/bias
    (reference: layers.py:954)."""

    def __init__(self, gen, style_dim: int, ch: int):
        self.fc = Linear(gen, style_dim, 2 * ch)
        self.norm_eps = 1e-5
        self.ch = ch

    def __call__(self, x, style):  # x [N,C,W], style [N,S]
        gamma, beta = self.fc(style).chunk(2, dim=-1)   # [N, C] each
        var, mu = torch.var_mean(x, dim=-1, keepdim=True, correction=0)
        y = (x - mu) / torch.sqrt(var + self.norm_eps)
        return (1 + gamma[:, :, None]) * y + beta[:, :, None]


def leaky_relu(x, slope: float = 0.1):
    return F.leaky_relu(x, slope)


def snake(x, alpha):
    """Snake activation used by iSTFT-net style vocoders."""
    return x + (1.0 / (alpha + 1e-9)) * torch.sin(alpha * x) ** 2


class AlbertLayer(Layer):
    """ALBERT transformer layer (shared weights across depth; reference:
    layers.py:1008). Its GELU is the tanh form (``jax.nn.gelu``'s
    default)."""

    def __init__(self, gen, dim: int, n_heads: int, ffn: int):
        self.q = Linear(gen, dim, dim)
        self.k = Linear(gen, dim, dim)
        self.v = Linear(gen, dim, dim)
        self.out = Linear(gen, dim, dim)
        self.ln1 = LayerNorm(dim, device=gen.device)
        self.fc1 = Linear(gen, dim, ffn)
        self.fc2 = Linear(gen, ffn, dim)
        self.ln2 = LayerNorm(dim, device=gen.device)
        self.n_heads = n_heads

    def __call__(self, x, mask=None):  # x [S, E]
        s, e = x.shape
        d = e // self.n_heads

        def heads(y):
            return y.reshape(s, self.n_heads, d).transpose(0, 1)
        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        scores = (q @ k.transpose(1, 2)) / math.sqrt(d)
        if mask is not None:
            scores = torch.where(mask, -1e30, scores)
        att = (torch.softmax(scores, dim=-1) @ v).transpose(0, 1).reshape(s, e)
        x = self.ln1(x + self.out(att))
        h = F.gelu(self.fc1(x), approximate="tanh")
        return self.ln2(x + self.fc2(h))


class AlbertEncoder(Layer):
    """ALBERT: one shared layer applied n_layers times (reference:
    layers.py:1092 + PLBERTEncoder:432)."""

    def __init__(self, gen, vocab: int, dim: int, n_heads: int, ffn: int,
                 n_layers: int, max_pos: int = 512, emb_dim: int | None = None):
        emb_dim = emb_dim or dim
        self.tok = _randn(gen, vocab, emb_dim)
        self.pos = _randn(gen, max_pos, emb_dim)
        self.emb_ln = LayerNorm(emb_dim, device=gen.device)
        self.emb_proj = (Linear(gen, emb_dim, dim)
                         if emb_dim != dim else None)
        self.layer = AlbertLayer(gen, dim, n_heads, ffn)
        self.n_layers = n_layers

    def __call__(self, ids):  # [S]
        x = self.emb_ln(self.tok[ids] + self.pos[:ids.shape[0]])
        if self.emb_proj is not None:
            x = self.emb_proj(x)
        for _ in range(self.n_layers):
            x = self.layer(x)
        return x                                  # [S, dim]


class TextEncoder(Layer):
    """Kokoro text encoder: embedding → CNN stack → biLSTM (reference:
    KokoroTextEncoder, layers.py:1167)."""

    def __init__(self, gen, vocab: int, dim: int, n_conv: int = 3,
                 kernel: int = 5):
        self.embed = _randn(gen, vocab, dim)
        pad = (kernel - 1) // 2
        self.convs = [Conv1d(gen, dim, dim, kernel, padding=pad)
                      for _ in range(n_conv)]
        self.norms = [LayerNorm(dim, device=gen.device) for _ in range(n_conv)]
        self.lstm = LSTM(gen, dim, dim // 2, bidirectional=True)

    def __call__(self, ids):  # [S] -> [S, dim]
        h = self.embed[ids].T[None]               # [1, D, S]
        for conv, norm in zip(self.convs, self.norms):
            h = leaky_relu(norm(conv(h)[0].T).T[None], 0.2)
        return self.lstm(h[0].T[:, None, :])[:, 0, :]


class StyleEncoder(Layer):
    """Style vector from reference mel / voice embedding (reference:
    layers.py:510). Kokoro ships precomputed voice style vectors; this
    encoder maps mel → style for voice cloning parity."""

    def __init__(self, gen, n_mels: int = 80, style_dim: int = 128):
        chans = [n_mels, 128, 128, 256]
        self.convs = [Conv1d(gen, chans[i], chans[i + 1], 5, stride=2,
                             padding=2) for i in range(3)]
        self.fc = Linear(gen, chans[-1], style_dim)

    def __call__(self, mel):  # [frames, n_mels] -> [style_dim]
        h = mel.T[None]                          # [1, M, F]
        for c in self.convs:
            h = leaky_relu(c(h), 0.2)
        return self.fc(h.mean(dim=-1)[0])


class AdaINResBlock(Layer):
    """Residual block with style-conditioned AdaIN (reference: layers.py:1224)."""

    def __init__(self, gen, ch: int, style_dim: int, kernel: int = 3,
                 dilation: int = 1):
        pad = dilation * (kernel - 1) // 2
        self.c1 = Conv1d(gen, ch, ch, kernel, padding=pad, dilation=dilation)
        self.c2 = Conv1d(gen, ch, ch, kernel, padding=pad, dilation=dilation)
        self.n1 = AdaIN(gen, style_dim, ch)
        self.n2 = AdaIN(gen, style_dim, ch)

    def __call__(self, x, style):  # [N,C,W], [N,S]
        h = self.c1(leaky_relu(self.n1(x, style), 0.2))
        h = self.c2(leaky_relu(self.n2(h, style), 0.2))
        return x + h


class ResBlock1d(Layer):
    """Plain residual conv block (reference: layers.py:568)."""

    def __init__(self, gen, ch: int, kernel: int = 3, dilations=(1, 3, 5)):
        self.convs = [Conv1d(gen, ch, ch, kernel,
                             padding=d * (kernel - 1) // 2, dilation=d)
                      for d in dilations]

    def __call__(self, x):
        for c in self.convs:
            x = x + c(leaky_relu(x, 0.1))
        return x


class ISTFTNet(Layer):
    """iSTFT-based vocoder: upsample → resblocks → (mag, phase) → iSTFT
    (reference: ISTFTNet, layers.py:666)."""

    def __init__(self, gen, in_ch: int = 512, n_fft: int = 20,
                 hop: int = 5, upsamples=(10, 6), up_kernels=(20, 12)):
        self.n_fft, self.hop = n_fft, hop
        ch = in_ch
        self.ups = []
        self.blocks = []
        for u, k in zip(upsamples, up_kernels):
            self.ups.append(ConvTranspose1d(
                gen, ch, ch // 2, k, stride=u, padding=(k - u) // 2))
            self.blocks.append(ResBlock1d(gen, ch // 2))
            ch //= 2
        self.out_conv = Conv1d(gen, ch, n_fft + 2, 7, padding=3)

    def __call__(self, x):  # [1, C, W] -> audio [T]
        for up, blk in zip(self.ups, self.blocks):
            x = blk(leaky_relu(up(x), 0.1))
        spec = self.out_conv(x)[0]               # [n_fft+2, W]
        half = self.n_fft // 2 + 1
        mag = torch.exp(torch.clamp(spec[:half], -11, 5)).T
        phase = (math.pi * torch.tanh(spec[half:2 * half])).T
        cplx = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
        return istft(cplx, self.n_fft, self.hop, window=hann_window(self.n_fft, x.device))


class DurationPredictor(Layer):
    """Text+style → per-phoneme durations (reference: Decoder/duration path,
    layers.py:588)."""

    def __init__(self, gen, dim: int, style_dim: int):
        self.proj_in = Linear(gen, dim + style_dim, dim)
        self.lstm = LSTM(gen, dim, dim // 2, bidirectional=True)
        self.proj = Linear(gen, dim, 1)

    def __call__(self, text_feats, style):  # [S,D], [style]
        st = style[None].expand(text_feats.shape[0], -1)
        h = self.proj_in(torch.cat([text_feats, st], dim=-1))
        h = self.lstm(h[:, None, :])[:, 0]
        return F.softplus(self.proj(h))[:, 0]   # [S] positive frames


class F0NPredictor(Layer):
    """F0 + noise predictors over expanded features (reference: prosody
    predictors in model.py)."""

    def __init__(self, gen, dim: int, style_dim: int):
        self.blocks = [AdaINResBlock(gen, dim, style_dim) for _ in range(2)]
        self.f0_conv = Conv1d(gen, dim, 1, 3, padding=1)
        self.n_conv = Conv1d(gen, dim, 1, 3, padding=1)

    def __call__(self, x, style):  # [1,D,W], [1,S]
        for b in self.blocks:
            x = b(x, style)
        return self.f0_conv(x)[0, 0], self.n_conv(x)[0, 0]
