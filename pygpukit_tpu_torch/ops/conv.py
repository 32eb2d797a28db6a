"""Convolutions (counterpart of ``pygpukit_tpu/ops/conv.py``).

The reference runs XLA's ``conv_general_dilated`` (no Pallas kernel), so
the port runs ``torch.nn.functional``'s convolutions: cuDNN on the card,
under ``ops.precision.f32_matmul_context`` where a model scopes it. As the
reference does, each computes in f32, adds the bias in f32 and casts to
the input's dtype. Layouts follow torch: conv1d NCW with weights [O, C/g,
K], conv2d NCHW with [O, C/g, Kh, Kw], the transposed conv1d [C, O, K].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.array import Array
from ._common import apply_op

_F32 = torch.float32


def conv1d_fn(x, w, b=None, stride: int = 1, padding: int = 0,
              dilation: int = 1, groups: int = 1):
    """x [N,C,W], w [O,C/g,K] -> [N,O,W']."""
    out = F.conv1d(x.to(_F32), w.to(_F32), None, stride, padding, dilation, groups)
    if b is not None:
        out = out + b.to(_F32)[None, :, None]
    return out.to(x.dtype)


def conv2d_fn(x, w, b=None, stride=1, padding=0, dilation=1, groups: int = 1):
    """x [N,C,H,W], w [O,C/g,Kh,Kw] -> [N,O,H',W']; ``padding`` an int or
    two (lo, hi) pairs, as the reference passes it to XLA."""
    stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
    dilation = (dilation, dilation) if isinstance(dilation, int) else tuple(dilation)
    if isinstance(padding, int):
        padding = [(padding, padding), (padding, padding)]
    (h0, h1), (w0, w1) = padding
    xf = x.to(_F32)
    if (h0, w0) == (h1, w1):
        out = F.conv2d(xf, w.to(_F32), None, stride, (h0, w0), dilation, groups)
    else:
        out = F.conv2d(F.pad(xf, (w0, w1, h0, h1)), w.to(_F32), None, stride, 0,
                       dilation, groups)
    if b is not None:
        out = out + b.to(_F32)[None, :, None, None]
    return out.to(x.dtype)


def conv_transpose1d_fn(x, w, b=None, stride: int = 1, padding: int = 0):
    """x [N,C,W], w [C,O,K] (torch ConvTranspose1d layout) -> [N,O,W']:
    W' = (W - 1) stride - 2 padding + K, the reference's transposed conv."""
    out = F.conv_transpose1d(x.to(_F32), w.to(_F32), None, stride, padding)
    if b is not None:
        out = out + b.to(_F32)[None, :, None]
    return out.to(x.dtype)


def conv1d(x, w, b=None, stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1, *, out: Array | None = None) -> Array:
    fn = lambda *a: conv1d_fn(*a, stride=stride, padding=padding,  # noqa: E731
                              dilation=dilation, groups=groups)
    args = (x, w) if b is None else (x, w, b)
    return apply_op(fn, *args, out=out)


def conv2d(x, w, b=None, stride=1, padding=0, dilation=1, groups: int = 1,
           *, out: Array | None = None) -> Array:
    fn = lambda *a: conv2d_fn(*a, stride=stride, padding=padding,  # noqa: E731
                              dilation=dilation, groups=groups)
    args = (x, w) if b is None else (x, w, b)
    return apply_op(fn, *args, out=out)
