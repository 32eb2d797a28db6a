"""f32 product precision scoped over a whole model stack (counterpart of
``pygpukit_tpu/ops/precision.py``).

The reference scopes the ASR, TTS and diffusion forwards in
``jax.default_matmul_precision("highest")`` when the model's weights are
f32, because XLA's default lowers f32 dots through bf16 passes on a TPU.
On the card the counterpart is TF32: cuBLAS (``allow_tf32`` of
``torch.backends.cuda.matmul``) and cuDNN (``torch.backends.cudnn``, whose
flag PyTorch leaves on by default, so an f32 convolution such as Whisper's
stem would otherwise run in TF32). ``f32_matmul_context`` turns both off
for the scope and puts both back on exit.

The flags are process-wide, so the scope covers every thread's products
while it is open. ``full_f32_context`` turns them off whatever the weights
are: the diffusion transformers promote bf16 weights against f32
activations as JAX does, so their products are f32 on a bf16 model too.

Divergence: the reference's ``PYGPUKIT_ALLOW_TF32=1`` opts out of the
scope. Nothing in the port reads that variable (the Array API does not
either), so here an f32 model always runs with TF32 off.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils import _pytree as pytree

_LOW = (torch.bfloat16, torch.float16)


@contextlib.contextmanager
def _tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def f32_matmul_context(params):
    """TF32 off (matmul and cuDNN) for the scope when every floating leaf
    of ``params`` is f32; otherwise a null context (a bf16/f16 model's
    inputs carry no extra precision to protect; f32 norm weights beside
    bf16 matrices do not count, as mixed-precision models keep them so)."""
    dtypes = [getattr(leaf, "dtype", None) for leaf in pytree.tree_leaves(params)]
    has_f32 = any(d == torch.float32 for d in dtypes)
    has_low = any(d in _LOW for d in dtypes)
    if has_f32 and not has_low:
        return _tf32_off()
    return contextlib.nullcontext()


def full_f32_context():
    """TF32 off (matmul and cuDNN) for the scope, whatever the weights: for
    stacks whose products are f32 by promotion (bf16 weights against f32
    activations), where ``f32_matmul_context`` of the bf16 weights would be
    a null context."""
    return _tf32_off()
