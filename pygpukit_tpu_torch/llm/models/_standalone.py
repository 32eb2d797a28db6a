"""What the standalone families (``deepseek.py``, ``gptoss.py``) share:
the f32 head, the rope tables of a ``rope_scaling`` block, random weights
drawn a slab at a time and the chunked greedy ``generate``.
Their caches are two stacked tensors; the model object gives
``params``, ``device``, ``graphs``, ``max_seq_len``, ``pos``, ``_name``,
``init_fixed_cache`` and ``_fixed_caches()``."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...ops.nn import rope_tables, rope_tables_yarn

_F32 = torch.float32


def random_normal(shape: tuple, generator: torch.Generator, dtype: torch.dtype,
                  std: float = 0.02) -> torch.Tensor:
    """std * N(0, 1) of ``shape`` in ``dtype`` on the generator's device,
    drawn a [rows, cols] slab of the last two dims at a time (an expert
    stack's f32 draw would otherwise double its bf16 size on the card)."""
    dev = generator.device
    if len(shape) <= 2:
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=dev)
    flat = out.view(-1, *shape[-2:])
    for i in range(flat.shape[0]):
        flat[i] = torch.randn(shape[-2:], generator=generator, device=dev) * std
    return out


def head_logits(p: dict, h):
    """f32 logits of h: ``lm_head`` or the tied embedding, f32 products
    (the reference's f32-accumulated dot)."""
    head = p.get("lm_head")
    head = p["embed"].t() if head is None else head
    return torch.matmul(h.to(_F32), head.to(_F32))


def rope_tables_from(scaling: dict | None, n: int, d: int, theta: float, device=None):
    """The (cos, sin) tables [n, d] of a config's ``rope_scaling``: yarn
    (the attention factor from ``mscale``/``mscale_all_dim`` where given,
    ``truncate`` as configured: True unless the config says otherwise) or
    standard."""
    scaling = scaling or {}
    if scaling.get("rope_type", scaling.get("type", "")) == "yarn":
        return rope_tables_yarn(
            n, d, theta, scaling.get("factor", 1.0),
            scaling.get("original_max_position_embeddings", n),
            beta_fast=scaling.get("beta_fast") or 32.0,
            beta_slow=scaling.get("beta_slow") or 1.0, mscale=scaling.get("mscale"),
            mscale_all_dim=scaling.get("mscale_all_dim"),
            attention_factor=scaling.get("attention_factor"),
            truncate=scaling.get("truncate", True), device=device)
    return rope_tables(n, d, theta, device=device)

def generate_chunked(model, prefill, scan, input_ids, max_new_tokens: int,
                     chunk_size: int) -> list[int]:
    """The standalone families' greedy ``generate`` (the reference's): a
    cache of the next power of two past the run (64 at least) when the
    model has none, the prompt through the captured ``prefill(params,
    cache_a, cache_b, tokens, true_len)`` of its bucket (a power of two, 16
    at least), the first token taken on the device, then captured chunks
    ``scan(n_steps, params, cache_a, cache_b, token, pos)`` of up to
    ``chunk_size`` steps with one host read each; all in ``model.graphs``
    (the caches donated, the weights bound; true length, token and
    position one-element device tensors)."""
    ids = np.asarray(input_ids, np.int64).reshape(-1)
    n = len(ids)
    if model.max_seq_len is None:
        need = n + max_new_tokens + 1
        model.init_fixed_cache(max(1 << (need - 1).bit_length(), 64))
    caches = model._fixed_caches()
    bucket = max(1 << (n - 1).bit_length(), 16)
    padded = torch.zeros(bucket, dtype=torch.int32)
    padded[:n] = torch.from_numpy(ids)
    name = model._name
    exe = model.graphs.get_or_capture(
        ("prefill", bucket), prefill, model.params, *caches,
        torch.zeros(bucket, dtype=torch.int32, device=model.device), 1,
        donate_argnums=(1, 2), bound_argnums=(0,), name=f"{name}_prefill_{bucket}")
    logits = exe.replay(model.params, *caches, padded.to(model.device), n)
    model.pos = n
    cur = torch.argmax(logits).to(torch.int32).reshape(1)
    out: list[int] = []
    first = True
    while len(out) < max_new_tokens:
        steps = min(max_new_tokens - len(out) - (1 if first else 0), chunk_size,
                    model.max_seq_len - model.pos)
        if steps <= 0:
            if first:
                out.append(int(cur))
            break
        exe = model.graphs.get_or_capture(
            ("generate", steps), functools.partial(scan, steps), model.params, *caches,
            0, 0, donate_argnums=(1, 2), bound_argnums=(0,),
            name=f"{name}_generate_{steps}")
        toks = exe.replay(model.params, *caches, cur, model.pos)
        model.pos += steps
        if first:
            toks = torch.cat([cur, toks])
            first = False
        out.extend(toks.tolist())
        cur = toks[-1:].to(torch.int32)
    return out[:max_new_tokens]
