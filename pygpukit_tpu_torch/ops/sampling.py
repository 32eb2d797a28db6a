"""Token sampling (counterpart of ``pygpukit_tpu/ops/sampling.py``).

The reference draws from explicit ``jax.random`` keys; here every draw
comes from a ``torch.Generator`` the caller seeds, so the same seed replays
the same tokens. The two packages' generators give different numbers: only
the masks (which tokens may be drawn) and greedy choices match across them.
"""

from __future__ import annotations

import torch

_F32 = torch.float32
_NEG_INF = -1e30


def sample_greedy_fn(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis (first index on ties)."""
    return torch.argmax(logits, dim=-1)


def _draw(lf: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    probs = torch.softmax(lf, dim=-1).reshape(-1, lf.shape[-1])
    return torch.multinomial(probs, 1, generator=generator).reshape(lf.shape[:-1])


def sample_temperature_fn(logits, generator=None, temperature: float = 1.0):
    return _draw(logits.to(_F32) / temperature, generator)


def topk_mask_fn(logits: torch.Tensor, k: int, temperature: float = 1.0) -> torch.Tensor:
    """Tempered f32 logits with everything below the k-th largest at -1e30."""
    lf = logits.to(_F32) / temperature
    kth = torch.topk(lf, k, dim=-1).values[..., -1:]
    return torch.where(lf < kth, torch.full_like(lf, _NEG_INF), lf)


def sample_topk_fn(logits, generator=None, k: int = 1, temperature: float = 1.0):
    return _draw(topk_mask_fn(logits, k, temperature), generator)


def topp_mask_fn(logits: torch.Tensor, p: float, temperature: float = 1.0) -> torch.Tensor:
    """The reference's nucleus: sorted descending, a token is kept while the
    cumulative probability before it is at most ``p`` (the top token always
    is); everything below the smallest kept logit goes to -1e30."""
    lf = logits.to(_F32) / temperature
    sorted_logits = torch.sort(lf, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff = torch.where(cum - probs > p, torch.full_like(sorted_logits, float("inf")),
                         sorted_logits)
    cutoff_logit = torch.amin(cutoff, dim=-1, keepdim=True)
    return torch.where(lf < cutoff_logit, torch.full_like(lf, _NEG_INF), lf)


def sample_topp_fn(logits, generator=None, p: float = 1.0, temperature: float = 1.0):
    return _draw(topp_mask_fn(logits, p, temperature), generator)
