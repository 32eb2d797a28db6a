"""First-order linear recurrences as a log-depth parallel scan (the
counterpart of ``jax.lax.associative_scan`` over the (a, b) pairs of
h_t = a_t h_{t-1} + b_t).

Mamba's selective scan (``llm/models/mamba.py``) and the audio IIR filters
(``ops/audio/features.py``: deemphasis, the single-pole highpass) both run
it. Static shapes, no host read: it captures into a CUDA graph.
"""

from __future__ import annotations

import torch


def _combine(a1, b1, a2, b2):
    """(a1, b1) then (a2, b2): the composition of h -> a1 h + b1 and
    h -> a2 h + b2."""
    return a2 * a1, a2 * b1 + b2


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 0 of h_t = a_t h_{t-1} + b_t (h_{-1} = 0):
    (prod_{i<=t} a_i, h_t). The odd/even recursion of
    ``jax.lax.associative_scan``: adjacent pairs combined, the half-length
    scan of them recursively, then the even positions from their odd
    neighbours; log2(S) levels of elementwise products over strided views."""
    n = a.shape[0]
    if n < 2:
        return a, b
    ra, rb = _combine(a[0:-1:2], b[0:-1:2], a[1::2], b[1::2])
    oa, ob = linear_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:-1], ob[:-1], a[2::2], b[2::2])
    else:
        ea, eb = _combine(oa, ob, a[2::2], b[2::2])
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    for out, first, even, odd in ((out_a, a, ea, oa), (out_b, b, eb, ob)):
        out[0] = first[0]
        out[2::2] = even
        out[1::2] = odd
    return out_a, out_b
