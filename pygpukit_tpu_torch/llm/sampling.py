"""The host sampler (counterpart of ``pygpukit_tpu/llm/sampling.py``, a
numpy copy of it): one token from numpy logits by temperature, top-k and
top-p. The same ``np.random.Generator`` in the same state draws the same
token as the reference's. Device-side sampling is ``ops.sampling``."""

from __future__ import annotations

import numpy as np


def sample_token(logits: np.ndarray, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, rng: np.random.Generator | None = None) -> int:
    """Greedy at ``temperature`` 0; else logits / temperature, the top-k
    kept (ties at the k-th value kept too), then the smallest prefix of
    the sorted distribution reaching ``top_p``, one draw by ``rng``."""
    logits = np.asarray(logits, np.float32).reshape(-1)
    if temperature <= 0.0:
        return int(logits.argmax())
    rng = rng or np.random.default_rng()
    logits = logits / temperature
    if top_k > 0:
        thresh = np.partition(logits, -top_k)[-top_k]
        logits = np.where(logits < thresh, -np.inf, logits)
    if 0.0 < top_p < 1.0:
        order = np.argsort(logits)[::-1]
        probs = _softmax(logits[order])
        cum = np.cumsum(probs)
        cutoff = np.searchsorted(cum, top_p) + 1
        mask = np.full_like(logits, -np.inf)
        mask[order[:cutoff]] = logits[order[:cutoff]]
        logits = mask
    probs = _softmax(logits)
    return int(rng.choice(len(probs), p=probs))


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - np.max(x[np.isfinite(x)]))
    e[~np.isfinite(x)] = 0.0
    return e / e.sum()
