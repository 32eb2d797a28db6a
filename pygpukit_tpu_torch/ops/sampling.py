"""Token sampling (counterpart of ``pygpukit_tpu/ops/sampling.py``).

The reference draws from explicit ``jax.random`` keys; here every draw
comes from a ``torch.Generator`` the caller seeds, so the same seed replays
the same tokens. The two packages' generators give different numbers: only
the masks (which tokens may be drawn) and greedy choices match across them.
The Array API's ``sample_token_gpu`` and ``sample_multinomial`` draw from a
module-level generator per device (``sampling_generator``), seeded by
``set_sampling_seed`` (0 until then), and return int32 token ids as the
reference does.

Nothing here reads the host, so every function runs inside a capture
(``core.capture``): a draw from a generator that the capture registers
(``generators=``; for the Array API, ``sampling_generator(device)``)
replays the eager draws of that generator's state at each replay.
"""

from __future__ import annotations

import torch

from ..core.array import Array
from ._common import finish, tensors

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


_seed_state: dict = {"seed": 0, "generators": {}}


def set_sampling_seed(seed: int) -> None:
    """Reseed the draws of ``sample_token_gpu`` and ``sample_multinomial``:
    the same seed replays the same tokens."""
    _seed_state["seed"] = seed
    _seed_state["generators"] = {}


def sampling_generator(device) -> torch.Generator:
    """The generator ``sample_token_gpu`` and ``sample_multinomial`` draw
    from on ``device``: register it with a capture of either."""
    return _generator(torch.device(device))


def _generator(device: torch.device) -> torch.Generator:
    gens = _seed_state["generators"]
    if device not in gens:
        gen = torch.Generator(device=device)
        gen.manual_seed(_seed_state["seed"])
        gens[device] = gen
    return gens[device]


def _token(tok: torch.Tensor, out: Array | None) -> Array:
    tok = tok.to(torch.int32)
    if out is not None:
        return finish(tok.reshape(out.shape), out)
    return Array(tok)


def sample_token_gpu(logits, temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 0.0, *, out: Array | None = None) -> Array:
    """One token id from the last row of ``logits``: greedy at temperature
    0, else a tempered top-k, top-p or full draw (the reference's order)."""
    lt = tensors(logits)[0]
    if lt.dim() > 1:
        lt = lt[-1]
    if temperature <= 0.0:
        tok = sample_greedy_fn(lt)
    elif top_k > 0:
        tok = sample_topk_fn(lt, _generator(lt.device), top_k, temperature)
    elif 0.0 < top_p < 1.0:
        tok = sample_topp_fn(lt, _generator(lt.device), top_p, temperature)
    else:
        tok = sample_temperature_fn(lt, _generator(lt.device), temperature)
    return _token(tok, out)


def sample_multinomial(probs, *, out: Array | None = None) -> Array:
    """One draw per row of ``probs`` [..., V] (probabilities floored at
    1e-30, as the reference takes their log)."""
    p = torch.clamp_min(tensors(probs)[0].to(_F32), 1e-30)
    flat = p.reshape(-1, p.shape[-1])
    tok = torch.multinomial(flat, 1, generator=_generator(p.device))
    return _token(tok.reshape(p.shape[:-1]), out)
