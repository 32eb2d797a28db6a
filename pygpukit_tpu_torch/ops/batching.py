"""Continuous-batching primitives (counterpart of
``pygpukit_tpu/ops/batching.py``): packed ragged batches of token ids,
their positions, the last token's logits of each sequence, greedy
sampling, EOS checks and cumulative sums. Integer results are int32, as
the reference's (64-bit types off)."""

from __future__ import annotations

import torch

from ..core.array import Array
from ..core.dtypes import canonical_dtype
from ._common import apply_op

_I32 = torch.int32


def gather_embeddings_fn(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Flattened ragged batch token ids -> embeddings [T, E]."""
    return table[ids.to(torch.long)]


def prepare_position_ids_fn(seq_lens: torch.Tensor, max_tokens: int) -> torch.Tensor:
    """seq_lens [B] -> flat position ids [max_tokens] of the packed
    sequences (each restarts at 0); tokens past the last sequence count on
    from its start."""
    lens = seq_lens.to(_I32)
    ends = torch.cumsum(lens, dim=0, dtype=_I32)
    starts = ends - lens
    idx = torch.arange(max_tokens, dtype=_I32, device=lens.device)
    seq_id = torch.sum(idx[:, None] >= ends[None, :], dim=1)
    seq_id = torch.clamp(seq_id, 0, lens.shape[0] - 1)
    return idx - starts[seq_id]


def scatter_last_token_logits_fn(logits_all: torch.Tensor, seq_lens: torch.Tensor):
    """Packed logits [T, V] and seq_lens [B] -> the last tokens' logits [B, V]."""
    last = torch.cumsum(seq_lens.to(torch.long), dim=0) - 1
    return logits_all[last]


def argmax_sample_fn(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] -> [B] greedy tokens (the first maximum)."""
    return torch.argmax(logits, dim=-1).to(_I32)


def check_eos_fn(tokens: torch.Tensor, eos_token_id: int) -> torch.Tensor:
    """[B] -> bool [B]."""
    return tokens == eos_token_id


def cumsum_fn(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The cumulative sum in x's dtype as the reference gives it (bool
    counts as int32, 64-bit types become 32-bit)."""
    dt = _I32 if x.dtype == torch.bool else canonical_dtype(x.dtype)
    return torch.cumsum(x, dim=axis).to(dt)


# Array-facing wrappers (numpy operands go where the first Array or tensor
# operand is, else to the card)

def gather_embeddings(table, ids, *, out: Array | None = None) -> Array:
    return apply_op(gather_embeddings_fn, table, ids, out=out)


def prepare_position_ids(seq_lens, max_tokens: int, *, out: Array | None = None) -> Array:
    return apply_op(lambda s: prepare_position_ids_fn(s, max_tokens), seq_lens, out=out)


def scatter_last_token_logits(logits_all, seq_lens, *, out: Array | None = None) -> Array:
    return apply_op(scatter_last_token_logits_fn, logits_all, seq_lens, out=out)


def argmax_sample(logits, *, out: Array | None = None) -> Array:
    return apply_op(argmax_sample_fn, logits, out=out)


def check_eos(tokens, eos_token_id: int, *, out: Array | None = None) -> Array:
    return apply_op(lambda t: check_eos_fn(t, eos_token_id), tokens, out=out)
