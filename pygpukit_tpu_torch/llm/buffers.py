"""Decode and prefill buffers (counterpart of ``pygpukit_tpu/llm/buffers.py``).

The reference's buffers exist for accounting: XLA donation already gives
its executables zero-allocation replay. In the port they are load-bearing:
a CUDA graph reads and writes fixed addresses, so ``DecodeBuffers.token``
and ``.position`` are the static inputs of the captured decode step
(``CausalTransformerModel._ensure_decode_exe``), and ``.logits`` and
``.sampled`` its outputs, written in place by every replay. ``nbytes``
keeps the reference's arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.backend import resolve_device
from .config import TransformerConfig


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclass
class DecodeBuffers:
    """Single-token decode buffers."""

    token: torch.Tensor | None = None       # [1] int32
    position: torch.Tensor | None = None    # [1] int32
    logits: torch.Tensor | None = None      # [V] f32
    sampled: torch.Tensor | None = None     # [1] int32
    hidden: torch.Tensor | None = None      # [1, E]
    _nbytes: int = 0

    @classmethod
    def allocate(cls, config: TransformerConfig, dtype: torch.dtype = torch.bfloat16,
                 device=None) -> "DecodeBuffers":
        device = resolve_device(device)

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)
        b = cls(token=zeros((1,), torch.int32), position=zeros((1,), torch.int32),
                logits=zeros((config.vocab_size,), torch.float32),
                sampled=zeros((1,), torch.int32),
                hidden=zeros((1, config.hidden_size), dtype))
        b._nbytes = (4 + 4 + config.vocab_size * 4 + 4
                     + config.hidden_size * _itemsize(dtype))
        return b

    @property
    def nbytes(self) -> int:
        return self._nbytes


@dataclass
class BatchDecodeBuffers:
    """Batch variant: tokens, positions [B] int32, logits [B, V] f32."""

    tokens: torch.Tensor | None = None
    positions: torch.Tensor | None = None
    logits: torch.Tensor | None = None
    _nbytes: int = 0

    @classmethod
    def allocate(cls, config: TransformerConfig, batch: int,
                 device=None) -> "BatchDecodeBuffers":
        device = resolve_device(device)
        b = cls(tokens=torch.zeros((batch,), dtype=torch.int32, device=device),
                positions=torch.zeros((batch,), dtype=torch.int32, device=device),
                logits=torch.zeros((batch, config.vocab_size), dtype=torch.float32,
                                   device=device))
        b._nbytes = batch * (8 + config.vocab_size * 4)
        return b

    @property
    def nbytes(self) -> int:
        return self._nbytes


@dataclass
class PrefillBuffers:
    """Bucketed prompt buffers: tokens [max_prefill_len] int32."""

    max_prefill_len: int = 0
    tokens: torch.Tensor | None = None
    _nbytes: int = 0

    @classmethod
    def allocate(cls, config: TransformerConfig, max_prefill_len: int,
                 device=None) -> "PrefillBuffers":
        device = resolve_device(device)
        b = cls(max_prefill_len=max_prefill_len,
                tokens=torch.zeros((max_prefill_len,), dtype=torch.int32, device=device))
        b._nbytes = max_prefill_len * 4
        return b

    @property
    def nbytes(self) -> int:
        return self._nbytes


def kv_cache_nbytes(config: TransformerConfig, max_seq_len: int,
                    dtype: torch.dtype = torch.bfloat16, batch: int = 1) -> int:
    """Device bytes of the fixed KV cache pair (the reference's arithmetic:
    an int8 cache's row scales are not counted)."""
    per = (config.num_layers * max_seq_len * config.num_kv_heads * config.head_dim
           * _itemsize(dtype))
    return 2 * per * batch
