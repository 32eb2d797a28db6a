"""Batched decode (reference ``llm/decode/batch.py``).

The reference vmaps the single-stream prefill and step over a batch axis.
The port's batch step is the batch-rows step the serving engines run
(``batch_decode_step_fn``: the hidden rows batched through every weight
matmul, the rows written and attended by ``kernels.kv_write_attention``,
one ``batch_decode_attention`` launch a layer on the card) over pools
``[B, L, MAX, Hk*D]`` in the model's ``kv_dtype``. Each prompt is
prefilled into its slot with ``prefill_fn`` over the slot's views, as the
engine admits a request. The positions stay a device ``[B]`` tensor; the
host reads each step's greedy tokens, as the reference reads its logits.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.embedding import kv_cache_zeros
from ..model import _bucket, batch_decode_step_fn, prefill_fn, slot_cache
from .base import DecodeStrategy


class DecodeBatch(DecodeStrategy):
    name = "batch"

    def __init__(self, max_seq_len: int | None = None):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.k_cache = None
        self.v_cache = None

    def _init_cache(self, batch: int, max_seq_len: int) -> None:
        model = self.model
        cfg = model.config
        shape = (batch, cfg.num_layers, max_seq_len, cfg.num_kv_heads * cfg.head_dim)
        self.k_cache = kv_cache_zeros(shape, model.kv_dtype, device=model.device)
        self.v_cache = kv_cache_zeros(shape, model.kv_dtype, device=model.device)
        self.max_seq_len = max_seq_len

    def _batch_prefill(self, padded: torch.Tensor, lens: np.ndarray) -> torch.Tensor:
        model = self.model
        return torch.stack([
            prefill_fn(model.config, model.params, slot_cache(self.k_cache, i),
                       slot_cache(self.v_cache, i), padded[i], int(n))
            for i, n in enumerate(lens)])                             # [B, V]

    def _batch_decode(self, tokens: torch.Tensor, poss: torch.Tensor) -> torch.Tensor:
        model = self.model
        return batch_decode_step_fn(model.config, model.params, self.k_cache,
                                    self.v_cache, tokens, poss)       # [B, V]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: int | None = None) -> list[list[int]]:
        """``input_ids``: a list of prompts. Returns one greedy token list
        per prompt."""
        model = self._require_model()
        prompts = [np.asarray(p, np.int64).reshape(-1) for p in input_ids]
        b = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int32)
        max_len = self.max_seq_len or _bucket(int(lens.max()) + max_new_tokens + 1, 256)
        self._init_cache(b, max_len)

        bucket = min(_bucket(int(lens.max())), max_len)
        padded = np.zeros((b, bucket), np.int64)
        for i, p in enumerate(prompts):
            padded[i, :len(p)] = p

        logits = self._batch_prefill(torch.as_tensor(padded).to(model.device), lens)
        poss_host = lens.copy()
        poss = torch.as_tensor(lens).to(model.device)
        done = np.zeros(b, bool)
        outs: list[list[int]] = [[] for _ in range(b)]

        for _ in range(max_new_tokens):
            toks_d = torch.argmax(logits, dim=-1).to(torch.int32)
            toks = toks_d.tolist()
            for i in range(b):
                if not done[i]:
                    outs[i].append(toks[i])
                    self.stats.tokens_generated += 1
                    if eos_token_id is not None and toks[i] == eos_token_id:
                        done[i] = True
                    if poss_host[i] + 1 >= max_len:
                        done[i] = True
            self.stats.steps += 1
            if done.all() or len(outs[0]) >= max_new_tokens:
                break
            logits = self._batch_decode(toks_d, poss)
            poss = poss + 1
            poss_host = poss_host + 1
        return outs
