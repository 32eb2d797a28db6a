"""Batched decode (reference ``llm/decode/batch.py``).

The reference vmaps the single-stream prefill and step over a batch axis.
The port's batch step is the batch-rows step the serving engines run
(``batch_decode_step_fn``: the hidden rows batched through every weight
matmul, the rows written and attended by ``kernels.kv_write_attention``,
one ``batch_decode_attention`` launch a layer on the card) over pools
``[B, L, MAX, Hk*D]`` in the model's ``dtype``, as the reference's. Each
prompt is prefilled into its slot with ``prefill_fn`` over the slot's
views, as the engine admits a request. Both are captured executables in
the strategy's pool, as the reference's: the prefill one per (B, bucket)
(``batch_prefill_{B}x{bucket}``, the lengths a device ``[B]`` tensor), the
step one (``batch_decode_{B}``, tokens and positions device ``[B]``
tensors). The programs and the pools belong to the bound model: binding
another model releases them. The host reads each step's greedy tokens, as
the reference reads its logits, before the next replay.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.executable import ExecutableCache
from ...ops.embedding import kv_cache_zeros, kv_leaf
from ..model import _bucket, batch_decode_step_fn, prefill_fn, slot_cache
from .base import DecodeStrategy


def _batch_prefill_fn(cfg, params, k_pool, v_pool, padded, lens):
    """Every slot's prompt (padded [B, S], lens [B] on the device) into its
    slot of the pools; the logits [B, V]."""
    return torch.stack([
        prefill_fn(cfg, params, slot_cache(k_pool, i), slot_cache(v_pool, i), padded[i],
                   lens[i:i + 1])
        for i in range(padded.shape[0])])


class DecodeBatch(DecodeStrategy):
    name = "batch"

    def __init__(self, max_seq_len: int | None = None):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.k_cache = None
        self.v_cache = None
        self.graphs = ExecutableCache(shared_pool=True)

    def bind(self, model) -> "DecodeBatch":
        if model is not self.model:
            self._release()
        return super().bind(model)

    def _release(self) -> None:
        """Drop the captured programs and the pools they were bound to."""
        self.graphs.reset()
        self.k_cache = self.v_cache = None

    def _init_cache(self, batch: int, max_seq_len: int) -> None:
        """Zeroed pools in the model's dtype; pools of the same shape, dtype
        and device are zeroed in place, so the captured programs stay bound
        to them."""
        model = self.model
        cfg = model.config
        shape = (batch, cfg.num_layers, max_seq_len, cfg.num_kv_heads * cfg.head_dim)
        leaf = None if self.k_cache is None else kv_leaf(self.k_cache)
        if (leaf is not None and tuple(leaf.shape) == shape and leaf.dtype == model.dtype
                and leaf.device == model.device):
            for pool in (self.k_cache, self.v_cache):
                pool.zero_()
        else:
            self._release()
            self.k_cache = kv_cache_zeros(shape, model.dtype, device=model.device, merged=True)
            self.v_cache = kv_cache_zeros(shape, model.dtype, device=model.device, merged=True)
        self.max_seq_len = max_seq_len

    def _batch_prefill(self, padded: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        model = self.model
        b, bucket = padded.shape
        exe = self.graphs.get_or_capture(
            ("prefill", b, bucket), functools.partial(_batch_prefill_fn, model.config),
            model.params, self.k_cache, self.v_cache, torch.zeros_like(padded),
            torch.ones_like(lens), donate_argnums=(1, 2), bound_argnums=(0,),
            name=f"batch_prefill_{b}x{bucket}")
        return exe.replay(model.params, self.k_cache, self.v_cache, padded, lens)  # [B, V]

    def _batch_decode(self, tokens: torch.Tensor, poss: torch.Tensor) -> torch.Tensor:
        model = self.model
        b = tokens.shape[0]
        exe = self.graphs.get_or_capture(
            ("decode", b), functools.partial(batch_decode_step_fn, model.config),
            model.params, self.k_cache, self.v_cache, torch.zeros_like(tokens),
            torch.zeros_like(poss), donate_argnums=(1, 2), bound_argnums=(0,),
            name=f"batch_decode_{b}")
        return exe.replay(model.params, self.k_cache, self.v_cache, tokens, poss)  # [B, V]

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

        logits = self._batch_prefill(torch.as_tensor(padded).to(model.device),
                                     torch.as_tensor(lens).to(model.device))
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
