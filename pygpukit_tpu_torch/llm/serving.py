"""Continuous-batching serving engine (the non-pipelined dense path of
``pygpukit_tpu/llm/serving.py``).

A fixed table of ``max_batch`` request slots shares merged KV pools
``[B, L, MAX, Hk*D]``. Each ``step()`` admits queued requests into free
slots (one prefill each, written straight into the slot's pool rows), then
advances every slot ``steps_per_dispatch`` tokens with the batch-rows
decode step and reads the tokens back once. Free slots decode garbage at
their stale positions (clamped inside the step) and their tokens are
dropped, exactly as in the reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..ops.embedding import kv_cache_zeros
from .model import (CausalTransformerModel, _bucket, batch_decode_step_fn,
                    batch_generate_scan_fn, prefill_fn, sample_logits,
                    slot_cache)


@dataclass
class Request:
    request_id: int
    prompt: list[int]
    max_new_tokens: int = 64
    eos_token_id: int | None = None
    generated: list[int] = field(default_factory=list)
    done: bool = False
    slot: int = -1
    pos: int = 0
    on_token: Callable | None = None   # streaming callback(request, token)
    submitted_at: float = field(default_factory=time.time)
    first_token_at: float | None = None
    finished_at: float | None = None

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


@dataclass
class EngineStats:
    requests_submitted: int = 0
    requests_completed: int = 0
    steps: int = 0
    tokens_generated: int = 0
    prefills: int = 0


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a CausalTransformerModel."""

    def __init__(self, model: CausalTransformerModel, max_batch: int = 8,
                 max_seq_len: int = 1024, steps_per_dispatch: int = 1,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 pipelined: bool = False, paged: bool = False,
                 block_size: int = 16, num_blocks: int | None = None,
                 mesh=None):
        later = [name for name, on in (
            ("pipelined dispatch", pipelined), ("paged pools", paged),
            ("block_size", block_size != 16), ("num_blocks", num_blocks is not None),
            ("mesh serving", mesh is not None)) if on]
        if later:
            raise NotImplementedError("not ported yet: " + ", ".join(later))
        self.model = model
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.steps_per_dispatch = steps_per_dispatch
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        cfg = model.config
        dev = model.device
        shape = (max_batch, cfg.num_layers, max_seq_len,
                 cfg.num_kv_heads * cfg.head_dim)
        self.k_cache = kv_cache_zeros(shape, model.kv_dtype, device=dev)
        self.v_cache = kv_cache_zeros(shape, model.kv_dtype, device=dev)
        self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(seed)
        self._slots: list[Request | None] = [None] * max_batch
        self._queue: list[Request] = []
        self._next_id = 1
        self._last_tokens = np.zeros(max_batch, np.int64)
        self._poss = np.zeros(max_batch, np.int32)
        # sticky on-device flag: did any prefill or decode logit go
        # non-finite? Read without a sync per step (logits_finite()).
        self._nonfinite = torch.zeros((), dtype=torch.bool, device=dev)
        self.stats = EngineStats()

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt: list[int], max_new_tokens: int = 64,
               eos_token_id: int | None = None,
               on_token: Callable | None = None) -> Request:
        if len(prompt) >= self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)} tokens) exceeds engine max_seq_len "
                f"({self.max_seq_len})")
        req = Request(self._next_id, list(prompt), max_new_tokens,
                      eos_token_id, on_token=on_token)
        self._next_id += 1
        self._queue.append(req)
        self.stats.requests_submitted += 1
        return req

    def logits_finite(self) -> bool:
        """True when every logit this engine produced was finite."""
        return not bool(self._nonfinite)

    def _track(self, logits: torch.Tensor) -> None:
        self._nonfinite |= ~torch.isfinite(logits).all()

    def _emit(self, req: Request, tok: int) -> None:
        """Append a token and fire the streaming callback (a raising
        callback is disabled, never allowed to kill the batch loop)."""
        req.generated.append(tok)
        self.stats.tokens_generated += 1
        if req.on_token is not None:
            try:
                req.on_token(req, tok)
            except Exception:
                req.on_token = None

    def _admit(self) -> None:
        """Move queued requests into free slots, running their prefills."""
        for slot in [i for i, r in enumerate(self._slots) if r is None]:
            if not self._queue:
                break
            req = self._queue.pop(0)
            req.slot = slot
            self._slots[slot] = req
            self._prefill_slot(slot, req)

    @torch.no_grad()
    def _prefill_slot(self, slot: int, req: Request) -> None:
        model = self.model
        n = len(req.prompt)
        bucket = min(_bucket(max(n, 8)), self.max_seq_len)
        padded = torch.zeros(bucket, dtype=torch.long)
        padded[:n] = torch.as_tensor(req.prompt, dtype=torch.long)
        logits = prefill_fn(model.config, model.params,
                            slot_cache(self.k_cache, slot),
                            slot_cache(self.v_cache, slot),
                            padded.to(model.device), n)
        self._track(logits)
        tok = int(sample_logits(logits, self.temperature, self.top_k,
                                self._generator))
        self._emit(req, tok)
        req.first_token_at = time.time()
        req.pos = n
        self._last_tokens[slot] = tok
        self._poss[slot] = n
        self.stats.prefills += 1
        self._maybe_finish(slot, tok)

    def _maybe_finish(self, slot: int, tok: int) -> None:
        req = self._slots[slot]
        if req is not None:
            self._maybe_finish_req(req, slot, tok)

    def _maybe_finish_req(self, req: Request, slot: int, tok: int,
                          pos: int | None = None) -> None:
        if pos is None:
            pos = self._poss[slot]
        if ((req.eos_token_id is not None and tok == req.eos_token_id)
                or len(req.generated) >= req.max_new_tokens
                or pos + 1 >= self.max_seq_len):
            req.done = True
            req.finished_at = time.time()
            if self._slots[slot] is req:
                self._slots[slot] = None
            self.stats.requests_completed += 1

    # -- engine loop -------------------------------------------------------

    @torch.no_grad()
    def step(self) -> int:
        """Admit, then advance every active slot by steps_per_dispatch
        tokens. Returns the number of active slots."""
        self._admit()
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active:
            return 0
        dev = self.model.device
        cfg, params = self.model.config, self.model.params
        last = torch.as_tensor(self._last_tokens).to(dev)
        poss = torch.as_tensor(self._poss).to(dev)
        n = self.steps_per_dispatch
        if n <= 1:
            logits = batch_decode_step_fn(cfg, params, self.k_cache,
                                          self.v_cache, last, poss)
            self._track(logits)
            toks_d = sample_logits(logits, self.temperature, self.top_k,
                                   self._generator)[:, None]
        else:
            toks_d = batch_generate_scan_fn(
                cfg, n, self.temperature, self.top_k, params, self.k_cache,
                self.v_cache, last, poss, self._generator, on_logits=self._track)
        toks = toks_d.cpu().numpy()                          # [B, n]
        self.stats.steps += 1
        for i in active:
            req = self._slots[i]
            for j in range(toks.shape[1]):
                if req is None or req.done:
                    break
                tok = int(toks[i, j])
                self._poss[i] += 1
                req.pos += 1
                self._emit(req, tok)
                self._last_tokens[i] = tok
                self._maybe_finish(i, tok)
                if self._slots[i] is None:
                    break
        return len(active)

    def run_until_complete(self, max_steps: int = 10000) -> None:
        for _ in range(max_steps):
            if not self.has_work:
                return
            self.step()

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(r is not None for r in self._slots)
