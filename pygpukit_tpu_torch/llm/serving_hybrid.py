"""Continuous batching for the standalone model families (counterpart of
``pygpukit_tpu/llm/serving_hybrid.py``'s ``HybridServingEngine``).

``ContinuousBatchingEngine`` (``serving.py``) is built on
``CausalTransformerModel``'s twin KV pools. A standalone family
(``llm/models``: DeepSeek's compressed MLA caches, gpt-oss's K/V, Mamba's
conv and SSM states, LFM2's conv states beside its K/V) keeps its caches
as one tree of tensors (a dict, or a list of per-layer dicts) behind three
hooks of its class: ``_init_caches(cfg, max_seq_len, dtype, device)``,
``_prefill_fn(cfg, params, caches, tokens, true_len)`` and
``_decode_step_fn(cfg, params, caches, token, pos)``, each returning
``(caches, logits)`` and writing the caches in place. The engine stacks
every leaf of the tree with a leading slot axis (``torch.utils._pytree``).

Design (the reference's non-pipelined engine semantics):
- a fixed slot table of ``max_batch`` slots, so the chunk program never
  changes; free slots decode garbage that the host discards (their
  positions clamp at ``max_seq_len - 1``);
- admission (``_admit_slot_fn``): one captured program per prompt bucket
  zeroes a single-sequence scratch cache (a stateful prefill such as
  Mamba's continues from the state it is given, so a reused slot starts
  from zeros, never from its last request), runs the family's prefill on it,
  copies every leaf into the slot (an index copy at a device slot), samples
  the first token on the device and writes it and the length into the
  device-resident ``last``/``poss``;
- decode (``_hybrid_chunk_fn``): one captured program advances every slot
  ``steps_per_dispatch`` tokens. The reference vmaps its sampling scan over
  the slots; here the slot axis is a loop inside the program, each slot's
  step the family's own single-sequence ``_decode_step_fn`` on its view of
  the stacked caches, so a slot computes the bits its prompt's greedy
  ``generate`` computes at the same cache length and prompt bucket.

Both programs are captured once and replayed (``core.executable``), in the
engine's ``graphs`` pool; the caches, ``last`` and ``poss`` are donated.
Sampling draws from the engine's ``torch.Generator`` (greedy streams match
the reference; sampled ones replay under ``seed``).
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.executable import Executable, ExecutableCache
from .model import _bucket, sample_logits
from .serving import EngineStats, Request, _to_device
from .serving_paged import put_at

#: the class hooks a family must expose to be served
HOOKS = ("_prefill_fn", "_decode_step_fn", "_init_caches")


def _admit_slot_fn(cfg, prefill_fn, temperature: float, top_k: int, generator,
                   params, caches_b, single, last, poss, tokens, true_len, slot):
    """Prefill one sequence into the zeroed ``single`` cache, copy every
    leaf into slot ``slot`` (a one-element device tensor) of the stacked
    caches, sample its first token and write it and the length
    ``true_len`` into ``last``/``poss`` (all in place). Returns the token,
    a device tensor."""
    for leaf in pytree.tree_leaves(single):
        leaf.zero_()
    single, logits = prefill_fn(cfg, params, single, tokens, true_len)
    at = slot.reshape(1).to(torch.long)
    for leaf, new in zip(pytree.tree_leaves(caches_b), pytree.tree_leaves(single)):
        leaf.index_copy_(0, at, new[None].to(leaf.dtype))
    tok = sample_logits(logits, temperature, top_k, generator).to(torch.int32)
    put_at(last, slot, tok)
    put_at(poss, slot, true_len)
    return tok


def _hybrid_chunk_fn(cfg, step_fn, n_steps: int, temperature: float, top_k: int,
                     generator, max_seq_len: int, params, caches_b, last, poss):
    """Advance every slot ``n_steps`` tokens: per slot, the family's
    single-sequence step on the slot's view of the stacked caches, sampled
    on the device, the position clamped to ``max_seq_len - 1`` after each
    step. ``last`` and ``poss`` are written in place. int32 tokens [B,
    n_steps]."""
    rows = []
    for b in range(last.shape[0]):
        caches = pytree.tree_map(lambda leaf, b=b: leaf[b], caches_b)
        tok, pos = last[b:b + 1].clone(), poss[b:b + 1].clone()
        row = []
        for _ in range(n_steps):
            _, logits = step_fn(cfg, params, caches, tok, pos)
            tok = sample_logits(logits, temperature, top_k, generator).to(torch.int32)
            tok = tok.reshape(1)
            row.append(tok)
            pos = torch.clamp(pos + 1, max=max_seq_len - 1)
        last[b:b + 1].copy_(tok)
        poss[b:b + 1].copy_(pos)
        rows.append(torch.cat(row))
    return torch.stack(rows)


class HybridServingEngine:
    """Slot-based continuous batching over a standalone family's model
    (``DeepseekV3Model``, ``GptOssModel``, ``MambaModel``, ``Lfm2Model``)."""

    def __init__(self, model, max_batch: int = 4, max_seq_len: int = 256,
                 steps_per_dispatch: int = 8, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, mesh=None):
        cls = type(model)
        for hook in HOOKS:
            if getattr(cls, hook, None) is None:
                raise TypeError(
                    f"{cls.__name__} does not expose {hook}; the hybrid engine serves "
                    "the standalone families (llm.models: DeepSeek, gpt-oss, Mamba, LFM2)")
        if mesh is not None:
            raise NotImplementedError("not ported yet: mesh serving")
        self.model = model
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.steps_per_dispatch = max(int(steps_per_dispatch), 1)
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        dev = model.device
        # the admission's single-sequence scratch cache, and every leaf of
        # its tree stacked with a leading slot axis
        self._single = cls._init_caches(model.config, max_seq_len, model.dtype, dev)
        self._caches = pytree.tree_map(
            lambda leaf: torch.zeros((max_batch,) + tuple(leaf.shape), dtype=leaf.dtype,
                                     device=dev), self._single)
        self._last_dev = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        self._poss_dev = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(seed)
        self._slots: list[Request | None] = [None] * max_batch
        self._queue: list[Request] = []
        self._next_id = 1
        self._poss = np.zeros(max_batch, np.int32)
        self.stats = EngineStats()
        # every captured program of the engine, one shared memory pool
        self.graphs = ExecutableCache(shared_pool=True)

    # -- request lifecycle --------------------------------------------------

    def submit(self, prompt: list[int], max_new_tokens: int = 64,
               eos_token_id: int | None = None, on_token=None) -> Request:
        if len(prompt) >= self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)} tokens) exceeds engine max_seq_len "
                f"({self.max_seq_len})")
        req = Request(self._next_id, list(prompt), max_new_tokens, eos_token_id,
                      on_token=on_token)
        self._next_id += 1
        self._queue.append(req)
        self.stats.requests_submitted += 1
        return req

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
        for slot in [i for i, r in enumerate(self._slots) if r is None]:
            if not self._queue:
                break
            req = self._queue.pop(0)
            req.slot = slot
            self._slots[slot] = req
            self._prefill_slot(slot, req)

    def _capture(self, key, name: str, fn, *example_args, donate_argnums=()) -> Executable:
        with torch.no_grad():
            return self.graphs.get_or_capture(
                key, fn, *example_args, donate_argnums=donate_argnums, bound_argnums=(0,),
                generators=(self._generator,) if self.temperature > 0 else (),
                name=f"{type(self.model)._name}_{name}")

    def _prefill_slot(self, slot: int, req: Request) -> None:
        model, dev = self.model, self.model.device
        n = len(req.prompt)
        bucket = min(_bucket(max(n, 8)), self.max_seq_len)
        fn = functools.partial(_admit_slot_fn, model.config, type(model)._prefill_fn,
                               float(self.temperature), int(self.top_k), self._generator)
        exe = self._capture(("prefill", bucket), f"serve_prefill_{bucket}", fn,
                            model.params, self._caches, self._single, self._last_dev,
                            self._poss_dev, torch.zeros(bucket, dtype=torch.int32, device=dev),
                            1, 0, donate_argnums=(1, 2, 3, 4))
        padded = np.zeros(bucket, np.int32)
        padded[:n] = req.prompt
        with torch.no_grad():
            tok = exe.replay(model.params, self._caches, self._single, self._last_dev,
                             self._poss_dev, _to_device(padded, dev), n, slot)
        tok = int(tok.reshape(()).item())
        self._emit(req, tok)
        req.first_token_at = time.time()
        self._poss[slot] = n
        self.stats.prefills += 1
        self._maybe_finish(slot, tok)

    def _maybe_finish(self, slot: int, tok: int) -> None:
        req = self._slots[slot]
        if req is None:
            return
        if ((req.eos_token_id is not None and tok == req.eos_token_id)
                or len(req.generated) >= req.max_new_tokens
                or self._poss[slot] + 1 >= self.max_seq_len):
            req.done = True
            req.finished_at = time.time()
            self._slots[slot] = None
            self.stats.requests_completed += 1

    # -- engine loop ----------------------------------------------------------

    def _chunk_exe(self) -> Executable:
        n = self.steps_per_dispatch
        fn = functools.partial(_hybrid_chunk_fn, self.model.config,
                               type(self.model)._decode_step_fn, n, float(self.temperature),
                               int(self.top_k), self._generator, int(self.max_seq_len))
        return self._capture(("chunk", n), f"serve_chunk_{n}", fn, self.model.params,
                             self._caches, self._last_dev, self._poss_dev,
                             donate_argnums=(1, 2, 3))

    def step(self) -> int:
        """Admit queued requests, then advance every slot by
        ``steps_per_dispatch`` tokens. Returns the number of active slots."""
        self._admit()
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active:
            return 0
        with torch.no_grad():
            toks = self._chunk_exe().replay(self.model.params, self._caches,
                                            self._last_dev, self._poss_dev)
        toks = toks.cpu().numpy()                                  # [B, n]
        self.stats.steps += 1
        for i in active:
            for j in range(toks.shape[1]):
                req = self._slots[i]
                if req is None or req.done:
                    break
                self._poss[i] = min(self._poss[i] + 1, self.max_seq_len - 1)
                tok = int(toks[i, j])
                self._emit(req, tok)
                self._maybe_finish(i, tok)
        return len(active)

    def run_until_complete(self, max_steps: int = 10000) -> None:
        for _ in range(max_steps):
            if not self.has_work():
                return
            self.step()
        raise RuntimeError(f"engine did not drain in {max_steps} steps")

    def has_work(self) -> bool:
        return bool(self._queue) or any(r is not None for r in self._slots)
