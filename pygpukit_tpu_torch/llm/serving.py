"""Continuous-batching serving engine (port of ``pygpukit_tpu/llm/serving.py``).

A fixed table of ``max_batch`` request slots. Each step admits queued
requests into free slots (one prefill each), then advances every slot
``steps_per_dispatch`` tokens with the batch-rows decode step. Free slots
decode garbage at clamped positions and their tokens are dropped, exactly
as in the reference. Two options, alone or together:

- ``paged``: KV lives in one shared block pool ``[L, NB, Hk, BS, D]`` with
  per-slot block tables (``serving_paged.py``); admission reserves a
  request's worst case and waits while the pool is busy. Otherwise KV lives
  in merged dense pools ``[B, L, MAX, Hk*D]``.
- ``pipelined``: the last tokens and positions stay on the device, and
  chunk N+1 is dispatched before chunk N's tokens are read back. The
  readback goes through pinned host memory and a CUDA event, so it waits
  for chunk N only; host uploads are non-blocking copies from pinned
  memory. Bookkeeping (EOS, admission, TTFT) lags one chunk behind the
  device; completion and block frees go by request identity.

Every program the engine runs is a captured executable (``core.
executable``), keyed and named as the reference's: one prefill per
bucket (``serve_prefill_{bucket}``, ``serve_prefill_paged_{bucket}``), per
pipelined bucket (``serve_prefill_pl_{bucket}``,
``serve_prefill_paged_pl_{bucket}``) and per (wave size, bucket)
(``serve_prefill_wave_{w}_{bucket}``, ``serve_prefill_paged_plw_{w}_
{bucket}``), and one decode chunk (``serve_decode_br[_{n}]``,
``serve_chunk_paged_{n}``, ``serve_chunk_br_{n}``,
``serve_chunk_paged_pl_{n}``), all in the engine's ``graphs`` pool. On the
card each is a CUDA graph captured at first use (or by ``warmup()``) and
replayed afterwards; on the CPU each calls its function. Slots, lengths,
block tables and the pipelined ``last``/``poss`` are device tensors the
programs read and write in place; the block tables are one tensor that
``_sync_tables`` copies into, and the pools, ``last``, ``poss`` and the
non-finite flag are donated. Every static output (logits, tokens) is
consumed before the next replay: a pinned readback (``_Readback``) or a
host read at once. ``_prefill_shapes`` records the (wave size, bucket)
shapes captured. ``PYGPUKIT_SERVE_PREADMIT`` and ``PYGPUKIT_SERVE_TAILSKIP`` switch off
pre-dispatch admission and the dead-tail-chunk skip, as in the reference.
Sampling draws from the engine's ``torch.Generator``: greedy streams match
the reference, sampled streams replay under ``seed``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

import functools

from ..core.executable import Executable, ExecutableCache
from ..ops.embedding import kv_cache_zeros
from .model import (CausalTransformerModel, _bucket, _note_nonfinite,
                    batch_generate_scan_fn, prefill_fn, sample_logits)
from .serving_paged import (BlockAllocator, paged_prefill_fn,
                            paged_prefill_wave_pl_fn, paged_serve_chunk_fn, put_at)


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Upload a host array without synchronising the stream: CUDA copies go
    from a fresh pinned buffer, non-blocking (a pageable copy waits for the
    whole stream, which would serialise the pipeline)."""
    t = torch.from_numpy(np.array(arr, order="C"))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


class _Readback:
    """A device -> host copy that waits only for the work queued before it:
    pinned memory, a non-blocking copy and an event (``tensor.cpu()`` would
    wait for the whole stream, the chunk just dispatched included)."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t.clone()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _prefill_into_slot_pl_fn(cfg, temperature: float, top_k: int, generator,
                             params, k_pool, v_pool, last, poss, tokens,
                             true_len, slot, on_logits=None):
    """Pipelined dense prefill: prefill into slot ``slot`` of the pools (a
    one-element device tensor: the rows land by an index copy), sample the
    first token on the device and write it and the position
    (``true_len``, a one-element device tensor) into the device-resident
    ``last``/``poss`` (in place). Returns the token, a device scalar:
    admission is a dispatch, never a sync."""
    logits = prefill_fn(cfg, params, k_pool, v_pool, tokens, true_len, slot)
    if on_logits is not None:
        on_logits(logits)
    tok = sample_logits(logits, temperature, top_k, generator)
    put_at(last, slot, tok)
    put_at(poss, slot, true_len)
    return tok


def _prefill_wave_pl_fn(cfg, temperature: float, top_k: int, generator,
                        n_wave: int, params, k_pool, v_pool, last, poss,
                        tokens_w, lens_w, slots_w, on_logits=None):
    """Pipelined admission wave: ``n_wave`` same-bucket prefills in order
    (tokens_w [W, S], lens_w and slots_w [W] int32, all on the device).
    Returns the first tokens [W] on the device."""
    return torch.stack([
        _prefill_into_slot_pl_fn(cfg, temperature, top_k, generator, params,
                                 k_pool, v_pool, last, poss, tokens_w[i],
                                 lens_w[i:i + 1], slots_w[i:i + 1], on_logits)
        for i in range(n_wave)])


def _serve_chunk_batch_fn(cfg, n_steps: int, temperature: float, top_k: int,
                          generator, max_seq_len: int, params, k_pool, v_pool,
                          last, poss, on_logits=None):
    """Advance every slot ``n_steps`` tokens with device-resident last/poss
    (batch-rows step), written in place: the reference donates them and
    the next chunk chains on them. Positions clamp to ``max_seq_len - 1``
    once, after the chunk; inside it the row write, rope rows and attention
    bound clamp. Returns (last, poss, toks [B, n_steps]) on the device."""
    toks = batch_generate_scan_fn(cfg, n_steps, temperature, top_k, params,
                                  k_pool, v_pool, last, poss, generator,
                                  on_logits=on_logits)
    last.copy_(toks[:, -1])
    poss.copy_(torch.clamp(poss + n_steps, max=max_seq_len - 1))
    return last, poss, toks


def _flagged(fn, *args):
    """``fn(*args[:-1], on_logits=...)`` that sets the sticky non-finite
    flag ``args[-1]`` (a donated argument of the captured program)."""
    return fn(*args[:-1], on_logits=functools.partial(_note_nonfinite, args[-1]))


def _noted(fn, *args):
    """``fn(*args[:-1])``, whose logits set the sticky non-finite flag
    ``args[-1]`` (a donated argument of the captured program)."""
    logits = fn(*args[:-1])
    _note_nonfinite(args[-1], logits)
    return logits


def _serve_decode_fn(cfg, n_steps: int, temperature: float, top_k: int, generator,
                     params, k_pool, v_pool, tokens, poss, nonfinite):
    """Non-pipelined dense chunk: ``batch_generate_scan_fn`` from host
    uploaded tokens and positions; the tokens [B, n_steps]."""
    return batch_generate_scan_fn(cfg, n_steps, temperature, top_k, params, k_pool,
                                  v_pool, tokens, poss, generator,
                                  functools.partial(_note_nonfinite, nonfinite))


@dataclass
class Request:
    request_id: int
    prompt: list[int]
    max_new_tokens: int = 64
    eos_token_id: int | None = None
    generated: list[int] = field(default_factory=list)
    done: bool = False
    slot: int = -1
    pos: int = 0                 # this request's own sequence position
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
        if mesh is not None:
            raise NotImplementedError("not ported yet: mesh serving")
        self.model = model
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.steps_per_dispatch = steps_per_dispatch
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.pipelined = pipelined
        self.paged = paged
        cfg = model.config
        dev = model.device
        if paged:
            # block 0 is the trash block; the default pool covers the worst
            # case (admission reserves each request's full need up front)
            self.block_size = block_size
            self.max_blocks = -(-max_seq_len // block_size)
            nb = num_blocks or (max_batch * self.max_blocks + 2)
            shape = (cfg.num_layers, nb, cfg.num_kv_heads, block_size,
                     cfg.head_dim)
            if model.kv_dtype == torch.int8:
                # int8 dict block pools: one scale per row, [L, NB, BS]
                self.k_cache, self.v_cache = (
                    {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
                     "s": torch.zeros(shape[:2] + shape[3:4],
                                      dtype=torch.bfloat16, device=dev)}
                    for _ in range(2))
            else:
                self.k_cache = torch.zeros(shape, dtype=model.kv_dtype, device=dev)
                self.v_cache = torch.zeros(shape, dtype=model.kv_dtype, device=dev)
            self._alloc = BlockAllocator(nb, block_size)
            self._tables_np = np.zeros((max_batch, self.max_blocks), np.int32)
            # the captured chunks read this tensor: _sync_tables copies into it
            self._tables_dev = _to_device(self._tables_np, dev)
            self._tables_dirty = False
        else:
            shape = (max_batch, cfg.num_layers, max_seq_len,
                     cfg.num_kv_heads * cfg.head_dim)
            self.k_cache = kv_cache_zeros(shape, model.kv_dtype, device=dev, merged=True)
            self.v_cache = kv_cache_zeros(shape, model.kv_dtype, device=dev, merged=True)
        self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(seed)
        self._slots: list[Request | None] = [None] * max_batch
        self._queue: list[Request] = []
        self._next_id = 1
        self._last_tokens = np.zeros(max_batch, np.int64)
        self._poss = np.zeros(max_batch, np.int32)
        self._prefill_shapes: set[tuple[int, int]] = set()   # (wave, bucket)
        # sticky on-device flag: did any prefill or decode logit go
        # non-finite? Read without a sync per step (logits_finite()).
        self._nonfinite = torch.zeros((), dtype=torch.bool, device=dev)
        self.stats = EngineStats()
        # every captured program of the engine, one shared memory pool
        self.graphs = ExecutableCache(shared_pool=True)
        if pipelined:
            self._last_dev = torch.zeros(max_batch, dtype=torch.long, device=dev)
            self._poss_dev = torch.zeros(max_batch, dtype=torch.int32, device=dev)
            self._inflight = None            # (_Readback, [(slot, req), ...])
            self._pending_first: list = []   # [(req, _Readback, index)]

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
        if self.paged:
            need = self._paged_need(req)
            if need > self._alloc.num_blocks - 1:
                raise MemoryError(
                    f"request needs {need} KV blocks; pool has "
                    f"{self._alloc.num_blocks - 1} usable — raise num_blocks"
                    f" or lower max_new_tokens")
        self._next_id += 1
        self._queue.append(req)
        self.stats.requests_submitted += 1
        return req

    def logits_finite(self) -> bool:
        """True when every logit this engine produced was finite."""
        return not bool(self._nonfinite)

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
        """Move queued requests into free slots, running their prefills
        (pipelined mode batches same-bucket admissions into waves)."""
        pairs = []
        for slot in [i for i, r in enumerate(self._slots) if r is None]:
            if not self._queue:
                break
            if self.paged and not self._can_admit_paged(self._queue[0], pairs):
                break                      # pool busy: admit when blocks free
            req = self._queue.pop(0)
            req.slot = slot
            self._slots[slot] = req
            pairs.append((slot, req))
        self._dispatch_prefills(pairs)

    def _dispatch_prefills(self, pairs: list) -> None:
        """Run prefills for (slot, request) pairs; in pipelined mode,
        same-bucket groups go in power-of-two sub-waves (the reference's
        bounded executable key space, which warmup() covers)."""
        if not self.pipelined:
            for slot, req in pairs:
                self._prefill_slot(slot, req)
            return
        by_bucket: dict[int, list] = {}
        for slot, req in pairs:
            by_bucket.setdefault(self._bucket_of(req), []).append((slot, req))
        for bucket, group in by_bucket.items():
            i = 0
            while i < len(group):
                w = 1 << ((len(group) - i).bit_length() - 1)
                self._prefill_wave(bucket, group[i:i + w])
                i += w

    def _bucket_of(self, req: Request) -> int:
        return min(_bucket(max(len(req.prompt), 8)), self.max_seq_len)

    def _capture(self, key, name: str, fn, *example_args, donate_argnums=(),
                 sampled: bool = False) -> Executable:
        """The engine's executable under ``key``, captured at first use into
        the engine's pool; ``sampled`` programs register the generator."""
        gens = (self._generator,) if sampled and self.temperature > 0 else ()
        return self.graphs.get_or_capture(key, fn, *example_args,
                                          donate_argnums=donate_argnums, bound_argnums=(0,),
                                          generators=gens, name=name)

    def _prefill_exe(self, w: int, bucket: int) -> Executable:
        """The prefill executable of a ``w``-request wave at ``bucket``
        (the reference's keys and names, module docstring), captured at
        zero example inputs the first time."""
        m = self.model
        cfg, dev = m.config, m.device
        self._prefill_shapes.add((w, bucket))
        z = functools.partial(torch.zeros, dtype=torch.int32, device=dev)
        one = functools.partial(torch.ones, dtype=torch.int32, device=dev)   # lengths
        tokens = torch.zeros((w, bucket), dtype=torch.long, device=dev)
        pools = (m.params, self.k_cache, self.v_cache)
        if not self.pipelined:
            if self.paged:
                return self._capture(
                    ("paged", bucket), f"serve_prefill_paged_{bucket}",
                    functools.partial(_noted, functools.partial(paged_prefill_fn, cfg)),
                    *pools,
                    z(self.max_blocks), tokens[0], one(1), self._nonfinite,
                    donate_argnums=(1, 2, 6))
            return self._capture(bucket, f"serve_prefill_{bucket}",
                                 functools.partial(_noted, functools.partial(prefill_fn, cfg)),
                                 *pools,
                                 tokens[0], one(1), z(1), self._nonfinite,
                                 donate_argnums=(1, 2, 6))
        head = (cfg, float(self.temperature), int(self.top_k), self._generator, w)
        state = pools + (self._last_dev, self._poss_dev)
        if self.paged:
            key, name = ((("paged-pl", bucket), f"serve_prefill_paged_pl_{bucket}")
                         if w == 1 else (("paged-plw", w, bucket),
                                         f"serve_prefill_paged_plw_{w}_{bucket}"))
            return self._capture(
                key, name, functools.partial(_flagged, functools.partial(
                    paged_prefill_wave_pl_fn, *head)),
                *state, z((w, self.max_blocks)), tokens, one(w), z(w), self._nonfinite,
                donate_argnums=(1, 2, 3, 4, 9), sampled=True)
        key, name = ((("pl", bucket), f"serve_prefill_pl_{bucket}") if w == 1 else
                     (("plw", w, bucket), f"serve_prefill_wave_{w}_{bucket}"))
        return self._capture(
            key, name, functools.partial(_flagged, functools.partial(
                _prefill_wave_pl_fn, *head)),
            *state, tokens, one(w), z(w), self._nonfinite,
            donate_argnums=(1, 2, 3, 4, 8), sampled=True)

    def _chunk_exe(self) -> Executable:
        """The decode chunk of ``steps_per_dispatch`` steps (the reference's
        ``_ensure_decode_exe``, ``_ensure_paged_chunk_exe`` and
        ``_ensure_chunk_exe``), captured the first time."""
        m = self.model
        n = max(self.steps_per_dispatch, 1)
        head = (m.config, n, float(self.temperature), int(self.top_k), self._generator)
        pools = (m.params, self.k_cache, self.v_cache)
        if self.pipelined:
            if self.paged:
                return self._capture(
                    "chunk", f"serve_chunk_paged_pl_{n}",
                    functools.partial(_flagged, functools.partial(
                        paged_serve_chunk_fn, *head, self.max_seq_len)),
                    *pools, self._tables_dev, self._last_dev, self._poss_dev,
                    self._nonfinite, donate_argnums=(1, 2, 4, 5, 6), sampled=True)
            return self._capture(
                "chunk", f"serve_chunk_br_{n}",
                functools.partial(_flagged, functools.partial(
                    _serve_chunk_batch_fn, *head, self.max_seq_len)),
                *pools, self._last_dev, self._poss_dev, self._nonfinite,
                donate_argnums=(1, 2, 3, 4, 5), sampled=True)
        dev = m.device
        last = torch.zeros(self.max_batch, dtype=torch.long, device=dev)
        poss = torch.zeros(self.max_batch, dtype=torch.int32, device=dev)
        if self.paged:
            return self._capture(
                "chunk", f"serve_chunk_paged_{n}",
                functools.partial(_flagged, functools.partial(
                    paged_serve_chunk_fn, *head, self.max_seq_len)),
                *pools, self._tables_dev, last, poss, self._nonfinite,
                donate_argnums=(1, 2, 6), sampled=True)
        return self._capture(
            "chunk", f"serve_decode_br_{n}" if self.steps_per_dispatch > 1
            else "serve_decode_br", functools.partial(_serve_decode_fn, *head),
            *pools, last, poss, self._nonfinite, donate_argnums=(1, 2, 5), sampled=True)

    def _run_prefills(self, bucket: int, slots: list[int], lens: list[int],
                      tokens: torch.Tensor, tables: torch.Tensor | None):
        """The one call site of the prefill executables (tokens [W, bucket],
        tables [W, MB] on the device for paged engines; slots and lengths
        uploaded as int32 [W]). Pipelined engines sample on the device into
        last/poss and get the first tokens [W]; the others prefill one
        request and get its logits. Both are static outputs, consumed
        before the next replay."""
        exe = self._prefill_exe(len(slots), bucket)
        m = self.model
        dev = m.device
        lens_d = _to_device(np.asarray(lens, np.int32), dev)
        slots_d = _to_device(np.asarray(slots, np.int32), dev)
        pools = (m.params, self.k_cache, self.v_cache)
        if not self.pipelined:
            if self.paged:
                return exe.replay(*pools, tables[0], tokens[0], lens_d, self._nonfinite)
            return exe.replay(*pools, tokens[0], lens_d, slots_d, self._nonfinite)
        state = pools + (self._last_dev, self._poss_dev)
        if self.paged:
            return exe.replay(*state, tables, tokens, lens_d, slots_d, self._nonfinite)
        return exe.replay(*state, tokens, lens_d, slots_d, self._nonfinite)

    def _prefill_inputs(self, bucket: int, group: list):
        """(slots, lengths, padded prompts [W, bucket], block-table rows
        [W, MB] or None) of (slot, request) pairs, on the device. Paged
        engines reserve each request's full worst case first (see
        _can_admit_paged)."""
        slots = [slot for slot, _ in group]
        padded = np.zeros((len(group), bucket), np.int64)
        for i, (slot, req) in enumerate(group):
            padded[i, :len(req.prompt)] = req.prompt
            if self.paged:
                self._ensure_blocks(req, slot,
                                    len(req.prompt) + req.max_new_tokens + 1)
        dev = self.model.device
        tables = _to_device(self._tables_np[slots], dev) if self.paged else None
        return (slots, [len(r.prompt) for _, r in group], _to_device(padded, dev),
                tables)

    def _prefill_slot(self, slot: int, req: Request) -> None:
        """Non-pipelined admission: prefill, then sample and read the first
        token back at once."""
        n = len(req.prompt)
        bucket = self._bucket_of(req)
        logits = self._run_prefills(bucket,
                                    *self._prefill_inputs(bucket, [(slot, req)]))
        tok = int(sample_logits(logits, self.temperature, self.top_k,
                                self._generator))
        self._emit(req, tok)
        req.first_token_at = time.time()
        req.pos = n
        self._last_tokens[slot] = tok
        self._poss[slot] = n
        self.stats.prefills += 1
        self._maybe_finish(slot, tok)

    def _prefill_wave(self, bucket: int, group: list) -> None:
        """Pipelined admission of same-bucket (slot, request) pairs: one
        dispatch each, the first tokens sampled on the device and read back
        at the next resolution (by then computed; the pinned copy waits for
        nothing dispatched after it). The reference's single and wave,
        dense and paged variants (_prefill_slot_pl, _prefill_wave_pl,
        _prefill_slot_paged_pl, _prefill_wave_paged_pl) are this method."""
        rb = _Readback(self._run_prefills(bucket,
                                          *self._prefill_inputs(bucket, group)))
        for i, (slot, req) in enumerate(group):
            self._poss[slot] = len(req.prompt)
            req.pos = len(req.prompt)      # per-request: the slot may be
            self._pending_first.append((req, rb, i))   # reused before it resolves
            self.stats.prefills += 1

    # -- paged mode ----------------------------------------------------------

    def _sync_tables(self) -> None:
        """Copy the host tables into the device tensor the chunks read."""
        if self._tables_dirty:
            self._tables_dev.copy_(_to_device(self._tables_np, self.model.device))
            self._tables_dirty = False

    def _paged_need(self, req: Request) -> int:
        """Worst-case blocks this request can ever need (context-clamped)."""
        n = min(len(req.prompt) + req.max_new_tokens + 1, self.max_seq_len)
        return -(-n // self.block_size)

    def _can_admit_paged(self, req: Request, pending=()) -> bool:
        """Admission reserves the full worst case, so growth mid-chunk never
        exhausts the pool; never-fitting requests are refused at submit().
        ``pending``: the (slot, request) pairs this admission pass took
        already, whose blocks are allocated only when their prefills run.
        (The reference checks each request against the free count alone, so
        one pass over several free slots can admit more than the pool holds
        and fail with MemoryError; ROADMAP E.)"""
        held = sum(self._paged_need(r) for _, r in pending)
        return self._paged_need(req) <= self._alloc.free_blocks - held

    def _ensure_blocks(self, req: Request, slot: int, n_tokens: int) -> None:
        n_tokens = min(n_tokens, self.max_seq_len)   # table capacity
        blocks = self._alloc.alloc_for(req.request_id, n_tokens)
        row = self._tables_np[slot]
        if not np.array_equal(row[:len(blocks)], blocks):
            row[:] = 0
            row[:len(blocks)] = blocks
            self._tables_dirty = True

    def _release_paged(self, req: Request, slot: int) -> None:
        self._alloc.free(req.request_id)
        self._tables_np[slot] = 0          # clamped writes land in trash
        self._tables_dirty = True

    def _maybe_finish(self, slot: int, tok: int) -> None:
        req = self._slots[slot]
        if req is not None:
            self._maybe_finish_req(req, slot, tok)

    def _maybe_finish_req(self, req: Request, slot: int, tok: int,
                          pos: int | None = None) -> None:
        """Request-bound finish check: in pipelined mode resolution lags a
        chunk, so ``slot`` may already host a newer request; the request's
        identity decides completion, and the slot (and its table row) is
        freed only if this request still owns it."""
        if pos is None:
            pos = self._poss[slot]
        if ((req.eos_token_id is not None and tok == req.eos_token_id)
                or len(req.generated) >= req.max_new_tokens
                or pos + 1 >= self.max_seq_len):
            req.done = True
            req.finished_at = time.time()
            if self._slots[slot] is req:
                self._slots[slot] = None
                if self.paged:
                    self._release_paged(req, slot)
            elif self.paged:
                # the slot already hosts a newer request whose table row
                # replaced ours: free the finished request's blocks by
                # identity so they don't leak
                self._alloc.free(req.request_id)
            self.stats.requests_completed += 1

    # -- engine loop -------------------------------------------------------

    @torch.no_grad()
    def step(self) -> int:
        """Admit, then advance every active slot by steps_per_dispatch
        tokens. Returns the number of active slots."""
        if self.pipelined:
            return self._step_pipelined()
        self._admit()
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active:
            return 0
        dev = self.model.device
        exe = self._chunk_exe()
        pools = (self.model.params, self.k_cache, self.v_cache)
        last = _to_device(self._last_tokens, dev)
        poss = _to_device(self._poss, dev)
        if self.paged:
            n = max(self.steps_per_dispatch, 1)
            for i in active:
                req = self._slots[i]
                # never demand past the admission-time reservation
                # (overflow positions land in the trash block)
                self._ensure_blocks(req, i, min(
                    int(self._poss[i]) + n + 1,
                    len(req.prompt) + req.max_new_tokens + 1))
            self._sync_tables()
            toks_d = exe.replay(*pools, self._tables_dev, last, poss,
                                self._nonfinite)[2]
        else:
            toks_d = exe.replay(*pools, last, poss, self._nonfinite)
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

    def _step_pipelined(self) -> int:
        """One pipelined engine step:

        1. dispatch a chunk over the current device state (admissions from
           the previous call are already queued on the device), unless
           every active request is length-certain to finish inside the
           chunk already in flight (_tail_covered): that chunk would be
           fully dead;
        2. resolve the previous chunk's tokens; its readback waits for that
           chunk only, so the host bookkeeping overlaps the chunk just
           dispatched;
        3. admissions prefill into the freed slots (queued after this
           chunk, picked up by the next one).
        """
        if (os.environ.get("PYGPUKIT_SERVE_PREADMIT", "1") != "0"
                and self._queue and any(r is None for r in self._slots)):
            # fill already-free slots before dispatching: the prefills are
            # queued ahead of the chunk, no sync needed
            self._admit()
        active = [(i, self._slots[i]) for i in range(self.max_batch)
                  if self._slots[i] is not None]
        dispatched = None
        if active and self._tail_covered(active):
            active = []
        if active:
            exe = self._chunk_exe()
            state = (self.model.params, self.k_cache, self.v_cache)
            if self.paged:
                self._sync_tables()
                state += (self._tables_dev,)
            toks = exe.replay(*state, self._last_dev, self._poss_dev,
                              self._nonfinite)[2]
            dispatched = (_Readback(toks), active)
            self.stats.steps += 1
        self._resolve_inflight()
        self._inflight = dispatched
        self._admit()
        self._early_admit()
        return len(active)

    def _tail_covered(self, active) -> bool:
        """True when every active slot holds a request that was already in
        the inflight chunk and is length-bound to complete there: another
        chunk over these slots yields no useful token. Early-admitted
        replacements are not in the inflight snapshot, so their presence
        forces a dispatch."""
        if os.environ.get("PYGPUKIT_SERVE_TAILSKIP", "1") == "0":
            return False
        if self._inflight is None:
            return False
        n = max(self.steps_per_dispatch, 1)
        inflight_ids = {id(r) for _, r in self._inflight[1]}
        return all(id(req) in inflight_ids
                   and len(req.generated) + n >= req.max_new_tokens
                   for _, req in active)

    def _early_admit(self) -> None:
        """Admission lookahead: a length-bound request certain to complete
        within the inflight chunk gets its replacement prefilled now (queued
        after that chunk), so the slot decodes useful tokens in the very
        next chunk. EOS-bound finishes keep the one-chunk lag."""
        if self._inflight is None or not self._queue:
            return
        n = max(self.steps_per_dispatch, 1)
        pairs = []
        for slot, req in self._inflight[1]:
            if not self._queue:
                break
            if (self._slots[slot] is req and not req.done
                    and len(req.generated) + n >= req.max_new_tokens):
                if self.paged and not self._can_admit_paged(self._queue[0], pairs):
                    break
                nxt = self._queue.pop(0)
                nxt.slot = slot
                self._slots[slot] = nxt
                pairs.append((slot, nxt))
        self._dispatch_prefills(pairs)

    def _resolve_inflight(self) -> None:
        # prefill first tokens were dispatched before the inflight chunk:
        # resolve them first so request.generated stays in stream order
        for req, rb, i in self._pending_first:
            tok = int(rb.numpy()[i])
            self._emit(req, tok)
            req.first_token_at = time.time()
            self._last_tokens[req.slot] = tok
            self._maybe_finish_req(req, req.slot, tok, pos=req.pos)
        self._pending_first = []
        if self._inflight is None:
            return
        rb, snapshot = self._inflight
        self._inflight = None
        toks = rb.numpy()
        for slot, req in snapshot:
            for j in range(toks.shape[1]):
                if req.done:
                    break
                tok = int(toks[slot, j])
                req.pos += 1
                if self._slots[slot] is req:   # slot may be early-readmitted
                    self._poss[slot] = req.pos
                self._emit(req, tok)
                self._last_tokens[slot] = tok
                self._maybe_finish_req(req, slot, tok, pos=req.pos)

    def run_until_complete(self, max_steps: int = 10000) -> None:
        for _ in range(max_steps):
            if not self.has_work:
                return
            self.step()

    @property
    def has_work(self) -> bool:
        return (bool(self._queue) or any(r is not None for r in self._slots)
                or (self.pipelined and (self._inflight is not None
                                        or bool(self._pending_first))))

    @torch.no_grad()
    def warmup(self, prompt_lens=(16,), wave_sizes=None) -> None:
        """Build the kernels and capture every executable the given prompt
        lengths can reach, so no capture lands mid-workload: each prefill
        bucket and, in pipelined mode, each power-of-two wave size (the only
        sizes _dispatch_prefills forms), and the decode chunk. Runs on an
        idle engine. A capture's warm-up runs on clones of the pools,
        ``last``/``poss`` and the flag and puts the generator back, so
        warmup changes no stream.

        Unlike the reference, this works on a paged engine that is not
        pipelined, and a paged pipelined engine warms the prefills it runs
        (the reference's serving.py:1154 raises and :1158 installs the
        non-pipelined chunk)."""
        if self.has_work:
            raise RuntimeError("warmup() runs on an idle engine")
        if self.model.device.type == "cuda":
            from ..kernels import build
            build()
        ws = (wave_sizes if wave_sizes is not None else
              [w for w in (2, 4, 8, 16, 32, 64, 128) if w <= self.max_batch])
        ws = [1] + (ws if self.pipelined else [])
        buckets = sorted({min(_bucket(max(int(n), 8)), self.max_seq_len)
                          for n in prompt_lens})
        for b in buckets:
            for w in ws:
                self._prefill_exe(w, b)
        self._chunk_exe()
