"""Speculative decode: a draft proposes, the full model verifies
(reference ``llm/decode/speculative.py``).

Two draft sources:

* self-speculative (default): the first ``n_draft_layers`` of the target
  (``slice_layers``: no separate draft weights), run by
  ``CausalTransformerModel.decode_spec_chunk`` (``speculative_scan_fn``):
  the rounds run with the position on the device and the host reads the
  tokens, counts and position once a chunk;
* a separate draft model (``draft_model=``): any
  ``CausalTransformerModel`` with the same vocabulary, run by the host
  loop below with its own cache. Its prefill (``draft_prefill_{bucket}``)
  and its gamma greedy steps (``draft_scan_{gamma}``) are captured
  executables in the strategy's pool, keyed as the reference's; the
  target's verify window is the model's ``decode_window`` executable. The
  host reads the proposals after each replay. (The reference's
  ``_draft_step`` is never called by its ``generate``, so the port has
  none.)

Each round the draft greedily proposes ``gamma`` tokens, the target runs
one lookahead window over [cur, d1..dγ], and the longest prefix on which
the target's argmax agrees is accepted, plus the correction (or, on full
acceptance, the bonus) token. Rejected KV rows need no rollback: later
steps mask them and write over them. Greedy-equivalent to M1 by
construction.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.executable import ExecutableCache
from ...ops.embedding import kv_cache_zeros, kv_leaf
from ..model import (CausalTransformerModel, _bucket, _merged, generate_scan_fn,
                     prefill_fn, slice_layers)
from .base import DecodeStrategy


def _draft_scan_fn(cfg, gamma: int, params, k_cache, v_cache, token, pos):
    """``gamma`` greedy draft steps (``generate_scan_fn``, unfused)."""
    return generate_scan_fn(cfg, gamma, 0.0, 0, params, k_cache, v_cache, token, pos,
                            allow_fused=False)


def _draft_prefill_fn(cfg, params, k_cache, v_cache, tokens, true_len):
    """The draft's prefill over its merged caches."""
    return prefill_fn(cfg, params, _merged(k_cache), _merged(v_cache), tokens, true_len)


class DecodeSpeculative(DecodeStrategy):
    name = "speculative"

    def __init__(self, n_draft_layers: int = 2, gamma: int = 4,
                 draft_model: CausalTransformerModel | None = None):
        super().__init__()
        self.n_draft_layers = n_draft_layers
        self.gamma = gamma
        self.draft_model = draft_model
        self._draft_params = None
        self._draft_cfg = None
        self._draft_layers = n_draft_layers
        self._draft_k = None
        self._draft_v = None
        self._draft_pos = 0
        self.graphs = ExecutableCache(shared_pool=True)

    def bind(self, model: CausalTransformerModel) -> "DecodeSpeculative":
        # the draft programs and caches belong to the model they were made
        # for: binding another model releases them
        if model is not self.model:
            self.graphs.reset()
            self._draft_k = self._draft_v = None
        super().bind(model)
        if self.draft_model is not None:
            if self.draft_model.config.vocab_size != model.config.vocab_size:
                raise ValueError(
                    "draft model vocabulary "
                    f"({self.draft_model.config.vocab_size}) must match the "
                    f"target's ({model.config.vocab_size})")
            self._draft_params = self.draft_model.params
            self._draft_cfg = self.draft_model.config
            self._draft_layers = self.draft_model.config.num_layers
        else:
            self._draft_params = slice_layers(model.params, self.n_draft_layers)
            self._draft_cfg = model.config
            self._draft_layers = self.n_draft_layers
        return self

    # -- the separate draft model ------------------------------------------

    def _init_draft_cache(self) -> None:
        """Zeroed draft caches in the model's dtype; caches of the same
        shape, dtype and device are zeroed in place, so the captured draft
        programs stay bound."""
        model = self.model
        cfg = self._draft_cfg
        shape = (self._draft_layers, model.max_seq_len, cfg.num_kv_heads, cfg.head_dim)
        dev = self.draft_model.device
        leaf = None if self._draft_k is None else kv_leaf(self._draft_k)
        if (leaf is not None and tuple(leaf.shape) == shape and leaf.dtype == model.dtype
                and leaf.device == dev):
            self._draft_k.zero_()
            self._draft_v.zero_()
        else:
            self.graphs.reset()
            self._draft_k = kv_cache_zeros(shape, model.dtype, device=dev, merged=False)
            self._draft_v = kv_cache_zeros(shape, model.dtype, device=dev, merged=False)
        self._draft_pos = 0

    def _draft_propose(self, token: int, gamma: int) -> list[int]:
        """``gamma`` greedy draft steps from ``token`` at the draft position,
        one replay of ``draft_scan_{gamma}``, read back once."""
        exe = self.graphs.get_or_capture(
            ("scan", gamma), functools.partial(_draft_scan_fn, self._draft_cfg, gamma),
            self._draft_params, self._draft_k, self._draft_v, 0, 0,
            donate_argnums=(1, 2), bound_argnums=(0,), name=f"draft_scan_{gamma}")
        toks = exe.replay(self._draft_params, self._draft_k, self._draft_v, int(token),
                          self._draft_pos)
        self._draft_pos += gamma
        return toks.tolist()

    def _draft_prefill(self, ids: np.ndarray) -> None:
        model = self.model
        n = len(ids)
        bucket = min(_bucket(n), model.max_seq_len)
        dev = self.draft_model.device
        exe = self.graphs.get_or_capture(
            ("prefill", bucket), functools.partial(_draft_prefill_fn, self._draft_cfg),
            self._draft_params, self._draft_k, self._draft_v,
            torch.zeros(bucket, dtype=torch.long, device=dev), 1,
            donate_argnums=(1, 2), bound_argnums=(0,), name=f"draft_prefill_{bucket}")
        padded = np.zeros((bucket,), np.int64)
        padded[:n] = ids
        exe.replay(self._draft_params, self._draft_k, self._draft_v,
                   torch.as_tensor(padded).to(dev), n)
        self._draft_pos = n

    # -- generation ----------------------------------------------------------

    def _generate_device_loop(self, ids: np.ndarray, max_new_tokens: int,
                              eos_token_id: int | None) -> list[int]:
        """Self-speculative generation: ``rounds_per_chunk`` rounds a
        ``decode_spec_chunk``, one host read each."""
        model = self.model
        gamma = self.gamma
        logits = model.prefill(ids)
        cur = int(torch.argmax(logits))
        out: list[int] = [cur]
        self.stats.tokens_generated += 1
        self.stats.steps += 1
        rounds_per_chunk = max(1, 32 // (gamma + 1))
        while len(out) < max_new_tokens:
            if eos_token_id is not None and cur == eos_token_id:
                break
            rounds = min(rounds_per_chunk, (model.max_seq_len - model.pos) // (gamma + 1))
            if rounds < 1:
                if model.pos >= model.max_seq_len:
                    break
                logits = model.decode_step(cur)
                cur = int(torch.argmax(logits))
                out.append(cur)
                self.stats.tokens_generated += 1
                self.stats.steps += 1
                continue
            toks, counts = model.decode_spec_chunk(cur, rounds, gamma, self.n_draft_layers)
            for r in range(rounds):
                c = int(counts[r])
                self.stats.steps += 1
                self.stats.accepted += c - 1
                self.stats.rejected += gamma - (c - 1)
                for t in toks[r, :c]:
                    out.append(int(t))
                    self.stats.tokens_generated += 1
                    if ((eos_token_id is not None and int(t) == eos_token_id)
                            or len(out) >= max_new_tokens):
                        return out[:max_new_tokens]
            cur = out[-1]
        return out[:max_new_tokens]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: int | None = None) -> list[int]:
        model = self._require_model()
        ids = np.asarray(input_ids, np.int64).reshape(-1)
        if model.k_cache is None:
            model.init_fixed_cache(
                max(2 * (len(ids) + max_new_tokens + self.gamma + 2), 256))
        if self.draft_model is None:
            return self._generate_device_loop(ids, max_new_tokens, eos_token_id)
        self._init_draft_cache()

        logits = model.prefill(ids)
        self._draft_prefill(ids)
        cur = int(torch.argmax(logits))
        out: list[int] = [cur]
        self.stats.tokens_generated += 1
        self.stats.steps += 1

        while len(out) < max_new_tokens:
            if eos_token_id is not None and cur == eos_token_id:
                break
            gamma = min(self.gamma, model.max_seq_len - model.pos - 2,
                        max_new_tokens - len(out))
            if gamma < 1:
                # no room to speculate: a plain step
                if model.pos >= model.max_seq_len:
                    break
                logits = model.decode_step(cur)
                cur = int(torch.argmax(logits))
                out.append(cur)
                self.stats.tokens_generated += 1
                self.stats.steps += 1
                continue

            # 1. the draft proposes gamma tokens from cur, aligned with the target
            self._draft_pos = model.pos
            proposals = self._draft_propose(cur, gamma)

            # 2. the target verifies the window [cur, d1..dγ] in one pass
            window = [cur] + proposals
            start_pos = model.pos
            preds = torch.argmax(model.decode_window(window, advance=0), dim=-1).tolist()

            # 3. accept the longest agreeing prefix
            accepted = 0
            for i in range(gamma):
                if proposals[i] == preds[i]:
                    accepted += 1
                else:
                    break
            self.stats.accepted += accepted
            self.stats.rejected += gamma - accepted
            self.stats.steps += 1

            # the correction, or the bonus token on full acceptance
            emitted = proposals[:accepted] + [preds[accepted]]

            model.pos = start_pos + accepted + 1       # cur + accepted now cached
            for tk in emitted:
                out.append(tk)
                self.stats.tokens_generated += 1
                if eos_token_id is not None and tk == eos_token_id:
                    return out[:max_new_tokens]
                if len(out) >= max_new_tokens:
                    return out[:max_new_tokens]
            cur = out[-1]
        return out[:max_new_tokens]
