"""Jacobi decoding: parallel iterative decode without a draft model
(reference ``llm/decode/jacobi.py``).

A window of W guessed tokens is iterated to a fixpoint: each pass feeds
[cur, g1..g_{W-1}] through one lookahead window (``decode_window``), takes
the argmax predictions, and accepts the longest prefix that has converged
(prediction == guess). Greedy-equivalent to M1: every accepted token is
the target argmax given its true prefix.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import DecodeStrategy


class DecodeJacobi(DecodeStrategy):
    name = "jacobi"

    def __init__(self, window: int = 6):
        super().__init__()
        self.window = window

    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: int | None = None) -> list[int]:
        model = self._require_model()
        ids = np.asarray(input_ids, np.int64).reshape(-1)
        if model.k_cache is None:
            model.init_fixed_cache(
                max(2 * (len(ids) + max_new_tokens + self.window + 2), 256))

        logits = model.prefill(ids)
        cur = int(torch.argmax(logits))
        out: list[int] = [cur]
        self.stats.tokens_generated += 1
        self.stats.steps += 1

        # guess init: repeat cur (the reference's Jacobi init)
        guesses = [cur] * (self.window - 1)

        while len(out) < max_new_tokens:
            if eos_token_id is not None and cur == eos_token_id:
                break
            w = min(self.window, model.max_seq_len - model.pos,
                    max_new_tokens - len(out) + 1)
            if w < 2:
                if model.pos >= model.max_seq_len:
                    break
                logits = model.decode_step(cur)
                cur = int(torch.argmax(logits))
                out.append(cur)
                self.stats.tokens_generated += 1
                self.stats.steps += 1
                continue

            window = [cur] + guesses[:w - 1]
            start_pos = model.pos
            preds = torch.argmax(model.decode_window(window, advance=0), dim=-1).tolist()
            self.stats.steps += 1

            # a guess is correct iff it equals the prediction that follows
            # the (already correct) prefix before it
            accepted = 0
            for i in range(w - 1):
                if window[i + 1] == preds[i]:
                    accepted += 1
                else:
                    break
            self.stats.accepted += accepted
            self.stats.rejected += (w - 1) - accepted

            emitted = preds[:accepted + 1]                    # converged + next
            model.pos = start_pos + accepted + 1
            for tk in emitted:
                out.append(tk)
                self.stats.tokens_generated += 1
                if eos_token_id is not None and tk == eos_token_id:
                    return out[:max_new_tokens]
                if len(out) >= max_new_tokens:
                    return out[:max_new_tokens]
            cur = out[-1]
            # next guesses: the unconverged tail (the Jacobi iteration state)
            tail = preds[accepted + 1:]
            guesses = (tail + [cur] * self.window)[:self.window - 1]
        return out[:max_new_tokens]
