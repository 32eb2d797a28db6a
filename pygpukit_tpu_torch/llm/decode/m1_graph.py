"""M1Graph: replayed decode (reference ``llm/decode/m1_graph.py``).

A graph of a step whose position is a host number replays one position
only. Here the whole step, attention over the fixed cache and the KV
write included, is one captured executable
(``CausalTransformerModel._ensure_decode_exe``): the position is a device
tensor the graph reads, so one capture replays at every position.
``init_graph`` makes the cache and captures; ``step_graph`` replays at the
model's position and advances it. Replays give the eager step's bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import DecodeStrategy


class DecodeM1Graph(DecodeStrategy):
    name = "m1_graph"

    def init_graph(self, max_seq_len: int) -> None:
        """A fresh cache of ``max_seq_len`` rows and the decode step
        captured at it."""
        model = self._require_model()
        model.init_fixed_cache(max_seq_len)
        model._ensure_decode_exe()

    @property
    def node_count(self) -> int:
        return self._require_model()._ensure_decode_exe().node_count

    def step_graph(self, token: int) -> torch.Tensor:
        """One replay at the model's position; f32 logits [V], overwritten
        by the next replay."""
        model = self._require_model()
        self.stats.steps += 1
        return model.decode_step(token)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: int | None = None) -> list[int]:
        model = self._require_model()
        if model.k_cache is None:
            self.init_graph(max(2 * (len(np.ravel(input_ids)) + max_new_tokens), 256))
        logits = model.prefill(input_ids)
        out: list[int] = []
        for _ in range(max_new_tokens):
            tok = int(torch.argmax(logits))
            out.append(tok)
            self.stats.tokens_generated += 1
            if eos_token_id is not None and tok == eos_token_id:
                break
            if model.pos >= model.max_seq_len:
                break
            logits = self.step_graph(tok)
        return out
