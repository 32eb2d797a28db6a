"""M1: eager single-token decode (reference ``llm/decode/m1.py``), one
``decode_step`` per token at the model's host position."""

from __future__ import annotations

import numpy as np
import torch

from ..model import _bucket
from .base import DecodeStrategy


class DecodeM1(DecodeStrategy):
    name = "m1"

    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: int | None = None) -> list[int]:
        model = self._require_model()
        if model.k_cache is None:
            n = len(np.ravel(input_ids))
            model.init_fixed_cache(_bucket(max(n + max_new_tokens + 1, 256)))
        logits = model.prefill(input_ids)
        out: list[int] = []
        for _ in range(max_new_tokens):
            tok = int(torch.argmax(logits))
            out.append(tok)
            self.stats.tokens_generated += 1
            self.stats.steps += 1
            if eos_token_id is not None and tok == eos_token_id:
                break
            if model.pos >= model.max_seq_len:
                break
            logits = model.decode_step(tok)
        return out
