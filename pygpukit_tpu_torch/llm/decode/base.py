"""Decode strategy framework (reference ``pygpukit_tpu/llm/decode/base.py``).

A strategy binds to a ``CausalTransformerModel`` and drives token
generation. All strategies are greedy-equivalent: every strategy produces
the same greedy token sequence (the cross-strategy token-match guarantee,
SURVEY §4), which the tests hold against the reference's strategies.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass

from ..model import CausalTransformerModel


@dataclass
class DecodeStats:
    tokens_generated: int = 0
    steps: int = 0           # model invocations
    accepted: int = 0        # speculative/jacobi: tokens accepted per window
    rejected: int = 0

    @property
    def tokens_per_step(self) -> float:
        return self.tokens_generated / max(self.steps, 1)


class DecodeStrategy(abc.ABC):
    """Base strategy: bind, then generate."""

    name = "base"

    def __init__(self):
        self.model: CausalTransformerModel | None = None
        self.stats = DecodeStats()

    def bind(self, model: CausalTransformerModel) -> "DecodeStrategy":
        self.model = model
        return self

    @abc.abstractmethod
    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: int | None = None) -> list[int]:
        ...

    def _require_model(self) -> CausalTransformerModel:
        if self.model is None:
            raise RuntimeError(f"{self.name}: call bind(model) first")
        return self.model
