"""Streaming LLM → TTS with sentence buffering (counterpart of
``pygpukit_tpu/pipeline/llm_tts.py``; the reference's source:
src/pygpukit/pipeline/llm_tts.py:25-145 — tokens stream out of the LLM, are
accumulated into sentence fragments, and each completed sentence is
synthesized while the LLM keeps decoding). Host logic, copied as it is;
the LLM is the port's ``CausalTransformerModel`` (``generate_stream``) and
the TTS model Kokoro's."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator

_SENTENCE_ENDS = ".!?…\n"


@dataclass
class LLMTTSConfig:
    max_new_tokens: int = 256
    temperature: float = 0.7
    top_k: int = 50
    min_sentence_chars: int = 8
    voice: str | None = None


class SentenceBuffer:
    """Accumulates streamed text; emits complete sentences."""

    def __init__(self, min_chars: int = 8):
        self.min_chars = min_chars
        self._buf = ""

    def push(self, text: str) -> list[str]:
        self._buf += text
        out = []
        while True:
            cut = -1
            for i, ch in enumerate(self._buf):
                if ch in _SENTENCE_ENDS and i + 1 >= self.min_chars:
                    cut = i
                    break
            if cut < 0:
                break
            out.append(self._buf[:cut + 1].strip())
            self._buf = self._buf[cut + 1:]
        return [s for s in out if s]

    def flush(self) -> str | None:
        s = self._buf.strip()
        self._buf = ""
        return s or None


class LLMTTSPipeline:
    """LLM token stream → sentence buffer → TTS synthesis stream."""

    def __init__(self, llm_model, tokenizer, tts_model,
                 config: LLMTTSConfig | None = None):
        self.llm = llm_model
        self.tokenizer = tokenizer
        self.tts = tts_model
        self.config = config or LLMTTSConfig()

    def run(self, prompt_ids: list[int],
            on_text: Callable[[str], None] | None = None) -> Iterator:
        """Yields SynthesisResult per completed sentence."""
        cfg = self.config
        buf = SentenceBuffer(cfg.min_sentence_chars)
        prev_len = 0
        acc_ids: list[int] = []
        for tok in self.llm.generate_stream(
                prompt_ids, cfg.max_new_tokens, cfg.temperature, cfg.top_k):
            acc_ids.append(int(tok))
            text = self.tokenizer.decode(acc_ids)
            delta, prev_len = text[prev_len:], len(text)
            if on_text and delta:
                on_text(delta)
            for sentence in buf.push(delta):
                yield self.tts.synthesize(sentence, voice=cfg.voice)
        tail = buf.flush()
        if tail:
            yield self.tts.synthesize(tail, voice=cfg.voice)
