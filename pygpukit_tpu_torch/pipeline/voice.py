"""Realtime voice pipeline: audio chunks → VAD → ASR → LLM → TTS
(counterpart of ``pygpukit_tpu/pipeline/voice.py``; the reference's source:
src/pygpukit/pipeline/voice.py:50-77 — VADState machine with hangover,
Whisper transcription, LLM response, Kokoro synthesis).

The pipeline is transport-agnostic: it consumes an iterator of PCM chunks
(mic, file, socket) and yields events; no audio-device dependency. The VAD
runs ``ops.audio.vad_energy`` and ``vad_hangover`` on ``device`` (the
card unless named; the voice pipeline's is its ASR model's), the state
machine on the host.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..core.backend import resolve_device
from ..ops.audio import vad_energy, vad_hangover


class VADState(enum.Enum):
    SILENCE = "silence"
    SPEECH = "speech"
    TRAILING = "trailing"       # hangover after speech


@dataclass
class VADConfig:
    frame_length: int = 400
    hop_length: int = 160
    threshold_db: float = -40.0
    hang_frames: int = 15
    min_speech_frames: int = 5


@dataclass
class VoiceEvent:
    kind: str                    # "speech_start" | "transcript" | "reply" | "audio"
    text: str = ""
    audio: np.ndarray | None = None


class VoiceActivityDetector:
    """Streaming VAD with hangover state machine."""

    def __init__(self, config: VADConfig | None = None, sample_rate: int = 16000,
                 device=None):
        self.config = config or VADConfig()
        self.sample_rate = sample_rate
        self.device = resolve_device(device)
        self.state = VADState.SILENCE
        self._speech_buf: list[np.ndarray] = []
        self._speech_frames = 0

    def process(self, chunk: np.ndarray) -> np.ndarray | None:
        """Feed one PCM chunk; returns a full utterance when speech ends."""
        cfg = self.config
        x = torch.as_tensor(np.asarray(chunk, np.float32), device=self.device)
        act = vad_hangover(vad_energy(x, cfg.frame_length, cfg.hop_length,
                                      cfg.threshold_db), cfg.hang_frames)
        frames_active = int(act.sum())

        if frames_active >= cfg.min_speech_frames:
            self.state = VADState.SPEECH
            self._speech_buf.append(chunk)
            self._speech_frames += frames_active
            return None
        if self.state == VADState.SPEECH:
            # trailing chunk ends the utterance
            self._speech_buf.append(chunk)
            utterance = np.concatenate(self._speech_buf)
            self._speech_buf = []
            self._speech_frames = 0
            self.state = VADState.SILENCE
            return utterance
        return None

    def flush(self) -> np.ndarray | None:
        if self._speech_buf:
            out = np.concatenate(self._speech_buf)
            self._speech_buf = []
            self.state = VADState.SILENCE
            return out
        return None


class VoicePipeline:
    """mic → VAD → Whisper → LLM → Kokoro loop (reference: voice.py). The
    VAD runs on the ASR model's device."""

    def __init__(self, asr_model, llm_model, llm_tokenizer, tts_model,
                 sot_sequence: list[int], vad_config: VADConfig | None = None,
                 max_reply_tokens: int = 128):
        self.asr = asr_model
        self.llm = llm_model
        self.llm_tokenizer = llm_tokenizer
        self.tts = tts_model
        self.sot_sequence = sot_sequence
        self.vad = VoiceActivityDetector(vad_config, device=asr_model.device)
        self.max_reply_tokens = max_reply_tokens

    def run(self, audio_chunks) -> Iterator[VoiceEvent]:
        for chunk in audio_chunks:
            utterance = self.vad.process(np.asarray(chunk))
            if utterance is None:
                continue
            yield from self._handle_utterance(utterance)
        tail = self.vad.flush()
        if tail is not None and len(tail) > self.vad.config.frame_length:
            yield from self._handle_utterance(tail)

    def _handle_utterance(self, utterance: np.ndarray) -> Iterator[VoiceEvent]:
        yield VoiceEvent("speech_start")
        toks = self.asr.transcribe_tokens(utterance, self.sot_sequence)
        text = (self.llm_tokenizer.decode(toks)
                if hasattr(self.llm_tokenizer, "decode") else str(toks))
        yield VoiceEvent("transcript", text=text)
        prompt = (self.llm_tokenizer.encode(text)
                  if hasattr(self.llm_tokenizer, "encode") else toks)
        reply_ids = self.llm.generate(prompt, self.max_reply_tokens,
                                      temperature=0.7, top_k=50)
        reply = (self.llm_tokenizer.decode(reply_ids)
                 if hasattr(self.llm_tokenizer, "decode") else str(reply_ids))
        yield VoiceEvent("reply", text=reply)
        result = self.tts.synthesize(reply)
        yield VoiceEvent("audio", audio=result.audio)
