"""The speech pipelines (counterpart of ``pygpukit_tpu/pipeline``): LLM to
speech, and the voice loop (VAD, Whisper, the LLM, Kokoro)."""

from .llm_tts import LLMTTSConfig, LLMTTSPipeline, SentenceBuffer
from .voice import (
    VADConfig, VADState, VoiceActivityDetector, VoiceEvent, VoicePipeline,
)

__all__ = [
    "LLMTTSConfig", "LLMTTSPipeline", "SentenceBuffer",
    "VADConfig", "VADState", "VoiceActivityDetector", "VoiceEvent",
    "VoicePipeline",
]
