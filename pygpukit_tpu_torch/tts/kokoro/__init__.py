"""Kokoro speech synthesis (counterpart of ``pygpukit_tpu/tts/kokoro``):
Kokoro-82M from its checkpoint (``pretrained``, over ``arch`` and
``checkpoint``) and the simple StyleTTS2-like stack (``model``, over
``layers``)."""

from .g2p import Phonemizer
from .model import KokoroConfig, KokoroModel, KokoroTokenizer, SynthesisResult
from .pretrained import Kokoro82M

__all__ = ["KokoroConfig", "KokoroModel", "KokoroTokenizer", "Kokoro82M",
           "Phonemizer", "SynthesisResult"]
