"""Kokoro TTS model (counterpart of ``pygpukit_tpu/tts/kokoro/model.py``:
the StyleTTS2-like stack over ``layers.py``: text → ALBERT/PLBERT + text
encoder → duration → alignment expansion → F0/N prediction →
style-conditioned decoder → iSTFT vocoder; voice embeddings select the
style).

``KokoroModel(config, ..., device=None)`` builds its layers on ``device``
(the card unless named) from a ``torch.Generator`` seeded with ``seed``
(the reference draws from ``jax.random``, so the two packages' random
models differ; ``carry_arrays`` copies the reference's arrays into the
port's layers). ``synthesize`` runs the stack as one captured program per
(phonemes, frame budget), as the reference keeps one jit per key, under
``ops.precision.f32_matmul_context`` (TF32 off for cuBLAS and cuDNN).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...core.backend import resolve_device
from ...core.executable import ExecutableCache
from ...core.numerics import true_div
from ...ops.precision import f32_matmul_context
from .arch import alignment_index
from .layers import (
    AdaINResBlock, AlbertEncoder, Conv1d, DurationPredictor, F0NPredictor,
    ISTFTNet, Layer, Linear, StyleEncoder, TextEncoder,
)

SAMPLE_RATE = 24000


@dataclass
class KokoroConfig:
    vocab_size: int = 178            # phoneme vocab
    plbert_dim: int = 128
    plbert_heads: int = 2
    plbert_ffn: int = 256
    plbert_layers: int = 3
    hidden_dim: int = 128
    style_dim: int = 64
    decoder_dim: int = 256
    n_fft: int = 20
    hop: int = 5
    upsamples: tuple = (10, 6)
    up_kernels: tuple = (20, 12)
    sample_rate: int = SAMPLE_RATE


@dataclass
class SynthesisResult:
    """reference: SynthesisResult, model.py:44."""
    audio: np.ndarray
    sample_rate: int
    duration: float = 0.0
    phonemes: str = ""

    def to_wav(self, path: str) -> None:
        import wave
        pcm = np.clip(self.audio, -1, 1)
        pcm16 = (pcm * 32767).astype(np.int16)
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(self.sample_rate)
            w.writeframes(pcm16.tobytes())


class KokoroTokenizer:
    """Phoneme tokenizer; char-level over the checkpoint-true Kokoro vocab
    when no phonemizer dictionary is provided (reference: KokoroTokenizer).
    Lowercase letters are real Kokoro symbols (ids 43-68), so the char-level
    fallback stays checkpoint-consistent."""

    def __init__(self, vocab: dict[str, int] | None = None):
        from .g2p import KOKORO_VOCAB
        self.vocab = vocab or KOKORO_VOCAB

    def encode(self, text: str) -> list[int]:
        text = text.lower()
        return [self.vocab[c] for c in text if c in self.vocab]


def carry_arrays(dst, src) -> None:
    """Copy the arrays of ``src`` (the reference's layer object or model, or
    any object with the same attribute names; its leaves as
    numpy-convertible arrays) into ``dst``'s tensors in place: ``dst``'s
    tensors, layers and lists of layers are walked by attribute name (a
    ``KokoroModel`` whole, or one layer). ValueError on a shape that
    differs."""
    for name, mine in vars(dst).items():
        if isinstance(mine, torch.Tensor):
            arr = torch.from_numpy(np.array(getattr(src, name), np.float32))
            if tuple(arr.shape) != tuple(mine.shape):
                raise ValueError(f"{type(dst).__name__}.{name}: shape {tuple(arr.shape)} "
                                 f"against the port's {tuple(mine.shape)}")
            mine.copy_(arr)
        elif isinstance(mine, Layer):
            carry_arrays(mine, getattr(src, name))
        elif isinstance(mine, list) and mine and isinstance(mine[0], Layer):
            for a, b in zip(mine, getattr(src, name), strict=True):
                carry_arrays(a, b)


class KokoroModel:
    """reference: KokoroModel, model.py:78."""

    MAX_FRAMES_PER_PHONEME = 20

    def __init__(self, config: KokoroConfig | None = None,
                 tokenizer: KokoroTokenizer | None = None,
                 voice_embeddings: dict[str, np.ndarray] | None = None,
                 seed: int = 0, device=None):
        cfg = self.config = config or KokoroConfig()
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or KokoroTokenizer()
        self.voice_embeddings = {
            k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
            for k, v in (voice_embeddings or {}).items()}
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.plbert = AlbertEncoder(
            gen, cfg.vocab_size, cfg.plbert_dim, cfg.plbert_heads,
            cfg.plbert_ffn, cfg.plbert_layers)
        self.text_encoder = TextEncoder(gen, cfg.vocab_size, cfg.hidden_dim)
        self.bert_proj = Linear(gen, cfg.plbert_dim, cfg.hidden_dim)
        self.style_encoder = StyleEncoder(gen, 80, cfg.style_dim)
        self.duration = DurationPredictor(gen, cfg.hidden_dim, cfg.style_dim)
        self.f0n = F0NPredictor(gen, cfg.hidden_dim, cfg.style_dim)
        self.dec_in = Conv1d(gen, cfg.hidden_dim + 2, cfg.decoder_dim, 3, padding=1)
        self.dec_blocks = [AdaINResBlock(gen, cfg.decoder_dim, cfg.style_dim),
                           AdaINResBlock(gen, cfg.decoder_dim, cfg.style_dim)]
        self.vocoder = ISTFTNet(gen, cfg.decoder_dim, cfg.n_fft, cfg.hop,
                                cfg.upsamples, cfg.up_kernels)
        self._current_voice: str | None = None
        self.graphs = ExecutableCache(shared_pool=True)

    # -- voices ---------------------------------------------------------------

    def set_voice(self, name: str) -> None:
        if name not in self.voice_embeddings:
            raise KeyError(f"unknown voice {name!r}; have "
                           f"{list(self.voice_embeddings)}")
        self._current_voice = name

    def _style(self) -> torch.Tensor:
        if self._current_voice is not None:
            return self.voice_embeddings[self._current_voice][:self.config.style_dim]
        return torch.zeros((self.config.style_dim,), device=self.device)

    # -- synthesis ------------------------------------------------------------

    def _synth_core(self, ids, style, speed, total: int):
        """Traceable synthesis core (total = static frame budget).

        The dynamic duration sum becomes a static budget: the alignment is
        ``arch.alignment_index`` over ``total`` frames and the true frame
        count is returned so the caller trims the fixed-length audio.
        """
        # 1. text features: PLBERT semantic + CNN/LSTM acoustic, fused
        feats = self.bert_proj(self.plbert(ids)) + self.text_encoder(ids)  # [S, H]

        # 2. durations → frame alignment (monotonic hard expansion)
        dur = self.duration(feats, style)
        dur = dur / speed if torch.is_tensor(speed) else true_div(dur, speed)
        frames = torch.clamp(torch.round(dur), 1,
                             self.MAX_FRAMES_PER_PHONEME).to(torch.int32)
        true_total = torch.clamp(frames.sum(), max=total).to(torch.int32)
        x = feats[alignment_index(frames, total)].T[None]     # [1, H, total]

        # 3. prosody: F0 + noise over expanded features
        f0, noise = self.f0n(x, style[None])           # [total], [total]

        # 4. decoder: features + prosody, style-conditioned
        h = self.dec_in(torch.cat([x, f0[None, None, :], noise[None, None, :]], dim=1))
        for blk in self.dec_blocks:
            h = blk(h, style[None])

        # 5. iSTFT vocoder (fixed-length audio; trimmed by the caller)
        return self.vocoder(h), true_total

    def _synth(self, ids: torch.Tensor, style: torch.Tensor, speed: float):
        """(audio, true_total) by the captured program of (S, budget)."""
        total = ids.shape[0] * self.MAX_FRAMES_PER_PHONEME
        with f32_matmul_context([self.plbert.tok]):   # every weight is f32
            exe = self.graphs.get_or_capture(
                (ids.shape[0], total),
                lambda i, s, v: self._synth_core(i, s, v, total),
                ids, style, float(speed), name=f"kokoro_{ids.shape[0]}")
            return exe.replay(ids, style, float(speed))

    def synthesize(self, text: str, voice: str | None = None,
                   speed: float = 1.0) -> SynthesisResult:
        """Text → audio (reference: synthesize): one captured program per
        text length, the frame budget static, the audio trimmed to the
        true length."""
        if voice is not None:
            self.set_voice(voice)
        id_list = self.tokenizer.encode(text) or [1]
        ids = torch.tensor(id_list, dtype=torch.int32, device=self.device)
        audio_full, true_total = self._synth(ids, self._style(), speed)
        # samples per frame = hop * prod(upsamples)
        spf = self.config.hop
        for u in self.config.upsamples:
            spf *= u
        audio = audio_full[:int(true_total) * spf].cpu().numpy()
        return SynthesisResult(
            audio=audio, sample_rate=self.config.sample_rate,
            duration=len(audio) / self.config.sample_rate,
            phonemes=text)

    def synthesize_streaming(self, text: str, voice: str | None = None,
                             chunk_chars: int = 64):
        """Sentence/segment streaming synthesis (reference: streaming synth)."""
        segments = []
        cur = ""
        for ch in text:
            cur += ch
            if ch in ".!?" or len(cur) >= chunk_chars:
                segments.append(cur.strip())
                cur = ""
        if cur.strip():
            segments.append(cur.strip())
        for seg in segments:
            if seg:
                yield self.synthesize(seg, voice)
