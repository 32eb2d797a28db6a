"""Streaming audio objects: VAD, SpeechSegment, AudioStream (counterpart of
``pygpukit_tpu/ops/audio/streaming.py``). The frame features run on the
audio's device; the adaptive threshold, the hangover's input and the
segment loop are host work on the features, as in the reference."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .analysis import vad_hangover
from .core import RingBuffer, as_tensor, frame_signal
from .features import _crossing_rate

_F32 = torch.float32


@dataclass
class SpeechSegment:
    """A detected speech region."""
    start_sample: int
    end_sample: int
    start_time: float
    end_time: float


def _vad_features(x: torch.Tensor, frame_size: int, hop_size: int):
    """(mean energy, zero-crossing rate) per frame [frames] each."""
    frames = frame_signal(x.to(_F32), frame_size, hop_size, center=False)
    return torch.mean(frames * frames, dim=-1), _crossing_rate(frames)


class VAD:
    """Voice activity detection: per-frame energy and zero-crossing
    features, an adaptive noise-floor threshold, hangover smoothing and
    segment extraction (the reference's knobs and defaults)."""

    def __init__(self, sample_rate: int = 16000, frame_ms: float = 20.0,
                 hop_ms: float = 10.0, energy_threshold: float | None = None,
                 hangover_ms: float = 100.0, zcr_low: float = 0.02,
                 zcr_high: float = 0.25, min_energy_floor: float = 0.01):
        self.sample_rate = sample_rate
        self.frame_size = int(frame_ms * sample_rate / 1000)
        self.hop_size = int(hop_ms * sample_rate / 1000)
        self.energy_threshold = energy_threshold
        self.hangover_frames = int(hangover_ms / hop_ms)
        self.zcr_low = zcr_low
        self.zcr_high = zcr_high
        #: absolute floor under the adaptive threshold (mean square; lower
        #: it for quiet recordings: speech near -30 dBFS sits about 1e-3)
        self.min_energy_floor = min_energy_floor
        self.adaptive_multiplier = 3.0

    def detect(self, audio) -> list[SpeechSegment]:
        """Speech segments of ``audio`` (an AudioBuffer, a tensor on its
        device, or samples for the card)."""
        data = as_tensor(getattr(audio, "data", audio))
        energy, zcr = _vad_features(data, self.frame_size, self.hop_size)
        energy_np = energy.cpu().numpy()
        if self.energy_threshold is not None:
            thr = self.energy_threshold
        else:
            thr = max(float(energy_np.min()) * self.adaptive_multiplier,
                      self.min_energy_floor)
        zcr_np = zcr.cpu().numpy()
        active = (energy_np > thr) & (zcr_np >= self.zcr_low) & (zcr_np <= self.zcr_high)
        active |= energy_np > 4 * thr          # loud frames bypass the zcr gate
        if self.hangover_frames > 0:
            active = vad_hangover(torch.from_numpy(active).to(data.device),
                                  self.hangover_frames).cpu().numpy()
        segments: list[SpeechSegment] = []
        start = None
        for i, a in enumerate(active):
            if a and start is None:
                start = i
            elif not a and start is not None:
                segments.append(self._segment(start, i))
                start = None
        if start is not None:
            segments.append(self._segment(start, len(active)))
        return segments

    def _segment(self, f0: int, f1: int) -> SpeechSegment:
        s0 = f0 * self.hop_size
        s1 = f1 * self.hop_size + self.frame_size
        return SpeechSegment(s0, s1, s0 / self.sample_rate, s1 / self.sample_rate)


class AudioStream:
    """Chunked streaming processor over a host ring buffer: push PCM, pop
    overlapping chunks."""

    def __init__(self, chunk_size: int = 480, hop_size: int | None = None,
                 sample_rate: int = 16000, buffer_duration: float = 30.0):
        self.chunk_size = chunk_size
        self.hop_size = hop_size if hop_size is not None else chunk_size // 2
        self.sample_rate = sample_rate
        self._ring = RingBuffer(int(buffer_duration * sample_rate))
        self._pending = np.zeros(0, np.float32)

    def push(self, pcm) -> None:
        arr = np.asarray(pcm)
        if arr.dtype == np.int16:
            arr = arr.astype(np.float32) / 32768.0
        arr = arr.astype(np.float32).ravel()
        self._ring.push(arr)
        self._pending = np.concatenate([self._pending, arr])

    def has_chunk(self) -> bool:
        return len(self._pending) >= self.chunk_size

    def pop_chunk(self) -> np.ndarray | None:
        if not self.has_chunk():
            return None
        chunk = self._pending[:self.chunk_size].copy()
        self._pending = self._pending[self.hop_size:]
        return chunk

    def latest(self, seconds: float) -> np.ndarray:
        """The most recent window from the ring (ASR context reads)."""
        return self._ring.read_latest(int(seconds * self.sample_rate))
