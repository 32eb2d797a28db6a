"""Audio DSP core: buffers, STFT/ISTFT, mel, MFCC, Griffin-Lim, resample
(counterpart of ``pygpukit_tpu/ops/audio/core.py``).

The reference computes its transforms with ``jnp.fft`` (XLA, no Pallas
kernel); here they are ``torch.fft``, and the frame, window and mel math
around them is plain PyTorch on the input's device. A tensor stays on its
device; numpy input goes to the card unless a function takes ``device=``
and the caller names the CPU.

- ``frame_signal`` pads the way ``numpy.pad(mode="reflect")`` does (any
  pad length) and frames by ``Tensor.unfold``, a strided view.
- ``istft``'s overlap-add is ``torch.nn.functional.fold`` (col2im: each
  output sample sums its frames in a fixed order, so the card repeats its
  bits; ``index_add_`` on CUDA adds by atomics in no fixed order).
- ``mel_filterbank`` and ``_cqt_kernel`` are host constants, the
  reference's numpy code bit for bit, cached; their device copies are
  cached per device.
- ``griffin_lim`` draws its initial phases from a ``torch.Generator``
  seeded by ``seed``, not from jax's PRNG: only its convergence compares
  with the reference, not its bits.
- ``resample`` computes the sample positions in f32, as the reference does
  with 64-bit types off, so its interpolation indices are the reference's.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...core.backend import resolve_device
from ...core.numerics import true_div

_F32 = torch.float32


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, anything else (numpy, lists,
    numbers) on ``device`` (the card unless named), f64 as f32 (the
    reference's jnp arrays with 64-bit types off)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=resolve_device(device))


@dataclass
class AudioBuffer:
    """Device audio buffer (reference: AudioBuffer)."""
    data: torch.Tensor      # [N] f32 mono
    sample_rate: int

    @classmethod
    def from_pcm(cls, pcm, sample_rate: int, device=None) -> "AudioBuffer":
        """int16 PCM scaled by 1/32768, stereo [N, C] averaged to mono;
        the samples on ``device`` (the card unless named)."""
        arr = np.asarray(pcm)
        if arr.dtype == np.int16:
            arr = arr.astype(np.float32) / 32768.0
        if arr.ndim == 2:  # downmix
            arr = arr.mean(axis=-1)
        return cls(torch.as_tensor(arr.astype(np.float32), device=resolve_device(device)),
                   sample_rate)

    def to_numpy(self) -> np.ndarray:
        return self.data.cpu().numpy()

    @property
    def duration(self) -> float:
        return self.data.shape[0] / self.sample_rate

    def __len__(self) -> int:
        return int(self.data.shape[0])


def hann_window(n: int, device=None) -> torch.Tensor:
    """The periodic Hann window of ``n`` samples, f32, on ``device`` (the
    card unless named)."""
    i = torch.arange(n, dtype=_F32, device=resolve_device(device))
    return 0.5 - 0.5 * torch.cos(true_div(i * (2 * math.pi), n))


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``numpy.pad(x, (pad, pad), mode="reflect")``: mirrored about the end
    samples (not repeating them), the mirror repeated for pads of the
    length or more."""
    n = x.shape[0]
    if pad == 0:
        return x
    if n == 1:
        return x.expand(2 * pad + 1)
    period = 2 * (n - 1)
    j = torch.arange(-pad, n + pad, device=x.device).abs() % period
    return x[torch.where(j >= n, period - j, j)]


def frame_signal(x: torch.Tensor, frame_length: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """[N] -> [frames, frame_length] strided frames (a view of the padded
    signal)."""
    if center:
        x = _reflect_pad(x, frame_length // 2)
    if x.shape[0] < frame_length:
        return x.new_empty((0, frame_length))
    return x.unfold(0, frame_length, hop_length)


def stft(x, n_fft: int = 400, hop_length: int = 160, window=None,
         center: bool = True) -> torch.Tensor:
    """[N] -> complex64 [frames, n_fft//2+1]."""
    x = as_tensor(x)
    w = window if window is not None else hann_window(n_fft, x.device)
    frames = frame_signal(x.to(_F32), n_fft, hop_length, center)
    return torch.fft.rfft(frames * w, n=n_fft, dim=-1)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """[F, W] frames summed at hop offsets into [W + hop (F - 1)] (col2im)."""
    num, width = frames.shape
    out_len = width + hop_length * (num - 1)
    return F.fold(frames.T[None], output_size=(1, out_len), kernel_size=(1, width),
                  stride=(1, hop_length)).reshape(out_len)


def istft(spec: torch.Tensor, n_fft: int = 400, hop_length: int = 160, window=None,
          length: int | None = None, center: bool = True) -> torch.Tensor:
    """Inverse STFT with overlap-add and window-square normalisation."""
    w = window if window is not None else hann_window(n_fft, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * w      # [F, n_fft]
    num = frames.shape[0]
    out_len = n_fft + hop_length * (num - 1)
    sig = _overlap_add(frames, hop_length)
    wsq = _overlap_add((w * w).expand(num, n_fft), hop_length)
    sig = sig / torch.clamp_min(wsq, 1e-8)
    if center:
        sig = sig[n_fft // 2:out_len - n_fft // 2]
    if length is not None:
        sig = sig[:length] if sig.shape[0] >= length else F.pad(sig, (0, length - sig.shape[0]))
    return sig


@functools.lru_cache(maxsize=32)
def mel_filterbank(sr: int, n_fft: int, n_mels: int = 80,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney-normalised triangular filterbank on the HTK mel scale [n_mels,
    n_fft//2+1] (host; cached constant). The reference's function, kept
    bit for bit; Whisper's features use the Slaney scale instead
    (``asr.whisper.model.whisper_mel_filters``)."""
    fmax = fmax or sr / 2
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_bins)

    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    mel_pts = np.linspace(hz2mel(fmin), hz2mel(fmax), n_mels + 2)
    hz_pts = 700.0 * (10.0 ** (mel_pts / 2595.0) - 1.0)
    fb = np.zeros((n_mels, n_bins), np.float32)
    for i in range(n_mels):
        lo, cen, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(cen - lo, 1e-8)
        down = (hi - fft_freqs) / max(hi - cen, 1e-8)
        fb[i] = np.maximum(0, np.minimum(up, down))
    # Slaney normalisation
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[:, None]
    return fb


@functools.lru_cache(maxsize=64)
def device_constant(make, *args, device: torch.device) -> torch.Tensor:
    """``torch.as_tensor(make(*args))`` on ``device``, cached (a host
    constant copied once per device)."""
    return torch.as_tensor(make(*args), device=device)


def melspectrogram(x, sr: int, n_fft: int = 400, hop_length: int = 160,
                   n_mels: int = 80, power: float = 2.0) -> torch.Tensor:
    """[frames, n_mels] power mel spectrogram."""
    spec = torch.abs(stft(x, n_fft, hop_length)) ** power     # [F, bins]
    fb = device_constant(mel_filterbank, sr, n_fft, n_mels, device=spec.device)
    return spec @ fb.T                                         # [F, n_mels]


def log_melspectrogram(x, sr: int, n_fft: int = 400, hop_length: int = 160,
                       n_mels: int = 80, eps: float = 1e-10) -> torch.Tensor:
    """Whisper-style log10 mel with dynamic-range clamping."""
    m = melspectrogram(x, sr, n_fft, hop_length, n_mels)
    logm = torch.log10(torch.clamp_min(m, eps))
    logm = torch.maximum(logm, logm.max() - 8.0)
    return (logm + 4.0) / 4.0


def mfcc(x, sr: int, n_mfcc: int = 13, n_fft: int = 400, hop_length: int = 160,
         n_mels: int = 40) -> torch.Tensor:
    """MFCC via DCT-II over log-mel [frames, n_mfcc]."""
    logm = torch.log(torch.clamp_min(melspectrogram(x, sr, n_fft, hop_length, n_mels), 1e-10))
    n, dev = n_mels, logm.device
    k = torch.arange(n_mfcc, dtype=_F32, device=dev)[:, None]
    i = torch.arange(n, dtype=_F32, device=dev)[None, :]
    scale = torch.sqrt(torch.tensor(2.0 / n, dtype=_F32, device=dev))
    dct = torch.cos(true_div((math.pi * k) * (2 * i + 1), 2 * n)) * scale
    return logm @ dct.T                                        # [F, n_mfcc]


def griffin_lim(mag: torch.Tensor, n_fft: int = 400, hop_length: int = 160,
                n_iter: int = 32, length: int | None = None, seed: int = 0) -> torch.Tensor:
    """Phase reconstruction from a magnitude spectrogram [F, bins]; the
    initial phases uniform in [0, 2 pi) from a generator seeded by
    ``seed`` on mag's device."""
    g = torch.Generator(device=mag.device)
    g.manual_seed(seed)
    angles = torch.rand(mag.shape, generator=g, dtype=_F32, device=mag.device) * (2 * math.pi)
    spec = mag * torch.exp(1j * angles)
    for _ in range(n_iter):
        x = istft(spec, n_fft, hop_length)
        re = stft(x, n_fft, hop_length)[:mag.shape[0]]
        spec = mag * (re / torch.clamp_min(torch.abs(re), 1e-8))
    return istft(spec, n_fft, hop_length, length=length)


def resample(x, orig_sr: int, target_sr: int) -> torch.Tensor:
    """Linear-interpolation resampling."""
    x = as_tensor(x)
    if orig_sr == target_sr:
        return x
    n = x.shape[0]
    out_n = int(round(n * target_sr / orig_sr))
    ratio = torch.tensor(orig_sr / target_sr, dtype=_F32, device=x.device)
    pos = torch.arange(out_n, dtype=_F32, device=x.device) * ratio
    i0 = torch.clamp(torch.floor(pos).to(torch.int32), 0, n - 1)
    i1 = torch.clamp(i0 + 1, 0, n - 1)
    frac = pos - i0
    return x[i0] * (1 - frac) + x[i1] * frac


def preemphasis(x, coeff: float = 0.97) -> torch.Tensor:
    x = as_tensor(x)
    return torch.cat([x[:1], x[1:] - coeff * x[:-1]])


def db_to_amplitude(db) -> torch.Tensor:
    return torch.pow(10.0, as_tensor(db) / 20.0)


def amplitude_to_db(amp, eps: float = 1e-10) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp_min(as_tensor(amp), eps))


class RingBuffer:
    """Streaming audio ring buffer on the host (reference: the native audio
    ring buffer: feeds realtime pipelines with fixed memory)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._buf = np.zeros(capacity, np.float32)
        self._write = 0
        self._count = 0

    def push(self, samples) -> None:
        s = np.asarray(samples, np.float32).ravel()
        if len(s) >= self.capacity:
            self._buf[:] = s[-self.capacity:]
            self._write = 0
            self._count = self.capacity
            return
        end = self._write + len(s)
        if end <= self.capacity:
            self._buf[self._write:end] = s
        else:
            split = self.capacity - self._write
            self._buf[self._write:] = s[:split]
            self._buf[:end - self.capacity] = s[split:]
        self._write = end % self.capacity
        self._count = min(self._count + len(s), self.capacity)

    def read_latest(self, n: int) -> np.ndarray:
        """Most recent n samples in chronological order."""
        n = min(n, self._count)
        start = (self._write - n) % self.capacity
        if start + n <= self.capacity:
            return self._buf[start:start + n].copy()
        split = self.capacity - start
        return np.concatenate([self._buf[start:], self._buf[:n - split]])

    def __len__(self) -> int:
        return self._count
