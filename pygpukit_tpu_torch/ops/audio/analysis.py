"""Audio analysis: VAD, YIN pitch, CQT, chroma, HPSS, effects (counterpart
of ``pygpukit_tpu/ops/audio/analysis.py``).

- ``vad_hangover`` is the reference's counter scan in closed form: frame t
  is active when an active frame s <= t has t - s < hang_frames.
- ``yin_pitch`` computes every frame's [half, half] difference function at
  once (the lag-shifted windows as an ``unfold`` view).
- ``time_stretch`` takes its fractional frame positions from the
  reference's own host call (``numpy.arange(0, frames, rate)`` in f32,
  what ``jnp.arange`` with a float step does), and accumulates the phase
  by an exclusive cumulative sum (the reference's scan).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .core import as_tensor, device_constant, frame_signal, istft, resample, stft
from .features import _crossing_rate

_F32 = torch.float32


# ---------------------------------------------------------------------- VAD --

def vad_energy(x, frame_length: int = 400, hop_length: int = 160,
               threshold_db: float = -40.0) -> torch.Tensor:
    """Energy VAD: per-frame RMS against a dB threshold -> bool [frames]."""
    frames = frame_signal(as_tensor(x).to(_F32), frame_length, hop_length)
    rms = torch.sqrt(torch.mean(frames * frames, dim=-1) + 1e-12)
    return 20.0 * torch.log10(torch.clamp_min(rms, 1e-10)) > threshold_db


def vad_zcr(x, frame_length: int = 400, hop_length: int = 160,
            max_rate: float = 0.3) -> torch.Tensor:
    """Zero-crossing-rate gate (speech crosses moderately, noise often)."""
    frames = frame_signal(as_tensor(x).to(_F32), frame_length, hop_length)
    return _crossing_rate(frames) < max_rate


def vad_hangover(active, hang_frames: int = 8) -> torch.Tensor:
    """Speech regions extended by ``hang_frames`` frames: the reference's
    counter (reset to hang_frames on an active frame, else counting down;
    active while above 0) in closed form."""
    active = as_tensor(active).to(torch.bool)
    t = torch.arange(active.shape[0], device=active.device)
    last = torch.cummax(torch.where(active, t, -1), dim=0).values
    return (last >= 0) & (t - last < hang_frames)


# ---------------------------------------------------------------- YIN pitch --

def yin_pitch(x, sr: int, frame_length: int = 2048, hop_length: int = 512,
              fmin: float = 65.0, fmax: float = 1000.0,
              threshold: float = 0.1) -> torch.Tensor:
    """YIN fundamental-frequency estimation -> f0 [frames] (0 unvoiced)."""
    half = frame_length // 2
    tau_max = min(int(sr / fmin), half - 1)
    tau_min = max(int(sr / fmax), 2)
    frames = frame_signal(as_tensor(x).to(_F32), frame_length, hop_length)   # [F, W]
    dev = frames.device
    # exact difference function d(tau) = sum_{j<half} (x[j] - x[j+tau])^2
    x0 = frames[:, :half]
    shifted = frames.unfold(-1, half, 1)[:, :half]               # [F, tau, j]
    e0 = torch.sum(x0 * x0, dim=-1, keepdim=True)
    e_tau = torch.sum(shifted * shifted, dim=-1)
    cross = torch.matmul(shifted, x0[:, :, None])[..., 0]
    d = e0 + e_tau - 2.0 * cross                                 # [F, half]
    # cumulative mean normalised difference
    tau = torch.arange(1, half, dtype=_F32, device=dev)
    cmnd = d[:, 1:] * tau / torch.clamp_min(torch.cumsum(d[:, 1:], dim=-1), 1e-8)
    cmnd = torch.cat([torch.ones_like(cmnd[:, :1]), cmnd], dim=-1)
    taus = torch.arange(half, device=dev)
    valid = (taus >= tau_min) & (taus < tau_max)
    below = valid & (cmnd < threshold)
    first = torch.argmax(below.to(torch.uint8), dim=-1, keepdim=True)
    # YIN: descend from the first threshold crossing to its local dip (not
    # the global minimum: no octave errors) within a 25% window
    dip_window = (taus >= first) & (taus <= first + first // 4 + 2) & valid
    inf = torch.tensor(math.inf, device=dev)
    dip = torch.argmin(torch.where(dip_window, cmnd, inf), dim=-1)
    best = torch.where(below.any(dim=-1), dip,
                       torch.argmin(torch.where(valid, cmnd, inf), dim=-1))
    # parabolic interpolation around the minimum for a sub-sample tau
    b = torch.clamp(best, 1, half - 2)[:, None]
    d0, d1, d2 = (torch.gather(cmnd, 1, b + k)[:, 0] for k in (-1, 0, 1))
    denom = d0 + d2 - 2 * d1
    offset = torch.where(torch.abs(denom) > 1e-12, 0.5 * (d0 - d2) / denom, 0.0)
    tau_est = b[:, 0].to(_F32) + torch.clamp(offset, -1.0, 1.0)
    f0 = torch.full_like(tau_est, sr) / torch.clamp_min(tau_est, 1.0)
    voiced = torch.gather(cmnd, 1, best[:, None])[:, 0] < 0.5
    return torch.where(voiced & (best > 0), f0, 0.0)


# ---------------------------------------------------------------------- CQT --

@functools.lru_cache(maxsize=8)
def _cqt_kernel(sr: int, n_bins: int, bins_per_octave: int, fmin: float,
                n_fft: int) -> np.ndarray:
    """Spectral-domain CQT kernel [n_bins, n_fft//2+1] (host constant, the
    reference's bit for bit)."""
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    kern = np.zeros((n_bins, n_fft // 2 + 1), np.complex64)
    for k, f in enumerate(freqs):
        if f >= sr / 2:
            continue
        nk = int(min(np.ceil(q * sr / f), n_fft))
        t = np.arange(nk)
        win = np.hanning(nk)
        atom = win * np.exp(2j * np.pi * f * t / sr) / nk
        buf = np.zeros(n_fft, np.complex64)
        buf[:nk] = atom
        kern[k] = np.fft.rfft(buf.real) + 1j * np.fft.rfft(buf.imag)
    return kern


def cqt(x, sr: int, n_bins: int = 84, bins_per_octave: int = 12,
        fmin: float = 32.703, hop_length: int = 512) -> torch.Tensor:
    """Constant-Q transform magnitude [frames, n_bins]."""
    n_fft = 2048
    spec = stft(x, n_fft, hop_length)                       # [F, bins]
    kern = device_constant(_cqt_kernel, sr, n_bins, bins_per_octave, fmin, n_fft,
                           device=spec.device)
    return torch.abs(spec @ kern.T.conj())


def chroma(x, sr: int, hop_length: int = 512) -> torch.Tensor:
    """12-bin chromagram folded from the CQT."""
    c = cqt(x, sr, n_bins=84, bins_per_octave=12, hop_length=hop_length)
    return c.reshape(c.shape[0], 7, 12).sum(dim=1)


# --------------------------------------------------------------------- HPSS --

def _median_filter(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Median filter along one axis over stacked rolls (odd ``size``: the
    middle element, as ``jnp.median``)."""
    half = size // 2
    rolls = [torch.roll(x, s, dims=axis) for s in range(-half, half + 1)]
    return torch.median(torch.stack(rolls), dim=0).values


def hpss(x, n_fft: int = 2048, hop_length: int = 512, kernel: int = 17,
         power: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Harmonic/percussive separation by median masking -> (harm, perc)."""
    x = as_tensor(x)
    spec = stft(x, n_fft, hop_length)
    mag = torch.abs(spec) ** power
    harm = _median_filter(mag, kernel, axis=0)   # smooth over time
    perc = _median_filter(mag, kernel, axis=1)   # smooth over frequency
    total = torch.clamp_min(harm + perc, 1e-8)
    n = x.shape[0]
    xh = istft(spec * (harm / total), n_fft, hop_length, length=n)
    xp = istft(spec * (perc / total), n_fft, hop_length, length=n)
    return xh, xp


# ------------------------------------------------------------------ effects --

def time_stretch(x, rate: float, n_fft: int = 2048, hop_length: int = 512) -> torch.Tensor:
    """Phase-vocoder time stretch (rate > 1: faster, shorter)."""
    spec = stft(x, n_fft, hop_length)                      # [F, bins]
    f, dev = spec.shape[0], spec.device
    steps = torch.from_numpy(np.arange(0, f, rate, dtype=np.float32)).to(dev)
    idx0 = torch.clamp(torch.floor(steps).to(torch.int64), 0, f - 1)
    idx1 = torch.clamp(idx0 + 1, 0, f - 1)
    frac = (steps - idx0)[:, None]
    s0, s1 = spec[idx0], spec[idx1]
    mag = (1 - frac) * torch.abs(s0) + frac * torch.abs(s1)
    # phase accumulation: step t's phase before its advance is added
    adv = torch.angle(s1) - torch.angle(s0)
    phases = torch.cumsum(torch.cat([torch.angle(spec[:1]), adv[:-1]]), dim=0)
    return istft(mag * torch.exp(1j * phases), n_fft, hop_length)


def pitch_shift(x, sr: int, n_steps: float, n_fft: int = 2048,
                hop_length: int = 512) -> torch.Tensor:
    """Pitch shift: a time stretch, then a resample."""
    x = as_tensor(x)
    rate = 2.0 ** (-n_steps / 12.0)
    stretched = time_stretch(x, rate, n_fft, hop_length)
    shifted = resample(stretched, int(sr / rate), sr)
    n = x.shape[0]
    return shifted[:n] if shifted.shape[0] >= n else F.pad(shifted, (0, n - shifted.shape[0]))


def normalize(x, target_db: float = -3.0) -> torch.Tensor:
    x = as_tensor(x)
    peak = torch.amax(torch.abs(x))
    target = torch.full_like(peak, 10.0 ** (target_db / 20.0))
    return x * (target / torch.clamp_min(peak, 1e-8))
