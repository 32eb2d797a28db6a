"""Spectral features and preprocessing filters (counterpart of
``pygpukit_tpu/ops/audio/features.py``).

- Per-frame reductions (centroid, bandwidth, rolloff, flatness, contrast)
  are plain reductions over the spectrogram [F, n_freq].
- The first-order IIR filters (deemphasis, the single-pole highpass) are
  the linear recurrence y[i] = a y[i-1] + b[i], run as the log-depth scan
  ``ops.scan.linear_scan`` (the reference's ``lax.associative_scan``).
- Frequency axis as the reference's: ``bin_hz = sample_rate / (2 (n_freq
  - 1))``.
"""

from __future__ import annotations

import torch

from ..scan import linear_scan
from .core import as_tensor, frame_signal

_F32 = torch.float32


def _first_order_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[i] = a[i] * y[i-1] + b[i] (y[-1] = 0)."""
    return linear_scan(a, b)[1]


def _freqs(n_freq: int, sample_rate: int, device) -> torch.Tensor:
    return torch.arange(n_freq, dtype=_F32, device=device) * (sample_rate / (2.0 * (n_freq - 1)))


def _safe_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where den > 1e-10, else 0."""
    return torch.where(den > 1e-10, num / torch.clamp_min(den, 1e-10), 0.0)


def _max_normalised(folded: torch.Tensor) -> torch.Tensor:
    """Each frame divided by its largest bin (frames of no energy kept)."""
    mx = torch.amax(folded, dim=-1, keepdim=True)
    return torch.where(mx > 1e-10, folded / torch.clamp_min(mx, 1e-10), folded)


# ---------------------------------------------------------------- features --

def spectral_centroid(spectrum, sample_rate: int = 16000) -> torch.Tensor:
    """Per-frame spectral centre of mass in Hz. spectrum: [F, n_freq]."""
    spectrum = as_tensor(spectrum).to(_F32)
    freqs = _freqs(spectrum.shape[-1], sample_rate, spectrum.device)
    return _safe_ratio(torch.sum(freqs * spectrum, dim=-1), torch.sum(spectrum, dim=-1))


def spectral_bandwidth(spectrum, centroids, sample_rate: int = 16000,
                       p: int = 2) -> torch.Tensor:
    """Weighted p-norm deviation of frequency around the centroid, in Hz."""
    spectrum = as_tensor(spectrum).to(_F32)
    freqs = _freqs(spectrum.shape[-1], sample_rate, spectrum.device)
    diff = torch.abs(freqs[None, :] - as_tensor(centroids)[:, None]) ** p
    bw = _safe_ratio(torch.sum(diff * spectrum, dim=-1), torch.sum(spectrum, dim=-1))
    return bw ** (1.0 / p)


def spectral_rolloff(spectrum, sample_rate: int = 16000,
                     roll_percent: float = 0.85) -> torch.Tensor:
    """Frequency below which ``roll_percent`` of the spectral energy lies."""
    spectrum = as_tensor(spectrum).to(_F32)
    n_freq = spectrum.shape[-1]
    cum = torch.cumsum(spectrum, dim=-1)
    hit = cum >= cum[:, -1:] * roll_percent
    # the first bin at the threshold; the last bin when none is
    first = torch.argmax(hit.to(torch.uint8), dim=-1)
    bin_idx = torch.where(hit.any(dim=-1), first, n_freq - 1)
    return bin_idx.to(_F32) * (sample_rate / (2.0 * (n_freq - 1)))


def spectral_flatness(spectrum) -> torch.Tensor:
    """Geometric mean over arithmetic mean per frame (1 noise, 0 tonal)."""
    mag = as_tensor(spectrum).to(_F32) + 1e-10
    geo = torch.exp(torch.mean(torch.log(mag), dim=-1))
    return _safe_ratio(geo, torch.mean(mag, dim=-1))


def spectral_contrast(spectrum, n_bands: int = 6, alpha: float = 0.2) -> torch.Tensor:
    """Per band log(peak) - log(valley), peak and valley the means of the
    top and bottom ``alpha`` of the band's sorted magnitudes -> [F,
    n_bands]."""
    spectrum = as_tensor(spectrum).to(_F32)
    n_freq = spectrum.shape[-1]
    cols = []
    for band in range(n_bands):
        start = band * n_freq // n_bands
        end = (band + 1) * n_freq // n_bands
        vals = torch.sort(spectrum[:, start:end], dim=-1).values
        n_top = max(1, int((end - start) * alpha))
        valley = torch.mean(vals[:, :n_top], dim=-1)
        peak = torch.mean(vals[:, -n_top:], dim=-1)
        cols.append(torch.log(peak + 1e-10) - torch.log(valley + 1e-10))
    return torch.stack(cols, dim=-1)


def delta(features, order: int = 1, width: int = 2) -> torch.Tensor:
    """Regression delta features over [F, D]; ``order`` applies it
    repeatedly."""
    x = as_tensor(features).to(_F32)
    n_frames = x.shape[0]
    denom = 2.0 * sum(n * n for n in range(1, width + 1))
    frames = torch.arange(n_frames, device=x.device)
    for _ in range(order):
        out = torch.zeros_like(x)
        for n in range(1, width + 1):
            plus = x[torch.clamp_max(frames + n, n_frames - 1)]
            minus = x[torch.clamp_min(frames - n, 0)]
            out = out + n * (plus - minus)
        x = out / (denom + 1e-10)
    return x


def autocorrelation(x, max_lag: int) -> torch.Tensor:
    """acf[lag] = sum_i x[i] x[i + lag] for lag in [0, max_lag)."""
    x = as_tensor(x).to(_F32)
    n = x.shape[0]
    i = torch.arange(n, device=x.device)
    lags = torch.arange(max_lag, device=x.device)[:, None]
    shifted = x[(i[None, :] + lags) % n]                      # [max_lag, n]
    return torch.sum(torch.where(i[None, :] < n - lags, x[None, :] * shifted, 0.0), dim=-1)


def chroma_cqt(cqt_magnitude, bins_per_octave: int = 12) -> torch.Tensor:
    """CQT magnitudes [F, n_bins] folded into a 12-bin chromagram,
    per-frame max-normalised."""
    mag = as_tensor(cqt_magnitude).to(_F32)
    n_octaves = mag.shape[-1] // bins_per_octave
    step = bins_per_octave // 12
    idx = (torch.arange(n_octaves, device=mag.device)[:, None] * bins_per_octave
           + torch.arange(12, device=mag.device)[None, :] * step)    # [oct, 12]
    return _max_normalised(mag[:, idx].sum(dim=1))


# ----------------------------------------------------------- preprocessing --

def deemphasis(x, alpha: float = 0.97) -> torch.Tensor:
    """Inverse of preemphasis: y[i] = x[i] + alpha y[i-1]."""
    x = as_tensor(x).to(_F32)
    return _first_order_recurrence(torch.full_like(x, alpha), x)


def remove_dc(x) -> torch.Tensor:
    x = as_tensor(x)
    return x - torch.mean(x)


def highpass_filter(x, cutoff_hz: float = 20.0, sample_rate: int = 16000) -> torch.Tensor:
    """Single-pole IIR highpass: y[i] = a (y[i-1] + x[i] - x[i-1])."""
    x = as_tensor(x).to(_F32)
    rc = 1.0 / (2.0 * torch.pi * cutoff_hz)
    a = rc / (rc + 1.0 / sample_rate)
    xd = x - torch.cat([x.new_zeros(1), x[:-1]])
    return _first_order_recurrence(torch.full_like(x, a), a * xd)


def noise_gate(x, threshold: float = 0.01) -> torch.Tensor:
    """Hard gate: samples with |x| < threshold set to zero."""
    x = as_tensor(x)
    return torch.where(torch.abs(x) < threshold, 0.0, x)


def compute_short_term_energy(x, frame_size: int = 256) -> torch.Tensor:
    """Mean energy of non-overlapping frames -> [n_frames]."""
    x = as_tensor(x).to(_F32)
    n_frames = x.shape[0] // frame_size
    frames = x[:n_frames * frame_size].reshape(n_frames, frame_size)
    return torch.mean(frames * frames, dim=-1)


def spectral_gate(x, threshold: float = 0.01, attack_samples: int = 64,
                  release_samples: int = 256) -> torch.Tensor:
    """Soft gate: each frame's gain (energy / threshold)^2 below the
    threshold. ``release_samples`` is accepted for the API and unused, as
    in the reference."""
    x = as_tensor(x).to(_F32)
    n = x.shape[0]
    frame_size = attack_samples
    num_frames = n // frame_size
    if num_frames <= 0:
        return noise_gate(x, threshold)
    energy = compute_short_term_energy(x, frame_size)
    frame_idx = torch.clamp_max(torch.arange(n, device=x.device) // frame_size,
                                num_frames - 1)
    e = energy[frame_idx]
    ratio = e / threshold
    return x * torch.where(e < threshold, ratio * ratio, 1.0)


def _crossing_rate(frames: torch.Tensor) -> torch.Tensor:
    """Per frame, the fraction of adjacent sample pairs whose signs differ."""
    signs = torch.sign(frames)
    return torch.mean((torch.abs(torch.diff(signs, dim=-1)) > 0).to(_F32), dim=-1)


def zero_crossing_rate(x, frame_size: int = 512, hop_size: int = 256) -> torch.Tensor:
    """Per-frame zero-crossing fraction."""
    return _crossing_rate(frame_signal(as_tensor(x).to(_F32), frame_size, hop_size,
                                       center=False))


def chroma_stft(spectrum, sample_rate: int = 16000, n_chroma: int = 12,
                tuning: float = 0.0) -> torch.Tensor:
    """Chromagram of an STFT magnitude spectrum [F, n_freq]: each bin's
    energy folded into its pitch class (bins at 20 Hz or below dropped),
    per-frame max-normalised."""
    spectrum = as_tensor(spectrum).to(_F32)
    freqs = _freqs(spectrum.shape[-1], sample_rate, spectrum.device)
    midi = 12.0 * torch.log2(torch.clamp_min(freqs, 1e-6) / 440.0) + 69.0 - tuning
    pc = torch.remainder(torch.round(midi), n_chroma).to(torch.int64)
    onehot = (torch.nn.functional.one_hot(pc, n_chroma).to(_F32)
              * (freqs > 20.0).to(_F32)[:, None])                   # [n_freq, C]
    return _max_normalised(spectrum @ onehot)
