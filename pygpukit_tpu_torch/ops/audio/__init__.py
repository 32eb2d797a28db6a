"""The audio DSP library (counterpart of ``pygpukit_tpu/ops/audio``): the
reference's exports and its reference-name aliases."""

import torch as _torch

from .analysis import (chroma, cqt, hpss, normalize, pitch_shift, time_stretch, vad_energy,
                       vad_hangover, vad_zcr, yin_pitch)
from .core import (AudioBuffer, RingBuffer, amplitude_to_db, db_to_amplitude, frame_signal,
                   griffin_lim, hann_window, istft, log_melspectrogram, mel_filterbank,
                   melspectrogram, mfcc, preemphasis, resample, stft)
from .core import as_tensor as _as_tensor
from .features import (autocorrelation, chroma_cqt, chroma_stft, compute_short_term_energy,
                       deemphasis, delta, highpass_filter, noise_gate, remove_dc,
                       spectral_bandwidth, spectral_centroid, spectral_contrast,
                       spectral_flatness, spectral_gate, spectral_rolloff, zero_crossing_rate)
from .streaming import VAD, AudioStream, SpeechSegment

# Reference-name aliases (the reference's ops/audio/__init__.py:22-80)
AudioRingBuffer = RingBuffer
from_pcm = AudioBuffer.from_pcm
mel_spectrogram = melspectrogram
log_mel_spectrogram = log_melspectrogram
create_mel_filterbank = mel_filterbank
detect_pitch_yin = yin_pitch
detect_pitch_yin_frames = yin_pitch
cqt_magnitude = cqt


def magnitude_spectrum(stft_output):
    return _torch.abs(_as_tensor(stft_output))


def power_spectrum(stft_output):
    return _torch.abs(_as_tensor(stft_output)) ** 2


def apply_mel_filterbank(spectrogram, mel_fb):
    spectrogram = _as_tensor(spectrogram)
    return spectrogram @ _as_tensor(mel_fb, spectrogram.device).T


def log_mel(mel_spec, eps: float = 1e-10):
    return _torch.log(_torch.clamp_min(_as_tensor(mel_spec), eps))


def to_decibels(x, eps: float = 1e-10):
    return 20.0 * _torch.log10(_torch.clamp_min(_torch.abs(_as_tensor(x)), eps))


def harmonic(x, **kw):
    return hpss(x, **kw)[0]


def percussive(x, **kw):
    return hpss(x, **kw)[1]


__all__ = [
    "AudioBuffer", "AudioRingBuffer", "AudioStream", "RingBuffer",
    "SpeechSegment", "VAD",
    "amplitude_to_db", "apply_mel_filterbank", "autocorrelation",
    "chroma", "chroma_cqt", "chroma_stft", "compute_short_term_energy",
    "cqt", "cqt_magnitude", "create_mel_filterbank", "db_to_amplitude",
    "deemphasis", "delta", "detect_pitch_yin", "detect_pitch_yin_frames",
    "frame_signal", "from_pcm", "griffin_lim", "hann_window", "harmonic",
    "highpass_filter", "hpss", "istft", "log_mel", "log_mel_spectrogram",
    "log_melspectrogram", "magnitude_spectrum", "mel_filterbank",
    "mel_spectrogram", "melspectrogram", "mfcc", "noise_gate", "normalize",
    "percussive", "pitch_shift", "power_spectrum", "preemphasis",
    "remove_dc", "resample", "spectral_bandwidth", "spectral_centroid",
    "spectral_contrast", "spectral_flatness", "spectral_gate",
    "spectral_rolloff", "stft", "time_stretch", "to_decibels",
    "vad_energy", "vad_hangover", "vad_zcr", "yin_pitch",
    "zero_crossing_rate",
]
