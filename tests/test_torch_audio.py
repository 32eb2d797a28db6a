"""The port's audio library (``pygpukit_tpu_torch.ops.audio``) against the
JAX package's, function by function, on the same numpy inputs: the cases
of tests/test_audio.py (a 440 Hz sine) and a seeded signal (a chirp, a
tone and noise).

Integer and boolean outputs (frames, VAD decisions, segments) and the host
constants (``mel_filterbank``, ``_cqt_kernel``) are held bitwise; float
outputs within rtol 1e-4 and atol 1e-5, at f32, except where a case says
otherwise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygpukit_tpu.ops import audio as R
from pygpukit_tpu.ops.audio import analysis as R_analysis
from pygpukit_tpu_torch.ops import audio as P
from pygpukit_tpu_torch.ops.audio import analysis as P_analysis

SR = 16000
RTOL, ATOL = 1e-4, 1e-5


def _sine():
    t = np.arange(SR, dtype=np.float32) / SR
    return (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)


def _seeded():
    rng = np.random.default_rng(24)
    t = np.arange(SR, dtype=np.float64) / SR
    chirp = 0.3 * np.sin(2 * np.pi * (200.0 * t + 900.0 * t * t))
    tone = 0.2 * np.sin(2 * np.pi * 330.0 * t)
    return (chirp + tone + 0.02 * rng.standard_normal(SR)).astype(np.float32)


SIGNALS = {"sine": _sine(), "seeded": _seeded()}


def _jax(a):
    return jnp.asarray(a)


def _torch(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _mag(x, n_fft=512, hop=256):
    return np.abs(np.asarray(R.stft(_jax(x), n_fft, hop)))


def _close(ours, ref, rtol=RTOL, atol=ATOL):
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype, (ours.shape, ref.shape,
                                                                 ours.dtype, ref.dtype)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol)


def _spectrum_close(ours, ref):
    """An FFT's rounding error scales with the spectrum's peak, not with
    each bin: atol is ATOL times the reference's largest magnitude."""
    _close(ours, ref, atol=ATOL * float(np.abs(_np(ref)).max()))


# Float cases: each runs the same expression on the reference (A = R, c =
# jnp.asarray) and on the port (A = P, c = a CPU tensor).
FLOAT_CASES = {
    "hann_window": lambda A, c, x: (R.hann_window(400) if A is R
                                    else P.hann_window(400, device="cpu")),
    "istft": lambda A, c, x: A.istft(c(np.asarray(R.stft(_jax(x), 512, 128))), 512, 128,
                                     length=len(x)),
    "log_melspectrogram": lambda A, c, x: A.log_melspectrogram(c(x), SR),
    "log_melspectrogram_128": lambda A, c, x: A.log_melspectrogram(c(x), SR, 400, 160, 128),
    "resample_down": lambda A, c, x: A.resample(c(x), SR, 8000),
    "resample_up": lambda A, c, x: A.resample(c(x), SR, 44100),
    "resample_from_44k": lambda A, c, x: A.resample(c(x[:8000]), 44100, SR),
    "resample_same": lambda A, c, x: A.resample(c(x), SR, SR),
    "preemphasis": lambda A, c, x: A.preemphasis(c(x), 0.97),
    "db_to_amplitude": lambda A, c, x: A.db_to_amplitude(c(np.linspace(-80, 10, 64,
                                                                        dtype=np.float32))),
    "amplitude_to_db": lambda A, c, x: A.amplitude_to_db(c(np.abs(x))),
    "spectral_centroid": lambda A, c, x: A.spectral_centroid(c(_mag(x)), SR),
    "spectral_bandwidth": lambda A, c, x: A.spectral_bandwidth(
        c(_mag(x)), c(np.asarray(R.spectral_centroid(_jax(_mag(x)), SR))), SR),
    "spectral_bandwidth_p3": lambda A, c, x: A.spectral_bandwidth(
        c(_mag(x)), c(np.asarray(R.spectral_centroid(_jax(_mag(x)), SR))), SR, p=3),
    "spectral_rolloff": lambda A, c, x: A.spectral_rolloff(c(_mag(x)), SR, 0.85),
    "spectral_flatness": lambda A, c, x: A.spectral_flatness(c(_mag(x))),
    "spectral_contrast": lambda A, c, x: A.spectral_contrast(c(_mag(x)), n_bands=6),
    "delta": lambda A, c, x: A.delta(c(x[:400].reshape(20, 20)), order=1, width=2),
    "delta_order2": lambda A, c, x: A.delta(c(x[:400].reshape(40, 10)), order=2, width=3),
    "autocorrelation": lambda A, c, x: A.autocorrelation(c(x[:2000]), 500),
    "chroma_cqt": lambda A, c, x: A.chroma_cqt(c(np.asarray(R.cqt(_jax(x), SR)))),
    "deemphasis": lambda A, c, x: A.deemphasis(c(x[:4000]), 0.97),
    "remove_dc": lambda A, c, x: A.remove_dc(c(x + 1.5)),
    "highpass_filter": lambda A, c, x: A.highpass_filter(c(x[:8000] + 0.5), 20.0, SR),
    "highpass_filter_100hz": lambda A, c, x: A.highpass_filter(c(x[:8000]), 100.0, SR),
    "noise_gate": lambda A, c, x: A.noise_gate(c(x * 0.05), 0.01),
    "compute_short_term_energy": lambda A, c, x: A.compute_short_term_energy(c(x), 256),
    "spectral_gate": lambda A, c, x: A.spectral_gate(c(x * np.linspace(0, 1, len(x),
                                                                         dtype=np.float32)),
                                                     threshold=0.01, attack_samples=64),
    "spectral_gate_short": lambda A, c, x: A.spectral_gate(c(x[:50]), 0.01, 64),
    "zero_crossing_rate": lambda A, c, x: A.zero_crossing_rate(c(x), 512, 256),
    "chroma_stft": lambda A, c, x: A.chroma_stft(c(_mag(x, 2048, 512)), SR),
    "chroma_stft_tuned": lambda A, c, x: A.chroma_stft(c(_mag(x, 2048, 512)), SR, 12, 0.3),
    "yin_pitch": lambda A, c, x: A.yin_pitch(c(x), SR),
    "chroma": lambda A, c, x: A.chroma(c(x[:8000]), SR),
    "hpss_harmonic": lambda A, c, x: A.hpss(c(x[:8000]))[0],
    "hpss_percussive": lambda A, c, x: A.hpss(c(x[:8000]))[1],
    "normalize": lambda A, c, x: A.normalize(c(x), target_db=-6.0),
    "apply_mel_filterbank": lambda A, c, x: A.apply_mel_filterbank(
        c(_mag(x)), A.create_mel_filterbank(SR, 512, 40)),
    "log_mel": lambda A, c, x: A.log_mel(c(_mag(x))),
    "to_decibels": lambda A, c, x: A.to_decibels(c(x)),
    "harmonic": lambda A, c, x: A.harmonic(c(x[:4000])),
    "percussive": lambda A, c, x: A.percussive(c(x[:4000])),
    "magnitude_spectrum": lambda A, c, x: A.magnitude_spectrum(
        c(np.asarray(R.stft(_jax(x), 512, 256)))),
    "power_spectrum": lambda A, c, x: A.power_spectrum(
        c(np.asarray(R.stft(_jax(x), 512, 256)))),
    "detect_pitch_yin": lambda A, c, x: A.detect_pitch_yin(c(x[:8000]), SR, 1024, 256),
}

# Cases whose values are spectra (FFT outputs and what is linear in them):
# held by _spectrum_close
SPECTRUM_CASES = {
    "stft": lambda A, c, x: A.stft(c(x), 512, 256),
    "stft_whisper": lambda A, c, x: A.stft(c(x), 400, 160),
    "stft_nocenter": lambda A, c, x: A.stft(c(x), 256, 100, center=False),
    "melspectrogram": lambda A, c, x: A.melspectrogram(c(x), SR, 400, 160, 80),
    "mel_spectrogram_power1": lambda A, c, x: A.mel_spectrogram(c(x), SR, 512, 256, 40, 1.0),
    "cqt": lambda A, c, x: A.cqt(c(x), SR),
    "cqt_magnitude": lambda A, c, x: A.cqt_magnitude(c(x[:8000]), SR, 60, 12, 65.4, 256),
}


@pytest.mark.parametrize("signal", SIGNALS)
@pytest.mark.parametrize("case", FLOAT_CASES)
def test_float_outputs_match_the_reference(case, signal):
    x = SIGNALS[signal]
    fn = FLOAT_CASES[case]
    _close(fn(P, _torch, x), fn(R, _jax, x))


@pytest.mark.parametrize("signal", SIGNALS)
@pytest.mark.parametrize("case", SPECTRUM_CASES)
def test_spectra_match_the_reference(case, signal):
    x = SIGNALS[signal]
    fn = SPECTRUM_CASES[case]
    _spectrum_close(fn(P, _torch, x), fn(R, _jax, x))


@pytest.mark.parametrize("signal", SIGNALS)
def test_istft_without_centering_matches_the_reference(signal):
    """Uncentred, the first and last samples are divided by window-square
    sums down to 0 (1e-8 at the first), which multiplies the inverse FFT's
    rounding by up to 1e8: held where the sum is at least 1e-2."""
    x = SIGNALS[signal]
    spec = np.asarray(R.stft(_jax(x), 400, 160))
    ref = np.asarray(R.istft(_jax(spec), 400, 160, center=False))
    ours = P.istft(_torch(spec), 400, 160, center=False).numpy()
    w2 = np.asarray(R.hann_window(400)) ** 2
    wsq = np.zeros(len(ref))
    for f in range(spec.shape[0]):
        wsq[f * 160:f * 160 + 400] += w2
    kept = wsq >= 1e-2
    assert ours.shape == ref.shape and kept.sum() > len(ref) - 200
    _close(ours[kept], ref[kept])


def _at_the_floor_close(ours, ref, signal, rtol_l2, elementwise):
    """The pure sine's bins away from 440 Hz hold energy at the f32
    rounding floor of the FFT (a millionth of the peak), so whatever is
    computed from their logarithm or their phase is rounding noise in both
    packages: for the sine the relative L2 within ``rtol_l2``; the seeded
    signal's noise lifts every bin off the floor, and it is held
    elementwise (``elementwise`` the atol)."""
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    if signal == "sine":
        assert np.linalg.norm(ours - ref) <= rtol_l2 * np.linalg.norm(ref)
    else:
        _close(ours, ref, atol=elementwise)


@pytest.mark.parametrize("signal", SIGNALS)
@pytest.mark.parametrize("n_mfcc", [13, 20])
def test_mfcc_matches_the_reference(n_mfcc, signal):
    """The log of a mel band at the rounding floor (the sine's) differs
    between the packages by the FFT's relative rounding there: relative L2
    within 2e-4 for the sine."""
    x = SIGNALS[signal]
    ref = R.mfcc(_jax(x), SR, n_mfcc=n_mfcc)
    _at_the_floor_close(P.mfcc(_torch(x), SR, n_mfcc=n_mfcc), ref, signal, 2e-4,
                        ATOL * float(np.abs(_np(ref)).max()))


@pytest.mark.parametrize("rate", [0.8, 1.3, 2.0])
@pytest.mark.parametrize("signal", SIGNALS)
def test_time_stretch_matches_the_reference(signal, rate):
    """The frame positions are the reference's own f32 values. The phase
    is a running sum of up to F angle differences, so its rounding grows
    with the frame count: atol 1e-5 times the frames (about 3e-4) on the
    seeded signal. On the sine a bin at the rounding floor advances its
    phase by rounding noise, which the running sum carries into the frames
    where the bin is loud again: relative L2 within 2e-3."""
    x = SIGNALS[signal]
    ref = R.time_stretch(_jax(x), rate)
    _at_the_floor_close(P.time_stretch(_torch(x), rate), ref, signal, 2e-3,
                        ATOL * (1 + len(x) // 512))


@pytest.mark.parametrize("signal", SIGNALS)
@pytest.mark.parametrize("n_steps", [-3.0, 2.0, 7.0])
def test_pitch_shift_matches_the_reference(n_steps, signal):
    """time_stretch's tolerance (above); the resample is exact."""
    x = SIGNALS[signal][:8000]
    ref = R.pitch_shift(_jax(x), SR, n_steps)
    _at_the_floor_close(P.pitch_shift(_torch(x), SR, n_steps), ref, signal, 2e-3,
                        ATOL * (1 + len(x) // 512))


# -------------------------------------------------------------- bitwise --

FRAME_CASES = [(400, 160, True), (400, 160, False), (512, 256, True), (2048, 512, True),
               (100, 37, False), (3000, 100, True)]


@pytest.mark.parametrize("length,hop,center", FRAME_CASES)
def test_frame_signal_bitwise(length, hop, center):
    x = SIGNALS["seeded"][:2500]
    ours = P.frame_signal(_torch(x), length, hop, center)
    ref = np.asarray(R.frame_signal(_jax(x), length, hop, center))
    assert ours.shape == ref.shape and np.array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("signal", SIGNALS)
@pytest.mark.parametrize("case", [
    ("vad_energy", dict()), ("vad_energy", dict(threshold_db=-12.0)),
    ("vad_energy", dict(frame_length=512, hop_length=256, threshold_db=-9.0)),
    ("vad_zcr", dict()), ("vad_zcr", dict(max_rate=0.15)),
    ("vad_zcr", dict(frame_length=256, hop_length=128, max_rate=0.2))],
    ids=lambda c: f"{c[0]}-{'-'.join(f'{k}{v}' for k, v in c[1].items()) or 'default'}")
def test_vad_decisions_bitwise(case, signal):
    """On a third of near silence, the signal, then a third of loud noise
    (high energy, high crossing rate)."""
    name, kw = case
    rng = np.random.default_rng(7)
    x = SIGNALS[signal].copy()
    x[:SR // 3] = rng.normal(0, 1e-3, SR // 3)
    x[2 * SR // 3:] = rng.normal(0, 0.5, SR - 2 * SR // 3)
    ours = getattr(P, name)(_torch(x), **kw)
    ref = np.asarray(getattr(R, name)(_jax(x), **kw))
    assert ours.dtype == torch.bool and np.array_equal(ours.numpy(), ref)
    assert 0 < ref.sum() < ref.size          # both decisions occur


@pytest.mark.parametrize("hang", [0, 1, 3, 8, 50])
@pytest.mark.parametrize("density", [0.02, 0.2, 0.7])
def test_vad_hangover_bitwise(hang, density):
    active = np.random.default_rng(int(density * 100) + hang).random(300) < density
    ours = P.vad_hangover(_torch(active), hang)
    assert np.array_equal(ours.numpy(), np.asarray(R.vad_hangover(_jax(active), hang)))


def test_vad_hangover_reference_case():
    act = np.array([False, True, False, False, False, False])
    out = P.vad_hangover(_torch(act), hang_frames=3).numpy()
    assert out.tolist() == [False, True, True, True, False, False]


def _segments(segs):
    return [dataclasses.astuple(s) for s in segs]


@pytest.mark.parametrize("kw", [dict(), dict(energy_threshold=0.02), dict(hangover_ms=0.0),
                                dict(min_energy_floor=1e-4, zcr_high=0.5)])
@pytest.mark.parametrize("burst", ["sine", "seeded"])
def test_vad_detect_segments_bitwise(burst, kw):
    sig = np.zeros(SR, np.float32)
    sig[4000:12000] = SIGNALS[burst][:8000]          # speech burst in silence
    sig[13000:14000] = SIGNALS[burst][:1000] * 0.3
    sig += np.random.default_rng(0).normal(0, 1e-4, SR).astype(np.float32)
    ours = P.VAD(sample_rate=SR, **kw).detect(_torch(sig))
    ref = R.VAD(sample_rate=SR, **kw).detect(sig)
    assert _segments(ours) == _segments(ref) and ours


def test_vad_detect_silence_is_empty():
    sig = np.random.default_rng(1).normal(0, 1e-5, SR).astype(np.float32)
    assert P.VAD(sample_rate=SR).detect(_torch(sig)) == [] == R.VAD(sample_rate=SR).detect(sig)


@pytest.mark.parametrize("args", [(16000, 400, 80), (16000, 400, 128), (16000, 512, 40),
                                  (22050, 1024, 80, 30.0, 8000.0), (8000, 256, 20)])
def test_mel_filterbank_bitwise(args):
    ours = P.mel_filterbank(*args)
    assert ours.dtype == np.float32 and np.array_equal(ours, R.mel_filterbank(*args))
    assert P.create_mel_filterbank is P.mel_filterbank


@pytest.mark.parametrize("args", [(16000, 84, 12, 32.703, 2048), (22050, 60, 12, 65.4, 2048),
                                  (16000, 48, 24, 55.0, 1024)])
def test_cqt_kernel_bitwise(args):
    ours = P_analysis._cqt_kernel(*args)
    assert ours.dtype == np.complex64 and np.array_equal(ours, R_analysis._cqt_kernel(*args))


# ------------------------------------------------------------ recurrences --

@pytest.mark.parametrize("alpha", [0.5, 0.97, 0.999])
def test_deemphasis_matches_the_sequential_recurrence(alpha):
    """The log-depth scan against y[i] = x[i] + alpha y[i-1] in f64 (the
    scan's products reassociate: atol 1e-4, as the reference's own test
    holds its highpass)."""
    x = SIGNALS["seeded"][:3000]
    want = np.zeros(len(x))
    prev = 0.0
    for i, v in enumerate(x.astype(np.float64)):
        prev = v + alpha * prev
        want[i] = prev
    np.testing.assert_allclose(P.deemphasis(_torch(x), alpha).numpy(), want,
                               rtol=1e-4, atol=1e-4)


def test_highpass_matches_the_sequential_recurrence():
    """tests/test_audio.py's case, at its tolerance."""
    x = np.random.default_rng(3).normal(size=500).astype(np.float32)
    sr, fc = 16000, 100.0
    rc = 1.0 / (2 * np.pi * fc)
    a = rc / (rc + 1.0 / sr)
    want = np.zeros_like(x)
    xp = yp = 0.0
    for i in range(len(x)):
        yp = a * (yp + x[i] - xp)
        xp = x[i]
        want[i] = yp
    np.testing.assert_allclose(P.highpass_filter(_torch(x), fc, sr).numpy(), want, atol=1e-4)
    _close(P.highpass_filter(_torch(x), fc, sr), R.highpass_filter(_jax(x), fc, sr))


def test_deemphasis_inverts_preemphasis():
    x = SIGNALS["sine"][:4000]
    back = P.deemphasis(P.preemphasis(_torch(x), 0.97), 0.97).numpy()
    np.testing.assert_allclose(back, x, atol=1e-3)


# ------------------------------------------------------------- the rest --

def test_griffin_lim_converges_as_the_reference():
    """Its initial phases come from a torch generator, not jax's PRNG, so
    it is held by spectral convergence (||S - |STFT(y)||| / ||S||): the
    port's after 32 iterations within 1.25x of the reference's, and below
    its own start."""
    x = SIGNALS["sine"][:4000]
    mag = np.abs(np.asarray(R.stft(_jax(x), 400, 160)))

    def convergence(y):
        s = np.abs(np.asarray(R.stft(_jax(_np(y)), 400, 160)))[:mag.shape[0]]
        return np.linalg.norm(s - mag) / np.linalg.norm(mag)
    ref = convergence(R.griffin_lim(_jax(mag), 400, 160, n_iter=32, length=4000))
    ours = P.griffin_lim(_torch(mag), 400, 160, n_iter=32, length=4000)
    start = convergence(P.griffin_lim(_torch(mag), 400, 160, n_iter=0, length=4000))
    assert ours.shape == (4000,) and torch.isfinite(ours).all()
    assert convergence(ours) <= 1.25 * ref and convergence(ours) < 0.5 * start, (
        convergence(ours), ref, start)
    again = P.griffin_lim(_torch(mag), 400, 160, n_iter=32, length=4000)
    assert torch.equal(again, ours)              # the seed fixes the draws


@pytest.mark.parametrize("pcm,sr", [
    ((np.ones(100) * 16384).astype(np.int16), 16000),
    (np.stack([np.ones(50), np.zeros(50)], axis=-1).astype(np.float32), 8000),
    (np.random.default_rng(5).integers(-32768, 32767, (300, 2)).astype(np.int16), 44100)])
def test_audio_buffer_from_pcm(pcm, sr):
    ours = P.AudioBuffer.from_pcm(pcm, sr, device="cpu")
    ref = R.AudioBuffer.from_pcm(pcm, sr)
    assert np.array_equal(ours.to_numpy(), ref.to_numpy())
    assert (len(ours), ours.duration, ours.sample_rate) == (len(ref), ref.duration, sr)
    assert np.array_equal(P.from_pcm(pcm, sr, device="cpu").to_numpy(), ref.to_numpy())


def test_ring_buffer_and_stream_match_the_reference():
    rng = np.random.default_rng(6)
    ours, ref = P.RingBuffer(64), R.RingBuffer(64)
    so, sr_ = P.AudioStream(chunk_size=48, hop_size=20, buffer_duration=0.01), \
        R.AudioStream(chunk_size=48, hop_size=20, buffer_duration=0.01)
    for n in (5, 40, 70, 1, 63, 200, 17):
        chunk = rng.standard_normal(n).astype(np.float32)
        pcm = (chunk * 1000).astype(np.int16)
        for a, b in ((ours, ref), (so, sr_)):
            a.push(chunk)
            b.push(chunk)
        so.push(pcm)
        sr_.push(pcm)
        assert len(ours) == len(ref)
        for k in (1, 10, 64, 100):
            assert np.array_equal(ours.read_latest(k), ref.read_latest(k))
        while sr_.has_chunk():
            assert so.has_chunk() and np.array_equal(so.pop_chunk(), sr_.pop_chunk())
        assert not so.has_chunk() and so.pop_chunk() is None
        assert np.array_equal(so.latest(0.004), sr_.latest(0.004))
    assert P.AudioRingBuffer is P.RingBuffer


def test_exports_are_the_references():
    assert sorted(P.__all__) == sorted(R.__all__)
    for name in P.__all__:
        assert hasattr(P, name), name


def test_a_tensor_stays_on_its_device_and_numpy_goes_to_the_card(monkeypatch):
    x = SIGNALS["sine"][:2000]
    assert P.stft(_torch(x), 400, 160).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.stft(x, 400, 160)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.hann_window(400)
