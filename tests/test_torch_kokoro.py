"""The port's Kokoro (``pygpukit_tpu_torch.tts.kokoro``) against the JAX
package's on the same seeded inputs, on the CPU: the phonemizer and the
vocabulary bit for bit, the checkpoint's key inventory, random flat dict
and param tree bit for bit, every ``arch`` stage at rtol 1e-4 on a tiny
``KokoroDims`` (the reference's functions jitted), the alignment index
bit for bit, ``kmodel_forward`` whole, ``Kokoro82M.from_pretrained`` on
the reference test's on-disk layout, and the simple ``KokoroModel`` with
the reference's weights carried across.

Three things are set up at test time, never in the JAX package:
- The sine source's two draws are the reference's ``jax.random`` values
  for the key, fed to the port's ``draws``.
- ``jax.image.resize`` runs with ``antialias=False`` wherever the
  reference's sine source is compared (ROADMAP C.13: the reference's
  default antialiases the 300x downsampling, so its harmonic source is
  not the linear interpolation its docstring states;
  ``test_sine_source_follows_linear_interpolation`` records the gap).
- The harmonic's STFT phase (``torch.angle``, ``jnp.angle``) is taken on
  one side of its branch cut on both sides (-pi read as +pi): the first
  and last STFT frames of a reflect-padded signal are symmetric under the
  symmetric window, so their spectra are real up to rounding and a bin
  with a negative real part gets +pi or -pi by the sign of a rounding
  residue. Either side is the same angle; the generator reads it as a
  number, so one flip moves the audio by about 1e-2 relative L2. The
  phases themselves are held as unit phasors.
"""

import functools
import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pygpukit_tpu.tts.kokoro import Kokoro82M as RefKokoro82M  # noqa: E402
from pygpukit_tpu.tts.kokoro import KokoroConfig as RefConfig  # noqa: E402
from pygpukit_tpu.tts.kokoro import KokoroModel as RefModel  # noqa: E402
from pygpukit_tpu.tts.kokoro import arch as ref_arch  # noqa: E402
from pygpukit_tpu.tts.kokoro import checkpoint as ref_ckpt  # noqa: E402
from pygpukit_tpu.tts.kokoro import g2p as ref_g2p  # noqa: E402
from pygpukit_tpu_torch.tts import kokoro  # noqa: E402
from pygpukit_tpu_torch.tts.kokoro import (Kokoro82M, KokoroConfig,  # noqa: E402
                                           KokoroModel, arch, checkpoint, g2p)
from pygpukit_tpu_torch.tts.kokoro.model import carry_arrays  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
# kmodel_forward and the generator whole (relative L2): f32 products
# summed in other orders through about 40 convolutions and 10 LSTMs, then
# exp() of the magnitude channel
AUDIO_REL = 1e-4
N_ALBERT, HEADS = 2, 4
_RESIZE = jax.image.resize           # the reference's, before any test patches it


def _tiny(mod):
    """A tiny KokoroDims of ``mod`` (style 128 and the generator's rates and
    FFT stay: the forward's slices and upsampling are fixed by them)."""
    d = mod.KokoroDims()
    d.hidden_dim, d.max_dur, d.albert_emb, d.albert_hidden = 32, 8, 16, 24
    d.albert_heads, d.albert_ffn, d.albert_layers, d.albert_max_pos = HEADS, 32, N_ALBERT, 64
    d.dec_hidden, d.gen_ch = 48, 16
    return d


@pytest.fixture(scope="module")
def trees():
    """(flat dict, the reference's tree, the port's tree) of one tiny random
    checkpoint."""
    flat = ref_ckpt.init_random_flat(_tiny(ref_ckpt), seed=3, scale=0.2)
    return (flat, ref_ckpt.load_params(flat, _tiny(ref_ckpt)),
            checkpoint.load_params(flat, _tiny(checkpoint), device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _ref_draws(key, n: int):
    """The reference sine source's two draws for ``key`` (arch.py:318-332)."""
    k1, k2 = jax.random.split(key)
    return (_t(jax.random.uniform(k1, (9,))), _t(jax.random.normal(k2, (n, 9))))


@pytest.fixture
def linear_resize(monkeypatch):
    """The reference's ``jax.image.resize`` without antialiasing (C.13)."""
    monkeypatch.setattr(jax.image, "resize",
                        lambda *a, **k: _RESIZE(*a, **{**k, "antialias": False}))


@pytest.fixture
def one_branch(monkeypatch):
    """Both packages' STFT phase read on one side of its branch cut (-pi as
    +pi; module docstring); returns the port's count of the bins it moved."""
    moved = []

    def wrap(fn, where, count):
        def stft(*a):
            mag, ph = fn(*a)
            near = ph < -math.pi + 1e-4
            if count:
                moved.append(int(near.sum()))
            return mag, where(near, ph + 2 * math.pi, ph)
        return stft
    monkeypatch.setattr(ref_arch, "_stft_mag_phase",
                        wrap(ref_arch._stft_mag_phase, jnp.where, False))
    monkeypatch.setattr(arch, "_stft_mag_phase", wrap(arch._stft_mag_phase, torch.where, True))
    return moved


# ----------------------------------------------------------------- g2p ----

G2P_TEXTS = ["Hello world", "I have 21 cats", "142", "The quick brown fox jumps over the lazy dog.",
             "Church, phone; ship: cat!", "Say 1234567 things?", "nation ought eight", ""]


@pytest.mark.parametrize("text", G2P_TEXTS)
def test_g2p_matches_the_reference(text):
    """normalize, text_to_ipa, word by word word_to_ipa and Phonemizer's
    ids on text and on its IPA, bit for bit."""
    assert g2p.normalize(text) == ref_g2p.normalize(text)
    ipa = g2p.text_to_ipa(text)
    assert ipa == ref_g2p.text_to_ipa(text)
    for w in g2p.normalize(text).split():
        assert g2p.word_to_ipa(w.strip(",.!?;:")) == ref_g2p.word_to_ipa(w.strip(",.!?;:"))
    p, r = g2p.Phonemizer(), ref_g2p.Phonemizer()
    assert p.encode(text) == r.encode(text)
    assert p.encode(phonemes=ipa) == r.encode(phonemes=ipa)


def test_g2p_tables_and_vocab_are_the_references():
    """The lexicon, the rules, KOKORO_VOCAB and default_vocab, the published
    ids the reference test spot-checks (test_kokoro_arch.py:300-325), a
    custom vocab."""
    assert g2p.LEXICON == ref_g2p.LEXICON and g2p.RULES == ref_g2p.RULES
    assert g2p.KOKORO_VOCAB == ref_g2p.KOKORO_VOCAB == g2p.default_vocab()
    assert g2p.Phonemizer().encode(phonemes="həlˈoʊ wˈɜːld") == [
        50, 83, 54, 156, 57, 135, 16, 65, 156, 87, 158, 54, 46]
    assert g2p.Phonemizer().encode("hello") == [50, 83, 54, 57, 135]
    assert g2p.Phonemizer(vocab={"h": 7, "i": 3}).encode(phonemes="hi") == [7, 3]
    assert kokoro.Phonemizer is g2p.Phonemizer


# ---------------------------------------------------------- checkpoint ----

@pytest.mark.parametrize("tiny", [False, True])
def test_spec_and_random_checkpoint_match_the_reference(tiny):
    """state_dict_spec (names, shapes, order) and init_random_flat bit for
    bit, at Kokoro-82M's dims and a tiny one; the spec's parameter count."""
    d, rd = (_tiny(checkpoint), _tiny(ref_ckpt)) if tiny else (None, None)
    spec = checkpoint.state_dict_spec(d)
    assert list(spec.items()) == list(ref_ckpt.state_dict_spec(rd).items())
    if not tiny:
        assert 81e6 < sum(int(np.prod(s)) for s in spec.values()) < 83e6
        return
    flat, ref = checkpoint.init_random_flat(d, seed=4), ref_ckpt.init_random_flat(rd, seed=4)
    assert list(flat) == list(ref)
    assert all(np.array_equal(flat[k], ref[k]) and flat[k].dtype == np.float32 for k in flat)


def _same_tree(got, ref, path="params"):
    """``got`` has ``ref``'s nested structure (keys in order, lists, None
    biases) with f32 CPU tensor leaves bitwise its arrays."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        for k in ref:
            _same_tree(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (x, y) in enumerate(zip(got, ref)):
            _same_tree(x, y, f"{path}[{i}]")
    elif ref is None:
        assert got is None, path
    else:
        assert got.dtype == torch.float32 and got.device.type == "cpu", path
        assert np.array_equal(got.numpy(), np.asarray(ref)), path


def test_load_params_is_the_references_tree(trees):
    """load_params: the reference's nested tree, leaf for leaf bitwise."""
    _, ref, got = trees
    _same_tree(got, ref)


def _nested(flat: dict) -> dict:
    """The on-disk layout: five sub-dicts with DataParallel prefixes."""
    nested: dict = {}
    for name, arr in flat.items():
        top, rest = name.split(".", 1)
        nested.setdefault(top, {})[f"module.{rest}"] = torch.tensor(arr)
    return nested


def test_checkpoint_files_load_as_the_references(tmp_path):
    """A nested .pth and a flat .safetensors (``module.`` prefixes) load to
    the reference's flat dicts; voices and their rows as the reference's."""
    from pygpukit_tpu_torch.llm.safetensors import save_safetensors
    flat = checkpoint.init_random_flat(_tiny(checkpoint), seed=1, scale=0.05)
    torch.save(_nested(flat), tmp_path / "k.pth")
    save_safetensors(tmp_path / "k.safetensors",
                     {"module." + k: v for k, v in flat.items()})
    for f in ("k.pth", "k.safetensors"):
        got, ref = (checkpoint.load_checkpoint_file(tmp_path / f),
                    ref_ckpt.load_checkpoint_file(tmp_path / f))
        assert set(got) == set(ref) == set(flat)
        assert all(np.array_equal(got[k], ref[k]) for k in flat)
    v = np.random.default_rng(0).standard_normal((510, 1, 256)).astype(np.float32)
    torch.save(torch.tensor(v), tmp_path / "v.pt")
    torch.save({"style": torch.tensor(v)}, tmp_path / "w.pt")
    for f in ("v.pt", "w.pt"):
        got = checkpoint.load_voice_file(tmp_path / f)
        assert np.array_equal(got, ref_ckpt.load_voice_file(tmp_path / f))
    for n in (0, 1, 5, 600):
        assert np.array_equal(checkpoint.select_ref_s(v, n), ref_ckpt.select_ref_s(v, n))


# ---------------------------------------------------------------- arch ----

def _ids(rng, n):
    return np.concatenate([[0], rng.integers(1, 178, n), [0]]).astype(np.int32)


def test_albert_text_and_duration_encoders_match_the_reference(trees):
    """albert_forward (gelu_new and the exact GELU), text_encoder_forward,
    duration_encoder_forward and predict_durations (speed 1 and 1.3)."""
    _, rp, pp = trees
    rng = np.random.default_rng(0)
    ids = _ids(rng, 9)
    for act in ("gelu_new", "gelu"):
        ref = jax.jit(functools.partial(ref_arch.albert_forward, n_layers=N_ALBERT,
                                        n_heads=HEADS, act=act))(jnp.asarray(ids), rp["bert"])
        _close(arch.albert_forward(_t(ids), pp["bert"], n_layers=N_ALBERT, n_heads=HEADS,
                                   act=act), ref)
    _close(arch.text_encoder_forward(_t(ids), pp["text_encoder"]),
           jax.jit(ref_arch.text_encoder_forward)(jnp.asarray(ids), rp["text_encoder"]))
    d_en = rng.standard_normal((1, 32, 11)).astype(np.float32)
    style = rng.standard_normal(128).astype(np.float32)
    _close(arch.duration_encoder_forward(_t(d_en), _t(style), pp["predictor"]["text_encoder"]),
           jax.jit(ref_arch.duration_encoder_forward)(jnp.asarray(d_en), jnp.asarray(style),
                                                      rp["predictor"]["text_encoder"]))
    for speed in (1.0, 1.3):
        rd, rdur = jax.jit(ref_arch.predict_durations)(jnp.asarray(d_en), jnp.asarray(style),
                                                       rp["predictor"], jnp.float32(speed))
        d, dur = arch.predict_durations(_t(d_en), _t(style), pp["predictor"], speed)
        _close(d, rd)
        _close(dur, rdur)


@pytest.mark.parametrize("upsample", [False, True])
def test_adain_resblk1d_matches_the_reference(trees, upsample):
    """The F0 branch's blocks: 32 -> 32 plain, 32 -> 16 with the grouped
    ConvTranspose upsampling and the 1x1 shortcut; the decoder's 114 -> 48
    encode block."""
    _, rp, pp = trees
    rng = np.random.default_rng(1)
    s = rng.standard_normal((1, 128)).astype(np.float32)
    blocks = [(rp["predictor"]["F0"]["blocks"][1 if upsample else 0],
               pp["predictor"]["F0"]["blocks"][1 if upsample else 0], 32)]
    if not upsample:
        blocks.append((rp["decoder"]["encode"], pp["decoder"]["encode"], 34))
    for rb, pb, ch in blocks:
        x = rng.standard_normal((1, ch, 17)).astype(np.float32)
        got = arch.adain_resblk1d(_t(x), _t(s), pb, upsample=upsample)
        ref = ref_arch.adain_resblk1d(jnp.asarray(x), jnp.asarray(s), rb, upsample=upsample)
        assert got.shape == ref.shape
        _close(got, ref)


def test_f0n_train_matches_the_reference(trees):
    _, rp, pp = trees
    rng = np.random.default_rng(2)
    en = rng.standard_normal((1, 160, 30)).astype(np.float32)
    style = rng.standard_normal(128).astype(np.float32)
    ref = jax.jit(ref_arch.f0n_train)(jnp.asarray(en), jnp.asarray(style), rp["predictor"])
    got = arch.f0n_train(_t(en), _t(style), pp["predictor"])
    for g, r in zip(got, ref):
        assert g.shape == (1, 60)
        _close(g, r)


def test_stft_and_istft_match_the_reference():
    """Magnitudes at rtol 1e-4, phases as unit phasors (a phase at the
    branch cut is +pi on one side and -pi on the other), the iSTFT of given
    magnitudes and phases; against torch.stft too."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(600).astype(np.float32)
    mag, ph = arch._stft_mag_phase(_t(x), 20, 5)
    rmag, rph = ref_arch._stft_mag_phase(jnp.asarray(x), 20, 5)
    _close(mag, rmag, atol=1e-5)
    np.testing.assert_allclose(np.exp(1j * ph.numpy()), np.exp(1j * np.asarray(rph)),
                               atol=1e-4)
    spec = torch.stft(_t(x), 20, 5, 20, torch.hann_window(20), return_complex=True)
    _close(mag, spec.abs(), atol=1e-5)
    mag2 = np.abs(rng.standard_normal((11, 121))).astype(np.float32)
    ph2 = rng.uniform(-3, 3, (11, 121)).astype(np.float32)
    got = arch._istft(_t(mag2), _t(ph2), 20, 5)
    _close(got, ref_arch._istft(jnp.asarray(mag2), jnp.asarray(ph2), 20, 5))
    _close(arch._istft(_t(mag2), _t(ph2), 20, 5, length=300), got[:300])


def test_alignment_index_is_the_references_repeat():
    """``alignment_index`` bit for bit ``jnp.repeat(arange(S), frames,
    total_repeat_length=total)``: budgets under, at and past the sum."""
    rng = np.random.default_rng(6)
    for s_len in (1, 7, 40):
        frames = rng.integers(1, 21, s_len).astype(np.int32)
        for total in (max(int(frames.sum()) - 3, 1), int(frames.sum()) + 13):
            want = np.asarray(jnp.repeat(jnp.arange(s_len), jnp.asarray(frames),
                                         total_repeat_length=total))
            assert np.array_equal(arch.alignment_index(_t(frames), total).numpy(), want)


def test_sine_source_follows_linear_interpolation(linear_resize):
    """C.13. The port's sine source bit for bit a transcription of istftnet's
    SineGen over F.interpolate(mode="linear", align_corners=False), and the
    reference's within its phases' rounding once its resize is linear. The
    reference's default resize antialiases the 300x downsampling: on phase
    increments constant over each frame, as the repeated f0 makes them,
    F.interpolate returns the frame values, the antialiased resize mixes in
    the neighbouring frames (recorded below)."""
    rng = np.random.default_rng(8)
    frames = 24
    f0 = np.repeat((150 + rng.standard_normal(frames) * 40).astype(np.float32), 300)
    f0[:1200] = 0.0                                        # an unvoiced stretch
    p = {"l_linear": {"w": (rng.standard_normal((9, 1)) * 0.3).astype(np.float32),
                      "b": np.zeros(1, np.float32)}}
    key = jax.random.PRNGKey(3)
    ri, nz = _ref_draws(key, len(f0))
    pp = {"l_linear": {k: _t(v) for k, v in p["l_linear"].items()}}
    got = arch.sine_source(_t(f0), pp, (ri, nz))

    # istftnet.py SineGen, transcribed
    f = _t(f0)
    rad = (f[:, None] * torch.arange(1, 10, dtype=torch.float32) / 24000) % 1.0
    rad[0, 1:] += ri[1:]
    ds = F.interpolate(rad.T[None], size=frames, mode="linear", align_corners=False)
    phase = torch.cumsum(ds[0].T, 0) * (2 * math.pi)
    up = F.interpolate((phase * 300).T[None], size=len(f0), mode="linear",
                       align_corners=False)[0].T / 300
    uv = (f > 10.0).float()[:, None]
    waves = torch.sin(up * 300) * 0.1 * uv + (uv * 0.003 + (1 - uv) * (0.1 / 3)) * nz
    want = torch.tanh(waves @ pp["l_linear"]["w"] + pp["l_linear"]["b"])[:, 0]
    assert torch.equal(got, want)

    # the reference with a linear resize: within |phase| 2^-24 of sin's input
    ref = np.asarray(ref_arch.sine_source(jnp.asarray(f0), p, key))
    max_phase = float((phase * 300).abs().max())
    assert max_phase > 1e3
    assert np.abs(got.numpy() - ref).max() < 4 * max_phase * 2.0 ** -24

    # the reference's default resize on the same increments
    rad_j = jnp.asarray(rad.numpy())
    lin = ds[0].T.numpy()
    assert np.abs(np.asarray(_RESIZE(rad_j, (frames, 9), "linear")) - lin).max() > 1e-3
    assert np.abs(np.asarray(_RESIZE(rad_j, (frames, 9), "linear", antialias=False))
                  - lin).max() < 1e-6


def test_generator_and_decoder_match_the_reference(trees, linear_resize, one_branch):
    """generator_forward on given (x, style, f0) with the reference's draws,
    and decoder_forward; f0 under the voicing threshold, so the source is
    the noise branch (a voiced source's sin() of thousands of radians
    carries |phase| 2^-24 and can move STFT phases across the cut; the sine
    source test holds that branch)."""
    _, rp, pp = trees
    rng = np.random.default_rng(9)
    t2 = 48
    x = rng.standard_normal((1, 16, t2)).astype(np.float32)
    s = rng.standard_normal((1, 128)).astype(np.float32)
    f0 = (np.abs(rng.standard_normal((1, t2))) * 3).astype(np.float32)
    key = jax.random.PRNGKey(1)
    draws = _ref_draws(key, t2 * 300)
    ref = jax.jit(ref_arch.generator_forward)(jnp.asarray(x), jnp.asarray(s), jnp.asarray(f0),
                                              rp["decoder"]["generator"], key)
    got = arch.generator_forward(_t(x), _t(s), _t(f0), pp["decoder"]["generator"], draws)
    assert got.shape == ref.shape == (t2 * 300,)
    assert _rel(got, ref) < AUDIO_REL
    asr = rng.standard_normal((1, 32, t2 // 2)).astype(np.float32)
    n = rng.standard_normal((1, t2)).astype(np.float32)
    ref = jax.jit(ref_arch.decoder_forward)(jnp.asarray(asr), jnp.asarray(f0), jnp.asarray(n),
                                            jnp.asarray(s), rp["decoder"], key)
    got = arch.decoder_forward(_t(asr), _t(f0), _t(n), _t(s), pp["decoder"], draws)
    assert _rel(got, ref) < AUDIO_REL
    assert sum(one_branch) <= 4 * 11                       # bins of the end frames


@pytest.mark.parametrize("speed", [1.0, 1.6])
def test_kmodel_forward_matches_the_reference(trees, linear_resize, one_branch, speed):
    """The whole forward on the tiny checkpoint, the reference's draws fed
    in: durations and the true frame count equal, the audio within
    AUDIO_REL relative L2; at speed 1.6 the budget holds the sum (a masked
    tail), at 1.0 it clamps it."""
    _, rp, pp = trees
    ids = np.array([10, 43, 57, 61, 47], np.int32)
    ref_s = (np.random.default_rng(2).standard_normal(256) * 0.3).astype(np.float32)
    total = 24
    key = jax.random.PRNGKey(7)
    fn = jax.jit(functools.partial(ref_arch.kmodel_forward, total_frames=total,
                                   n_albert_layers=N_ALBERT, albert_heads=HEADS))
    ra, rd, rt = fn(jnp.asarray(ids), jnp.asarray(ref_s), rp, speed=jnp.float32(speed), key=key)
    pa, pd, pt = arch.kmodel_forward(_t(ids), _t(ref_s), pp, speed=speed, total_frames=total,
                                     n_albert_layers=N_ALBERT, albert_heads=HEADS,
                                     draws=_ref_draws(key, total * 600))
    assert pd.tolist() == np.asarray(rd).tolist() and int(pt) == int(rt)
    assert (int(pt) < total) == (speed > 1.0)
    assert pa.shape == (total * 600,) and torch.isfinite(pa).all()
    assert _rel(pa, ra) < AUDIO_REL


def test_kmodel_forward_draws_from_a_generator():
    """Without draws, the forward draws them from the generator (seeded 0
    when none is given): the same seed the same audio, another seed another."""
    d = _tiny(checkpoint)
    pp = checkpoint.load_params(checkpoint.init_random_flat(d, seed=0, scale=0.05), d,
                                device="cpu")
    ids, ref_s = torch.tensor([43, 44, 45], dtype=torch.int32), torch.zeros(256)
    kw = dict(total_frames=12, n_albert_layers=N_ALBERT, albert_heads=HEADS)

    def run(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return arch.kmodel_forward(ids, ref_s, pp, generator=g, **kw)[0]
    a0 = arch.kmodel_forward(ids, ref_s, pp, **kw)[0]
    assert torch.equal(a0, run(0)) and not torch.equal(a0, run(1))


# ---------------------------------------------------------- Kokoro82M ----

def _write_snapshot(root, flat, tiny: bool):
    root.mkdir(parents=True, exist_ok=True)
    torch.save(_nested(flat), root / "kokoro-v1_0.pth")
    cfg = {"n_token": 178, "style_dim": 128, "hidden_dim": 32 if tiny else 512,
           "max_dur": 8, "vocab": g2p.default_vocab(),
           "plbert": {"hidden_size": 24, "num_attention_heads": HEADS,
                      "intermediate_size": 32, "num_hidden_layers": N_ALBERT,
                      "max_position_embeddings": 64},
           "decoder": {"upsample_initial_channel": 16}}
    (root / "config.json").write_text(json.dumps(cfg))
    (root / "voices").mkdir(exist_ok=True)
    for i, name in enumerate(("af_heart", "bm_test")):
        v = np.random.default_rng(i).standard_normal((510, 1, 256)).astype(np.float32) * 0.1
        torch.save(torch.tensor(v), root / "voices" / f"{name}.pt")


def _snapshot_dims(mod):
    """What config.json above gives KokoroDims.from_config (albert_emb and
    dec_hidden are not read from it)."""
    d = _tiny(mod)
    d.albert_emb, d.dec_hidden = 128, 1024
    return d


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    root = tmp_path_factory.mktemp("kokoro82m")
    flat = ref_ckpt.init_random_flat(_snapshot_dims(ref_ckpt), seed=5, scale=0.05)
    _write_snapshot(root, flat, tiny=True)
    return root


def test_from_pretrained_loads_the_references_model(snapshot):
    """The reference test's layout (nested .pth with module. prefixes,
    config.json with the vocab, voices/*.pt): the dims, vocab, params and
    voices the reference loads; one voice or all; the current voice."""
    m = Kokoro82M.from_pretrained(snapshot, voice="af_heart", device="cpu")
    r = RefKokoro82M.from_pretrained(snapshot, voice="af_heart")
    assert vars(m.dims) == vars(r.dims) and m.phonemizer.vocab == r.phonemizer.vocab
    assert m.available_voices == r.available_voices == ["af_heart"]
    assert m.current_voice == "af_heart"
    assert np.array_equal(m.voices["af_heart"], r.voices["af_heart"])
    _same_tree(m.params, r.params)
    every = Kokoro82M.from_pretrained(snapshot, load_all_voices=True, device="cpu")
    assert every.available_voices == ["af_heart", "bm_test"]
    with pytest.raises(KeyError):
        every.set_voice("nope")
    assert every.load_voice(snapshot / "voices" / "bm_test.pt") == "bm_test"


def test_synthesize_follows_the_reference(snapshot):
    """synthesize: the phonemes and audio length the reference gives (the
    durations do not depend on the draws), finite audio; a second call
    with the seed the same samples, another seed others; from phonemes;
    the program captured once per length (on the CPU a capture calls the
    function on its static inputs)."""
    m = Kokoro82M.from_pretrained(snapshot, voice="af_heart", device="cpu")
    r = RefKokoro82M.from_pretrained(snapshot, voice="af_heart")
    got, want = m.synthesize("test", speed=1.2), r.synthesize("test", speed=1.2)
    assert got.phonemes == want.phonemes and got.sample_rate == 24000
    assert got.audio.shape == want.audio.shape and got.audio.shape[0] > 0
    assert np.isfinite(got.audio).all()
    assert np.array_equal(got.audio, m.synthesize("test", speed=1.2).audio)
    assert not np.array_equal(got.audio, m.synthesize("test", speed=1.2, seed=1).audio)
    ph = m.synthesize(phonemes="həlˈoʊ")
    assert ph.phonemes == "həlˈoʊ" and np.isfinite(ph.audio).all()
    assert len(m.graphs.executables()) == 2


def test_synthesize_streaming_yields_a_segment_a_sentence(snapshot):
    m = Kokoro82M.from_pretrained(snapshot, device="cpu")
    outs = list(m.synthesize_streaming("one. two! three?"))
    assert len(outs) == 3 and all(np.isfinite(o.audio).all() for o in outs)
    assert [o.phonemes for o in outs] == [g2p.text_to_ipa(t) for t in ("one.", "two!", "three?")]


def test_random_init_is_the_references_checkpoint(monkeypatch):
    """random_init: the reference's flat dict and demo voice for the seed
    (checked on the tiny dims: the dims are the only thing it takes)."""
    d = _tiny(checkpoint)
    monkeypatch.setattr(checkpoint, "KokoroDims", lambda: d)
    m = Kokoro82M.random_init(seed=2, device="cpu")
    rd = _tiny(ref_ckpt)
    _same_tree(m.params, ref_ckpt.load_params(ref_ckpt.init_random_flat(rd, seed=2, scale=0.05),
                                              rd))
    v = np.random.default_rng(2).standard_normal((510, 1, 256)).astype(np.float32) * 0.1
    assert np.array_equal(m.voices["demo"], v) and m.current_voice == "demo"


# ---------------------------------------------------------- KokoroModel ----

SMALL = dict(hidden_dim=64, decoder_dim=64, plbert_dim=64)


@pytest.fixture(scope="module")
def simple_pair():
    """The reference's small KokoroModel and the port's with its arrays."""
    voices = {"af_test": np.linspace(-1, 1, 64).astype(np.float32)}
    ref = RefModel(RefConfig(**SMALL), voice_embeddings=voices)
    got = KokoroModel(KokoroConfig(**SMALL), voice_embeddings=voices, device="cpu")
    carry_arrays(got, ref)
    return ref, got


@pytest.mark.parametrize("text,voice,speed", [
    ("hello world.", None, 1.0), ("hi.", "af_test", 1.0), ("a longer test sentence", None, 1.5)])
def test_simple_model_matches_the_reference(simple_pair, text, voice, speed):
    """synthesize with the reference's weights: the same length, the audio
    at rtol 1e-4 of its peak."""
    ref, got = simple_pair
    want = ref.synthesize(text, voice=voice, speed=speed)
    res = got.synthesize(text, voice=voice, speed=speed)
    assert res.audio.shape == want.audio.shape and res.sample_rate == want.sample_rate
    np.testing.assert_allclose(res.audio, want.audio, rtol=RTOL,
                               atol=RTOL * np.abs(want.audio).max())


def test_simple_layers_match_the_reference(simple_pair):
    """The layers the synthesis does not reach alone: the style encoder, a
    unidirectional LSTM, InstanceNorm1d, a weight-norm conv and a
    transposed conv loaded from torch modules."""
    from pygpukit_tpu.tts.kokoro import layers as rl
    from pygpukit_tpu_torch.tts.kokoro import layers as pl
    ref, got = simple_pair
    rng = np.random.default_rng(12)
    mel = rng.standard_normal((50, 80)).astype(np.float32)
    _close(got.style_encoder(_t(mel)), ref.style_encoder(jnp.asarray(mel)))
    g = torch.Generator()
    g.manual_seed(0)
    rl_lstm, pl_lstm = rl.LSTM(jax.random.PRNGKey(0), 6, 5, bidirectional=False), \
        pl.LSTM(g, 6, 5, bidirectional=False)
    carry_arrays(pl_lstm, rl_lstm)
    x = rng.standard_normal((9, 2, 6)).astype(np.float32)
    _close(pl_lstm(_t(x)), rl_lstm(jnp.asarray(x)))
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    _close(pl.InstanceNorm1d(3)(_t(x)), rl.InstanceNorm1d(3)(jnp.asarray(x)))
    tc = torch.nn.utils.parametrizations.weight_norm(torch.nn.Conv1d(3, 5, 3, padding=1))
    gw, vw = (tc.parametrizations.weight.original0.detach().numpy(),
              tc.parametrizations.weight.original1.detach().numpy())
    wn = pl.WeightNormConv1d(g, 3, 5, 3, padding=1).load_weight_norm(gw, vw, tc.bias.detach())
    x = rng.standard_normal((1, 3, 12)).astype(np.float32)
    _close(wn(_t(x)), tc(_t(x)).detach(), atol=1e-4)
    tt = torch.nn.ConvTranspose1d(4, 2, 8, stride=4, padding=2)
    ct = pl.ConvTranspose1d(g, 4, 2, 8, stride=4, padding=2).load(tt.weight.detach(),
                                                                  tt.bias.detach())
    x = rng.standard_normal((1, 4, 10)).astype(np.float32)
    _close(ct(_t(x)), tt(_t(x)).detach(), atol=1e-4)


def test_simple_model_voices_streaming_and_wav(simple_pair, tmp_path):
    """The reference test's cases on the port: a voice changes the audio,
    an unknown voice raises, three segments stream, a WAV file is written;
    the captured program is reused for a length it has seen."""
    _, m = simple_pair
    m.set_voice("af_test")
    r2 = m.synthesize("hi.")
    m._current_voice = None
    r1 = m.synthesize("hi.")
    assert not np.allclose(r1.audio[:500], r2.audio[:500])
    with pytest.raises(KeyError):
        m.set_voice("nope")
    outs = list(m.synthesize_streaming("one. two! three?"))
    assert len(outs) == 3
    n = len(m.graphs.executables())
    m.synthesize("one.")
    assert len(m.graphs.executables()) == n
    p = tmp_path / "out.wav"
    r1.to_wav(str(p))
    assert p.stat().st_size == 44 + 2 * len(r1.audio) and len(r1.audio) > 500
