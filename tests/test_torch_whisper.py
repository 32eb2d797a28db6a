"""The port's Whisper (``pygpukit_tpu_torch.asr.whisper``) on tiny
transformers checkpoints written under tmp_path (the reference test's
config, tests/test_whisper.py; nothing is downloaded): against
transformers under the checkpoint's default "gelu" (the exact erf form),
and against the JAX package's functions under "gelu_new" (the tanh form,
the only one the reference computes) at rtol 1e-4.

Two faults of the reference are recorded beside the port's repair:
C.11, its features on the HTK mel scale (``test_whisper_features_follow_
transformers``), and C.12, its GELU always the tanh form
(``test_whisper_gelu_follows_activation_function``).
"""

import json
import types

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pygpukit_tpu.asr.whisper import WhisperModel as RefModel  # noqa: E402
from pygpukit_tpu.asr.whisper import model as ref_mod  # noqa: E402
from pygpukit_tpu_torch.asr.whisper import WhisperConfig, WhisperModel  # noqa: E402
from pygpukit_tpu_torch.asr.whisper import model as wm  # noqa: E402
from pygpukit_tpu_torch.llm.convert import params_from_jax  # noqa: E402
from pygpukit_tpu_torch.llm.safetensors import save_safetensors  # noqa: E402
from pygpukit_tpu_torch.ops.precision import f32_matmul_context  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
SOT, EOS = 2, 3


def _save(d, activation: str, decoder_scale: float = 1.0, fc1_scale: float = 1.0):
    """The reference test's tiny model (seed 0) under ``activation``, its
    decoder layers' and positions' weights times ``decoder_scale`` (10: a
    greedy stream that varies from token to token) and every fc1 weight
    times ``fc1_scale`` (pre-activations where the two GELU forms part)."""
    cfg = transformers.WhisperConfig(
        vocab_size=256, num_mel_bins=80, d_model=64, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=128,
        decoder_ffn_dim=128, max_source_positions=1500, max_target_positions=64,
        eos_token_id=EOS, decoder_start_token_id=SOT, pad_token_id=0,
        activation_function=activation)
    torch.manual_seed(0)
    m = transformers.WhisperForConditionalGeneration(cfg).eval()
    with torch.no_grad():
        for name, p in m.named_parameters():
            if (("decoder.layers" in name or "decoder.embed_positions" in name)
                    and "layer_norm" not in name):
                p.mul_(decoder_scale)
            if name.endswith("fc1.weight"):
                p.mul_(fc1_scale)
    m.save_pretrained(d, safe_serialization=True)
    return d, m


@pytest.fixture(scope="module")
def erf_ckpt(tmp_path_factory):
    return _save(tmp_path_factory.mktemp("whisper_erf"), "gelu", decoder_scale=10.0)


@pytest.fixture(scope="module")
def tanh_ckpt(tmp_path_factory):
    return _save(tmp_path_factory.mktemp("whisper_tanh"), "gelu_new", decoder_scale=10.0)


@pytest.fixture(scope="module")
def models(tanh_ckpt):
    """(the port's model on the CPU, the reference's) of the tanh checkpoint."""
    d, _ = tanh_ckpt
    return WhisperModel.from_safetensors(d, device="cpu"), RefModel.from_safetensors(d)


def _mel(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((3000, 80)).astype(np.float32)


def _audio(seed: int, n: int = 16000) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def _close(ours, ref, rtol=RTOL, atol=ATOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=rtol, atol=atol)


# ------------------------------------------------------------ transformers --

def test_encoder_matches_transformers(erf_ckpt):
    d, m = erf_ckpt
    model = WhisperModel.from_safetensors(d, device="cpu")
    mel = _mel(0)
    ours = model.encode(torch.from_numpy(mel))
    with torch.no_grad():
        ref = m.model.encoder(torch.tensor(mel.T[None])).last_hidden_state[0]
    _close(ours, ref.numpy())


@pytest.mark.parametrize("tokens", [[SOT], [SOT, 5, 9, 100], [SOT, 7, 200, 13, 13, 40, 3, 99]])
def test_decoder_logits_match_transformers(erf_ckpt, tokens):
    d, m = erf_ckpt
    model = WhisperModel.from_safetensors(d, device="cpu")
    mel = _mel(1)
    ours = model.decoder_logits(tokens, model.encode(torch.from_numpy(mel)))
    with torch.no_grad():
        enc = m.model.encoder(torch.tensor(mel.T[None]))
        ref = m(decoder_input_ids=torch.tensor([tokens]), encoder_outputs=enc).logits[0]
    assert ours.dtype == torch.float32
    _close(ours, ref.numpy(), atol=1e-4)


@pytest.mark.parametrize("seed", [2, 3])
def test_greedy_transcribe_matches_transformers_generate(erf_ckpt, seed):
    d, m = erf_ckpt
    model = WhisperModel.from_safetensors(d, device="cpu")
    audio = _audio(seed)
    mel = model.compute_mel(audio)
    ours = model.transcribe_tokens(audio, [SOT], max_new_tokens=12)
    with torch.no_grad():
        ref = m.generate(input_features=mel.T[None], max_new_tokens=12, do_sample=False,
                         suppress_tokens=None, begin_suppress_tokens=None)[0].tolist()
    body = [t for t in ref[1:] if t != EOS]
    assert len(set(body)) > 2 and ours[1:len(body) + 1] == body, (ours, ref)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_whisper_features_follow_transformers(n_mels):
    """C.11: the port's features are transformers' WhisperFeatureExtractor's
    (the Slaney mel scale) within 1e-3; the reference's compute_mel, on
    the HTK scale, differs by far more (about 0.66 on this input)."""
    cfg = WhisperConfig(n_mels=n_mels, d_model=16, encoder_layers=1, decoder_layers=1,
                        n_heads=2, vocab_size=8, ffn_dim=32)
    model = WhisperModel(cfg, wm.init_params(cfg, 0, device="cpu"))
    audio = _audio(11)
    fe = transformers.WhisperFeatureExtractor(feature_size=n_mels)
    want = fe(audio, sampling_rate=16000, return_tensors="np").input_features[0].T
    ours = model.compute_mel(audio)
    assert ours.shape == want.shape == (3000, n_mels)
    np.testing.assert_allclose(ours.numpy(), want, rtol=0, atol=1e-3)
    ref = RefModel.compute_mel(types.SimpleNamespace(config=cfg), audio)
    gap = float(np.abs(np.asarray(ref) - want).max())
    assert gap > 0.1, gap                              # the reference's divergence


def test_whisper_mel_filters_match_transformers():
    from transformers.audio_utils import mel_filter_bank
    for n_mels in (80, 128):
        want = mel_filter_bank(num_frequency_bins=201, num_mel_filters=n_mels,
                               min_frequency=0.0, max_frequency=8000.0, sampling_rate=16000,
                               norm="slaney", mel_scale="slaney")
        np.testing.assert_allclose(wm.whisper_mel_filters(n_mels), want.T.astype(np.float32),
                                   rtol=1e-6, atol=1e-9)


def test_whisper_gelu_follows_activation_function(tmp_path):
    """C.12: a checkpoint's default activation_function "gelu" is the erf
    form (transformers', OpenAI's). With fc1 weights scaled so that the
    pre-activations reach the region where the forms part, the port's
    encoder matches transformers' and the reference's, always tanh,
    does not."""
    d, m = _save(tmp_path / "c12", "gelu", fc1_scale=40.0)
    assert json.loads((d / "config.json").read_text())["activation_function"] == "gelu"
    mel = _mel(5)
    with torch.no_grad():
        want = m.model.encoder(torch.tensor(mel.T[None])).last_hidden_state[0].numpy()
    ours = WhisperModel.from_safetensors(d, device="cpu")
    assert not ours.config.gelu_tanh
    _close(ours.encode(torch.from_numpy(mel)), want, atol=1e-4)
    ref = np.asarray(RefModel.from_safetensors(d).encode(jnp.asarray(mel)))
    ours_gap = float(np.abs(ours.encode(torch.from_numpy(mel)).numpy() - want).max())
    ref_gap = float(np.abs(ref - want).max())
    assert ref_gap > 1e-4 and ref_gap > 20 * ours_gap, (ref_gap, ours_gap)


@pytest.mark.parametrize("name,tanh", [("gelu", False), ("gelu_new", True), ("gelu_fast", True),
                                       ("gelu_pytorch_tanh", True)])
def test_config_reads_activation_function(name, tanh):
    cfg = WhisperConfig.from_hf({"activation_function": name, "d_model": 64})
    assert cfg.gelu_tanh is tanh and cfg.d_model == 64
    assert not WhisperConfig.from_hf({}).gelu_tanh
    with pytest.raises(NotImplementedError):
        WhisperConfig.from_hf({"activation_function": "relu"})


# -------------------------------------------------------- the JAX package --

def test_encoder_fn_matches_the_reference(models):
    ours, ref = models
    mel = _mel(6)
    _close(wm.encoder_fn(ours.config, ours.params, torch.from_numpy(mel)),
           ref_mod.encoder_fn(ref.config, ref.params, jnp.asarray(mel)))


def test_decoder_fn_and_cross_kv_match_the_reference(models):
    ours, ref = models
    feats = np.array(ref.encode(jnp.asarray(_mel(7))))
    tokens = np.array([SOT, 17, 4, 250, 31], np.int32)
    _close(wm.decoder_fn(ours.config, ours.params, torch.from_numpy(tokens).long(),
                         torch.from_numpy(feats)),
           ref_mod.decoder_fn(ref.config, ref.params, jnp.asarray(tokens), jnp.asarray(feats)),
           atol=1e-4)
    for a, b in zip(wm.cross_kv_fn(ours.config, ours.params, torch.from_numpy(feats)),
                    ref_mod.cross_kv_fn(ref.config, ref.params, jnp.asarray(feats))):
        _close(a, b)


@pytest.mark.parametrize("max_len", [8, 24])
def test_decoder_step_fn_matches_the_reference(models, max_len):
    """Steps at positions 0.. along a token run: the caches (written in
    place on the port's side) and the logits; the position an int or a
    one-element int32 tensor."""
    ours, ref = models
    cfg = ours.config
    feats = np.array(ref.encode(jnp.asarray(_mel(8))))
    ck, cv = wm.cross_kv_fn(cfg, ours.params, torch.from_numpy(feats))
    rck, rcv = ref_mod.cross_kv_fn(ref.config, ref.params, jnp.asarray(feats))
    shape = (cfg.decoder_layers, max_len, cfg.d_model)
    k, v = torch.zeros(shape), torch.zeros(shape)
    rk, rv = jnp.zeros(shape), jnp.zeros(shape)
    for pos, tok in enumerate([SOT, 40, 41, 250, 7, 7]):
        p = pos if pos % 2 else torch.tensor([pos], dtype=torch.int32)
        k2, v2, logits = wm.decoder_step_fn(cfg, ours.params, k, v, ck, cv, tok, p)
        rk, rv, rl = ref_mod.decoder_step_fn(ref.config, ref.params, rk, rv, rck, rcv,
                                             jnp.int32(tok), jnp.int32(pos))
        assert k2 is k and v2 is v
        _close(logits, rl, atol=1e-4)
        _close(k, rk)
        _close(v, rv)


@pytest.mark.parametrize("sot,n_steps", [([SOT], 10), ([SOT, 50, 51, 52], 16), ([SOT, 9], 3)])
def test_greedy_decode_fn_matches_the_reference(models, sot, n_steps):
    ours, ref = models
    feats = np.array(ref.encode(jnp.asarray(_mel(9))))
    max_len = len(sot) + n_steps + 1
    prompt = np.zeros(max_len, np.int32)
    prompt[:len(sot)] = sot
    want = np.asarray(ref_mod.greedy_decode_fn(ref.config, n_steps, max_len, ref.params,
                                               jnp.asarray(feats), jnp.asarray(prompt),
                                               jnp.int32(len(sot))))
    got = wm.greedy_decode_fn(ours.config, n_steps, max_len, ours.params,
                              torch.from_numpy(feats), torch.from_numpy(prompt), len(sot))
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    assert len(set(want.tolist())) > 1


@pytest.mark.parametrize("seed", [12, 13])
def test_transcribe_tokens_matches_the_reference(models, seed):
    """The captured greedy step (on the CPU: its function on the bound
    state) against the reference's one executable; a second call reuses
    the program and gives the same tokens."""
    ours, ref = models
    audio = _audio(seed, 24000)
    want = ref.transcribe_tokens(audio, [SOT, 50], max_new_tokens=14)
    assert ours.transcribe_tokens(audio, [SOT, 50], max_new_tokens=14) == want
    assert ours.transcribe_tokens(audio, [SOT, 50], max_new_tokens=14) == want
    assert len(ours.graphs.executables()) >= 1


def test_transcribe_cuts_at_eos_as_the_reference(models, monkeypatch):
    ours, ref = models
    audio = _audio(14)
    stream = ref.transcribe_tokens(audio, [SOT], max_new_tokens=12)
    eos = stream[4]
    monkeypatch.setattr(ours.config, "eos_token_id", eos)
    monkeypatch.setattr(ref.config, "eos_token_id", eos)
    want = ref.transcribe_tokens(audio, [SOT], max_new_tokens=12)
    assert want == stream[:stream.index(eos)]
    assert ours.transcribe_tokens(audio, [SOT], max_new_tokens=12) == want


def test_transcribe_streaming_matches_the_reference(models):
    ours, ref = models
    rng = np.random.default_rng(3)
    chunks = [(rng.standard_normal(n) * 0.05).astype(np.float32) for n in (8000, 3000, 9000)]
    want = list(ref.transcribe_streaming(iter(chunks), [SOT], chunk_seconds=0.5))
    got = list(ours.transcribe_streaming(iter(chunks), [SOT], chunk_seconds=0.5))
    assert len(got) == 3 and got == want


def test_params_from_jax_gives_the_loaders_tree(models, tanh_ckpt):
    """The reference's params tree carried across byte for byte is the
    port loader's tree, leaf for leaf, and encodes to the same bits."""
    ours, ref = models
    tree = params_from_jax(jax.tree.map(np.asarray, ref.params))
    assert tree.keys() == ours.params.keys()
    for key in ("enc_layers", "dec_layers"):
        assert tree[key].keys() == ours.params[key].keys()
    flat = torch.utils._pytree.tree_leaves_with_path(tree)
    mine = dict(torch.utils._pytree.tree_leaves_with_path(ours.params))
    for path, leaf in flat:
        assert leaf.dtype == mine[path].dtype and torch.equal(leaf, mine[path]), path
    mel = torch.from_numpy(_mel(10))
    assert torch.equal(WhisperModel(ours.config, tree).encode(mel), ours.encode(mel))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hf_tensors_round_trip_without_the_prefix(models, tmp_path, dtype):
    """``hf_tensors`` writes the names ``from_safetensors`` reads (here
    without "model."), and the load gives the tree back in ``dtype``."""
    ours, _ = models
    save_safetensors(tmp_path / "model.safetensors", wm.hf_tensors(ours.params))
    (tmp_path / "config.json").write_text(json.dumps({
        "num_mel_bins": 80, "d_model": 64, "encoder_layers": 2, "decoder_layers": 2,
        "encoder_attention_heads": 4, "vocab_size": 256, "max_target_positions": 64,
        "eos_token_id": EOS, "decoder_start_token_id": SOT, "encoder_ffn_dim": 128,
        "activation_function": "gelu_new"}))
    back = WhisperModel.from_safetensors(tmp_path, dtype=dtype, device="cpu")
    assert back.config == ours.config
    for path, leaf in torch.utils._pytree.tree_leaves_with_path(ours.params):
        got = dict(torch.utils._pytree.tree_leaves_with_path(back.params))[path]
        assert got.dtype == dtype and torch.equal(got, leaf.to(dtype)), path
    assert "self.k.b" not in back.params["dec_layers"]


def test_init_params_has_the_loaders_layout(models):
    ours, _ = models
    fresh = wm.init_params(ours.config, 3, device="cpu")
    shapes = {p: tuple(t.shape) for p, t in torch.utils._pytree.tree_leaves_with_path(fresh)}
    assert shapes == {p: tuple(t.shape)
                      for p, t in torch.utils._pytree.tree_leaves_with_path(ours.params)}


# -------------------------------------------------------------- the rest --

@pytest.mark.parametrize("n,sr", [(16000, 16000), (0 + 1, 16000), (44100, 44100),
                                  (16000 * 31, 16000), (8000 * 35, 8000)])
def test_mel_shapes(models, n, sr):
    ours, _ = models
    mel = ours.compute_mel(np.zeros(n, np.float32) + 0.01, sr=sr)
    assert mel.shape == (3000, 80) and mel.device.type == "cpu" and torch.isfinite(mel).all()


def test_compute_mel_resamples_to_16k(models):
    ours, _ = models
    audio = _audio(15, 44100)
    from pygpukit_tpu_torch.ops.audio import resample
    want = ours.compute_mel(resample(torch.from_numpy(audio), 44100, 16000))
    assert torch.equal(ours.compute_mel(audio, sr=44100), want)


@pytest.mark.parametrize("allow", ["0", "1"])
def test_f32_matmul_context_turns_both_tf32_flags_off_and_back(monkeypatch, allow):
    """Both flags off inside for an all-f32 tree, both restored after; a
    tree with a bf16 or f16 leaf keeps them. PYGPUKIT_ALLOW_TF32, which
    the reference reads, changes nothing here (a recorded divergence)."""
    monkeypatch.setenv("PYGPUKIT_ALLOW_TF32", allow)
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32)
    try:
        mm.allow_tf32, cudnn.allow_tf32 = True, True
        f32 = {"a": torch.zeros(2),
               "b": {"c": torch.zeros(3), "n": torch.zeros(2, dtype=torch.int32)}}
        with f32_matmul_context(f32):
            assert (mm.allow_tf32, cudnn.allow_tf32) == (False, False)
        assert (mm.allow_tf32, cudnn.allow_tf32) == (True, True)
        with pytest.raises(ValueError):
            with f32_matmul_context(f32):
                raise ValueError
        assert (mm.allow_tf32, cudnn.allow_tf32) == (True, True)
        for low in (torch.bfloat16, torch.float16):
            with f32_matmul_context({"w": torch.zeros(2, dtype=low), "n": torch.zeros(2)}):
                assert (mm.allow_tf32, cudnn.allow_tf32) == (True, True)
        with f32_matmul_context({"n": torch.zeros(2, dtype=torch.int32)}):
            assert (mm.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved


def test_the_loader_defaults_to_the_card(tanh_ckpt, monkeypatch):
    d, _ = tanh_ckpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WhisperModel.from_safetensors(d)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wm.init_params(WhisperConfig(d_model=16, n_heads=2, ffn_dim=32, vocab_size=8), 0)


def test_exports():
    import pygpukit_tpu_torch.asr.whisper as w
    import pygpukit_tpu_torch.ops.precision as prec
    assert {"WhisperConfig", "WhisperModel"} <= set(w.__all__)
    assert callable(prec.f32_matmul_context)
