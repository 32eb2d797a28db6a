"""Whisper ASR: log-mel features -> encoder -> decoder with cross-attention
and a self-attention cache (counterpart of
``pygpukit_tpu/asr/whisper/model.py``).

Plain functions on tensors over a params dict loaded from a Hugging Face
checkpoint (openai/whisper-* names): the encoder runs once a 30 s window,
the decoder steps over a ``[L, MAX, E]`` f32 self-attention cache beside
cross-attention K/V computed once an utterance. The reference has no
Pallas kernel on this path, and neither has the port: attention is f32
products with an f32 softmax, the stem two f32 convolutions, every entry
point scoped by ``ops.precision.f32_matmul_context`` (TF32 off for an f32
model, cuBLAS and cuDNN alike).

- Params: the reference's tree. Stacked ``enc_layers`` / ``dec_layers``
  ``[L, ...]`` leaves named ``ln1.w``, ``self.q.w``, ``fc1.b`` ...,
  projections ``[in, out]`` (a checkpoint's ``k_proj`` has no bias), so
  ``llm.convert.params_from_jax`` carries the reference's tree across.
- The GELU follows the checkpoint's ``activation_function`` as
  transformers reads it: "gelu" (the default) is the exact erf form,
  "gelu_new", "gelu_fast" and "gelu_pytorch_tanh" the tanh form. The
  reference always takes the tanh form.
- Features (``compute_mel``): Whisper's log-mel on the Slaney mel scale
  (``whisper_mel_filters``), as transformers' ``WhisperFeatureExtractor``
  and OpenAI's Whisper compute them. The reference builds them on
  ``ops.audio.mel_filterbank``'s HTK scale, which stays as it is there.
- Greedy decoding (``transcribe_tokens``): the reference's semantics: the
  prompt consumed step by step, ``max_len - 1`` steps, the first
  ``n_steps`` real emissions (EOS included), the host cutting at EOS. On
  the card one step is captured (``core.capture``, the caches and the
  loop state donated) and replayed ``max_len - 1`` times back to back:
  the token, position and emissions live on the device, so no step reads
  the host. One program per (max_len, n_steps, features shape), as the
  reference keeps one executable per key.
"""

from __future__ import annotations

import functools
import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ...core.backend import resolve_device
from ...core.executable import ExecutableCache
from ...llm.models._standalone import random_normal
from ...llm.safetensors import load_safetensors
from ...ops.audio import resample, stft
from ...ops.audio.core import as_tensor, device_constant
from ...ops.nn.activation import gelu_fn
from ...ops.nn.norm import layernorm_fn
from ...ops.precision import f32_matmul_context

_F32 = torch.float32

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
CHUNK_SECONDS = 30

#: transformers' names of the GELU's two forms
_GELU_ERF = ("gelu",)
_GELU_TANH = ("gelu_new", "gelu_fast", "gelu_pytorch_tanh")


@dataclass
class WhisperConfig:
    n_mels: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    n_heads: int = 6
    vocab_size: int = 51865
    max_source_positions: int = 1500
    max_target_positions: int = 448
    eos_token_id: int = 50257
    sot_token_id: int = 50258
    ffn_dim: int = 1536
    activation_function: str = "gelu"

    def __post_init__(self):
        if self.activation_function not in _GELU_ERF + _GELU_TANH:
            raise NotImplementedError(
                f"activation_function {self.activation_function!r}: the port runs "
                f"{_GELU_ERF + _GELU_TANH}")

    @property
    def gelu_tanh(self) -> bool:
        """The tanh approximation (else the exact erf form)."""
        return self.activation_function in _GELU_TANH

    @classmethod
    def from_hf(cls, hf: dict) -> "WhisperConfig":
        return cls(
            n_mels=hf.get("num_mel_bins", 80),
            d_model=hf.get("d_model", 384),
            encoder_layers=hf.get("encoder_layers", 4),
            decoder_layers=hf.get("decoder_layers", 4),
            n_heads=hf.get("encoder_attention_heads", 6),
            vocab_size=hf.get("vocab_size", 51865),
            max_source_positions=hf.get("max_source_positions", 1500),
            max_target_positions=hf.get("max_target_positions", 448),
            eos_token_id=hf.get("eos_token_id", 50257),
            sot_token_id=hf.get("decoder_start_token_id", 50258),
            ffn_dim=hf.get("encoder_ffn_dim", 1536),
            activation_function=hf.get("activation_function", "gelu"),
        )


# ------------------------------------------------------------------ layers --

def _gelu(cfg: WhisperConfig, x: torch.Tensor) -> torch.Tensor:
    return gelu_fn(x, approximate=cfg.gelu_tanh)


def _layer(stacked: dict, i: int) -> dict:
    """Layer i's leaves of a stacked ``[L, ...]`` tree (views)."""
    return {k: v[i] for k, v in stacked.items()}


def _attn(q, k, v, n_heads: int, mask=None):
    """[S, E] x [T, E] multi-head attention, f32 scores and softmax; True
    in ``mask`` hides a key (-1e30); the output in q's dtype."""
    s, e = q.shape
    t = k.shape[0]
    d = e // n_heads
    qh = q.reshape(s, n_heads, d).transpose(0, 1).to(_F32)
    kh = k.reshape(t, n_heads, d).transpose(0, 1).to(_F32)
    vh = v.reshape(t, n_heads, d).transpose(0, 1).to(_F32)
    scores = torch.matmul(qh, kh.transpose(1, 2)) / math.sqrt(d)
    if mask is not None:
        scores = torch.where(mask, -1e30, scores)
    out = torch.matmul(torch.softmax(scores, dim=-1), vh)
    return out.transpose(0, 1).reshape(s, e).to(q.dtype)


def _linear(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b) as an f32 product, rounded to x's dtype."""
    out = torch.matmul(x.to(_F32), p[f"{name}.w"].to(_F32))
    if f"{name}.b" in p:
        out = out + p[f"{name}.b"].to(_F32)
    return out.to(x.dtype)


def _mha(p, prefix, x, kv, n_heads, mask=None):
    q = _linear(p, f"{prefix}.q", x)
    k = _linear(p, f"{prefix}.k", kv)
    v = _linear(p, f"{prefix}.v", kv)
    return _linear(p, f"{prefix}.out", _attn(q, k, v, n_heads, mask))


def _mlp(cfg: WhisperConfig, lp: dict, h: torch.Tensor) -> torch.Tensor:
    return _linear(lp, "fc2", _gelu(cfg, _linear(lp, "fc1", h)))


def encoder_fn(cfg: WhisperConfig, params: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel [frames, n_mels] -> audio features [frames / 2, E] (f32)."""
    x = mel.T[None].to(_F32)                                  # [1, n_mels, frames]
    x = F.conv1d(x, params["conv1.w"].to(_F32), padding=1)
    x = _gelu(cfg, x + params["conv1.b"].to(_F32)[None, :, None])
    x = F.conv1d(x, params["conv2.w"].to(_F32), stride=2, padding=1)
    x = _gelu(cfg, x + params["conv2.b"].to(_F32)[None, :, None])
    x = x[0].T                                                # [T, E]
    x = x + params["enc_pos"][:x.shape[0]]
    for i in range(params["enc_layers"]["ln1.w"].shape[0]):
        lp = _layer(params["enc_layers"], i)
        h = layernorm_fn(x, lp["ln1.w"], lp["ln1.b"])
        x = x + _mha(lp, "self", h, h, cfg.n_heads)
        x = x + _mlp(cfg, lp, layernorm_fn(x, lp["ln2.w"], lp["ln2.b"]))
    return layernorm_fn(x, params["enc_ln.w"], params["enc_ln.b"])


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """f32 logits against the tied token embedding."""
    return torch.matmul(x.to(_F32), params["tok_embed"].to(_F32).T)


def decoder_fn(cfg: WhisperConfig, params: dict, tokens: torch.Tensor,
               audio_features: torch.Tensor) -> torch.Tensor:
    """The uncached decoder: tokens [S] -> f32 logits [S, V]."""
    s = tokens.shape[0]
    x = params["tok_embed"][tokens] + params["dec_pos"][:s]
    i = torch.arange(s, device=x.device)
    causal = (i[None, :] > i[:, None])[None]
    for li in range(params["dec_layers"]["ln1.w"].shape[0]):
        lp = _layer(params["dec_layers"], li)
        h = layernorm_fn(x, lp["ln1.w"], lp["ln1.b"])
        x = x + _mha(lp, "self", h, h, cfg.n_heads, causal)
        h = layernorm_fn(x, lp["ln2.w"], lp["ln2.b"])
        x = x + _mha(lp, "cross", h, audio_features, cfg.n_heads)
        x = x + _mlp(cfg, lp, layernorm_fn(x, lp["ln3.w"], lp["ln3.b"]))
    return _head(params, layernorm_fn(x, params["dec_ln.w"], params["dec_ln.b"]))


def cross_kv_fn(cfg: WhisperConfig, params: dict, audio_features: torch.Tensor):
    """Each decoder layer's cross-attention K and V of the audio features,
    stacked [L, T_audio, E]: computed once an utterance."""
    layers = params["dec_layers"]
    n = layers["ln1.w"].shape[0]
    ks = [_linear(_layer(layers, i), "cross.k", audio_features) for i in range(n)]
    vs = [_linear(_layer(layers, i), "cross.v", audio_features) for i in range(n)]
    return torch.stack(ks), torch.stack(vs)


def _position(pos, device) -> torch.Tensor:
    """``pos`` (an int or a one-element device tensor) as a [1] int64 tensor."""
    return torch.as_tensor(pos, device=device).reshape(1).to(torch.int64)


def decoder_step_fn(cfg: WhisperConfig, params: dict, k_self: torch.Tensor,
                    v_self: torch.Tensor, cross_k: torch.Tensor, cross_v: torch.Tensor,
                    token, pos):
    """One cached decoder step at ``pos`` (an int or a one-element int32
    device tensor, never read on the host): row pos of each layer's
    ``[L, MAX, E]`` self cache written in place, keys past pos masked,
    cross-attention over the precomputed K/V. Returns (k_self, v_self,
    f32 logits [V]). Positions past the tables clamp, as the reference's
    dynamic slices do."""
    e, n_heads = cfg.d_model, cfg.n_heads
    d = e // n_heads
    dev = k_self.device
    max_len = k_self.shape[1]
    p = _position(pos, dev)
    tok = torch.as_tensor(token, device=dev).reshape(1).to(torch.int64)
    x = (params["tok_embed"].index_select(0, tok)
         + params["dec_pos"].index_select(0, p.clamp(0, params["dec_pos"].shape[0] - 1)))
    row = p.clamp(0, max_len - 1)
    hidden = (torch.arange(max_len, device=dev) > p)[None, None, :]
    layers = params["dec_layers"]
    for i in range(layers["ln1.w"].shape[0]):
        lp = _layer(layers, i)
        h = layernorm_fn(x, lp["ln1.w"], lp["ln1.b"])
        q = _linear(lp, "self.q", h)
        k_self[i].index_copy_(0, row, _linear(lp, "self.k", h).to(k_self.dtype))
        v_self[i].index_copy_(0, row, _linear(lp, "self.v", h).to(v_self.dtype))
        qh = q.reshape(1, n_heads, d).transpose(0, 1).to(_F32)
        kh = k_self[i].reshape(max_len, n_heads, d).transpose(0, 1).to(_F32)
        vh = v_self[i].reshape(max_len, n_heads, d).transpose(0, 1).to(_F32)
        scores = torch.matmul(qh, kh.transpose(1, 2)) / math.sqrt(d)
        scores = torch.where(hidden, -1e30, scores)
        att = torch.matmul(torch.softmax(scores, dim=-1), vh)
        att = att.transpose(0, 1).reshape(1, e).to(x.dtype)
        x = x + _linear(lp, "self.out", att)
        h = layernorm_fn(x, lp["ln2.w"], lp["ln2.b"])
        q2 = _linear(lp, "cross.q", h)
        x = x + _linear(lp, "cross.out", _attn(q2, cross_k[i], cross_v[i], n_heads))
        x = x + _mlp(cfg, lp, layernorm_fn(x, lp["ln3.w"], lp["ln3.b"]))
    x = layernorm_fn(x, params["dec_ln.w"], params["dec_ln.b"])
    return k_self, v_self, _head(params, x[0])


# ------------------------------------------------------------------ greedy --

def greedy_state(cfg: WhisperConfig, params: dict, audio_features: torch.Tensor,
                 max_len: int) -> dict:
    """The greedy loop's device state: zeroed f32 self caches [L, max_len,
    E], the cross K/V buffers [L, T, E] and the loop's token, position,
    prompt and emissions (int32)."""
    dev = audio_features.device
    n, (t, e) = params["dec_layers"]["ln1.w"].shape[0], audio_features.shape

    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)
    return {"k": torch.zeros((n, max_len, e), dtype=_F32, device=dev),
            "v": torch.zeros((n, max_len, e), dtype=_F32, device=dev),
            "ck": torch.empty((n, t, e), dtype=audio_features.dtype, device=dev),
            "cv": torch.empty((n, t, e), dtype=audio_features.dtype, device=dev),
            "cur": i32(1), "pos": i32(1), "prompt": i32(max_len), "prompt_len": i32(1),
            "emits": i32(max_len - 1)}


def greedy_reset(cfg: WhisperConfig, params: dict, st: dict, audio_features: torch.Tensor,
                 prompt: list[int]) -> None:
    """``st`` set in place for a new utterance: caches zeroed, the cross
    K/V of ``audio_features`` written, the prompt loaded, position 0."""
    ck, cv = cross_kv_fn(cfg, params, audio_features)
    st["ck"].copy_(ck)
    st["cv"].copy_(cv)
    st["k"].zero_()
    st["v"].zero_()
    host = torch.zeros(st["prompt"].shape, dtype=torch.int32)
    host[:len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
    st["prompt"].copy_(host)
    st["prompt_len"].fill_(len(prompt))
    st["cur"].fill_(prompt[0])
    st["pos"].zero_()
    st["emits"].fill_(-1)


def greedy_step(cfg: WhisperConfig, params: dict, st: dict) -> torch.Tensor:
    """One step of the greedy loop on ``st`` in place: the cached step at
    st["pos"], then the next input (the prompt's next token while the
    prompt lasts, else the argmax) and this step's emission (-1 inside the
    prompt, else the argmax); the position advances. Returns the logits."""
    i = st["pos"]
    _, _, logits = decoder_step_fn(cfg, params, st["k"], st["v"], st["ck"], st["cv"],
                                   st["cur"], i)
    max_len = st["prompt"].shape[0]
    pred = torch.argmax(logits).to(torch.int32).reshape(1)
    in_prompt = i + 1 < st["prompt_len"]
    nxt = torch.where(in_prompt, st["prompt"][torch.clamp_max(i + 1, max_len - 1)], pred)
    # a step past the loop's last (none in the loop) rewrites the last slot
    slot = torch.clamp_max(i, max_len - 2).to(torch.int64)
    st["emits"].index_copy_(0, slot, torch.where(in_prompt, -1, pred))
    st["cur"].copy_(nxt)
    st["pos"].add_(1)
    return logits


def first_emissions(emits: torch.Tensor, n_steps: int) -> torch.Tensor:
    """The first ``n_steps`` real emissions (those >= 0), in order, zeros
    past the last one."""
    is_real = (emits >= 0).to(torch.int32)
    order = torch.argsort(-is_real, stable=True)
    return torch.where(emits >= 0, emits, 0)[order][:n_steps]


def greedy_decode_fn(cfg: WhisperConfig, n_steps: int, max_len: int, params: dict,
                     audio_features: torch.Tensor, prompt, prompt_len) -> torch.Tensor:
    """Greedy decoding with the cached step, eagerly: the first
    ``prompt_len`` tokens of ``prompt`` consumed step by step, then new
    tokens, ``max_len - 1`` steps in all; the first ``n_steps`` emissions
    (int32). The model's ``transcribe_tokens`` replays a captured
    ``greedy_step`` instead."""
    st = greedy_state(cfg, params, audio_features, max_len)
    prompt = torch.as_tensor(prompt).reshape(-1)[:int(prompt_len)]
    greedy_reset(cfg, params, st, audio_features, [int(t) for t in prompt.tolist()])
    for _ in range(max_len - 1):
        greedy_step(cfg, params, st)
    return first_emissions(st["emits"], n_steps)


# ---------------------------------------------------------------- features --

def _hz_to_mel(f):
    """The Slaney mel scale (transformers' and librosa's default for Whisper):
    linear to 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) * (27.0 / np.log(6.4))
    return np.where(f >= 1000.0, log, 3.0 * f / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                    200.0 * m / 3.0)


@functools.lru_cache(maxsize=8)
def whisper_mel_filters(n_mels: int, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """Whisper's filterbank [n_mels, n_fft//2+1]: triangles evenly spaced
    on the Slaney mel scale from 0 to sr/2, Slaney area normalisation
    (transformers' ``mel_filter_bank(norm="slaney", mel_scale="slaney")``);
    f64 on the host, then f32."""
    fft_freqs = np.linspace(0, sr // 2, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2), n_mels + 2))
    diff = np.diff(hz)
    slopes = hz[None, :] - fft_freqs[:, None]                  # [bins, n_mels + 2]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up)) * (2.0 / (hz[2:] - hz[:-2]))
    return fb.T.astype(np.float32)


def whisper_log_mel(x: torch.Tensor, n_mels: int) -> torch.Tensor:
    """Whisper's features of 16 kHz samples: the power STFT (Hann 400, hop
    160, centred), the last frame dropped, the Slaney mel bank, log10
    floored at 1e-10, clamped to 8 below the maximum, (x + 4) / 4 ->
    [frames, n_mels]."""
    spec = torch.abs(stft(x, N_FFT, HOP)[:-1]) ** 2
    fb = device_constant(whisper_mel_filters, n_mels, device=spec.device)
    logm = torch.log10(torch.clamp_min(spec @ fb.T, 1e-10))
    logm = torch.maximum(logm, logm.max() - 8.0)
    return (logm + 4.0) / 4.0


# -------------------------------------------------------------- checkpoint --

#: a layer's leaves -> their Hugging Face names under ``{encoder,decoder}.
#: layers.{i}.``; ".w" leaves of the projections are transposed
_ATTN = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "out": "out_proj"}
_ENC_LAYER = {"ln1": "self_attn_layer_norm", "ln2": "final_layer_norm",
              **{f"self.{k}": f"self_attn.{v}" for k, v in _ATTN.items()},
              "fc1": "fc1", "fc2": "fc2"}
_DEC_LAYER = {"ln1": "self_attn_layer_norm", "ln2": "encoder_attn_layer_norm",
              "ln3": "final_layer_norm",
              **{f"self.{k}": f"self_attn.{v}" for k, v in _ATTN.items()},
              **{f"cross.{k}": f"encoder_attn.{v}" for k, v in _ATTN.items()},
              "fc1": "fc1", "fc2": "fc2"}
_TOP = {"conv1.w": "encoder.conv1.weight", "conv1.b": "encoder.conv1.bias",
        "conv2.w": "encoder.conv2.weight", "conv2.b": "encoder.conv2.bias",
        "enc_pos": "encoder.embed_positions.weight",
        "enc_ln.w": "encoder.layer_norm.weight", "enc_ln.b": "encoder.layer_norm.bias",
        "tok_embed": "decoder.embed_tokens.weight",
        "dec_pos": "decoder.embed_positions.weight",
        "dec_ln.w": "decoder.layer_norm.weight", "dec_ln.b": "decoder.layer_norm.bias"}
_STACKS = (("enc_layers", "encoder", _ENC_LAYER), ("dec_layers", "decoder", _DEC_LAYER))


def _layer_leaves(spec: dict):
    """(leaf, Hugging Face suffix, transposed) of one layer."""
    for key, hf in spec.items():
        yield f"{key}.w", f"{hf}.weight", not key.startswith("ln")
        yield f"{key}.b", f"{hf}.bias", False


def hf_tensors(params: dict) -> dict:
    """``params`` under their Hugging Face names ("model." prefix omitted),
    projections back to [out, in]: what ``from_safetensors`` reads."""
    out = {hf: params[key] for key, hf in _TOP.items()}
    for stack, side, spec in _STACKS:
        layers = params[stack]
        for key, hf, transposed in _layer_leaves(spec):
            if key in layers:
                for i in range(layers[key].shape[0]):
                    t = layers[key][i]
                    out[f"{side}.layers.{i}.{hf}"] = t.T.contiguous() if transposed else t
    return out


def init_params(cfg: WhisperConfig, seed: int, dtype=torch.float32, device=None) -> dict:
    """Random params of ``cfg`` drawn on ``device`` (the card unless named)
    from ``seed``: every matrix, bias and position std 0.02 normal, the
    LayerNorm weights 1 plus that; no ``self.k.b`` (Whisper's k_proj has no
    bias)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    e, f = cfg.d_model, cfg.ffn_dim

    def rnd(*shape):
        return random_normal(shape, g, dtype)

    def norm(*shape):
        return (1.0 + random_normal(shape, g, _F32)).to(dtype)
    p = {"conv1.w": rnd(e, cfg.n_mels, 3), "conv1.b": rnd(e), "conv2.w": rnd(e, e, 3),
         "conv2.b": rnd(e), "enc_pos": rnd(cfg.max_source_positions, e),
         "enc_ln.w": norm(e), "enc_ln.b": rnd(e), "tok_embed": rnd(cfg.vocab_size, e),
         "dec_pos": rnd(cfg.max_target_positions, e), "dec_ln.w": norm(e),
         "dec_ln.b": rnd(e)}
    shapes = {"fc1": (e, f), "fc2": (f, e)}
    for stack, n, spec in (("enc_layers", cfg.encoder_layers, _ENC_LAYER),
                           ("dec_layers", cfg.decoder_layers, _DEC_LAYER)):
        layers = {}
        for key in spec:
            if key.startswith("ln"):
                layers[f"{key}.w"], layers[f"{key}.b"] = norm(n, e), rnd(n, e)
                continue
            k_in, k_out = shapes.get(key, (e, e))
            layers[f"{key}.w"] = rnd(n, k_in, k_out)
            if not key.endswith(".k"):
                layers[f"{key}.b"] = rnd(n, k_out)
        p[stack] = layers
    return p


# ------------------------------------------------------------------- model --

class WhisperModel:
    """Whisper on one device: its params, the captured greedy programs
    (``graphs``) and their loop states."""

    def __init__(self, config: WhisperConfig, params: dict, dtype=torch.float32):
        self.config = config
        self.params = params
        self.dtype = dtype
        self.device = params["tok_embed"].device
        self.graphs = ExecutableCache(shared_pool=True)
        self._greedy_states: dict = {}

    # -- loading -------------------------------------------------------------

    @classmethod
    def from_safetensors(cls, path, dtype=torch.float32, device=None) -> "WhisperModel":
        """A Hugging Face Whisper checkpoint (a file, a directory or an
        index; names with or without "model.") and its config.json, on
        ``device`` (the card unless named) in ``dtype``: each tensor copied
        in its file dtype, then converted and transposed on the device,
        the layers written into their stacks one at a time."""
        dev = resolve_device(device)
        p = Path(path)
        cj = (p if p.is_dir() else p.parent) / "config.json"
        cfg = WhisperConfig.from_hf(json.loads(cj.read_text()) if cj.exists() else {})
        with load_safetensors(path) as st:
            pre = "model." if "model.encoder.conv1.weight" in st else ""

            def t(name: str, transposed: bool = False) -> torch.Tensor:
                x = st.tensor(pre + name).to(dev, copy=True).to(dtype)
                return x.T if transposed else x
            params = {key: t(hf) for key, hf in _TOP.items()}
            for stack, side, spec in _STACKS:
                n = cfg.encoder_layers if side == "encoder" else cfg.decoder_layers
                layers = {}
                for key, hf, transposed in _layer_leaves(spec):
                    if pre + f"{side}.layers.0.{hf}" not in st:
                        continue                     # k_proj's bias
                    first = t(f"{side}.layers.0.{hf}", transposed)
                    buf = torch.empty((n, *first.shape), dtype=dtype, device=dev)
                    buf[0] = first
                    for i in range(1, n):
                        buf[i] = t(f"{side}.layers.{i}.{hf}", transposed)
                    layers[key] = buf
                params[stack] = layers
        return cls(cfg, params, dtype)

    # -- inference -----------------------------------------------------------

    def _prec(self):
        return f32_matmul_context(self.params)

    def compute_mel(self, audio, sr: int = SAMPLE_RATE) -> torch.Tensor:
        """Whisper's features [3000, n_mels] of ``audio`` (numpy on the
        model's device, a tensor on its own) padded or trimmed to 30 s,
        resampled to 16 kHz first where ``sr`` differs."""
        x = as_tensor(audio, self.device).to(_F32)
        if sr != SAMPLE_RATE:
            x = resample(x, sr, SAMPLE_RATE)
        target = SAMPLE_RATE * CHUNK_SECONDS
        n = x.shape[0]
        x = x[:target] if n >= target else F.pad(x, (0, target - n))
        with self._prec():
            return whisper_log_mel(x, self.config.n_mels)

    def encode(self, mel) -> torch.Tensor:
        with self._prec():
            return encoder_fn(self.config, self.params, as_tensor(mel, self.device).to(self.device))

    def decoder_logits(self, tokens, audio_features) -> torch.Tensor:
        tok = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
        with self._prec():
            return decoder_fn(self.config, self.params, tok, audio_features.to(self.device))

    def greedy_tokens(self, audio_features: torch.Tensor, sot_sequence: list[int],
                      max_len: int, n_steps: int) -> torch.Tensor:
        """``greedy_decode_fn``'s tokens by the captured step: the loop
        state reset in place, then ``max_len - 1`` replays back to back."""
        cfg = self.config
        key = (max_len, n_steps, tuple(audio_features.shape))
        st = self._greedy_states.get(key)
        if st is None:
            st = self._greedy_states[key] = greedy_state(cfg, self.params, audio_features,
                                                         max_len)
        with self._prec():
            greedy_reset(cfg, self.params, st, audio_features, sot_sequence)
            exe = self.graphs.get_or_capture(
                key, functools.partial(greedy_step, cfg), self.params, st,
                donate_argnums=(1,), bound_argnums=(0,), name=f"whisper_greedy_{max_len}")
            for _ in range(max_len - 1):
                exe.replay(self.params, st)
        return first_emissions(st["emits"], n_steps)

    def transcribe_tokens(self, audio, sot_sequence: list[int], max_new_tokens: int = 64,
                          sr: int = SAMPLE_RATE) -> list[int]:
        """Greedy token transcription given the SOT prompt sequence, cut at
        the first EOS."""
        feats = self.encode(self.compute_mel(audio, sr))
        max_new_tokens = min(max_new_tokens,
                             self.config.max_target_positions - len(sot_sequence) - 1)
        max_len = len(sot_sequence) + max_new_tokens + 1
        out = []
        for tk in self.greedy_tokens(feats, sot_sequence, max_len, max_new_tokens).tolist():
            if tk == self.config.eos_token_id:
                break
            out.append(int(tk))
        return out

    def transcribe_streaming(self, audio_iter, sot_sequence: list[int],
                             chunk_seconds: float = 5.0, sr: int = SAMPLE_RATE):
        """Streaming transcription: audio accumulates and each completed
        window (at most the 30 s context) yields its tokens and is
        consumed; the last partial window is flushed once."""
        window = min(int(sr * chunk_seconds), SAMPLE_RATE * CHUNK_SECONDS)
        buf = np.zeros((0,), np.float32)
        for chunk in audio_iter:
            buf = np.concatenate([buf, np.asarray(chunk, np.float32)])
            while len(buf) >= window:
                yield self.transcribe_tokens(buf[:window], sot_sequence, sr=sr)
                buf = buf[window:]
        if len(buf):
            yield self.transcribe_tokens(buf, sot_sequence, sr=sr)
