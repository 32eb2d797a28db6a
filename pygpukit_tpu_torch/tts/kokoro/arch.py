"""Kokoro-82M (the StyleTTS2 inference stack) as functions on tensors over
a params tree (counterpart of ``pygpukit_tpu/tts/kokoro/arch.py``).

Components (Kokoro-82M's dims, ``checkpoint.KokoroDims``): the ALBERT
text encoder (12 shared layers), ``bert_encoder``, the prosody predictor
(duration encoder, duration biLSTM and head, the shared biLSTM, the F0/N
branches of ``adain_resblk1d``), the text encoder (convs, channel
LayerNorm, biLSTM) and the iSTFTNet decoder with its hn-NSF generator
(sine source, STFT of the harmonic, noise convs, ConvTranspose ups,
snake AdaIN resblocks, iSTFT). The tree is ``checkpoint.load_params``'s:
linear weights [in, out], convs in torch [O, I/g, K] layout.

The reference has no Pallas kernel on this path, and neither has the
port: f32 products, ``torch.nn.functional`` convolutions, the LSTMs a
step loop (``ops.nn.recurrent``), ``torch.fft``. Callers scope a forward
with ``ops.precision.f32_matmul_context`` (TF32 off for cuBLAS and
cuDNN). Everything has static shapes for a given (phonemes, frame
budget), so one forward captures as one CUDA graph: the durations become
an alignment index built on the device (``alignment_index``), masked past
the true frame count, with no host read.

- **The sine source's draws.** The reference draws ``rand_ini`` (uniform
  [9]) and the noise (normal [samples, 9]) from ``jax.random``; a torch
  generator cannot repeat those bits. So ``sine_source`` and everything
  above it take the two draws as tensors (``draws``), and ``sine_draws``
  makes them from a ``torch.Generator``.
- **The downsampling (ROADMAP C.13).** ``sine_source`` resamples the
  harmonics' phase increments down to frame rate and the phase back up
  with ``F.interpolate(mode="linear", align_corners=False)``, the formula
  the reference's docstring names (upstream istftnet.py's ``SineGen``).
  The reference's ``jax.image.resize`` antialiases when it downsamples (a
  600-tap triangle at 300x), so its harmonic source differs; the port
  follows the stated formula.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...core.numerics import true_div
from ...ops.audio import hann_window
from ...ops.audio.core import _overlap_add
from ...ops.nn.recurrent import lstm_fn

_F32 = torch.float32


# ---------------------------------------------------------------- primitives

def linear(x, p):
    """x [..., in] @ p["w"] [in, out] + p["b"]."""
    y = x @ p["w"]
    return y + p["b"] if p.get("b") is not None else y


def _var_mean(x):
    """(variance, mean) over the last dim, the population variance."""
    return torch.var_mean(x, dim=-1, keepdim=True, correction=0)


def layer_norm(x, w, b, eps=1e-12):
    var, mu = _var_mean(x)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def conv1d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    """torch-layout conv1d: x [N,C,W], w [O,I/g,K]."""
    return F.conv1d(x, w, b, stride, padding, dilation, groups)


def conv_transpose1d(x, w, b=None, stride=1, padding=0, output_padding=0,
                     groups=1):
    """torch ConvTranspose1d: x [N,C,W], w [I, O/g, K]."""
    return F.conv_transpose1d(x, w, b, stride, padding, output_padding, groups)


def leaky_relu(x, slope):
    return F.leaky_relu(x, slope)


def gelu_new(x):
    return F.gelu(x, approximate="tanh")


def gelu_exact(x):
    return F.gelu(x)


def lstm_cell_scan(x, p, reverse=False):
    """Unidirectional LSTM over x [S, I] with torch gate order (i,f,g,o).
    p: w_ih [4H, I], w_hh [4H, H], b_ih, b_hh [4H]."""
    out, _ = lstm_fn(x[:, None, :], p["w_ih"], p["w_hh"], p["b_ih"], p["b_hh"],
                     reverse=reverse)
    return out[:, 0]


def bilstm(x, p):
    """x [S, I] -> [S, 2H]; p keys: fwd{w_ih,...}, bwd{w_ih,...}."""
    fwd = lstm_cell_scan(x, p["fwd"])
    bwd = lstm_cell_scan(x, p["bwd"], reverse=True)
    return torch.cat([fwd, bwd], dim=-1)


def instance_norm(x, eps=1e-5):
    """Non-affine instance norm over W: x [N, C, W]."""
    var, mu = _var_mean(x)
    return (x - mu) * torch.rsqrt(var + eps)


def ada_in(x, s, p):
    """AdaIN1d: x [N,C,W], s [N,S]; p["fc"] -> [N, 2C]."""
    gamma, beta = linear(s, p["fc"]).chunk(2, dim=-1)
    return (1 + gamma[:, :, None]) * instance_norm(x) + beta[:, :, None]


def ada_layer_norm(x, s, p, eps=1e-5):
    """AdaLayerNorm: x [..., C], s [S_dim]; non-affine LN then styled."""
    gamma, beta = linear(s, p["fc"]).chunk(2, dim=-1)
    var, mu = _var_mean(x)
    return (1 + gamma) * ((x - mu) * torch.rsqrt(var + eps)) + beta


# ------------------------------------------------------------------- ALBERT

def albert_forward(ids, p, *, n_layers=12, n_heads=12, act="gelu_new"):
    """ids [S] -> [S, hidden]. Checkpoint-shaped param dict (see docstring)."""
    s = ids.shape[0]
    x = p["word_emb"][ids] + p["pos_emb"][:s] + p["type_emb"][0]
    x = layer_norm(x, p["emb_ln_w"], p["emb_ln_b"])
    x = linear(x, p["map"])                                # 128 -> 768
    hidden = x.shape[-1]
    d = hidden // n_heads
    act_fn = gelu_new if act == "gelu_new" else gelu_exact

    def heads(y):
        return y.reshape(s, n_heads, d).transpose(0, 1)     # [h, S, d]

    for _ in range(n_layers):
        q, k, v = heads(linear(x, p["q"])), heads(linear(x, p["k"])), heads(linear(x, p["v"]))
        scores = (q @ k.transpose(1, 2)) / math.sqrt(d)
        attn = (torch.softmax(scores, dim=-1) @ v).transpose(0, 1).reshape(s, hidden)
        x = layer_norm(x + linear(attn, p["dense"]), p["attn_ln_w"], p["attn_ln_b"])
        f = linear(act_fn(linear(x, p["ffn"])), p["ffn_out"])
        x = layer_norm(x + f, p["full_ln_w"], p["full_ln_b"])
    return x


# ------------------------------------------------------------- text encoder

def text_encoder_forward(ids, p):
    """StyleTTS2 TextEncoder: ids [S] -> [1, 512, S]."""
    x = p["emb"][ids].T[None]                              # [1, 512, S]
    for cnn in p["cnn"]:
        x = conv1d(x, cnn["w"], cnn["b"], padding=(cnn["w"].shape[-1] - 1) // 2)
        # channel LayerNorm (StyleTTS2 LayerNorm: over C with gamma/beta)
        xt = layer_norm(x.transpose(1, 2), cnn["gamma"], cnn["beta"], eps=1e-5)
        x = leaky_relu(xt.transpose(1, 2), 0.2)
    return bilstm(x[0].T, p["lstm"]).T[None]               # [1, 512, S]


# --------------------------------------------------------- prosody predictor

def duration_encoder_forward(d_en, style, p):
    """DurationEncoder: d_en [1, 512, S], style [128] -> [1, S, 640]."""
    s_len = d_en.shape[-1]
    sty = style.expand(s_len, style.shape[0])              # [S, 128]
    x = torch.cat([d_en[0].T, sty], dim=-1)                # [S, 640]
    for block in p["blocks"]:
        x = bilstm(x, block["lstm"])                       # [S, 512]
        x = ada_layer_norm(x, style, block["aln"])         # [S, 512]
        x = torch.cat([x, sty], dim=-1)                    # [S, 640]
    return x[None]                                         # [1, S, 640]


def adain_resblk1d(x, s, p, *, upsample=False):
    """istftnet.py AdainResBlk1d. x [N,C,W], s [N,S]."""
    h = leaky_relu(ada_in(x, s, p["norm1"]), 0.2)
    if upsample:
        h = conv_transpose1d(h, p["pool_w"], p["pool_b"], stride=2, padding=1,
                             output_padding=1, groups=h.shape[1])
    h = conv1d(h, p["conv1_w"], p["conv1_b"], padding=1)
    h = leaky_relu(ada_in(h, s, p["norm2"]), 0.2)
    h = conv1d(h, p["conv2_w"], p["conv2_b"], padding=1)
    if upsample:                                           # nearest 2x
        x = x.repeat_interleave(2, dim=-1)
    if "sc_w" in p:
        x = conv1d(x, p["sc_w"], None)
    return (h + x) / math.sqrt(2.0)


def f0n_train(en, style, p):
    """F0Ntrain: en [1, 640, T] -> (F0 [1, 2T], N [1, 2T])."""
    x = bilstm(en[0].T, p["shared"]).T[None]               # [1, 512, T]
    s = style[None]

    def branch(bp):
        h = adain_resblk1d(x, s, bp["blocks"][0])
        h = adain_resblk1d(h, s, bp["blocks"][1], upsample=True)
        h = adain_resblk1d(h, s, bp["blocks"][2])
        return conv1d(h, bp["proj_w"], bp["proj_b"])[:, 0]  # [1, 2T]

    return branch(p["F0"]), branch(p["N"])


def predict_durations(d_en, style, p, speed):
    """-> (d [1, S, 640], durations [S] float). ``speed`` a float or a
    tensor (divided as an IEEE division on every device)."""
    d = duration_encoder_forward(d_en, style, p["text_encoder"])
    x = bilstm(d[0], p["lstm"])                            # [S, 512]
    dur = torch.sigmoid(linear(x, p["duration_proj"])).sum(dim=-1)  # [S]
    return d, (dur / speed if torch.is_tensor(speed) else true_div(dur, speed))


def alignment_index(frames: torch.Tensor, total: int) -> torch.Tensor:
    """``jnp.repeat(arange(S), frames, total_repeat_length=total)`` on the
    device with no host read: frame t belongs to the token whose
    cumulative duration first exceeds t (the last token past the sum)."""
    ends = torch.cumsum(frames, dim=0)
    t = torch.arange(total, device=frames.device, dtype=ends.dtype)
    return torch.searchsorted(ends, t, right=True).clamp_(max=frames.shape[0] - 1)


# ----------------------------------------------------------------- vocoder

def _stft_mag_phase(x, n_fft, hop):
    """torch.stft(center=True, hann) magnitudes+phase: x [T] -> ([bins,F],)"""
    pad = n_fft // 2
    xp = F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = xp.unfold(0, n_fft, hop) * hann_window(n_fft, x.device)
    spec = torch.fft.rfft(frames, dim=-1)                  # [F, bins]
    return spec.abs().T, torch.angle(spec).T               # [bins, F]


def _istft(mag, phase, n_fft, hop, length=None):
    """torch.istft(center=True): mag/phase [bins, F] -> [T]; the overlap-add
    by ``F.fold`` (a fixed order on every device)."""
    w = hann_window(n_fft, mag.device)                     # periodic Hann
    frames = torch.fft.irfft(torch.polar(mag, phase).T, n=n_fft, dim=-1) * w
    n_frames = frames.shape[0]
    out_len = n_fft + hop * (n_frames - 1)
    sig = _overlap_add(frames, hop)
    wsq = _overlap_add((w * w).expand(n_frames, n_fft), hop)
    sig = (sig / torch.clamp_min(wsq, 1e-11))[n_fft // 2:out_len - n_fft // 2]
    return sig if length is None else sig[:length]


def sine_draws(n: int, generator: torch.Generator, harmonic_num: int = 8):
    """The sine source's two draws on the generator's device: ``rand_ini``
    uniform [harmonic_num + 1] and the noise normal [n, harmonic_num + 1]
    (the reference's two ``jax.random`` draws, from a torch generator)."""
    dev = generator.device
    return (torch.rand(harmonic_num + 1, generator=generator, device=dev),
            torch.randn(n, harmonic_num + 1, generator=generator, device=dev))


def _interp(x, size):
    """Linear resampling along dim 0 of x [n, c] to ``size`` rows
    (``F.interpolate(mode="linear", align_corners=False)``, no antialias)."""
    return F.interpolate(x.T[None], size=size, mode="linear", align_corners=False)[0].T


def sine_source(f0_up, p, draws, *, sampling_rate=24000, upsample_scale=300,
                harmonic_num=8, sine_amp=0.1, noise_std=0.003,
                voiced_threshold=10.0):
    """SourceModuleHnNSF: f0_up [samples] -> harmonic source [samples].

    SineGen with the interpolated-phase formulation (istftnet.py SineGen):
    per-harmonic rad values are linearly downsampled by ``upsample_scale``,
    cumulatively summed at frame rate, then the phase is linearly upsampled
    back, both by ``F.interpolate(mode="linear", align_corners=False)``
    (module docstring, C.13). ``draws`` = (rand_ini [harmonic_num + 1],
    whose first entry is ignored, noise [samples, harmonic_num + 1]).
    """
    rand_ini, noise = draws
    n = f0_up.shape[0]
    harmonics = torch.arange(1, harmonic_num + 2, dtype=_F32, device=f0_up.device)
    fn = f0_up[:, None] * harmonics[None, :]               # [n, 9]
    rad = true_div(fn, float(sampling_rate)) % 1.0
    rad[0, 1:] += rand_ini[1:]                             # rand_ini[0] is 0
    frames = n // upsample_scale
    rad_ds = _interp(rad, frames)
    phase = torch.cumsum(rad_ds, dim=0) * (2 * math.pi)
    phase_up = true_div(_interp(phase * upsample_scale, n), float(upsample_scale))
    sines = torch.sin(phase_up * upsample_scale)
    uv = (f0_up > voiced_threshold).to(_F32)[:, None]
    sine_waves = sines * sine_amp
    noise_amp = uv * noise_std + (1 - uv) * (sine_amp / 3)
    sine_waves = sine_waves * uv + noise_amp * noise
    return torch.tanh(linear(sine_waves, p["l_linear"]))[:, 0]  # [n]


def generator_forward(x, s, f0, p, draws, *, n_fft=20, hop=5,
                      upsample_rates=(10, 6), num_kernels=3):
    """iSTFTNet generator: x [1, 512, 2T], s [1,128], f0 [1, 2T] -> audio."""
    upsample_scale = int(np.prod(upsample_rates)) * hop    # 300
    f0_up = f0[0].repeat_interleave(upsample_scale)        # nearest
    har = sine_source(f0_up, p["m_source"], draws, upsample_scale=upsample_scale)
    har_spec, har_phase = _stft_mag_phase(har, n_fft, hop)
    har_cat = torch.cat([har_spec, har_phase], dim=0)[None]  # [1,22,F]

    n_up = len(upsample_rates)
    for i in range(n_up):
        x = leaky_relu(x, 0.1)
        nc = p["noise_convs"][i]
        if i + 1 < n_up:
            stride_f0 = int(np.prod(upsample_rates[i + 1:]))
            x_source = conv1d(har_cat, nc["w"], nc["b"], stride=stride_f0,
                              padding=(stride_f0 + 1) // 2)
        else:
            x_source = conv1d(har_cat, nc["w"], nc["b"])
        x_source = adain_resblock1(x_source, s, p["noise_res"][i])
        up = p["ups"][i]
        k = up["w"].shape[-1]
        x = conv_transpose1d(x, up["w"], up["b"], stride=upsample_rates[i],
                             padding=(k - upsample_rates[i]) // 2)
        if i == n_up - 1:
            x = F.pad(x, (1, 0), mode="reflect")
        x = x + x_source
        xs = None
        for j in range(num_kernels):
            r = adain_resblock1(x, s, p["resblocks"][i * num_kernels + j])
            xs = r if xs is None else xs + r
        x = xs / num_kernels
    x = conv1d(leaky_relu(x, 0.01), p["conv_post_w"], p["conv_post_b"], padding=3)
    half = n_fft // 2 + 1
    return _istft(torch.exp(x[0, :half]), torch.sin(x[0, half:]), n_fft, hop)


def snake(x, alpha):
    return x + (1.0 / (alpha + 1e-9)) * torch.sin(alpha * x) ** 2


def adain_resblock1(x, s, p, dilations=(1, 3, 5)):
    """Generator AdaINResBlock1 (snake + AdaIN, 3 dilated conv pairs);
    paddings from the conv kernels' shapes."""
    for conv, dil in zip(p["convs"], dilations):
        k = conv["c1_w"].shape[-1]
        xt = snake(ada_in(x, s, conv["adain1"]), conv["alpha1"])
        xt = conv1d(xt, conv["c1_w"], conv["c1_b"], dilation=dil,
                    padding=(k - 1) * dil // 2)
        xt = snake(ada_in(xt, s, conv["adain2"]), conv["alpha2"])
        x = conv1d(xt, conv["c2_w"], conv["c2_b"], padding=(k - 1) // 2) + x
    return x


# ----------------------------------------------------------------- decoder

def decoder_forward(asr, f0_curve, n_curve, s, p, draws):
    """istftnet Decoder: asr [1,512,T], F0/N [1,2T], s [1,128] -> audio."""
    f0 = conv1d(f0_curve[:, None, :], p["F0_conv_w"], p["F0_conv_b"],
                stride=2, padding=1)                        # [1,1,T]
    n = conv1d(n_curve[:, None, :], p["N_conv_w"], p["N_conv_b"],
               stride=2, padding=1)
    x = adain_resblk1d(torch.cat([asr, f0, n], dim=1), s, p["encode"])  # [1,1024,T]
    asr_res = conv1d(asr, p["asr_res_w"], p["asr_res_b"])  # [1,64,T]
    res = True
    for i, blk in enumerate(p["decode"]):
        up = i == len(p["decode"]) - 1
        if res:
            x = torch.cat([x, asr_res, f0, n], dim=1)
        x = adain_resblk1d(x, s, blk, upsample=up)
        if up:
            res = False
    return generator_forward(x, s, f0_curve, p["generator"], draws)


# -------------------------------------------------------------- full model

def samples_per_frame(upsample_rates=(10, 6), hop=5) -> int:
    """Audio samples an alignment frame becomes: the decoder's 2x, the
    generator's ups, the iSTFT hop (600 for Kokoro-82M)."""
    return 2 * int(np.prod(upsample_rates)) * hop


def kmodel_forward(ids, ref_s, params, *, speed=1.0, total_frames=None,
                   n_albert_layers=12, albert_heads=12, albert_act="gelu_new",
                   max_frames_per_token=20, draws=None, generator=None):
    """Full Kokoro forward: phoneme ids [S] (without bos/eos), voice ref_s
    [256] -> (audio [samples], pred_dur [S+2], true_total).

    ``total_frames`` is the static alignment budget (defaults to
    (S+2)*max_frames_per_token); the true duration sum is clamped into it
    and the audio is valid for the first ``true_total * 600`` samples.
    ``draws`` are the sine source's (``sine_draws``), else drawn from
    ``generator`` (a CPU generator seeded 0 when neither is given).
    """
    dev = ids.device
    zero = torch.zeros(1, dtype=ids.dtype, device=dev)
    ids_b = torch.cat([zero, ids, zero])
    s_len = ids_b.shape[0]
    total = total_frames or s_len * max_frames_per_token
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        draws = sine_draws(total * samples_per_frame(), generator)

    bert = albert_forward(ids_b, params["bert"], n_layers=n_albert_layers,
                          n_heads=albert_heads, act=albert_act)  # [S, 768]
    d_en = linear(bert, params["bert_encoder"]).T[None]          # [1,512,S]

    style = ref_s[128:]                                          # prosody
    d, dur = predict_durations(d_en, style, params["predictor"], speed)
    pred_dur = torch.clamp(torch.round(dur), 1, max_frames_per_token).to(torch.int32)
    true_total = torch.clamp(pred_dur.sum(), max=total).to(torch.int32)
    idx = alignment_index(pred_dur, total)
    frame_valid = (torch.arange(total, device=dev) < true_total)[None, None, :]

    en = d[0][idx].T[None] * frame_valid                         # [1,640,T]
    f0_pred, n_pred = f0n_train(en, style, params["predictor"])  # [1,2T]

    t_en = text_encoder_forward(ids_b, params["text_encoder"])   # [1,512,S]
    asr = t_en[0].T[idx].T[None] * frame_valid                   # [1,512,T]

    audio = decoder_forward(asr, f0_pred, n_pred, ref_s[None, :128],
                            params["decoder"], draws)
    return audio, pred_dur, true_total
