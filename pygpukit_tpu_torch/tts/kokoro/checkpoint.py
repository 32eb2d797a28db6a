"""Kokoro-82M checkpoint loading (counterpart of
``pygpukit_tpu/tts/kokoro/checkpoint.py``): a .pth/.safetensors state
dict -> ``arch.py``'s param tree, voice embeddings, config and vocab.

The key inventory (``state_dict_spec``), the weight-norm fold and the
random checkpoint (``init_random_flat``, numpy with the reference's
generator and draw order) are the reference's, so both packages load the
same flat dict. ``load_params`` builds the reference's nested tree (linear
weights [in, out], convs in torch [O, I/g, K] layout, ``None`` for a
missing bias) of f32 tensors on a device, the card unless named. A
``.pth`` loads through ``torch.load(weights_only=True)``, a
``.safetensors`` through the port's ``llm.safetensors``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ...core.backend import resolve_device
from ...llm.safetensors import SafeTensorsFile


# --------------------------------------------------------------- dimensions

class KokoroDims:
    """Kokoro-82M architecture dimensions (hexgrad/Kokoro-82M config.json)."""
    n_token = 178
    style_dim = 128          # each half of the 256-dim voice vector
    hidden_dim = 512         # d_model
    max_dur = 50
    n_layer = 3              # text-encoder conv depth & duration-enc layers
    text_kernel = 5
    # plbert
    albert_emb = 128
    albert_hidden = 768
    albert_heads = 12
    albert_ffn = 2048
    albert_layers = 12
    albert_max_pos = 512
    # decoder / generator
    dec_hidden = 1024
    gen_ch = 512             # upsample_initial_channel
    n_fft = 20
    hop = 5
    upsample_rates = (10, 6)
    upsample_kernels = (20, 12)
    resblock_kernels = (3, 7, 11)
    resblock_dilations = (1, 3, 5)
    harmonic_num = 8

    @classmethod
    def from_config(cls, cfg: dict) -> "KokoroDims":
        d = cls()
        d.n_token = cfg.get("n_token", d.n_token)
        d.style_dim = cfg.get("style_dim", d.style_dim)
        d.hidden_dim = cfg.get("hidden_dim", d.hidden_dim)
        d.max_dur = cfg.get("max_dur", d.max_dur)
        d.n_layer = cfg.get("n_layer", d.n_layer)
        pl = cfg.get("plbert", {})
        d.albert_hidden = pl.get("hidden_size", d.albert_hidden)
        d.albert_heads = pl.get("num_attention_heads", d.albert_heads)
        d.albert_ffn = pl.get("intermediate_size", d.albert_ffn)
        d.albert_layers = pl.get("num_hidden_layers", d.albert_layers)
        d.albert_max_pos = pl.get("max_position_embeddings", d.albert_max_pos)
        dec = cfg.get("decoder", {})
        d.n_fft = dec.get("gen_istft_n_fft", d.n_fft)
        d.hop = dec.get("gen_istft_hop_size", d.hop)
        d.upsample_rates = tuple(dec.get("upsample_rates", d.upsample_rates))
        d.upsample_kernels = tuple(
            dec.get("upsample_kernel_sizes", d.upsample_kernels))
        d.resblock_kernels = tuple(
            dec.get("resblock_kernel_sizes", d.resblock_kernels))
        d.gen_ch = dec.get("upsample_initial_channel", d.gen_ch)
        return d


# ------------------------------------------------------------ key inventory

def _wn_conv(prefix, o, i, k, bias=True):
    keys = {f"{prefix}.weight_g": (o, 1, 1), f"{prefix}.weight_v": (o, i, k)}
    if bias:
        keys[f"{prefix}.bias"] = (o,)
    return keys


def _linear(prefix, o, i, bias=True):
    keys = {f"{prefix}.weight": (o, i)}
    if bias:
        keys[f"{prefix}.bias"] = (o,)
    return keys


def _bilstm(prefix, inp, hid):
    keys = {}
    for suf, shp in (("weight_ih_l0", (4 * hid, inp)),
                     ("weight_hh_l0", (4 * hid, hid)),
                     ("bias_ih_l0", (4 * hid,)), ("bias_hh_l0", (4 * hid,))):
        keys[f"{prefix}.{suf}"] = shp
        keys[f"{prefix}.{suf}_reverse"] = shp
    return keys


def _adain_resblk1d(prefix, dim_in, dim_out, style, upsample=False):
    keys = {}
    keys.update(_wn_conv(f"{prefix}.conv1", dim_out, dim_in, 3))
    keys.update(_wn_conv(f"{prefix}.conv2", dim_out, dim_out, 3))
    keys.update(_linear(f"{prefix}.norm1.fc", 2 * dim_in, style))
    keys.update(_linear(f"{prefix}.norm2.fc", 2 * dim_out, style))
    if dim_in != dim_out:
        keys.update(_wn_conv(f"{prefix}.conv1x1", dim_out, dim_in, 1,
                             bias=False))
    if upsample:
        keys.update({f"{prefix}.pool.weight_g": (dim_in, 1, 1),
                     f"{prefix}.pool.weight_v": (dim_in, 1, 3),
                     f"{prefix}.pool.bias": (dim_in,)})
    return keys


def _adain_resblock1(prefix, ch, style, kernel, dilations=(1, 3, 5)):
    keys = {}
    for j, d in enumerate(dilations):
        keys.update(_wn_conv(f"{prefix}.convs1.{j}", ch, ch, kernel))
        keys.update(_wn_conv(f"{prefix}.convs2.{j}", ch, ch, kernel))
        keys.update(_linear(f"{prefix}.adain1.{j}.fc", 2 * ch, style))
        keys.update(_linear(f"{prefix}.adain2.{j}.fc", 2 * ch, style))
        keys[f"{prefix}.alpha1.{j}"] = (1, ch, 1)
        keys[f"{prefix}.alpha2.{j}"] = (1, ch, 1)
    return keys


def state_dict_spec(d: KokoroDims | None = None) -> dict[str, tuple]:
    """Every checkpoint key -> shape (flattened, ``module.`` stripped)."""
    d = d or KokoroDims()
    h, sty = d.hidden_dim, d.style_dim
    keys: dict[str, tuple] = {}

    # --- bert (ALBERT) ---
    b = "bert"
    keys[f"{b}.embeddings.word_embeddings.weight"] = (d.n_token, d.albert_emb)
    keys[f"{b}.embeddings.position_embeddings.weight"] = (
        d.albert_max_pos, d.albert_emb)
    keys[f"{b}.embeddings.token_type_embeddings.weight"] = (2, d.albert_emb)
    keys[f"{b}.embeddings.LayerNorm.weight"] = (d.albert_emb,)
    keys[f"{b}.embeddings.LayerNorm.bias"] = (d.albert_emb,)
    keys.update(_linear(f"{b}.encoder.embedding_hidden_mapping_in",
                        d.albert_hidden, d.albert_emb))
    lp = f"{b}.encoder.albert_layer_groups.0.albert_layers.0"
    for name in ("query", "key", "value", "dense"):
        keys.update(_linear(f"{lp}.attention.{name}",
                            d.albert_hidden, d.albert_hidden))
    keys[f"{lp}.attention.LayerNorm.weight"] = (d.albert_hidden,)
    keys[f"{lp}.attention.LayerNorm.bias"] = (d.albert_hidden,)
    keys.update(_linear(f"{lp}.ffn", d.albert_ffn, d.albert_hidden))
    keys.update(_linear(f"{lp}.ffn_output", d.albert_hidden, d.albert_ffn))
    keys[f"{lp}.full_layer_layer_norm.weight"] = (d.albert_hidden,)
    keys[f"{lp}.full_layer_layer_norm.bias"] = (d.albert_hidden,)

    # --- bert_encoder ---
    keys.update(_linear("bert_encoder", h, d.albert_hidden))

    # --- predictor ---
    p = "predictor"
    for i in range(d.n_layer):
        keys.update(_bilstm(f"{p}.text_encoder.lstms.{2 * i}",
                            h + sty, h // 2))
        keys.update(_linear(f"{p}.text_encoder.lstms.{2 * i + 1}.fc",
                            2 * h, sty))
    keys.update(_bilstm(f"{p}.lstm", h + sty, h // 2))
    keys.update(_linear(f"{p}.duration_proj.linear_layer", d.max_dur, h))
    keys.update(_bilstm(f"{p}.shared", h + sty, h // 2))
    for br in ("F0", "N"):
        keys.update(_adain_resblk1d(f"{p}.{br}.0", h, h, sty))
        keys.update(_adain_resblk1d(f"{p}.{br}.1", h, h // 2, sty,
                                    upsample=True))
        keys.update(_adain_resblk1d(f"{p}.{br}.2", h // 2, h // 2, sty))
        keys[f"{p}.{br}_proj.weight"] = (1, h // 2, 1)
        keys[f"{p}.{br}_proj.bias"] = (1,)

    # --- text_encoder ---
    t = "text_encoder"
    keys[f"{t}.embedding.weight"] = (d.n_token, h)
    for i in range(d.n_layer):
        keys.update(_wn_conv(f"{t}.cnn.{i}.0", h, h, d.text_kernel))
        keys[f"{t}.cnn.{i}.1.gamma"] = (h,)
        keys[f"{t}.cnn.{i}.1.beta"] = (h,)
    keys.update(_bilstm(f"{t}.lstm", h, h // 2))

    # --- decoder ---
    dd = "decoder"
    keys.update(_wn_conv(f"{dd}.F0_conv", 1, 1, 3))
    keys.update(_wn_conv(f"{dd}.N_conv", 1, 1, 3))
    keys.update(_wn_conv(f"{dd}.asr_res.0", 64, h, 1))
    keys.update(_adain_resblk1d(f"{dd}.encode", h + 2, d.dec_hidden, sty))
    cat = d.dec_hidden + 2 + 64
    for i in range(3):
        keys.update(_adain_resblk1d(f"{dd}.decode.{i}", cat, d.dec_hidden,
                                    sty))
    keys.update(_adain_resblk1d(f"{dd}.decode.3", cat, d.gen_ch, sty,
                                upsample=True))

    # --- generator ---
    g = f"{dd}.generator"
    keys.update(_linear(f"{g}.m_source.l_linear", 1, d.harmonic_num + 1))
    ch = d.gen_ch
    spec_ch = d.n_fft + 2
    for i, (rate, k) in enumerate(zip(d.upsample_rates, d.upsample_kernels)):
        keys.update({f"{g}.ups.{i}.weight_g": (ch, 1, 1),
                     f"{g}.ups.{i}.weight_v": (ch, ch // 2, k),
                     f"{g}.ups.{i}.bias": (ch // 2,)})
        c_cur = ch // 2
        if i + 1 < len(d.upsample_rates):
            stride_f0 = int(np.prod(d.upsample_rates[i + 1:]))
            keys[f"{g}.noise_convs.{i}.weight"] = (
                c_cur, spec_ch, stride_f0 * 2)
            keys[f"{g}.noise_convs.{i}.bias"] = (c_cur,)
            keys.update(_adain_resblock1(f"{g}.noise_res.{i}", c_cur, sty, 7,
                                         d.resblock_dilations))
        else:
            keys[f"{g}.noise_convs.{i}.weight"] = (c_cur, spec_ch, 1)
            keys[f"{g}.noise_convs.{i}.bias"] = (c_cur,)
            keys.update(_adain_resblock1(f"{g}.noise_res.{i}", c_cur, sty, 11,
                                         d.resblock_dilations))
        for j, rk in enumerate(d.resblock_kernels):
            keys.update(_adain_resblock1(
                f"{g}.resblocks.{i * len(d.resblock_kernels) + j}", c_cur,
                sty, rk, d.resblock_dilations))
        ch = c_cur
    keys.update(_wn_conv(f"{g}.conv_post", spec_ch, ch, 7))
    return keys


# ----------------------------------------------------------------- loading

def flatten_state_dict(raw: dict) -> dict[str, np.ndarray]:
    """Flatten {bert: {module.x: t}} -> {"bert.x": ndarray}; strips
    DataParallel ``module.`` prefixes anywhere in the name."""
    flat: dict[str, np.ndarray] = {}

    def visit(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                visit(f"{prefix}.{k}" if prefix else k, v)
        else:
            arr = np.asarray(obj, dtype=np.float32)
            name = prefix.replace("module.", "")
            flat[name] = arr

    visit("", raw)
    return flat


def _fold_wn(flat, prefix):
    """weight-norm fold: w = g * v / ||v|| (norm over dims 1.., per dim 0)."""
    v = flat[f"{prefix}.weight_v"]
    g = flat[f"{prefix}.weight_g"]
    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)),
                                keepdims=True)) + 1e-12
    return (g * v / norm).astype(np.float32)


def _j(x):
    return np.asarray(x, np.float32)


def to_device(tree, device: torch.device):
    """A nested dict/list tree as f32 tensors on ``device``: tensors moved,
    arrays copied, ``None`` leaves kept."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    if tree is None or isinstance(tree, torch.Tensor):
        return tree if tree is None else tree.to(device)
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def _lin(flat, prefix, bias=True):
    p = {"w": _j(flat[f"{prefix}.weight"].T)}
    p["b"] = _j(flat[f"{prefix}.bias"]) if bias else None
    return p


def _lstm_dir(flat, prefix, rev=False):
    suf = "_reverse" if rev else ""
    return {"w_ih": _j(flat[f"{prefix}.weight_ih_l0{suf}"]),
            "w_hh": _j(flat[f"{prefix}.weight_hh_l0{suf}"]),
            "b_ih": _j(flat[f"{prefix}.bias_ih_l0{suf}"]),
            "b_hh": _j(flat[f"{prefix}.bias_hh_l0{suf}"])}


def _lstm(flat, prefix):
    return {"fwd": _lstm_dir(flat, prefix), "bwd": _lstm_dir(flat, prefix, True)}


def _resblk1d(flat, prefix, upsample=False):
    p = {"conv1_w": _j(_fold_wn(flat, f"{prefix}.conv1")),
         "conv1_b": _j(flat[f"{prefix}.conv1.bias"]),
         "conv2_w": _j(_fold_wn(flat, f"{prefix}.conv2")),
         "conv2_b": _j(flat[f"{prefix}.conv2.bias"]),
         "norm1": {"fc": _lin(flat, f"{prefix}.norm1.fc")},
         "norm2": {"fc": _lin(flat, f"{prefix}.norm2.fc")}}
    if f"{prefix}.conv1x1.weight_v" in flat:
        p["sc_w"] = _j(_fold_wn(flat, f"{prefix}.conv1x1"))
    if upsample:
        p["pool_w"] = _j(_fold_wn(flat, f"{prefix}.pool"))
        p["pool_b"] = _j(flat[f"{prefix}.pool.bias"])
    return p


def _resblock1(flat, prefix, dilations=(1, 3, 5)):
    convs = []
    for j, dil in enumerate(dilations):
        c1 = _fold_wn(flat, f"{prefix}.convs1.{j}")
        c2 = _fold_wn(flat, f"{prefix}.convs2.{j}")
        convs.append({
            "c1_w": _j(c1), "c1_b": _j(flat[f"{prefix}.convs1.{j}.bias"]),
            "c2_w": _j(c2), "c2_b": _j(flat[f"{prefix}.convs2.{j}.bias"]),
            "adain1": {"fc": _lin(flat, f"{prefix}.adain1.{j}.fc")},
            "adain2": {"fc": _lin(flat, f"{prefix}.adain2.{j}.fc")},
            "alpha1": _j(flat[f"{prefix}.alpha1.{j}"]),
            "alpha2": _j(flat[f"{prefix}.alpha2.{j}"]),
        })
    return {"convs": convs}


def load_params(flat: dict[str, np.ndarray], d: KokoroDims | None = None,
                device=None) -> dict:
    """Flat checkpoint dict -> arch.py param tree of f32 tensors on
    ``device`` (the card unless named)."""
    return to_device(_param_arrays(flat, d or KokoroDims()), resolve_device(device))


def _param_arrays(flat: dict[str, np.ndarray], d: KokoroDims) -> dict:
    """The param tree with numpy leaves."""
    lp = "bert.encoder.albert_layer_groups.0.albert_layers.0"
    bert = {
        "word_emb": _j(flat["bert.embeddings.word_embeddings.weight"]),
        "pos_emb": _j(flat["bert.embeddings.position_embeddings.weight"]),
        "type_emb": _j(flat["bert.embeddings.token_type_embeddings.weight"]),
        "emb_ln_w": _j(flat["bert.embeddings.LayerNorm.weight"]),
        "emb_ln_b": _j(flat["bert.embeddings.LayerNorm.bias"]),
        "map": _lin(flat, "bert.encoder.embedding_hidden_mapping_in"),
        "q": _lin(flat, f"{lp}.attention.query"),
        "k": _lin(flat, f"{lp}.attention.key"),
        "v": _lin(flat, f"{lp}.attention.value"),
        "dense": _lin(flat, f"{lp}.attention.dense"),
        "attn_ln_w": _j(flat[f"{lp}.attention.LayerNorm.weight"]),
        "attn_ln_b": _j(flat[f"{lp}.attention.LayerNorm.bias"]),
        "ffn": _lin(flat, f"{lp}.ffn"),
        "ffn_out": _lin(flat, f"{lp}.ffn_output"),
        "full_ln_w": _j(flat[f"{lp}.full_layer_layer_norm.weight"]),
        "full_ln_b": _j(flat[f"{lp}.full_layer_layer_norm.bias"]),
    }

    predictor = {
        "text_encoder": {"blocks": [
            {"lstm": _lstm(flat, f"predictor.text_encoder.lstms.{2 * i}"),
             "aln": {"fc": _lin(flat,
                                f"predictor.text_encoder.lstms.{2 * i + 1}.fc")}}
            for i in range(d.n_layer)]},
        "lstm": _lstm(flat, "predictor.lstm"),
        "duration_proj": _lin(flat, "predictor.duration_proj.linear_layer"),
        "shared": _lstm(flat, "predictor.shared"),
    }
    for br in ("F0", "N"):
        predictor[br] = {
            "blocks": [_resblk1d(flat, f"predictor.{br}.0"),
                       _resblk1d(flat, f"predictor.{br}.1", upsample=True),
                       _resblk1d(flat, f"predictor.{br}.2")],
            "proj_w": _j(flat[f"predictor.{br}_proj.weight"]),
            "proj_b": _j(flat[f"predictor.{br}_proj.bias"]),
        }

    text_encoder = {
        "emb": _j(flat["text_encoder.embedding.weight"]),
        "cnn": [{"w": _j(_fold_wn(flat, f"text_encoder.cnn.{i}.0")),
                 "b": _j(flat[f"text_encoder.cnn.{i}.0.bias"]),
                 "gamma": _j(flat[f"text_encoder.cnn.{i}.1.gamma"]),
                 "beta": _j(flat[f"text_encoder.cnn.{i}.1.beta"])}
                for i in range(d.n_layer)],
        "lstm": _lstm(flat, "text_encoder.lstm"),
    }

    nk = len(d.resblock_kernels)
    generator = {
        "m_source": {"l_linear": _lin(flat,
                                      "decoder.generator.m_source.l_linear")},
        "ups": [{"w": _j(_fold_wn(flat, f"decoder.generator.ups.{i}")),
                 "b": _j(flat[f"decoder.generator.ups.{i}.bias"])}
                for i in range(len(d.upsample_rates))],
        "noise_convs": [],
        "noise_res": [_resblock1(flat, f"decoder.generator.noise_res.{i}",
                                 d.resblock_dilations)
                      for i in range(len(d.upsample_rates))],
        "resblocks": [_resblock1(flat, f"decoder.generator.resblocks.{i}",
                                 d.resblock_dilations)
                      for i in range(len(d.upsample_rates) * nk)],
        "conv_post_w": _j(_fold_wn(flat, "decoder.generator.conv_post")),
        "conv_post_b": _j(flat["decoder.generator.conv_post.bias"]),
    }
    for i in range(len(d.upsample_rates)):
        w = flat[f"decoder.generator.noise_convs.{i}.weight"]
        generator["noise_convs"].append(
            {"w": _j(w),
             "b": _j(flat[f"decoder.generator.noise_convs.{i}.bias"])})

    decoder = {
        "F0_conv_w": _j(_fold_wn(flat, "decoder.F0_conv")),
        "F0_conv_b": _j(flat["decoder.F0_conv.bias"]),
        "N_conv_w": _j(_fold_wn(flat, "decoder.N_conv")),
        "N_conv_b": _j(flat["decoder.N_conv.bias"]),
        "asr_res_w": _j(_fold_wn(flat, "decoder.asr_res.0")),
        "asr_res_b": _j(flat["decoder.asr_res.0.bias"]),
        "encode": _resblk1d(flat, "decoder.encode"),
        "decode": [_resblk1d(flat, f"decoder.decode.{i}",
                             upsample=(i == 3)) for i in range(4)],
        "generator": generator,
    }

    return {"bert": bert, "bert_encoder": _lin(flat, "bert_encoder"),
            "predictor": predictor, "text_encoder": text_encoder,
            "decoder": decoder}


def init_random_flat(d: KokoroDims | None = None, seed: int = 0,
                     scale: float = 0.1) -> dict[str, np.ndarray]:
    """Random flat state dict matching ``state_dict_spec`` (tests/demos)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, shape in state_dict_spec(d).items():
        if name.endswith("weight_g"):
            flat[name] = np.ones(shape, np.float32)
        elif "alpha" in name:
            flat[name] = np.ones(shape, np.float32)
        elif name.endswith((".gamma", "LayerNorm.weight",
                            "full_layer_layer_norm.weight")):
            flat[name] = np.ones(shape, np.float32)
        elif name.endswith(("bias", ".beta", "LayerNorm.bias",
                            "full_layer_layer_norm.bias")):
            flat[name] = np.zeros(shape, np.float32)
        else:
            flat[name] = rng.standard_normal(shape).astype(np.float32) * scale
    return flat


# ------------------------------------------------------------------ voices

def load_voice_file(path) -> np.ndarray:
    """voices/*.pt -> [N, 1, 256] f32 (torch tensor or {"style": t})."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(data, dict) and "style" in data:
        data = data["style"]
    return np.asarray(data.detach().numpy() if hasattr(data, "detach")
                      else data, np.float32)


def select_ref_s(voice: np.ndarray, n_tokens: int) -> np.ndarray:
    """ref_s = voice[len(phonemes)-1] (hexgrad KPipeline convention)."""
    v = voice.reshape(voice.shape[0], -1)
    return v[min(max(n_tokens - 1, 0), v.shape[0] - 1)]


def load_checkpoint_file(path) -> dict[str, np.ndarray]:
    """Load .pth (torch) or .safetensors into a flat numpy dict."""
    path = Path(path)
    if path.suffix == ".pth":
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if "net" in raw:
            raw = raw["net"]
        raw = {k: ({kk: vv.numpy() if hasattr(vv, "numpy") else vv
                    for kk, vv in v.items()} if isinstance(v, dict) else
                   (v.numpy() if hasattr(v, "numpy") else v))
               for k, v in raw.items()}
        return flatten_state_dict(raw)
    # safetensors: already-flat names, any float dtype read as f32
    with SafeTensorsFile(path) as st:
        return {name.replace("module.", ""): st.tensor(name).to(torch.float32).numpy().copy()
                for name in st.keys()}


def load_config_file(path) -> tuple[KokoroDims, dict[str, int]]:
    cfg = json.loads(Path(path).read_text())
    return KokoroDims.from_config(cfg), cfg.get("vocab", {})
