"""Build a model from a safetensors checkpoint (counterpart of
``pygpukit_tpu/llm/loader.py``): the spec-driven assembly of the stacked
param tree, GPT-2's Conv1D layout and fused-QKV split, and the
per-architecture loaders.

The tree is the one ``model.py`` reads: per-layer weights stacked on a
leading layer axis, projections ``[in, out]`` (``x @ W``), norm weights and
the MoE router in f32, an untied head ``[E, V]`` and a tied one ``None``.
The model runs every family of ``config.MODEL_SPECS``; a config or a
leaf it does not know (``model.check_supported``, ``model._LAYER_LEAVES``)
raises NotImplementedError at load, and nothing is dropped.

Host -> device. On the card a tensor's bytes are copied as they lie in the
file, then converted to the model's dtype and, for HF ``[out, in]``
projections, transposed on the card (``.t()`` to a contiguous copy: the
reference's host transpose, the same bytes). The bytes go through two
pinned buffers of the largest tensor's size: the host fills one from the
map while the card copies from the other (an event a buffer says when a
buffer is free), so the pinned memory is bounded by the largest tensor, not
the model. ``PYGPUKIT_ASYNC_LOAD=0`` (read per call; the reference's
switch for its staging engine) takes pageable copies instead. On the CPU
the map's views are copied.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch

from ..core.backend import resolve_device
from ..core.dtypes import to_dtype
from .config import MODEL_SPECS, ModelSpec, TransformerConfig, detect_model_spec
from .model import CausalTransformerModel, check_supported, fuse_params
from .quant import kv_dtype_from_quant_config
from .safetensors import load_safetensors

_F32 = torch.float32


class _Stager:
    """The device copies of a checkpoint's tensors (module docstring)."""

    def __init__(self, st, device: torch.device):
        self.st = st
        self.device = device
        self.pinned = None
        self.events: list = [None, None]       # the last copy out of each buffer
        self.turn = 0
        if device.type == "cuda" and os.environ.get("PYGPUKIT_ASYNC_LOAD", "1") != "0":
            largest = max((st.info(k).nbytes for k in st.keys()), default=0)
            self.pinned = [torch.empty(largest, dtype=torch.uint8, pin_memory=True)
                           for _ in range(2)]

    def get(self, name: str) -> torch.Tensor:
        """``name`` on the device in the file's dtype and shape: a view of
        the map on the CPU (read-only: callers copy), a fresh tensor on the
        card, ordered before the current stream's later work."""
        if self.device.type != "cuda":
            return self.st.tensor(name)
        info = self.st.info(name)
        raw = self.st.tensor_raw(name)
        out = torch.empty(raw.numel(), dtype=torch.uint8, device=self.device)
        if self.pinned is None:
            out.copy_(raw)
        elif raw.numel():
            i = self.turn
            if self.events[i] is not None:
                self.events[i].synchronize()       # the buffer's last copy is done
            buf = self.pinned[i][:raw.numel()]
            buf.copy_(raw)
            out.copy_(buf, non_blocking=True)
            self.events[i] = torch.cuda.Event()
            self.events[i].record()
            self.turn ^= 1
        return out.view(info.torch_dtype).reshape(info.shape)

    def tensor(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        return self.get(name).to(dtype, copy=True)

    def linear(self, name: str, dtype: torch.dtype, transpose: bool) -> torch.Tensor:
        w = self.get(name)
        return (w.t() if transpose else w).to(dtype, memory_format=torch.contiguous_format,
                                              copy=True)


def _find_config_json(path) -> dict | None:
    p = Path(path)
    base = p if p.is_dir() else p.parent
    cj = base / "config.json"
    if cj.exists():
        with open(cj) as f:
            return json.load(f)
    return None


def _infer_config(st, spec: ModelSpec, hf_cfg: dict | None) -> TransformerConfig:
    if hf_cfg is not None:
        cfg = TransformerConfig.from_hf_config(hf_cfg, spec)
        return cfg
    # heuristic inference from tensor shapes (no config.json)
    names = st.keys()
    n_layers = 0
    probe = spec.attn_norm or spec.post_attn_norm   # olmo2: post-only norms
    while probe.format(layer=n_layers) in st:
        n_layers += 1
    vocab, hidden = st.tensor_shape(spec.embed_tokens)
    qn = spec.q_proj.format(layer=0)
    kn = spec.k_proj.format(layer=0)
    q_shape = st.tensor_shape(qn)
    if spec.qkv_combined:
        if spec.name == "phi3":
            # the fused qkv/gate_up shapes cannot disambiguate the head
            # split (Phi-3-mini uses 96-dim heads; hidden//64 would infer
            # 48 heads that reshape "successfully" into garbage) — demand
            # the config.json that every HF phi3 checkpoint ships
            raise ValueError(
                "phi3 checkpoints need config.json next to the weights: "
                "the fused qkv_proj cannot disambiguate num_heads/head_dim")
        num_heads = max(1, hidden // 64)
        num_kv = num_heads
    else:
        q_out = q_shape[0] if spec.hf_linear_layout else q_shape[1]
        k_out = st.tensor_shape(kn)[0] if spec.hf_linear_layout else st.tensor_shape(kn)[1]
        # head_dim is not recoverable from projection shapes alone; q_norm
        # weight (Qwen3-family) is exactly [head_dim] when present, else
        # default 64 (config.json is the reliable source)
        if (spec.q_norm and not spec.qk_norm_wide
                and spec.q_norm.format(layer=0) in st):
            # last dim: qwen3 q_norm is [D], cohere's is per-head [Hq, D]
            head_dim = st.tensor_shape(spec.q_norm.format(layer=0))[-1]
        else:
            # olmo2's q_norm is the WHOLE projection width, not [head_dim]
            head_dim = 64
        num_heads = q_out // head_dim
        num_kv = k_out // head_dim
    inter = None
    if spec.gate_proj:
        g = st.tensor_shape(spec.gate_proj.format(layer=0))
        inter = g[0] if spec.hf_linear_layout else g[1]
        if spec.gate_up_combined:
            inter //= 2                   # fused gate_up tensor is [2I, E]
    elif spec.fc1:
        g = st.tensor_shape(spec.fc1.format(layer=0))
        inter = g[1] if not spec.hf_linear_layout else g[0]
    max_pos = 1024
    if spec.position_embed and spec.position_embed in st:
        max_pos = st.tensor_shape(spec.position_embed)[0]
    if spec.name in ("gemma2", "gemma3"):
        # no config.json: fall back to the published arch defaults so the
        # sandwich norms / softcaps / sliding pattern still apply
        hf = {"model_type": spec.hf_model_type, "vocab_size": vocab,
              "hidden_size": hidden, "num_hidden_layers": n_layers,
              "num_attention_heads": num_heads,
              "num_key_value_heads": num_kv, "intermediate_size": inter,
              "head_dim": head_dim}
        return TransformerConfig.from_hf_config(hf, spec)
    return TransformerConfig(
        vocab_size=vocab, hidden_size=hidden, num_layers=n_layers,
        num_heads=num_heads, num_kv_heads=num_kv, intermediate_size=inter,
        head_dim_override=(head_dim if not spec.qkv_combined else None),
        norm_type=spec.norm_type, activation=spec.activation,
        use_rope=spec.use_rope, use_qk_norm=spec.use_qk_norm,
        pre_norms=spec.pre_norms, qk_norm_wide=spec.qk_norm_wide,
        use_post_norms=(spec.post_attn_norm is not None
                        or not spec.pre_norms),
        parallel_block=spec.parallel_block,
        rope_interleaved=spec.rope_interleaved,
        # arch constants the config.json would normally carry — fall back
        # to the published family defaults so a bare checkpoint still
        # computes the right function (glm4 partial rotary, cohere logit
        # scale)
        rope_partial_factor=(
            0.5 if spec.name in ("glm4", "nemotron", "phi") else 1.0),
        logit_scale=0.0625 if spec.name == "cohere" else None,
        use_position_embed=spec.use_position_embed,
        max_position_embeddings=max_pos,
        norm_eps=spec.default_norm_eps, rope_theta=spec.default_rope_theta,
        tie_word_embeddings=spec.lm_head is None,
    )


def load_model_from_safetensors(path, dtype=torch.bfloat16,
                                spec: ModelSpec | None = None,
                                config: TransformerConfig | None = None,
                                max_seq_len: int | None = None,
                                fuse: bool = True,
                                kv_dtype=None,
                                device=None) -> CausalTransformerModel:
    """Load a supported checkpoint (a file, an index or a directory; see
    ``load_safetensors``) into a ``CausalTransformerModel`` on ``device``
    (the card unless the caller names one). ``dtype`` is a torch dtype or
    a name (``"float32"``, ``"bfloat16"``). The spec comes from the tensor
    names and the config from ``config.json`` beside the weights (else
    ``_infer_config``'s heuristics). ``fuse`` (default) packs q/k/v and
    gate/up into fused leaves (``fuse_params``); ``fuse=False`` keeps them
    apart (the fused-decode kernel's layout). Without ``kv_dtype`` the
    checkpoint's ``quantization_config`` may name one, else
    ``resolve_kv_dtype``'s order holds. ``max_seq_len`` makes the fixed
    caches. NotImplementedError for a family the model does not run."""
    dtype = to_dtype(dtype).torch_dtype
    device = resolve_device(device)
    st = load_safetensors(path)
    try:
        if spec is None:
            spec = detect_model_spec(st.keys())
        hf_cfg = _find_config_json(path)
        if config is None:
            config = _infer_config(st, spec, hf_cfg)
        check_supported(config)
        params = _build_params(_Stager(st, device), spec, config, dtype)
    finally:
        st.close()
    if fuse:
        params = fuse_params(params)
    if kv_dtype is None and hf_cfg:
        kv_dtype = kv_dtype_from_quant_config(hf_cfg.get("quantization_config"))
    model = CausalTransformerModel(config, params, spec=spec, dtype=dtype,
                                   kv_dtype=kv_dtype)
    if max_seq_len is not None:
        model.init_fixed_cache(max_seq_len)
    return model


def _build_params(stage: _Stager, spec: ModelSpec, config: TransformerConfig,
                  dtype: torch.dtype) -> dict:
    st = stage.st
    tr = spec.hf_linear_layout
    hq, hk, d = config.num_heads, config.num_kv_heads, config.head_dim
    dev = stage.device

    def scalar(v: int) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int32, device=dev)

    params: dict = {"embed": stage.tensor(spec.embed_tokens, dtype)}
    if spec.use_position_embed and spec.position_embed:
        params["pos_embed"] = stage.tensor(spec.position_embed, dtype)
    params["final_norm_w"] = stage.tensor(spec.final_norm, _F32)
    if spec.final_norm_bias and spec.final_norm_bias in st:
        params["final_norm_b"] = stage.tensor(spec.final_norm_bias, _F32)
    if spec.lm_head and spec.lm_head in st:
        params["lm_head"] = stage.linear(spec.lm_head, dtype, transpose=True)   # [E, V]
        if spec.lm_head_bias and spec.lm_head_bias in st:
            params["lm_head_b"] = stage.tensor(spec.lm_head_bias, _F32)
    else:
        params["lm_head"] = None

    wins = config.layer_windows()
    layers = []
    for l in range(config.num_layers):
        lp: dict = {}

        def name(template: str, **kw) -> str:
            return template.format(layer=l, **kw)

        if spec.attn_norm:            # None: the OLMo-2 post-norm-only scheme
            lp["attn_norm_w"] = stage.tensor(name(spec.attn_norm), _F32)
        if spec.attn_norm_bias:
            lp["attn_norm_b"] = stage.tensor(name(spec.attn_norm_bias), _F32)
        if spec.mlp_norm:
            lp["mlp_norm_w"] = stage.tensor(name(spec.mlp_norm), _F32)
        if spec.mlp_norm_bias:
            lp["mlp_norm_b"] = stage.tensor(name(spec.mlp_norm_bias), _F32)
        if spec.post_attn_norm:
            lp["post_attn_norm_w"] = stage.tensor(name(spec.post_attn_norm), _F32)
            lp["post_mlp_norm_w"] = stage.tensor(name(spec.post_mlp_norm), _F32)
        if wins is not None:
            lp["attn_window"] = scalar(wins[l])
        if config.rope_local_theta is not None and config.layer_types is not None:
            lp["use_local_rope"] = scalar(
                1 if config.layer_types[l] == "sliding_attention" else 0)
        if config.rope_layers is not None:
            lp["use_rope_layer"] = scalar(config.rope_layers[l])

        if spec.qkv_combined:
            w = stage.get(name(spec.q_proj))
            if tr:
                w = w.t()                                 # -> [in, 3E]
            qd, kd = hq * d, hk * d
            for leaf, cols in (("w_q", slice(0, qd)), ("w_k", slice(qd, qd + kd)),
                               ("w_v", slice(qd + kd, qd + 2 * kd))):
                lp[leaf] = w[:, cols].to(dtype, memory_format=torch.contiguous_format,
                                         copy=True)
            if spec.q_bias:
                b = stage.get(name(spec.q_bias))
                lp["b_q"] = b[:qd].to(dtype, copy=True)
                lp["b_k"] = b[qd:qd + kd].to(dtype, copy=True)
                lp["b_v"] = b[qd + kd:qd + 2 * kd].to(dtype, copy=True)
        else:
            for leaf, template in (("w_q", spec.q_proj), ("w_k", spec.k_proj),
                                   ("w_v", spec.v_proj)):
                lp[leaf] = stage.linear(name(template), dtype, tr)
            if spec.q_bias and name(spec.q_bias) in st:
                for leaf, template in (("b_q", spec.q_bias), ("b_k", spec.k_bias),
                                       ("b_v", spec.v_bias)):
                    lp[leaf] = stage.tensor(name(template), dtype)
        lp["w_o"] = stage.linear(name(spec.o_proj), dtype, tr)
        if spec.o_bias and name(spec.o_bias) in st:
            lp["b_o"] = stage.tensor(name(spec.o_bias), dtype)
        if spec.use_qk_norm or (config.use_qk_norm and spec.q_norm
                                and name(spec.q_norm) in st):
            # cohere: q/k norms are optional (use_qk_norm in config.json);
            # qwen3/olmo2 always carry them (the spec's flag)
            lp["w_q_norm"] = stage.tensor(name(spec.q_norm), _F32)
            lp["w_k_norm"] = stage.tensor(name(spec.k_norm), _F32)

        if spec.is_moe:
            lp["w_router"] = stage.linear(name(spec.moe_gate), _F32, tr)
            for leaf, template in (("w_experts_gate", spec.expert_gate_proj),
                                   ("w_experts_up", spec.expert_up_proj),
                                   ("w_experts_down", spec.expert_down_proj)):
                lp[leaf] = torch.stack([stage.linear(name(template, expert=e), dtype, tr)
                                        for e in range(config.num_experts)])
        elif spec.gate_proj and spec.gate_up_combined:
            # Phi-3: one gate_up_proj tensor, gate rows first
            w = stage.get(name(spec.gate_proj))
            if tr:
                w = w.t()                                 # -> [in, 2I]
            ii = w.shape[1] // 2
            lp["w_gate"] = w[:, :ii].to(dtype, memory_format=torch.contiguous_format,
                                        copy=True)
            lp["w_up"] = w[:, ii:].to(dtype, memory_format=torch.contiguous_format,
                                      copy=True)
            lp["w_down"] = stage.linear(name(spec.down_proj), dtype, tr)
        elif spec.gate_proj:
            for leaf, template in (("w_gate", spec.gate_proj), ("w_up", spec.up_proj),
                                   ("w_down", spec.down_proj)):
                lp[leaf] = stage.linear(name(template), dtype, tr)
        else:
            lp["w_fc1"] = stage.linear(name(spec.fc1), dtype, tr)
            lp["w_fc2"] = stage.linear(name(spec.fc2), dtype, tr)
            if spec.fc1_bias:
                lp["b_fc1"] = stage.tensor(name(spec.fc1_bias), dtype)
                lp["b_fc2"] = stage.tensor(name(spec.fc2_bias), dtype)
            if spec.activation == "xielu" and spec.act_params:
                # apertus: learned activation params and checkpoint buffers
                pre = name(spec.act_params)
                for leaf, key in (("act_alpha_p", "alpha_p"), ("act_alpha_n", "alpha_n"),
                                  ("act_beta", "beta"), ("act_eps", "eps")):
                    lp[leaf] = stage.tensor(pre + key, _F32)
        layers.append(lp)

    if spec.norm_plus_one:
        # gemma RMSNorm's effective weight is 1 + w: folded into the f32
        # stored weights so the shared rmsnorm path is exact
        norm_keys = ("attn_norm_w", "mlp_norm_w", "post_attn_norm_w",
                     "post_mlp_norm_w", "w_q_norm", "w_k_norm")
        for lp in layers:
            for k in norm_keys:
                if k in lp:
                    lp[k] = lp[k] + 1.0
        params["final_norm_w"] = params["final_norm_w"] + 1.0
    params["layers"] = {k: torch.stack([lp.pop(k) for lp in layers]) for k in list(layers[0])}
    return params


# per-architecture loaders

def load_gpt2_from_safetensors(path, dtype=torch.float32, **kw):
    return load_model_from_safetensors(path, dtype, spec=MODEL_SPECS["gpt2"], **kw)


def load_llama_from_safetensors(path, dtype=torch.bfloat16, **kw):
    return load_model_from_safetensors(path, dtype, spec=MODEL_SPECS["llama"], **kw)


def load_qwen3_from_safetensors(path, dtype=torch.bfloat16, **kw):
    return load_model_from_safetensors(path, dtype, spec=MODEL_SPECS["qwen3"], **kw)


def load_mixtral_from_safetensors(path, dtype=torch.bfloat16, **kw):
    return load_model_from_safetensors(path, dtype, spec=MODEL_SPECS["mixtral"], **kw)
