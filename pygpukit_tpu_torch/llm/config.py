"""Model specs and the unified transformer config (a copy of
``pygpukit_tpu/llm/config.py``: ``ModelSpec`` and the 17 family specs in
``MODEL_SPECS``, ``detect_model_spec``, ``TransformerConfig`` with
``from_hf_config``, and the legacy ``GPT2Config``/``LlamaConfig``/
``Qwen3Config``). The port keeps its own copy: importing the reference's
module loads jax through that package's ``__init__``.

Weight-name templates are the standard Hugging Face checkpoint names of
each family. Projections are stored ``[in_features, out_features]`` so a
forward is ``x @ W``: HF Linear ``[out, in]`` tensors are transposed once
at load (``hf_linear_layout``); GPT-2 Conv1D tensors already are
``[in, out]``. The specs are data; the model runs every family here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal


@dataclass(frozen=True)
class ModelSpec:
    """Data-only per-architecture spec: weight-name templates + arch flags."""

    name: str

    # embeddings / head
    embed_tokens: str = "model.embed_tokens.weight"
    position_embed: str | None = None
    lm_head: str | None = "lm_head.weight"
    lm_head_bias: str | None = None      # phi-2: biased lm head
    final_norm: str = "model.norm.weight"
    final_norm_bias: str | None = None

    # per-layer attention ({layer} placeholder; None = no pre-norm, the
    # OLMo-2 post-norm-only scheme)
    attn_norm: str | None = "model.layers.{layer}.input_layernorm.weight"
    attn_norm_bias: str | None = None
    q_proj: str = "model.layers.{layer}.self_attn.q_proj.weight"
    k_proj: str = "model.layers.{layer}.self_attn.k_proj.weight"
    v_proj: str = "model.layers.{layer}.self_attn.v_proj.weight"
    o_proj: str = "model.layers.{layer}.self_attn.o_proj.weight"
    q_bias: str | None = None
    k_bias: str | None = None
    v_bias: str | None = None
    o_bias: str | None = None
    q_norm: str | None = None
    k_norm: str | None = None

    # per-layer mlp
    mlp_norm: str | None = "model.layers.{layer}.post_attention_layernorm.weight"
    mlp_norm_bias: str | None = None
    fc1: str | None = None          # GELU-style
    fc1_bias: str | None = None
    fc2: str | None = None
    fc2_bias: str | None = None
    gate_proj: str | None = "model.layers.{layer}.mlp.gate_proj.weight"
    up_proj: str | None = "model.layers.{layer}.mlp.up_proj.weight"
    down_proj: str | None = "model.layers.{layer}.mlp.down_proj.weight"

    # learned-activation parameter prefix (apertus xIELU:
    # "<prefix>alpha_p" etc.)
    act_params: str | None = None

    # MoE ({layer} and {expert} placeholders)
    moe_gate: str | None = None
    expert_gate_proj: str | None = None
    expert_up_proj: str | None = None
    expert_down_proj: str | None = None

    # Gemma-style sandwich norms (post-attn / post-mlp, applied to the
    # sublayer OUTPUT before the residual add)
    post_attn_norm: str | None = None
    post_mlp_norm: str | None = None

    # architecture flags
    norm_type: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    activation: Literal["gelu", "silu", "gelu_tanh", "relu2",
                        "xielu"] = "silu"
    use_rope: bool = True
    use_qk_norm: bool = False
    pre_norms: bool = True           # False: OLMo-2 post-norm-only blocks
    qk_norm_wide: bool = False       # OLMo-2 whole-width q/k norms
    parallel_block: bool = False     # Cohere parallel attn+mlp residual
    rope_interleaved: bool = False   # Cohere/Llama-4 even/odd rope pairs
    use_position_embed: bool = False
    qkv_combined: bool = False       # GPT-2 c_attn / Phi-3 qkv_proj fused
    gate_up_combined: bool = False   # Phi-3 gate_up_proj fused [2I, E]
    hf_linear_layout: bool = True    # True: HF Linear [out,in] → transpose at load
    is_moe: bool = False
    norm_plus_one: bool = False      # Gemma RMSNorm: effective weight = 1+w
    #                                  (folded into the stored weight at load)

    default_norm_eps: float = 1e-5
    default_rope_theta: float = 10000.0
    hf_model_type: str = ""


GPT2_SPEC = ModelSpec(
    name="gpt2",
    embed_tokens="wte.weight",
    position_embed="wpe.weight",
    lm_head=None,
    final_norm="ln_f.weight",
    final_norm_bias="ln_f.bias",
    attn_norm="h.{layer}.ln_1.weight",
    attn_norm_bias="h.{layer}.ln_1.bias",
    q_proj="h.{layer}.attn.c_attn.weight",
    k_proj="h.{layer}.attn.c_attn.weight",
    v_proj="h.{layer}.attn.c_attn.weight",
    o_proj="h.{layer}.attn.c_proj.weight",
    q_bias="h.{layer}.attn.c_attn.bias",
    k_bias="h.{layer}.attn.c_attn.bias",
    v_bias="h.{layer}.attn.c_attn.bias",
    o_bias="h.{layer}.attn.c_proj.bias",
    mlp_norm="h.{layer}.ln_2.weight",
    mlp_norm_bias="h.{layer}.ln_2.bias",
    fc1="h.{layer}.mlp.c_fc.weight",
    fc1_bias="h.{layer}.mlp.c_fc.bias",
    fc2="h.{layer}.mlp.c_proj.weight",
    fc2_bias="h.{layer}.mlp.c_proj.bias",
    gate_proj=None, up_proj=None, down_proj=None,
    norm_type="layernorm",
    activation="gelu",
    use_rope=False,
    use_position_embed=True,
    qkv_combined=True,
    hf_linear_layout=False,          # GPT-2 Conv1D already [in,out]
    default_norm_eps=1e-5,
    hf_model_type="gpt2",
)

LLAMA_SPEC = ModelSpec(
    name="llama",
    default_norm_eps=1e-5,
    hf_model_type="llama",
)

QWEN2_SPEC = ModelSpec(
    name="qwen2",
    q_bias="model.layers.{layer}.self_attn.q_proj.bias",
    k_bias="model.layers.{layer}.self_attn.k_proj.bias",
    v_bias="model.layers.{layer}.self_attn.v_proj.bias",
    default_norm_eps=1e-6,
    default_rope_theta=1000000.0,
    hf_model_type="qwen2",
)

QWEN3_SPEC = ModelSpec(
    name="qwen3",
    q_norm="model.layers.{layer}.self_attn.q_norm.weight",
    k_norm="model.layers.{layer}.self_attn.k_norm.weight",
    use_qk_norm=True,
    default_norm_eps=1e-6,
    default_rope_theta=1000000.0,
    hf_model_type="qwen3",
)

QWEN3_MOE_SPEC = ModelSpec(
    name="qwen3_moe",
    q_norm="model.layers.{layer}.self_attn.q_norm.weight",
    k_norm="model.layers.{layer}.self_attn.k_norm.weight",
    use_qk_norm=True,
    gate_proj=None, up_proj=None, down_proj=None,
    moe_gate="model.layers.{layer}.mlp.gate.weight",
    expert_gate_proj="model.layers.{layer}.mlp.experts.{expert}.gate_proj.weight",
    expert_up_proj="model.layers.{layer}.mlp.experts.{expert}.up_proj.weight",
    expert_down_proj="model.layers.{layer}.mlp.experts.{expert}.down_proj.weight",
    is_moe=True,
    default_norm_eps=1e-6,
    default_rope_theta=10000000.0,
    hf_model_type="qwen3_moe",
)

COHERE_SPEC = ModelSpec(
    name="cohere",
    # Command-R (HF modeling_cohere): ONE input LayerNorm (no bias, no
    # second norm) feeding attention AND mlp in PARALLEL; interleaved
    # rope; tied embeddings with a logit_scale multiplier
    lm_head=None,
    mlp_norm=None,
    norm_type="layernorm",
    parallel_block=True,
    rope_interleaved=True,
    q_norm="model.layers.{layer}.self_attn.q_norm.weight",
    k_norm="model.layers.{layer}.self_attn.k_norm.weight",
    default_norm_eps=1e-5,
    default_rope_theta=10000.0,
    hf_model_type="cohere",
)

OLMO2_SPEC = ModelSpec(
    name="olmo2",
    # OLMo-2 (HF modeling_olmo2): NO input norms — sublayers read the raw
    # residual stream; post_attention/post_feedforward norms on the
    # sublayer OUTPUTS before the residual add; q/k RMS norms over the
    # WHOLE projection width (Hq*D / Hk*D) before the head reshape
    attn_norm=None,
    mlp_norm=None,
    post_attn_norm="model.layers.{layer}.post_attention_layernorm.weight",
    post_mlp_norm="model.layers.{layer}.post_feedforward_layernorm.weight",
    q_norm="model.layers.{layer}.self_attn.q_norm.weight",
    k_norm="model.layers.{layer}.self_attn.k_norm.weight",
    use_qk_norm=True,
    pre_norms=False,
    qk_norm_wide=True,
    default_norm_eps=1e-6,
    default_rope_theta=500000.0,
    hf_model_type="olmo2",
)

MIXTRAL_SPEC = ModelSpec(
    name="mixtral",
    gate_proj=None, up_proj=None, down_proj=None,
    moe_gate="model.layers.{layer}.block_sparse_moe.gate.weight",
    expert_gate_proj="model.layers.{layer}.block_sparse_moe.experts.{expert}.w1.weight",
    expert_up_proj="model.layers.{layer}.block_sparse_moe.experts.{expert}.w3.weight",
    expert_down_proj="model.layers.{layer}.block_sparse_moe.experts.{expert}.w2.weight",
    is_moe=True,
    default_norm_eps=1e-5,
    default_rope_theta=1000000.0,
    hf_model_type="mixtral",
)


GEMMA2_SPEC = ModelSpec(
    name="gemma2",
    lm_head=None,                    # tied embeddings (no lm_head tensor)
    # gemma checkpoint naming: "post_attention_layernorm" is the POST-attn
    # sandwich norm (NOT the pre-MLP norm it names in llama checkpoints);
    # the pre-MLP norm is "pre_feedforward_layernorm"
    mlp_norm="model.layers.{layer}.pre_feedforward_layernorm.weight",
    post_attn_norm="model.layers.{layer}.post_attention_layernorm.weight",
    post_mlp_norm="model.layers.{layer}.post_feedforward_layernorm.weight",
    activation="gelu_tanh",
    norm_plus_one=True,
    default_norm_eps=1e-6,
    hf_model_type="gemma2",
)

GEMMA3_SPEC = ModelSpec(
    name="gemma3",
    lm_head=None,
    mlp_norm="model.layers.{layer}.pre_feedforward_layernorm.weight",
    post_attn_norm="model.layers.{layer}.post_attention_layernorm.weight",
    post_mlp_norm="model.layers.{layer}.post_feedforward_layernorm.weight",
    q_norm="model.layers.{layer}.self_attn.q_norm.weight",
    k_norm="model.layers.{layer}.self_attn.k_norm.weight",
    use_qk_norm=True,
    activation="gelu_tanh",
    norm_plus_one=True,
    default_norm_eps=1e-6,
    default_rope_theta=1000000.0,
    hf_model_type="gemma3_text",
)


STARCODER2_SPEC = ModelSpec(
    name="starcoder2",
    # GPT-2-style blocks (LayerNorm + biased gelu-tanh c_fc/c_proj MLP)
    # with llama key layout + rope (HF modeling_starcoder2)
    final_norm_bias="model.norm.bias",
    attn_norm_bias="model.layers.{layer}.input_layernorm.bias",
    mlp_norm_bias="model.layers.{layer}.post_attention_layernorm.bias",
    q_bias="model.layers.{layer}.self_attn.q_proj.bias",
    k_bias="model.layers.{layer}.self_attn.k_proj.bias",
    v_bias="model.layers.{layer}.self_attn.v_proj.bias",
    o_bias="model.layers.{layer}.self_attn.o_proj.bias",
    fc1="model.layers.{layer}.mlp.c_fc.weight",
    fc1_bias="model.layers.{layer}.mlp.c_fc.bias",
    fc2="model.layers.{layer}.mlp.c_proj.weight",
    fc2_bias="model.layers.{layer}.mlp.c_proj.bias",
    gate_proj=None, up_proj=None, down_proj=None,
    norm_type="layernorm",
    activation="gelu",
    default_norm_eps=1e-5,
    hf_model_type="starcoder2",
)

GLM4_SPEC = ModelSpec(
    name="glm4",
    # GLM-4: gemma2-style sandwich norms (post_self_attn/post_mlp on the
    # sublayer outputs), fused gate_up MLP, qkv biases, and INTERLEAVED
    # rope over the first partial_rotary_factor*head_dim dims only
    # (HF modeling_glm4.apply_rotary_pos_emb)
    post_attn_norm="model.layers.{layer}.post_self_attn_layernorm.weight",
    post_mlp_norm="model.layers.{layer}.post_mlp_layernorm.weight",
    q_bias="model.layers.{layer}.self_attn.q_proj.bias",
    k_bias="model.layers.{layer}.self_attn.k_proj.bias",
    v_bias="model.layers.{layer}.self_attn.v_proj.bias",
    gate_proj="model.layers.{layer}.mlp.gate_up_proj.weight",
    up_proj=None,
    gate_up_combined=True,
    rope_interleaved=True,
    default_norm_eps=1.5625e-07,
    hf_model_type="glm4",
)

APERTUS_SPEC = ModelSpec(
    name="apertus",
    # Apertus (swiss-ai, HF modeling_apertus): gateless up->xIELU->down
    # MLP where xIELU carries LEARNED per-layer parameters (alpha_p,
    # alpha_n + beta/eps buffers — loaded as layer leaves), per-head
    # qk-norms, norms named attention_/feedforward_layernorm
    attn_norm="model.layers.{layer}.attention_layernorm.weight",
    mlp_norm="model.layers.{layer}.feedforward_layernorm.weight",
    q_norm="model.layers.{layer}.self_attn.q_norm.weight",
    k_norm="model.layers.{layer}.self_attn.k_norm.weight",
    use_qk_norm=True,
    fc1="model.layers.{layer}.mlp.up_proj.weight",
    fc2="model.layers.{layer}.mlp.down_proj.weight",
    gate_proj=None, up_proj=None, down_proj=None,
    activation="xielu",
    act_params="model.layers.{layer}.mlp.act_fn.",
    default_norm_eps=1e-5,
    default_rope_theta=12000000.0,
    hf_model_type="apertus",
)

SEED_OSS_SPEC = ModelSpec(
    name="seed_oss",
    # ByteDance Seed-OSS: llama layout + biases on ALL FOUR attention
    # projections (qwen2 has q/k/v only; o_proj bias is the tell)
    q_bias="model.layers.{layer}.self_attn.q_proj.bias",
    k_bias="model.layers.{layer}.self_attn.k_proj.bias",
    v_bias="model.layers.{layer}.self_attn.v_proj.bias",
    o_bias="model.layers.{layer}.self_attn.o_proj.bias",
    default_norm_eps=1e-6,
    default_rope_theta=10000000.0,
    hf_model_type="seed_oss",
)

PHI_SPEC = ModelSpec(
    name="phi",
    # phi-1/1.5/2 (HF modeling_phi): PARALLEL attn+mlp residual off one
    # shared LayerNorm (cohere block shape, but biased LayerNorm + biased
    # projections + biased lm_head), gelu-tanh fc1/fc2 MLP, split-half
    # PARTIAL rotary (factor 0.4-0.5 from config.json)
    lm_head_bias="lm_head.bias",
    final_norm="model.final_layernorm.weight",
    final_norm_bias="model.final_layernorm.bias",
    attn_norm_bias="model.layers.{layer}.input_layernorm.bias",
    mlp_norm=None,
    q_bias="model.layers.{layer}.self_attn.q_proj.bias",
    k_bias="model.layers.{layer}.self_attn.k_proj.bias",
    v_bias="model.layers.{layer}.self_attn.v_proj.bias",
    o_proj="model.layers.{layer}.self_attn.dense.weight",
    o_bias="model.layers.{layer}.self_attn.dense.bias",
    fc1="model.layers.{layer}.mlp.fc1.weight",
    fc1_bias="model.layers.{layer}.mlp.fc1.bias",
    fc2="model.layers.{layer}.mlp.fc2.weight",
    fc2_bias="model.layers.{layer}.mlp.fc2.bias",
    gate_proj=None, up_proj=None, down_proj=None,
    norm_type="layernorm",
    activation="gelu",
    parallel_block=True,
    default_norm_eps=1e-5,
    hf_model_type="phi",
)

NEMOTRON_SPEC = ModelSpec(
    name="nemotron",
    # Nemotron (HF modeling_nemotron): LayerNorm1P (effective weight =
    # 1 + w — folded at load via norm_plus_one, bias kept), gateless
    # up->relu^2->down MLP, split-half PARTIAL rotary (factor 0.5)
    final_norm_bias="model.norm.bias",
    attn_norm_bias="model.layers.{layer}.input_layernorm.bias",
    mlp_norm_bias="model.layers.{layer}.post_attention_layernorm.bias",
    fc1="model.layers.{layer}.mlp.up_proj.weight",
    fc2="model.layers.{layer}.mlp.down_proj.weight",
    gate_proj=None, up_proj=None, down_proj=None,
    norm_type="layernorm",
    activation="relu2",
    norm_plus_one=True,
    default_norm_eps=1e-5,
    hf_model_type="nemotron",
)

PHI3_SPEC = ModelSpec(
    name="phi3",
    # fused checkpoint projections: qkv_proj [(Hq+2Hk)D, E] and
    # gate_up_proj [2I, E] — split at load into the standard leaves
    q_proj="model.layers.{layer}.self_attn.qkv_proj.weight",
    o_proj="model.layers.{layer}.self_attn.o_proj.weight",
    gate_proj="model.layers.{layer}.mlp.gate_up_proj.weight",
    up_proj=None,
    down_proj="model.layers.{layer}.mlp.down_proj.weight",
    qkv_combined=True,
    gate_up_combined=True,
    default_rope_theta=10000.0,
    hf_model_type="phi3",
)


MODEL_SPECS: dict[str, ModelSpec] = {
    s.name: s for s in (
        GPT2_SPEC, LLAMA_SPEC, QWEN2_SPEC, QWEN3_SPEC, QWEN3_MOE_SPEC,
        MIXTRAL_SPEC, GEMMA2_SPEC, GEMMA3_SPEC, PHI3_SPEC, OLMO2_SPEC,
        COHERE_SPEC, STARCODER2_SPEC, GLM4_SPEC, NEMOTRON_SPEC, PHI_SPEC,
        SEED_OSS_SPEC, APERTUS_SPEC,
    )
}


def _merge_rope_scaling(hf: dict) -> dict | None:
    """rope_scaling dict with original_max_position_embeddings folded in —
    Phi-3 stores it at the TOP level of config.json while the longrope
    table math needs it alongside short_factor/long_factor."""
    rs = hf.get("rope_scaling")
    if (rs and "original_max_position_embeddings" not in rs
            and "original_max_position_embeddings" in hf):
        rs = {**rs,
              "original_max_position_embeddings":
                  hf["original_max_position_embeddings"]}
    return rs


def detect_model_spec(tensor_names: list[str]) -> ModelSpec:
    """Pattern-match architecture from checkpoint tensor names
    (reference: detect_model_spec, llm/config.py:393)."""
    names = set(tensor_names)
    if any("block_sparse_moe" in n for n in names):
        return MIXTRAL_SPEC
    has_experts = any("mlp.experts" in n for n in names)
    has_qk_norm = any(".q_norm." in n or n.endswith("q_norm.weight") for n in names)
    if any("pre_feedforward_layernorm" in n for n in names):
        return GEMMA3_SPEC if has_qk_norm else GEMMA2_SPEC
    if any("post_feedforward_layernorm" in n for n in names):
        return OLMO2_SPEC    # post-only norms (gemma has BOTH pre+post)
    if any("post_self_attn_layernorm" in n for n in names):
        return GLM4_SPEC
    if "model.layers.0.attention_layernorm.weight" in names:
        return APERTUS_SPEC
    if "model.layers.0.mlp.c_fc.weight" in names:
        return STARCODER2_SPEC
    if ("model.layers.0.mlp.up_proj.weight" in names
            and "model.layers.0.mlp.gate_proj.weight" not in names):
        return NEMOTRON_SPEC    # gateless relu2 MLP
    if "model.layers.0.self_attn.dense.weight" in names:
        return PHI_SPEC
    if ("model.layers.0.input_layernorm.weight" in names
            and "model.layers.0.post_attention_layernorm.weight"
            not in names):
        # ONE shared input norm = cohere's parallel block (its optional
        # qk-norms must not fall through to the qwen3 branch)
        return COHERE_SPEC
    if has_experts and has_qk_norm:
        return QWEN3_MOE_SPEC
    if has_qk_norm:
        return QWEN3_SPEC
    if "model.layers.0.self_attn.qkv_proj.weight" in names:
        return PHI3_SPEC
    if "model.embed_tokens.weight" in names:
        if "model.layers.0.self_attn.q_proj.bias" in names:
            if "model.layers.0.self_attn.o_proj.bias" in names:
                return SEED_OSS_SPEC    # all-four biases (qwen2: q/k/v only)
            return QWEN2_SPEC
        return LLAMA_SPEC
    if "wte.weight" in names:
        return GPT2_SPEC
    raise ValueError(
        f"cannot detect model architecture; first names: {sorted(names)[:10]}")


@dataclass
class TransformerConfig:
    """Unified hyperparameter config (reference: TransformerConfig,
    llm/config.py:440)."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int | None = None
    intermediate_size: int | None = None
    head_dim_override: int | None = None

    # MoE
    num_experts: int | None = None
    num_experts_per_tok: int = 2
    moe_intermediate_size: int | None = None

    norm_type: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    activation: Literal["gelu", "silu", "gelu_tanh", "relu2",
                        "xielu"] = "silu"
    use_rope: bool = True
    use_qk_norm: bool = False
    use_position_embed: bool = False
    causal: bool = True

    max_position_embeddings: int = 2048
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: dict | None = None   # {"type": "yarn"|"linear"|"ntk", ...}
    tie_word_embeddings: bool = True

    # Gemma-family extensions
    use_post_norms: bool = False       # sandwich norms on sublayer outputs
    embed_scale: float | None = None   # h *= embed_scale after embedding
    query_scale: float | None = None   # softmax scale override (gemma:
    #                                    query_pre_attn_scalar**-0.5)
    attn_logit_softcap: float | None = None    # cap*tanh(scores/cap)
    final_logit_softcap: float | None = None   # cap*tanh(logits/cap)
    sliding_window: int | None = None
    # per-layer "sliding_attention"/"full_attention"; None with
    # sliding_window set = every layer slides (mistral convention)
    layer_types: tuple[str, ...] | None = None
    # gemma3: sliding layers use a separate local rope theta
    rope_local_theta: float | None = None

    # OLMo-2 extensions: no pre-norms (sublayers read the raw residual
    # stream; combined with use_post_norms this gives
    # h += post_norm(sublayer(h)) — HF modeling_olmo2.Olmo2DecoderLayer),
    # and q/k norms applied over the WHOLE projection width before the
    # head reshape (Olmo2Attention.q_norm, width Hq*D) instead of
    # per-head (Qwen3 convention)
    pre_norms: bool = True
    qk_norm_wide: bool = False

    # Cohere (Command-R) extensions: PARALLEL residual block
    # (h += attn(norm(h)) + mlp(norm(h)) — ONE shared input norm,
    # HF modeling_cohere.CohereDecoderLayer), interleaved even/odd rope
    # pairs (repeat_interleave tables + pairwise rotate_half), and a
    # constant logits multiplier
    parallel_block: bool = False
    rope_interleaved: bool = False
    logit_scale: float | None = None
    # GLM-4 / phi-class partial rotary: only the first
    # partial_rotary_factor * head_dim dims rotate; the rest pass through
    rope_partial_factor: float = 1.0
    # Granite: sublayer outputs scaled before the residual add
    # (h += residual_multiplier * sublayer(norm(h)))
    residual_multiplier: float | None = None
    # SmolLM3: per-layer rope switch (HF no_rope_layers — 1 = rope,
    # 0 = NoPE); None = every layer ropes
    rope_layers: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size
        if self.moe_intermediate_size is None:
            self.moe_intermediate_size = self.intermediate_size

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_heads

    @property
    def rope_dim(self) -> int:
        """Rotated dims per head (partial rotary); even by construction."""
        rd = int(self.head_dim * self.rope_partial_factor)
        return rd - (rd % 2)

    @property
    def attn_scale(self) -> float:
        if self.query_scale is not None:
            return self.query_scale
        return self.head_dim ** -0.5

    def layer_windows(self) -> list[int] | None:
        """Per-layer sliding windows, 0 = full attention; None when no
        layer slides (the common case — keeps the param pytree unchanged)."""
        if self.sliding_window is None:
            return None
        if self.layer_types is None:
            return [self.sliding_window] * self.num_layers
        return [self.sliding_window if t == "sliding_attention" else 0
                for t in self.layer_types]

    @property
    def is_moe(self) -> bool:
        return self.num_experts is not None and self.num_experts > 1

    @property
    def num_kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    @classmethod
    def from_hf_config(cls, hf: dict, spec: ModelSpec | None = None
                       ) -> "TransformerConfig":
        """Build from a HuggingFace config.json dict."""
        mt = hf.get("model_type", "")
        if spec is None:
            spec = MODEL_SPECS.get(mt) or next(
                (s for s in MODEL_SPECS.values() if s.hf_model_type == mt),
                LLAMA_SPEC)
        if mt == "gpt2" or spec.name == "gpt2":
            return cls(
                vocab_size=hf.get("vocab_size", 50257),
                hidden_size=hf.get("n_embd", 768),
                num_layers=hf.get("n_layer", 12),
                num_heads=hf.get("n_head", 12),
                norm_type="layernorm", activation="gelu", use_rope=False,
                use_position_embed=True,
                max_position_embeddings=hf.get("n_positions", 1024),
                norm_eps=hf.get("layer_norm_epsilon", 1e-5),
            )
        kw = {}
        if spec.name == "phi3":
            # phi3 applies one sliding window to EVERY layer (mistral
            # convention) when config.json sets it (mini-4k: 2047)
            kw = dict(sliding_window=hf.get("sliding_window"))
        elif mt == "mistral":
            # mistral-v0.1 class: sliding_window set -> every layer slides
            kw = dict(sliding_window=hf.get("sliding_window"))
        elif mt == "starcoder2" or spec.name == "starcoder2":
            kw = dict(sliding_window=hf.get("sliding_window"),
                      norm_eps=hf.get("norm_epsilon", 1e-5),
                      tie_word_embeddings=hf.get("tie_word_embeddings",
                                                 True))
        elif mt == "glm4" or spec.name == "glm4":
            kw = dict(use_post_norms=True)
        elif mt == "nemotron" or spec.name == "nemotron":
            kw = dict(norm_eps=hf.get("norm_eps", 1e-5))
        elif mt == "phi" or spec.name == "phi":
            kw = dict(norm_eps=hf.get("layer_norm_eps", 1e-5))
        elif mt == "ernie4_5":
            # Ernie 4.5 = llama layout with INTERLEAVED rope pairs
            # (modeling_ernie4_5.rotate_half works on even/odd pairs)
            kw = dict(rope_interleaved=True,
                      tie_word_embeddings=hf.get("tie_word_embeddings",
                                                 True))
        elif mt in ("granite", "granitemoe"):
            # IBM Granite = llama + four scalar multipliers
            # (modeling_granite: "main diff with Llama" sites)
            kw = dict(tie_word_embeddings=hf.get("tie_word_embeddings",
                                                 True))
            if hf.get("embedding_multiplier", 1.0) != 1.0:
                kw["embed_scale"] = hf["embedding_multiplier"]
            if hf.get("attention_multiplier") is not None:
                kw["query_scale"] = hf["attention_multiplier"]
            if hf.get("residual_multiplier", 1.0) != 1.0:
                kw["residual_multiplier"] = hf["residual_multiplier"]
            if hf.get("logits_scaling", 1.0) != 1.0:
                kw["logit_scale"] = 1.0 / hf["logits_scaling"]
        elif mt == "smollm3":
            # llama layout + NoPE every no_rope_layer_interval-th layer
            # (no_rope_layers: 1 = rope, 0 = NoPE) + the qwen-style
            # use_sliding_window gate. HF DEFAULTS (SmolLM3Config.__init__):
            # interval=4 when both keys are absent, and layer_types derive
            # as sliding ONLY on NoPE layers.
            n_layers = hf.get("num_hidden_layers", 22)
            kw = dict(tie_word_embeddings=hf.get("tie_word_embeddings",
                                                 True))
            nrl = hf.get("no_rope_layers")
            if nrl is None:
                iv = hf.get("no_rope_layer_interval", 4)
                nrl = [0 if (i + 1) % iv == 0 else 1
                       for i in range(n_layers)]
            kw["rope_layers"] = tuple(int(x) for x in nrl)
            if hf.get("use_sliding_window", False) and hf.get(
                    "sliding_window") is not None:
                lt = hf.get("layer_types")
                if lt is None:
                    # HF: sliding on NoPE layers only, full elsewhere
                    lt = ["full_attention" if r else "sliding_attention"
                          for r in nrl]
                kw["layer_types"] = tuple(lt)
                kw["sliding_window"] = hf.get("sliding_window")
        elif mt in ("qwen2", "qwen3", "qwen3_moe"):
            # qwen configs CARRY sliding_window but gate it behind
            # use_sliding_window (default off); layers >= max_window_layers
            # slide (HF serialises the derived layer_types — prefer it)
            if hf.get("use_sliding_window", False) and hf.get(
                    "sliding_window") is not None:
                n_layers = hf.get("num_hidden_layers", 22)
                mwl = hf.get("max_window_layers", n_layers)
                lt = hf.get("layer_types") or [
                    "sliding_attention" if i >= mwl else "full_attention"
                    for i in range(n_layers)]
                kw = dict(sliding_window=hf.get("sliding_window"),
                          layer_types=tuple(lt))
        if mt == "cohere" or spec.name == "cohere":
            kw = dict(
                logit_scale=hf.get("logit_scale", 0.0625),
                norm_eps=hf.get("layer_norm_eps", 1e-5),
                use_qk_norm=hf.get("use_qk_norm", False),
                tie_word_embeddings=hf.get("tie_word_embeddings", True),
            )
        if spec.name in ("gemma2", "gemma3"):
            n_layers = hf.get("num_hidden_layers", 22)
            lt = hf.get("layer_types")
            if lt is None:
                # gemma2: sliding on even layers; gemma3: 5 sliding : 1 full
                if spec.name == "gemma2":
                    lt = ["sliding_attention" if i % 2 == 0
                          else "full_attention" for i in range(n_layers)]
                else:
                    lt = ["full_attention" if (i + 1) % 6 == 0
                          else "sliding_attention" for i in range(n_layers)]
            kw = dict(
                use_post_norms=True,
                embed_scale=hf.get("hidden_size", 2304) ** 0.5,
                query_scale=hf.get("query_pre_attn_scalar", 256) ** -0.5,
                sliding_window=hf.get("sliding_window", 4096),
                layer_types=tuple(lt),
                head_dim_override=hf.get("head_dim", 256),
                tie_word_embeddings=hf.get("tie_word_embeddings", True),
            )
            if spec.name == "gemma2":
                kw["attn_logit_softcap"] = hf.get("attn_logit_softcapping",
                                                  50.0)
                kw["final_logit_softcap"] = hf.get("final_logit_softcapping",
                                                   30.0)
            else:
                kw["rope_local_theta"] = hf.get("rope_local_base_freq",
                                                10000.0)
        base = dict(
            vocab_size=hf.get("vocab_size", 32000),
            hidden_size=hf.get("hidden_size", 2048),
            num_layers=hf.get("num_hidden_layers", 22),
            num_heads=hf.get("num_attention_heads", 32),
            num_kv_heads=hf.get("num_key_value_heads"),
            intermediate_size=hf.get("intermediate_size"),
            head_dim_override=hf.get("head_dim"),
            num_experts=hf.get("num_local_experts", hf.get("num_experts")),
            num_experts_per_tok=hf.get("num_experts_per_tok", 2),
            moe_intermediate_size=hf.get("moe_intermediate_size"),
            norm_type=spec.norm_type,
            activation=spec.activation,
            use_rope=spec.use_rope,
            use_qk_norm=spec.use_qk_norm,
            pre_norms=spec.pre_norms,
            qk_norm_wide=spec.qk_norm_wide,
            # olmo2 (post-only) and glm4 (sandwich) both imply post norms
            # from the spec; gemma sets it via kw as well
            use_post_norms=(spec.post_attn_norm is not None
                            or not spec.pre_norms),
            parallel_block=spec.parallel_block,
            rope_interleaved=spec.rope_interleaved,
            max_position_embeddings=hf.get("max_position_embeddings", 2048),
            norm_eps=hf.get("rms_norm_eps", spec.default_norm_eps),
            rope_theta=hf.get("rope_theta", spec.default_rope_theta),
            rope_scaling=_merge_rope_scaling(hf),
            rope_partial_factor=hf.get(
                "partial_rotary_factor",
                0.5 if spec.name in ("glm4", "nemotron") else 1.0),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
        )
        base.update(kw)
        return cls(**base)


# =============================================================================
# Legacy config classes (reference: llm/config.py:515-615 — GPT2Config,
# LlamaConfig, Qwen3Config with to_transformer_config())
# =============================================================================


@dataclass
class GPT2Config:
    vocab_size: int = 50257
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_positions: int = 1024
    layer_norm_eps: float = 1e-5

    @property
    def n_inner(self) -> int:
        return 4 * self.n_embd

    def to_transformer_config(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size, hidden_size=self.n_embd,
            num_layers=self.n_layer, num_heads=self.n_head,
            intermediate_size=self.n_inner, norm_type="layernorm",
            activation="gelu", use_rope=False, use_position_embed=True,
            max_position_embeddings=self.n_positions,
            norm_eps=self.layer_norm_eps)


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0

    def to_transformer_config(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_layers=self.num_hidden_layers,
            num_heads=self.num_attention_heads,
            num_kv_heads=self.num_key_value_heads,
            intermediate_size=self.intermediate_size,
            max_position_embeddings=self.max_position_embeddings,
            norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta)


@dataclass
class Qwen3Config:
    vocab_size: int = 151936
    hidden_size: int = 4096
    intermediate_size: int = 12288
    num_hidden_layers: int = 36
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 128
    max_position_embeddings: int = 40960
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0

    def to_transformer_config(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_layers=self.num_hidden_layers,
            num_heads=self.num_attention_heads,
            num_kv_heads=self.num_key_value_heads,
            intermediate_size=self.intermediate_size,
            head_dim_override=self.head_dim, use_qk_norm=True,
            max_position_embeddings=self.max_position_embeddings,
            norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta)
