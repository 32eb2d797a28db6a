"""Model hyperparameters (a copy of ``TransformerConfig`` from
``pygpukit_tpu/llm/config.py``; importing that module loads jax through the
reference package's ``__init__``). ``from_hf_config`` and the model specs
come with checkpoint loading.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal


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
