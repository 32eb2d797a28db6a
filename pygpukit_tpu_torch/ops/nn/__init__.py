from .activation import gelu_fn, swiglu_fn
from .attention import flash_attention_fn, sdpa_causal_fn
from .norm import layernorm_fn, rmsnorm_fn
from .rope import apply_rope_fn, rope_init

__all__ = ["gelu_fn", "swiglu_fn", "flash_attention_fn", "sdpa_causal_fn",
           "layernorm_fn", "rmsnorm_fn", "apply_rope_fn", "rope_init"]
