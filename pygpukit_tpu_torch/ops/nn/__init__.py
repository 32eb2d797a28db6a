from . import activation, attention, norm, rope
from .activation import (geglu, geglu_fn, gelu, gelu_fn, relu, relu2, relu2_fn,
                         relu_fn, silu, silu_fn, swiglu, swiglu_fn)
from .attention import (decode_pref, flash_attention, flash_attention_fn,
                        sdpa_causal, sdpa_causal_fixed_cache, sdpa_causal_fn,
                        sdpa_fixed_cache_chunked_fn, sdpa_fixed_cache_fn)
from .norm import (l2norm, l2norm_fn, layernorm, layernorm_fn, rmsnorm,
                   rmsnorm_fn)
from .rope import apply_rope_fn, rope_init, rope_inplace, rope_tables

__all__ = ["activation", "attention", "norm", "rope",
           "geglu", "geglu_fn", "gelu", "gelu_fn", "relu", "relu2", "relu2_fn",
           "relu_fn", "silu", "silu_fn", "swiglu", "swiglu_fn",
           "decode_pref", "flash_attention", "flash_attention_fn", "sdpa_causal",
           "sdpa_causal_fixed_cache", "sdpa_causal_fn",
           "sdpa_fixed_cache_chunked_fn", "sdpa_fixed_cache_fn",
           "l2norm", "l2norm_fn", "layernorm", "layernorm_fn", "rmsnorm",
           "rmsnorm_fn", "apply_rope_fn", "rope_init", "rope_inplace", "rope_tables"]
