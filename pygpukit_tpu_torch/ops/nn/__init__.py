from . import activation, attention, fused, llama4, norm, recurrent, rope
from .activation import (geglu, geglu_fn, gelu, gelu_fn, relu, relu2, relu2_fn,
                         relu_fn, silu, silu_fn, swiglu, swiglu_fn)
from .attention import (decode_pref, flash_attention, flash_attention_fn,
                        sdpa_causal, sdpa_causal_fixed_cache, sdpa_causal_fn,
                        sdpa_fixed_cache_chunked_fn, sdpa_fixed_cache_fn)
from .llama4 import (irope_scale_fn, irope_scale_q, irope_scale_q_fn, sdpa_irope,
                     sdpa_irope_fn)
from .norm import (groupnorm, groupnorm_fn, l2norm, l2norm_fn, layernorm, layernorm_fn,
                   qk_l2norm_fn, rmsnorm, rmsnorm_fn)
from .rope import (alibi_add_bias, alibi_bias_fn, alibi_compute_bias, alibi_init_slopes,
                   apply_rope_fn, apply_rope_interleaved_fn, pope_init_encoding,
                   pope_inplace, rope_init, rope_init_linear, rope_init_llama3,
                   rope_init_longrope, rope_init_ntk_aware, rope_init_yarn, rope_inplace,
                   rope_inplace_f32table, rope_inplace_interleaved, rope_tables,
                   rope_tables_linear, rope_tables_llama3, rope_tables_longrope,
                   rope_tables_ntk_aware, rope_tables_yarn)

__all__ = ["activation", "attention", "fused", "llama4", "norm", "recurrent", "rope",
           "geglu", "geglu_fn", "gelu", "gelu_fn", "relu", "relu2", "relu2_fn",
           "relu_fn", "silu", "silu_fn", "swiglu", "swiglu_fn",
           "decode_pref", "flash_attention", "flash_attention_fn", "sdpa_causal",
           "sdpa_causal_fixed_cache", "sdpa_causal_fn",
           "sdpa_fixed_cache_chunked_fn", "sdpa_fixed_cache_fn",
           "irope_scale_fn", "irope_scale_q", "irope_scale_q_fn", "sdpa_irope",
           "sdpa_irope_fn", "groupnorm", "groupnorm_fn", "l2norm", "l2norm_fn",
           "layernorm", "layernorm_fn", "qk_l2norm_fn", "rmsnorm", "rmsnorm_fn", "alibi_add_bias", "alibi_bias_fn", "alibi_compute_bias",
           "alibi_init_slopes", "apply_rope_fn", "apply_rope_interleaved_fn",
           "pope_init_encoding", "pope_inplace", "rope_init", "rope_init_linear",
           "rope_init_llama3", "rope_init_longrope", "rope_init_ntk_aware", "rope_init_yarn",
           "rope_inplace", "rope_inplace_f32table", "rope_inplace_interleaved",
           "rope_tables", "rope_tables_linear", "rope_tables_llama3", "rope_tables_longrope",
           "rope_tables_ntk_aware", "rope_tables_yarn"]
