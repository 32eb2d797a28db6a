"""Ops re-export hub (counterpart of ``pygpukit_tpu/ops/__init__.py``): the
reference's names for every ported module, the audio library included
(``ops.audio``, with ``ops.precision`` beside it). Not ported, so not
exported: conv and the recurrent ops (they go with the TTS and diffusion
stacks). The rope variants, ALiBi and PoPE are exported by ``ops.nn``, as
the reference exports them."""

from . import (audio, batching, elementwise, embedding, matmul, moe, nn, paged, reduction,
               sampling, tensor, unary)
from .batching import (argmax_sample, check_eos, gather_embeddings, prepare_position_ids,
                       scatter_last_token_logits)
from .elementwise import add, add_scaled, clamp, div, maximum, minimum, mul, sub, where
from .embedding import (embedding_lookup, embedding_lookup_batch, kv_cache_prefill,
                        kv_cache_prefill_gqa, kv_cache_update, kv_cache_update_gqa,
                        kv_cache_zeros, kv_dequant, kv_leaf, kv_quant_rows, kv_write,
                        to_kv_dtype)
from .matmul import (batched_matmul, fp8_available, gemv, gemv_bf16, gemv_int4,
                     gemv_w8a16, grouped_matmul, int4_available, int8_available,
                     matmul, matmul_fp8, matmul_int8, matmul_nt, matmul_w8a16,
                     quantize_fp8, quantize_int4, quantize_int8, w8a16_available)
from .nn import (flash_attention, geglu, gelu, l2norm, layernorm, relu, relu2,
                 rmsnorm, rope_init, rope_inplace, sdpa_causal,
                 sdpa_causal_fixed_cache, silu, swiglu)
from .nn.fused import linear_bias_gelu
from .paged import (PagedKVCache, paged_attention_batch_fn,
                    paged_attention_dispatch, paged_attention_fn,
                    reshape_and_cache_fn)
from .reduction import (argmax, argmin, cumsum, log_softmax, max, mean, min,
                        softmax, sum, sum_axis)
from .sampling import (sample_greedy_fn, sample_multinomial, sample_temperature_fn,
                       sample_token_gpu, sample_topk_fn, sample_topp_fn,
                       set_sampling_seed)
from .tensor import (cast, cast_bf16_to_f32, cast_f32_to_bf16, cast_f32_to_f16,
                     concat, pad, repeat, reshape_copy, transpose_2d,
                     transpose_3d_021, transpose_3d_102, transpose_4d_0213,
                     transpose_4d_0231)
from .unary import (abs, ceil, cos, exp, floor, log, neg, reciprocal, rsqrt,
                    sigmoid, sign, sin, sqrt, tan, tanh)

# Reference-name aliases (reference ops/__init__.py:54-124).
transpose = transpose_2d
rope_inplace_f32table = rope_inplace      # tables are always f32 here
cast_f16_to_f32 = cast_bf16_to_f32


def sample_greedy(logits):
    """Greedy token id."""
    return sample_token_gpu(logits, temperature=0.0)


def sample_topk(logits, k: int, temperature: float = 1.0):
    return sample_token_gpu(logits, temperature=temperature, top_k=k)


def sample_topp(logits, p: float, temperature: float = 1.0):
    return sample_token_gpu(logits, temperature=temperature, top_p=p)


def add_inplace(a, b):
    """a += b through the out= rebind."""
    return add(a, b, out=a)


def mul_inplace(a, b):
    return mul(a, b, out=a)


def bias_add_inplace(a, bias):
    """Row-broadcast bias add."""
    return add(a, bias, out=a)


def concat_axis0(arrays, *, out=None):
    return concat(arrays, axis=0, out=out)


def copy_to(src, dst):
    """Copy src into dst's handle (dst rebound to src in dst's dtype)."""
    return cast(src, dst.dtype, out=dst)


def repeat_interleave_axis1(a, repeats: int, *, out=None):
    """GQA head expansion [.., Hk, ..] -> [.., Hk*r, ..]."""
    return repeat(a, repeats, axis=1, out=out)


def split_qkv_batch(qkv, n_heads: int, n_kv_heads: int, head_dim: int):
    """[S, (Hq+2Hk)*D] fused projection -> (q, k, v)."""
    from ..core.array import Array, as_tensor
    x = as_tensor(qkv)
    qd, kd = n_heads * head_dim, n_kv_heads * head_dim
    q, k, v = x[..., :qd], x[..., qd:qd + kd], x[..., qd + kd:qd + 2 * kd]
    if isinstance(qkv, Array):
        return Array(q), Array(k), Array(v)
    return q, k, v
