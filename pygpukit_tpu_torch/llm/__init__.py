from . import decode
from .buffers import (BatchDecodeBuffers, DecodeBuffers, PrefillBuffers,
                      kv_cache_nbytes)
from .chat import (ChatMessage, apply_chat_template, apply_guard_template,
                   create_chat_prompt, format_chat_messages)
from .config import (GPT2_SPEC, LLAMA_SPEC, MIXTRAL_SPEC, MODEL_SPECS, QWEN2_SPEC,
                     QWEN3_MOE_SPEC, QWEN3_SPEC, GPT2Config, LlamaConfig, ModelSpec,
                     Qwen3Config, TransformerConfig, detect_model_spec)
from .decode import (STRATEGIES, DecodeBatch, DecodeJacobi, DecodeM1, DecodeM1Graph,
                     DecodeSpeculative, DecodeStats, DecodeStrategy)
from .convert import params_from_jax, tensor_from_numpy
from .layers import (MLP, Attention, CausalSelfAttention, LayerNorm, Linear,
                     LinearBF16, LinearFP8, LlamaAttention, LlamaBlock, LlamaMLP,
                     MoELayer, Norm, RMSNorm, TransformerBlock, precompute_freqs_cis)
from .loader import (load_gpt2_from_safetensors, load_llama_from_safetensors,
                     load_mixtral_from_safetensors, load_model_from_safetensors,
                     load_qwen3_from_safetensors)
from .model import (CausalTransformerModel, KVSnapshot, batch_decode_step_fn,
                    batch_generate_scan_fn, check_supported, decode_step_fn,
                    decode_window_fn, forward_fn, fuse_params,
                    fused_decode_eligible, fused_decode_step_fn,
                    generate_scan_fn, init_params, layer_stack_fn,
                    prefill_fn, prepare_fused_decode_params, resolve_kv_dtype,
                    sample_logits, slice_layers, speculative_scan_fn, use_fused_decode)
from .quant import (FP8QuantConfig, ModelOptimizationInfo, PruningConfig, QATConfig,
                    QATQuantConfig, QuantizationMetadata, SparsityConfig,
                    dequantize_model_params, dequantize_weight, kv_dtype_from_quant_config,
                    model_quant_bytes, quantize_model_params, quantize_weight,
                    unpack_int4)
from .safetensors import (LazyModelLoader, SafeTensorsFile, ShardedSafeTensorsFile,
                          TensorInfo, TensorState, load_model_params, load_safetensors,
                          save_model_params, save_safetensors)
from .sampling import sample_token
from .serving import ContinuousBatchingEngine, EngineStats, Request
from .serving_paged import (BlockAllocator, paged_decode_step_fn,
                            paged_prefill_fn, paged_serve_chunk_fn)
from .streaming import (LayerStreamingContext, LoadingStrategy, StreamingConfig,
                        create_streaming_context)
from .tokenizer import Tokenizer
from ..core.dtypes import DataType as Dtype
from ..memory.pool import PoolStats

# the reference's model-class names: the unified model is each of them
GPT2Model = CausalTransformerModel
LlamaModel = CausalTransformerModel
QwenModel = CausalTransformerModel

# the reference's streaming-strategy class names, as LoadingStrategy values
SimpleStreaming = LoadingStrategy.SIMPLE
SlidingWindow = LoadingStrategy.SLIDING_WINDOW
AutoLRU = LoadingStrategy.AUTO_LRU


def apply_rotary_pos_emb_numpy(q, k, cos, sin):
    """Host-side split-half rope of q and k (numpy, f32): x [S, D] or
    [S, H, D] with tables [S, >= D/2]."""
    import numpy as np

    def rot(x):
        x = np.asarray(x, np.float32)
        half = x.shape[-1] // 2
        c, sn = np.asarray(cos)[..., :half], np.asarray(sin)[..., :half]
        if x.ndim == 3:   # [S, H, D]: broadcast over heads
            c, sn = c[:, None, :], sn[:, None, :]
        x0, x1 = x[..., :half], x[..., half:]
        return np.concatenate([x0 * c - x1 * sn, x1 * c + x0 * sn], axis=-1)

    return rot(q), rot(k)


__all__ = ["decode", "STRATEGIES", "DecodeBatch", "DecodeJacobi", "DecodeM1",
           "DecodeM1Graph", "DecodeSpeculative", "DecodeStats", "DecodeStrategy",
           "BatchDecodeBuffers", "DecodeBuffers", "PrefillBuffers", "kv_cache_nbytes",
           "slice_layers", "speculative_scan_fn", "params_from_jax", "tensor_from_numpy",
           "CausalTransformerModel", "KVSnapshot", "batch_decode_step_fn",
           "batch_generate_scan_fn", "check_supported", "decode_step_fn",
           "decode_window_fn", "fused_decode_eligible", "fused_decode_step_fn",
           "generate_scan_fn", "prepare_fused_decode_params", "use_fused_decode",
           "forward_fn", "layer_stack_fn", "fuse_params", "init_params", "prefill_fn",
           "resolve_kv_dtype", "sample_logits", "sample_token",
           "ContinuousBatchingEngine", "EngineStats", "Request",
           "BlockAllocator", "paged_decode_step_fn", "paged_prefill_fn",
           "paged_serve_chunk_fn",
           # checkpoints and the model API
           "TensorInfo", "SafeTensorsFile", "ShardedSafeTensorsFile", "load_safetensors",
           "TensorState", "LazyModelLoader", "save_safetensors", "save_model_params",
           "load_model_params",
           "ModelSpec", "MODEL_SPECS", "GPT2_SPEC", "LLAMA_SPEC", "MIXTRAL_SPEC",
           "QWEN2_SPEC", "QWEN3_SPEC", "QWEN3_MOE_SPEC", "TransformerConfig",
           "detect_model_spec", "GPT2Config", "LlamaConfig", "Qwen3Config",
           "FP8QuantConfig", "QATConfig", "QATQuantConfig", "PruningConfig",
           "SparsityConfig", "ModelOptimizationInfo", "QuantizationMetadata",
           "kv_dtype_from_quant_config", "dequantize_model_params", "model_quant_bytes",
           "dequantize_weight", "quantize_model_params", "quantize_weight", "unpack_int4",
           "load_model_from_safetensors", "load_gpt2_from_safetensors",
           "load_llama_from_safetensors", "load_qwen3_from_safetensors",
           "load_mixtral_from_safetensors",
           "LoadingStrategy", "StreamingConfig", "LayerStreamingContext",
           "create_streaming_context", "SimpleStreaming", "SlidingWindow", "AutoLRU",
           "Tokenizer", "ChatMessage", "apply_chat_template", "apply_guard_template",
           "format_chat_messages", "create_chat_prompt",
           "precompute_freqs_cis", "Linear", "LinearBF16", "LinearFP8", "RMSNorm",
           "LayerNorm", "Norm", "Attention", "CausalSelfAttention", "LlamaAttention",
           "MLP", "LlamaMLP", "MoELayer", "TransformerBlock", "LlamaBlock",
           "GPT2Model", "LlamaModel", "QwenModel", "apply_rotary_pos_emb_numpy",
           "PoolStats", "Dtype"]
