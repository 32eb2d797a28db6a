from . import decode
from .buffers import (BatchDecodeBuffers, DecodeBuffers, PrefillBuffers,
                      kv_cache_nbytes)
from .config import TransformerConfig
from .decode import (STRATEGIES, DecodeBatch, DecodeJacobi, DecodeM1, DecodeM1Graph,
                     DecodeSpeculative, DecodeStats, DecodeStrategy)
from .convert import params_from_jax, tensor_from_numpy
from .model import (CausalTransformerModel, KVSnapshot, batch_decode_step_fn,
                    batch_generate_scan_fn, check_supported, decode_step_fn,
                    decode_window_fn, forward_fn, fuse_params,
                    fused_decode_eligible, fused_decode_step_fn,
                    generate_scan_fn, init_params, layer_stack_fn,
                    prefill_fn, prepare_fused_decode_params, sample_logits,
                    slice_layers, speculative_scan_fn, use_fused_decode)
from .quant import (dequantize_weight, quantize_model_params, quantize_weight,
                    unpack_int4)
from .serving import ContinuousBatchingEngine, EngineStats, Request
from .serving_paged import (BlockAllocator, paged_decode_step_fn,
                            paged_prefill_fn, paged_serve_chunk_fn)

__all__ = ["decode", "STRATEGIES", "DecodeBatch", "DecodeJacobi", "DecodeM1",
           "DecodeM1Graph", "DecodeSpeculative", "DecodeStats", "DecodeStrategy", "BatchDecodeBuffers", "DecodeBuffers", "PrefillBuffers",
           "kv_cache_nbytes", "slice_layers", "speculative_scan_fn", "TransformerConfig", "params_from_jax", "tensor_from_numpy",
           "CausalTransformerModel", "KVSnapshot", "batch_decode_step_fn",
           "batch_generate_scan_fn", "check_supported", "decode_step_fn",
           "decode_window_fn", "fused_decode_eligible", "fused_decode_step_fn",
           "generate_scan_fn", "prepare_fused_decode_params", "use_fused_decode",
           "forward_fn", "layer_stack_fn", "fuse_params", "init_params", "prefill_fn", "sample_logits",
           "dequantize_weight",
           "quantize_model_params", "quantize_weight", "unpack_int4",
           "ContinuousBatchingEngine", "EngineStats", "Request",
           "BlockAllocator", "paged_decode_step_fn", "paged_prefill_fn",
           "paged_serve_chunk_fn"]
