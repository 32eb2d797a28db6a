from .config import TransformerConfig
from .convert import params_from_jax, tensor_from_numpy
from .model import (CausalTransformerModel, batch_decode_step_fn,
                    batch_generate_scan_fn, check_supported, decode_step_fn,
                    fuse_params, init_params, prefill_fn, sample_logits)
from .quant import (dequantize_weight, quantize_model_params, quantize_weight,
                    unpack_int4)
from .serving import ContinuousBatchingEngine, EngineStats, Request

__all__ = ["TransformerConfig", "params_from_jax", "tensor_from_numpy",
           "CausalTransformerModel", "batch_decode_step_fn",
           "batch_generate_scan_fn", "check_supported", "decode_step_fn",
           "fuse_params", "init_params", "prefill_fn", "sample_logits",
           "dequantize_weight",
           "quantize_model_params", "quantize_weight", "unpack_int4",
           "ContinuousBatchingEngine", "EngineStats", "Request"]
