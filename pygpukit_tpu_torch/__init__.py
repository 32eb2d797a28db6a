"""pygpukit_tpu_torch: the PyTorch + CUDA port of pygpukit_tpu.

The JAX package ``pygpukit_tpu`` stays the reference; module paths and
function names here mirror it. This package imports torch and never jax.
Every kernel the reference wrote in Pallas becomes a hand-written Hopper
kernel (``csrc/``, built by ``kernels/_build.py`` on first use) with a
plain PyTorch version beside it: CUDA tensors launch the kernel, CPU
tensors run the plain version.

Ported so far: the int4 batch-8 serving path (``llm.serving``) over the
unified causal LM (``llm.model``), dense or paged (``llm.serving_paged``,
``ops.paged``), pipelined or not; the decode weight-format ladder; the
uncached forward (``CausalTransformerModel.forward`` / ``get_logits``,
``ops.nn.flash_attention_fn``) with uncached and top-p generation; and
their eleven kernels.
"""

from .core import get_device, require_cuda, set_deterministic_numerics
from .kernels import (LAUNCHES, batch_decode_attention, kv_rows_write,
                      paged_attention, reset_launches, w4a8_matmul)
from .llm import (CausalTransformerModel, ContinuousBatchingEngine,
                  EngineStats, Request, TransformerConfig, fuse_params,
                  init_params, params_from_jax, quantize_model_params,
                  quantize_weight)

__all__ = ["get_device", "require_cuda", "set_deterministic_numerics",
           "LAUNCHES", "batch_decode_attention", "kv_rows_write",
           "paged_attention", "reset_launches", "w4a8_matmul",
           "CausalTransformerModel", "ContinuousBatchingEngine", "EngineStats", "Request",
           "TransformerConfig", "fuse_params", "init_params",
           "params_from_jax", "quantize_model_params", "quantize_weight"]
