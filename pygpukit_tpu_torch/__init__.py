"""pygpukit_tpu_torch: the PyTorch + CUDA port of pygpukit_tpu.

The JAX package ``pygpukit_tpu`` stays the reference; module paths and
function names here mirror it. This package imports torch and never jax.
Every kernel the reference wrote in Pallas becomes a hand-written Hopper
kernel (``csrc/``, built by ``kernels/_build.py`` on first use) with a
plain PyTorch version beside it: CUDA tensors launch the kernel, CPU
tensors run the plain version. Public constructors place their tensors on
``cuda:0`` unless the caller names a device (``device="cpu"``).

Ported so far: the NumPy-like Array API (``Array``/``GPUArray``, the
factory, elementwise, unary, reduction, layout, matmul and neural ops,
``sdpa_causal_fixed_cache``, sampling) with its GEMM behind
``PYGPUKIT_GEMM=pallas``; the int4 batch-8 serving path (``llm.serving``)
over the unified causal LM (``llm.model``), dense or paged
(``llm.serving_paged``, ``ops.paged``), pipelined or not; the decode
weight-format ladder; the uncached forward (``CausalTransformerModel.forward``
/ ``get_logits``, ``ops.nn.flash_attention_fn``) with uncached and top-p
generation; the single-stream fixed-cache decode, its position an int or
a device tensor; the MoE family's routed expert MLP (``ops.moe``,
Mixtral); the decode strategies (``llm.decode``: M1, M1Graph, Batch,
Jacobi, Speculative) with ``speculative_scan_fn`` and ``slice_layers``;
capture and replay (``core.capture``: CUDA graphs on the card, the
reference's ``Executable`` API) with ``llm.buffers``; checkpoint loading
and the model API (``llm.safetensors``, ``llm.config``'s specs and
``from_hf_config``, ``llm.loader``, ``llm.streaming``, ``llm.tokenizer``,
``llm.chat``, ``llm.layers``); the standalone families (``llm.models``)
with the hybrid engine (``llm.serving_hybrid``); the fused and batching
ops, the host sampler (``llm.sampling``) and the core services (logical
streams and events, device and memory queries, host copies); Whisper
speech recognition (``asr.whisper``) with the audio DSP library
(``ops.audio``) and the f32 precision scope (``ops.precision``); Kokoro
speech synthesis (``tts.kokoro``: Kokoro-82M from its checkpoint and the
simple layer stack) with the convolutions (``ops.conv``) and the LSTM
(``ops.nn.recurrent``); the LLM-to-speech and voice pipelines
(``pipeline``); image generation (``diffusion``: FLUX.1 with its CLIP and
T5 encoders and the VAE, SD3 and PixArt, the schedulers and pipelines);
the runtime services (the backend choice, ``get_backend``/``set_backend``;
the native-backed ``memory`` pool, ``scheduler`` with its partitions and
multi-model controller, and ``transfer`` engine, built from ``native/``
into ``build/pygpukit_tpu_torch/``; ``dispatch``, ``jit``, ``profiling``
and the ``benchmark`` CLI); and the fifteen kernels. The reference's
``is_tpu_available`` is ``is_cuda_available`` here.
"""

from . import (asr, benchmark, core, diffusion, dispatch, jit, kernels, llm, memory, ops,
               pipeline, profiling, scheduler, transfer, tts)
from .core import (Array, Backend, DataType, DataTypeKind, Event, Stream, StreamManager,
                   StreamPriority, arange, capture, default_stream, device_count, dtypes,
                   empty, from_numpy, full, get_backend, get_device_info, get_memory_info,
                   interpret_mode, is_cuda_available, ones, ones_like, randn, require_cuda,
                   reset_backend, resolve_device, set_backend, set_deterministic_numerics,
                   synchronize, to_dtype, zeros, zeros_like)
from .core.dtypes import (bfloat16, bool_, float8_e4m3, float8_e5m2, float16,
                          float32, float64, fp8, int4, int8, int16, int32, int64,
                          uint8, uint16, uint32)
from .kernels import (LAUNCHES, batch_decode_attention, kv_rows_write,
                      paged_attention, reset_launches, w4a8_matmul)
from .llm import (CausalTransformerModel, ContinuousBatchingEngine,
                  EngineStats, Request, Tokenizer, TransformerConfig,
                  apply_chat_template, fuse_params, init_params,
                  load_model_from_safetensors, params_from_jax,
                  quantize_model_params, quantize_weight)
from .ops import (add, add_scaled, argmax, argmin, batched_matmul, cast, clamp,
                  concat, cos, cumsum, div, embedding_lookup, exp, flash_attention,
                  geglu, gelu, gemv, grouped_matmul, l2norm, layernorm, log,
                  log_softmax, matmul, matmul_fp8, matmul_int8, matmul_nt,
                  matmul_w8a16, max, maximum, mean, min, minimum, mul, neg, relu,
                  relu2, rmsnorm, rope_init, rope_inplace, rsqrt, sample_token_gpu,
                  sdpa_causal, sdpa_causal_fixed_cache, set_sampling_seed, sigmoid,
                  silu, sin, softmax, sqrt, sub, sum, sum_axis, swiglu, tanh, where)
from .ops.nn.fused import linear_bias_gelu
from .ops.nn.recurrent import lstm as lstm_forward
from .ops.tensor import transpose_2d as transpose
from .ops.unary import abs  # noqa: A004 - reference API name
from .jit.compiler import JITKernel, get_warmup_error, is_warmup_done, warmup

# The reference's name for the NumPy-like device array.
GPUArray = Array
