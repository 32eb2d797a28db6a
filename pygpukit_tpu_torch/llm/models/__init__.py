"""The standalone model families (counterpart of
``pygpukit_tpu/llm/models``), each with its own params tree, caches and
greedy ``generate``:
- DeepSeek-V3/R1 and V2 (``deepseek.py``: Multi-head Latent Attention and
  MoE) and gpt-oss (``gptoss.py``: attention sinks, clamped-SwiGLU
  experts), their caches two stacked tensors (``_standalone.py``);
- Llama-4 / Llama-Guard-4 (``llama4.py``: interleaved rope, the QK norm,
  NoPE layers with the iRoPE temperature), no cache;
- Mamba and FalconMamba (``mamba.py``: the selective scan), LFM2
  (``lfm2.py``: gated short convs beside attention) and Qwen3-Next
  (``qwen3next.py``: gated DeltaNet beside gated attention, a 512-expert
  MoE), their caches one per-layer tree (``_base.py``).
The cached families are batch-served by
``llm.serving_hybrid.HybridServingEngine``."""

from .deepseek import DeepseekV3Config, DeepseekV3Model
from .gptoss import GptOssConfig, GptOssModel
from .lfm2 import Lfm2Config, Lfm2Model
from .llama4 import Llama4Config, Llama4Model
from .mamba import MambaConfig, MambaModel
from .qwen3next import Qwen3NextConfig, Qwen3NextModel

__all__ = ["DeepseekV3Config", "DeepseekV3Model", "GptOssConfig", "GptOssModel",
           "Lfm2Config", "Lfm2Model", "Llama4Config", "Llama4Model", "MambaConfig",
           "MambaModel", "Qwen3NextConfig", "Qwen3NextModel"]
