"""The standalone model families (counterpart of
``pygpukit_tpu/llm/models``): DeepSeek-V3/R1 and V2 (``deepseek.py``,
Multi-head Latent Attention and MoE) and gpt-oss (``gptoss.py``,
attention sinks and clamped-SwiGLU experts), each with its own params
tree, caches and greedy ``generate``, batch-served by
``llm.serving_hybrid.HybridServingEngine``."""

from .deepseek import DeepseekV3Config, DeepseekV3Model
from .gptoss import GptOssConfig, GptOssModel

__all__ = ["DeepseekV3Config", "DeepseekV3Model", "GptOssConfig", "GptOssModel"]
