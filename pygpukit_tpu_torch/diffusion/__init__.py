"""Diffusion image generation (counterpart of ``pygpukit_tpu/diffusion``):
FLUX.1 with its CLIP-L and T5-XXL encoders and the VAE, SD3 and PixArt, the
schedulers and the pipelines. The reference holds no Pallas kernel here,
and the port launches none of its kernels: f32 products, f32 softmax
attention and cuDNN convolutions."""

from .pipeline import (FluxPipeline, PipelineOutput, PixArtPipeline, SD3Pipeline,
                       Text2ImagePipeline)
from .schedulers import SCHEDULERS, DDIMScheduler, EulerDiscreteScheduler, FlowMatchingScheduler

__all__ = [
    "FluxPipeline", "PipelineOutput", "PixArtPipeline", "SD3Pipeline",
    "Text2ImagePipeline", "SCHEDULERS", "DDIMScheduler",
    "EulerDiscreteScheduler", "FlowMatchingScheduler",
]
