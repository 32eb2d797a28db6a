from .dit import DiT, DiTConfig
from .flux import FluxConfig, FluxTransformer
from .pixart import PixArtConfig, PixArtTransformer
from .sd3 import SD3Config, SD3Transformer
from .vae import VAE, VAEConfig

__all__ = ["DiT", "DiTConfig", "FluxConfig", "FluxTransformer",
           "PixArtConfig", "PixArtTransformer", "SD3Config",
           "SD3Transformer", "VAE", "VAEConfig"]
