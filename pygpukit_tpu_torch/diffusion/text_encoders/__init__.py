from .clip import CLIPTextConfig, CLIPTextEncoder
from .t5 import T5Config, T5Encoder

__all__ = ["CLIPTextConfig", "CLIPTextEncoder", "T5Config", "T5Encoder"]
