from .model import WhisperConfig, WhisperModel

__all__ = ["WhisperConfig", "WhisperModel"]
