from .cache import CacheStats, KernelCache, PersistentCache
from .pacing import KernelPacingEngine, PacingConfig, PacingStats
from .slicing import SliceConfig, SliceScheduler, SliceStats

__all__ = ["CacheStats", "KernelCache", "PersistentCache",
           "KernelPacingEngine", "PacingConfig", "PacingStats",
           "SliceConfig", "SliceScheduler", "SliceStats"]
