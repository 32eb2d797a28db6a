from .pool import SIZE_CLASSES, MemoryBlock, MemoryPool, PoolStats

__all__ = ["SIZE_CLASSES", "MemoryBlock", "MemoryPool", "PoolStats"]
