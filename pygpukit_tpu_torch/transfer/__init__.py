from .engine import AsyncTransferEngine, TransferFuture, TransferStats

__all__ = ["AsyncTransferEngine", "TransferFuture", "TransferStats"]
