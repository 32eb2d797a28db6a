"""Decode strategies (counterpart of ``pygpukit_tpu/llm/decode``): every
strategy gives the same greedy tokens (SURVEY §4)."""

from .base import DecodeStats, DecodeStrategy
from .batch import DecodeBatch
from .jacobi import DecodeJacobi
from .m1 import DecodeM1
from .m1_graph import DecodeM1Graph
from .speculative import DecodeSpeculative

STRATEGIES = {
    "m1": DecodeM1,
    "m1_graph": DecodeM1Graph,
    "batch": DecodeBatch,
    "jacobi": DecodeJacobi,
    "speculative": DecodeSpeculative,
}

__all__ = ["DecodeStats", "DecodeStrategy", "DecodeBatch", "DecodeJacobi",
           "DecodeM1", "DecodeM1Graph", "DecodeSpeculative", "STRATEGIES"]
