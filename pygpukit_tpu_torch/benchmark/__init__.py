from .base import Benchmark, BenchResult, time_fn
from .suites import (
    SUITES, AttentionBenchmark, DecodeBenchmark, GemmBenchmark, GemvBenchmark,
)

__all__ = [
    "Benchmark", "BenchResult", "time_fn", "SUITES", "AttentionBenchmark",
    "DecodeBenchmark", "GemmBenchmark", "GemvBenchmark",
]
