from .determinism import (
    DeterminismReport, verify_bitwise_replay, verify_recompile_parity,
    verify_strategy_equivalence,
)
from .memory import MemoryProfiler, MemorySnapshot, print_memory_summary
from .profiler import (
    KernelRecord, Profiler, disable_profiling, enable_profiling,
    get_profile_stats, get_profiler, profile_matmul,
)

__all__ = [
    "DeterminismReport", "verify_bitwise_replay", "verify_recompile_parity",
    "verify_strategy_equivalence",
    "MemoryProfiler", "MemorySnapshot", "print_memory_summary",
    "KernelRecord", "Profiler", "disable_profiling", "enable_profiling",
    "get_profile_stats", "get_profiler", "profile_matmul",
]
