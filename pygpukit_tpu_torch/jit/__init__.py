from .compiler import (
    CompileError, CompileErrorCode, JITKernel, check_platform_compatibility,
    get_warmup_error, is_warmup_done, jit, reset_warmup_state, warmup,
)

__all__ = ["CompileError", "CompileErrorCode", "JITKernel",
           "check_platform_compatibility", "get_warmup_error", "is_warmup_done",
           "jit", "reset_warmup_state", "warmup"]
