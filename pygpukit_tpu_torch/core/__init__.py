from .backend import get_device, require_cuda, set_deterministic_numerics
from .dtypes import DTYPES, FP8_MAX, resolve_dtype

__all__ = ["get_device", "require_cuda", "set_deterministic_numerics",
           "DTYPES", "FP8_MAX", "resolve_dtype"]
