from . import dtypes
from .array import Array, as_tensor, wrap
from .backend import (Backend, default_device, get_backend, interpret_mode, require_cuda,
                      reset_backend, resolve_device, set_backend,
                      set_deterministic_numerics)
from .device import (CARD_PEAKS, DeviceInfo, card_peaks, device_count, get_device_info,
                     is_cuda_available)
from .dtypes import (DTYPES, FP8_MAX, DataType, DataTypeKind, resolve_dtype,
                     to_dtype)
from .executable import (Executable, ExecutableCache, ExecutableStats, capture, global_executable_cache, replayed_launches,
                         reset_replayed_launches)
from .factory import (arange, empty, from_numpy, full, ones, ones_like, randn,
                      zeros, zeros_like)
from .memory import (MemoryInfo, copy_to_device, copy_to_host, copy_to_host_async,
                     get_memory_info, synchronize)
from .stream import (Event, Stream, StreamManager, StreamPriority, current_stream,
                     default_stream)

__all__ = ["dtypes", "Array", "as_tensor", "wrap", "Backend", "default_device",
           "get_backend", "interpret_mode", "require_cuda", "reset_backend",
           "resolve_device", "set_backend", "set_deterministic_numerics", "Executable",
           "ExecutableCache", "ExecutableStats", "capture",
           "replayed_launches", "reset_replayed_launches", "global_executable_cache", "DTYPES", "FP8_MAX",
           "DataType", "DataTypeKind", "resolve_dtype", "to_dtype", "arange",
           "empty", "from_numpy", "full", "ones", "ones_like", "randn", "zeros",
           "zeros_like", "CARD_PEAKS", "DeviceInfo", "card_peaks", "device_count",
           "get_device_info", "is_cuda_available", "MemoryInfo", "copy_to_device",
           "copy_to_host", "copy_to_host_async", "get_memory_info", "synchronize", "Event",
           "Stream", "StreamManager", "StreamPriority", "current_stream", "default_stream"]
