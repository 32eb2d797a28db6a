"""ctypes loader for the native runtime services library (counterpart of
``pygpukit_tpu/_native.py``).

The library is the repository's C++ sources under ``native/`` (the memory
pool, the QoS scheduler with its partitions, the threaded transfer engine;
``native/include/pygpukit_native.h`` is their C interface). It is optional:
the pool, the scheduler, the partitions and the transfer engine each have
a pure-Python route that makes the same decisions. ``PYGPUKIT_USE_NATIVE=0``
turns it off.

It builds at first use with the rule of ``native/Makefile`` (``g++ -O2
-std=c++17 -fPIC -shared -lpthread -Inative/include``, ``CXX`` overrides
the compiler) into ``build/pygpukit_tpu_torch/`` at the repository root,
named by a digest of the sources, header and flags; nothing is written
under ``native/``. Concurrent builds serialise on a lock file.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
NATIVE_DIR = _ROOT / "native"
SOURCES = tuple(NATIVE_DIR / "src" / f"{n}.cpp" for n in ("pool", "scheduler", "transfer"))
HEADER = NATIVE_DIR / "include" / "pygpukit_native.h"
BUILD_DIR = _ROOT / "build" / "pygpukit_tpu_torch"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]

_lib = None
_tried = False
_load_lock = threading.Lock()


class PkPoolStats(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint64) for n in (
        "quota_bytes", "used_bytes", "peak_bytes", "allocations", "frees",
        "reuses", "evictions", "failures", "free_list_bytes")]


class PkSchedConfig(ctypes.Structure):
    _fields_ = [("total_memory", ctypes.c_uint64),
                ("overcommit_ratio", ctypes.c_double),
                ("max_pending", ctypes.c_uint32),
                ("total_bandwidth", ctypes.c_double)]


class PkTaskDesc(ctypes.Structure):
    _fields_ = [("memory_bytes", ctypes.c_uint64),
                ("bandwidth", ctypes.c_double),
                ("qos", ctypes.c_int32),
                ("priority", ctypes.c_int32),
                ("partition_id", ctypes.c_uint64)]


class PkAdmitResult(ctypes.Structure):
    _fields_ = [("decision", ctypes.c_int32),
                ("eta_seconds", ctypes.c_double),
                ("available_memory", ctypes.c_uint64)]


class PkSchedStats(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint64) for n in (
        "submitted", "completed", "failed", "rejected", "queued", "running",
        "reserved_memory")]


class PkPartitionLimits(ctypes.Structure):
    _fields_ = [("memory_bytes", ctypes.c_uint64),
                ("compute_fraction", ctypes.c_double),
                ("bandwidth", ctypes.c_double),
                ("max_streams", ctypes.c_uint32)]


class PkPartitionUsage(ctypes.Structure):
    _fields_ = [("memory_used", ctypes.c_uint64),
                ("bandwidth_used", ctypes.c_double),
                ("streams_used", ctypes.c_uint32),
                ("tasks_admitted", ctypes.c_uint64),
                ("tasks_rejected", ctypes.c_uint64)]


class PkTransferStats(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint64) for n in (
        "submitted", "completed", "bytes_h2d", "bytes_d2h", "queue_depth")]


TRANSFER_CALLBACK = ctypes.CFUNCTYPE(None, ctypes.c_uint64, ctypes.c_void_p)

_P, _U64, _I = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
_SIGNATURES = {
    "pk_pool_create": (_P, [_U64]),
    "pk_pool_destroy": (None, [_P]),
    "pk_pool_alloc": (_U64, [_P, _U64, _I]),
    "pk_pool_free": (_I, [_P, _U64]),
    "pk_pool_host_ptr": (_P, [_P, _U64]),
    "pk_pool_block_size": (_U64, [_P, _U64]),
    "pk_pool_touch": (_I, [_P, _U64]),
    "pk_pool_trim": (_U64, [_P, _U64]),
    "pk_pool_stats": (None, [_P, ctypes.POINTER(PkPoolStats)]),
    "pk_sched_create": (_P, [ctypes.POINTER(PkSchedConfig)]),
    "pk_sched_destroy": (None, [_P]),
    "pk_sched_submit": (_U64, [_P, ctypes.POINTER(PkTaskDesc),
                               ctypes.POINTER(PkAdmitResult)]),
    "pk_sched_next": (_U64, [_P]),
    "pk_sched_complete": (_I, [_P, _U64, _I]),
    "pk_sched_cancel": (_I, [_P, _U64]),
    "pk_sched_task_state": (ctypes.c_int32, [_P, _U64]),
    "pk_sched_stats": (None, [_P, ctypes.POINTER(PkSchedStats)]),
    "pk_part_create": (_U64, [_P, ctypes.POINTER(PkPartitionLimits)]),
    "pk_part_destroy": (_I, [_P, _U64]),
    "pk_part_acquire": (_I, [_P, _U64, _U64, ctypes.c_double]),
    "pk_part_release": (_I, [_P, _U64, _U64, ctypes.c_double]),
    "pk_part_usage": (_I, [_P, _U64, ctypes.POINTER(PkPartitionUsage)]),
    "pk_transfer_create": (_P, [_I]),
    "pk_transfer_destroy": (None, [_P]),
    "pk_transfer_submit": (_U64, [_P, _P, _P, _U64, _I, _I, TRANSFER_CALLBACK, _P]),
    "pk_transfer_wait": (_I, [_P, _U64]),
    "pk_transfer_sync": (None, [_P]),
    "pk_transfer_stats": (None, [_P, ctypes.POINTER(PkTransferStats)]),
    "pk_version": (ctypes.c_char_p, []),
}


def _configure(lib) -> None:
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def _digest() -> str:
    h = hashlib.sha256(" ".join([_compiler(), *CXX_FLAGS]).encode())
    for p in (*SOURCES, HEADER):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libpygpukit_native_{_digest()}.so"


def build() -> Path:
    """Compile the library unless one for these sources exists; returns its
    path. RuntimeError when the compiler fails."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file():
            return out
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_compiler(), *CXX_FLAGS, f"-I{HEADER.parent}", "-o", str(tmp),
               *map(str, SOURCES), "-lpthread"]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


def get_native():
    """The loaded native library, or None (the pure-Python routes run)."""
    global _lib, _tried
    with _load_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PYGPUKIT_USE_NATIVE", "1") == "0":
            return None
        try:
            lib = ctypes.CDLL(str(build()))
            _configure(lib)
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_native() is not None


def select_native(use_native: bool | None, what: str):
    """The library for a service's ``use_native``: None takes it when it
    loads, True requires it (RuntimeError without it), False refuses it."""
    lib = get_native() if use_native in (None, True) else None
    if use_native is True and lib is None:
        raise RuntimeError(f"native {what} requested but the library is unavailable")
    return lib
