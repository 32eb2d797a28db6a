"""Build and load the port's CUDA kernels (``pygpukit_tpu_torch/csrc``).

The sources have a plain C interface and include no PyTorch header. Each
``.cu`` compiles in its own ``nvcc`` process, all started together, and one
more call links the objects into a shared library: about 35 s on the H100
machine, bound by the two decode-attention files (30 storage, query and
head-dim variants each). The Hopper instructions (TMA, mbarriers, wgmma,
setmaxnreg) are raw PTX in ``csrc/hopper.cuh`` (the GEMM mainloop of
``gemm.cu`` and ``gmm.cu`` in ``csrc/hopper_gemm.cuh``): no CUTLASS or CuTe
header is compiled, and the tensor-map encoder is libcuda's, fetched at run
time (no ``-lcuda``). The library
goes to ``build/pygpukit_tpu_torch/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources and flags: a changed source
rebuilds, an unchanged one loads the library already there. The build runs
at first use, never at import.

Every entry point takes its pointers and the stream as ``c_void_p`` and
returns ``cudaGetLastError()``; :func:`launch` raises on a non-zero code and
counts the launch. The counts let a run show that its main path went through
the kernels (``chip_smoke.py`` resets them before the path and reads them
after).

Threads. ``DEVICE_LOCK`` (re-entrant) is held around every launch and its
count, every graph replay (``core.executable``) and a whole capture,
warm-up included. So a capture on one thread (a background JIT warm-up,
a context's ``run_async``) never overlaps another thread's launches: the
counters' totals stay exact, and ``flash_decode`` and the w4a8 GEMM's
split-K fold, whose arrival counters live in ``__device__`` memory, never
run on two streams at once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from ctypes import c_float, c_int, c_void_p
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pygpukit_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

#: launches of each kernel's wrapper since the last reset;
#: "kv_rows_write_fused" counts the batch_decode_attention launches whose
#: pass one also stores the step's new rows (kv_row_write.kv_write_attention)
LAUNCHES: dict[str, int] = {"w4a8_gemv": 0, "w4a8_gemm": 0,
                            "kv_rows_write": 0, "kv_rows_write_fused": 0,
                            "batch_decode_attention": 0,
                            "paged_attention": 0, "w4a16_gemv": 0,
                            "block_w4a8_gemv": 0, "block_w4a16_gemv": 0,
                            "conv_gemv": 0, "flash_attention": 0,
                            "flash_decode": 0, "gemm": 0, "gemv_quant": 0,
                            "fused_decode": 0, "gmm": 0}

_P = c_void_p
_SIGNATURES = {
    "pgk_w4a8_gemv": [_P, c_int, _P, _P, _P, _P, _P, c_int, c_int, c_int, c_int, _P],
    "pgk_w4a8_gemv_plan": [c_int, c_int, c_int, _P],
    "pgk_w4a8_gemm": [_P, c_int, _P, _P, _P, _P, _P, _P, c_int, c_int, c_int, _P],
    "pgk_w4a8_gemm_plan": [c_int, c_int, c_int, _P],
    "pgk_w4a16_gemv": [_P, _P, _P, _P, c_int, c_int, c_int, _P],
    "pgk_w4a16_plan": [c_int, c_int, c_int, _P],
    "pgk_block_w4a8_gemv": [_P, c_int, _P, _P, _P, _P, _P, c_int, c_int, c_int,
                            c_int, c_int, _P],
    "pgk_block_w4a8_plan": [c_int, c_int, c_int, _P],
    "pgk_block_w4a16_gemv": [_P, _P, _P, _P, c_int, c_int, c_int, c_int, _P],
    "pgk_block_w4a16_plan": [c_int, c_int, c_int, _P],
    "pgk_conv_gemv": [_P, _P, c_int, _P, _P, c_int, c_int, c_int, _P],
    "pgk_conv_gemv_plan": [c_int, c_int, c_int, _P],
    "pgk_kv_rows_write": [_P] * 7 + [c_int] * 7 + [_P],
    "pgk_batch_decode_attention": [_P] * 11 + [c_int] * 10 + [c_float, c_float,
                                                              c_int, _P],
    "pgk_paged_attention": [_P] * 9 + [c_int] * 9 + [c_float, c_float, c_int, _P],
    "pgk_flash_attention": [_P, _P, _P, _P, c_int, c_int, c_int, c_int, c_int,
                            c_int, c_float, _P],
    "pgk_flash_decode": [_P, _P, _P, _P, c_int, _P, _P, c_int, c_int, c_int, c_int,
                         c_int, c_int, c_float, _P],
    "pgk_gemm": [_P, _P, _P, c_int, c_int, c_int, c_int, c_int, c_int, c_int,
                 c_int, _P],
    "pgk_gemv_quant": [_P, c_int, _P, c_int, _P, _P, c_int, c_int, _P],
    "pgk_gemv_quant_plan": [_P],
    "pgk_fused_decode_plan": [c_int] * 7 + [_P],
    "pgk_fused_decode": [_P] * 19 + [c_int] * 7 + [c_float, c_float, _P],
    "pgk_gmm": [_P, _P, _P, _P, c_int, c_int, c_int, c_int, c_int, _P],
    "pgk_gmm_simt": [_P, _P, _P, _P, c_int, c_int, c_int, c_int, c_int, c_int, _P],
    "pgk_gemm_plan": [c_int, c_int, _P],
}

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()

#: held around every launch, replay and capture (module docstring)
DEVICE_LOCK = threading.RLock()


def reset_launches() -> None:
    with DEVICE_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count(kernel: str, n: int = 1) -> None:
    """Add ``n`` launches of ``kernel`` (under ``DEVICE_LOCK``)."""
    with DEVICE_LOCK:
        LAUNCHES[kernel] += n


@contextmanager
def launches_restored():
    """Hold ``DEVICE_LOCK`` and put ``LAUNCHES`` back as it was on exit:
    launches made inside (a capture's warm-up and recording) count for no
    one, and no other thread launches meanwhile."""
    with DEVICE_LOCK:
        saved = dict(LAUNCHES)
        try:
            yield saved
        finally:
            LAUNCHES.update(saved)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libpgk_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.
    Returns its path. Concurrent builds serialise on a lock file."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file():
            return out
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        nvcc = nvcc_path()
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
        jobs = {src.name: [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(_sources(), objs)}
        procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
                 for name, cmd in jobs.items()}
        logs = {name: (p.communicate()[0], p.returncode)
                for name, p in procs.items()}
        if all(rc == 0 for _, rc in logs.values()):
            jobs["link"] = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            res = subprocess.run(jobs["link"], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            logs["link"] = (res.stdout, res.returncode)
        for obj in objs:
            obj.unlink(missing_ok=True)
        (BUILD_DIR / "build.log").write_text("".join(
            " ".join(jobs[name]) + "\n" + log for name, (log, _) in logs.items()))
        for name, (log, rc) in logs.items():
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {name} ({rc}):\n{log[-4000:]}")
        os.replace(tmp, out)
    return out


def build_log() -> str:
    p = BUILD_DIR / "build.log"
    return p.read_text() if p.is_file() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first when needed."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = c_int
            lib.pgk_error_string.argtypes = [c_int]
            lib.pgk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(kernel: str, entry: str, *args) -> None:
    """Call C entry ``entry``; raise on a CUDA error, else count one launch
    of ``kernel``."""
    lib = library()
    with DEVICE_LOCK:
        rc = getattr(lib, entry)(*args)
        if rc != 0:
            msg = lib.pgk_error_string(rc).decode()
            raise RuntimeError(f"{entry} failed: CUDA error {rc} ({msg})")
        LAUNCHES[kernel] += 1


def require_on(device, **tensors) -> None:
    """Raise unless every named tensor lies on ``device``: a kernel handed
    a host or another card's pointer would fault instead of raising."""
    bad = [name for name, t in tensors.items() if t.device != device]
    if bad:
        raise ValueError(f"{', '.join(bad)} not on {device}")


def stream_of(t) -> int:
    """The current CUDA stream on ``t``'s device, as a ``c_void_p`` value."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
