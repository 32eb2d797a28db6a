"""Runtime JIT front end (counterpart of ``pygpukit_tpu/jit/compiler.py``):
per-signature compile caching, structured errors with codes, retry with
backoff on transient failures, background warm-up, a platform probe.

The reference's compile step is ``jax.jit(...).lower().compile()`` for each
signature. The port's is the capture: ``core.capture`` of ``fn`` at the
example arguments, with ``static_argnums`` and ``donate_argnums`` passed
through, so on the card a call is a CUDA graph replay. A signature is the
static arguments' values, each other leaf's shape, dtype and device, and
the address of each donated tensor (donated state is bound by address: a
new cache is a new signature). On CPU tensors the capture records no graph
and a call runs ``fn``; the compile step then runs ``fn`` once on clones of
the donated arguments (``Executable.node_count``), so a broken function
fails at compile there too. A failed capture raises ``CompileError``;
nothing runs ``fn`` eagerly in its place.

A call returns the executable's outputs, which the next call of the same
signature overwrites (``core.executable``). A background ``warmup`` on the
card captures under ``kernels._build.DEVICE_LOCK`` and in ``thread_local``
capture mode (``core.executable``): it never overlaps another thread's
launches and never makes them illegal.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from ..core.executable import Executable, capture


class CompileErrorCode(enum.Enum):
    """Structured error codes."""
    COMPILATION_FAILED = "compilation_failed"
    INVALID_INPUT = "invalid_input"
    OUT_OF_MEMORY = "out_of_memory"
    PLATFORM_UNAVAILABLE = "platform_unavailable"
    TRANSIENT = "transient"
    INTERNAL = "internal"


class CompileError(RuntimeError):
    def __init__(self, code: CompileErrorCode, message: str, log: str = ""):
        super().__init__(f"[{code.value}] {message}")
        self.code = code
        self.log = log


_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED",
                      "connection", "timeout")


def _classify(exc: Exception) -> CompileErrorCode:
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return CompileErrorCode.OUT_OF_MEMORY
    msg = str(exc)
    if any(m.lower() in msg.lower() for m in _TRANSIENT_MARKERS):
        return CompileErrorCode.TRANSIENT
    if "out of memory" in msg.lower() or "OOM" in msg:
        return CompileErrorCode.OUT_OF_MEMORY
    if isinstance(exc, (TypeError, ValueError)):
        return CompileErrorCode.INVALID_INPUT
    return CompileErrorCode.COMPILATION_FAILED


@dataclass
class KernelStats:
    compiles: int = 0
    cache_hits: int = 0
    launches: int = 0
    total_compile_s: float = 0.0


def _leaf_key(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return ("number", type(x).__name__)
    return ("value", x)


class JITKernel:
    """A function compiled (captured) once per signature (module
    docstring). Compilation retries with exponential backoff on transient
    errors."""

    def __init__(self, fn: Callable, name: str | None = None,
                 static_argnums: tuple = (), donate_argnums: tuple = (),
                 max_retries: int = 3, backoff_s: float = 0.5):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "kernel")
        self.static_argnums = tuple(static_argnums)
        self.donate_argnums = tuple(donate_argnums)
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.stats = KernelStats()
        self._compiled: dict[Any, Executable] = {}
        self._lock = threading.Lock()

    def _signature(self, args) -> tuple:
        sig = []
        for i, a in enumerate(args):
            if i in self.static_argnums:
                sig.append(("static", a))
                continue
            leaves, spec = pytree.tree_flatten(a)
            keys = tuple(_leaf_key(x) for x in leaves)
            if i in self.donate_argnums:
                keys += tuple(x.data_ptr() for x in leaves if isinstance(x, torch.Tensor))
            sig.append((str(spec), keys))
        return tuple(sig)

    def compile(self, *example_args) -> None:
        """Capture for the example signature (a cached one is a hit)."""
        self._compile(self._signature(example_args), example_args)

    def _compile(self, sig: tuple, args: tuple) -> Executable:
        with self._lock:
            exe = self._compiled.get(sig)
            if exe is not None:
                self.stats.cache_hits += 1
                return exe
        for attempt in range(self.max_retries + 1):
            try:
                t0 = time.perf_counter()
                exe = capture(self.fn, *args, static_argnums=self.static_argnums,
                              donate_argnums=self.donate_argnums, name=self.name)
                _ = exe.node_count         # on the CPU: one run on clones, errors surface
                with self._lock:
                    self.stats.total_compile_s += time.perf_counter() - t0
                    self.stats.compiles += 1
                    self._compiled[sig] = exe
                return exe
            except Exception as e:  # noqa: BLE001 - classified below
                code = _classify(e)
                if code is not CompileErrorCode.TRANSIENT or attempt == self.max_retries:
                    raise CompileError(code, f"{self.name}: {e}") from e
                time.sleep(self.backoff_s * (2 ** attempt))
        raise CompileError(CompileErrorCode.INTERNAL, f"{self.name}: no attempt ran")

    def __call__(self, *args):
        sig = self._signature(args)
        exe = self._compiled.get(sig)
        if exe is None:
            exe = self._compile(sig, args)
        with self._lock:
            self.stats.launches += 1
        return exe.replay(*args)

    launch = __call__


def jit(fn: Callable | None = None, *, static_argnums: tuple = (),
        donate_argnums: tuple = (), name: str | None = None):
    """Decorator form of ``JITKernel``."""
    def wrap(f):
        return JITKernel(f, name=name, static_argnums=static_argnums,
                         donate_argnums=donate_argnums)
    return wrap(fn) if fn is not None else wrap


_warmup_state = {"threads": [], "error": None}
_warmup_lock = threading.Lock()


def warmup(kernel: JITKernel, *example_args) -> threading.Thread:
    """Compile ``kernel`` for the example signature on a background thread;
    its first error is kept for ``get_warmup_error``."""
    def run():
        try:
            kernel.compile(*example_args)
        except Exception as e:  # noqa: BLE001 - surfaced via get_warmup_error
            with _warmup_lock:
                if _warmup_state["error"] is None:   # keep the first error
                    _warmup_state["error"] = e

    t = threading.Thread(target=run, daemon=True)
    with _warmup_lock:
        _warmup_state["threads"] = [x for x in _warmup_state["threads"] if x.is_alive()]
        if not _warmup_state["threads"]:
            # a new batch of warm-ups: forget an earlier batch's error
            _warmup_state["error"] = None
        _warmup_state["threads"].append(t)
    t.start()
    return t


def is_warmup_done() -> bool:
    """True when every background warm-up still tracked has finished."""
    with _warmup_lock:
        return all(not t.is_alive() for t in _warmup_state["threads"])


def get_warmup_error() -> Exception | None:
    """The first error of the current batch of warm-ups, if any."""
    with _warmup_lock:
        return _warmup_state["error"]


def reset_warmup_state() -> None:
    with _warmup_lock:
        _warmup_state["threads"] = []
        _warmup_state["error"] = None


def check_platform_compatibility() -> dict:
    """The card's platform (``"gpu"``), count and name; compatible when
    torch sees a card."""
    info = {"platform": None, "devices": 0, "name": "", "compatible": False, "error": ""}
    try:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible to torch")
        info["platform"] = "gpu"
        info["devices"] = torch.cuda.device_count()
        info["name"] = torch.cuda.get_device_name(0)
        info["compatible"] = True
    except Exception as e:  # noqa: BLE001 - reported
        info["error"] = str(e)
    return info
