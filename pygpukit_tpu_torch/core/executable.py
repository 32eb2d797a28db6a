"""Captured executables with bitwise-identical replay (counterpart of
``pygpukit_tpu/core/executable.py``).

The reference compiles a function once for fixed shapes into an XLA
executable and replays it. On the card the counterpart is a CUDA graph:
``capture`` records ``fn`` into a ``torch.cuda.CUDAGraph`` and ``replay``
launches the recorded kernels again, in the same order, with the same
launch parameters, so a replay computes the eager call's bits.

- **Warm-up.** Before recording, ``fn`` runs once on a side stream (torch
  asks for it): that builds the kernels (``kernels.build()``), their plans
  and any lazy workspace. It runs on clones of the donated arguments, so
  ``capture`` leaves the caller's state untouched, and the ``LAUNCHES``
  counters are put back afterwards. The capture itself executes nothing.
- **Donated arguments** (``donate_argnums``) are state that ``fn`` updates
  in place (caches, flags, output buffers): the graph binds them by
  address, and ``replay`` raises ValueError when handed another tensor
  (data pointer, shape or dtype): the port's reading of XLA donation.
- **Bound arguments** (``bound_argnums``) are read-only state the graph
  reads in place, such as the weights: bound by address as donated
  arguments are, and not cloned for the warm-up. ``replay`` raises
  ValueError when handed other tensors, so an executable never copies one
  model's weights into another's.
- **Other tensor arguments.** The example tensors are the graph's static
  inputs. At replay a tensor leaf whose storage is not the captured one is
  copied into it (ValueError on another shape or dtype); a Python number
  in a non-static position is written into its one-element static tensor
  (int32 for an int, float32 for a float), which ``capture`` makes for it.
  ``static_argnums`` are passed to ``fn`` as they are and must not change.
- **Outputs.** ``replay`` returns the graph's static outputs: the next
  replay overwrites them.
- **No eager fallback.** A capture or replay that fails on the card raises
  (a host read inside ``fn``, such as ``int()`` of a device tensor, fails
  the capture); nothing runs ``fn`` eagerly in its place.
- **CPU arguments** make no graph: ``capture`` runs nothing, and
  ``replay`` binds the arguments the same way and calls ``fn`` on the
  static inputs, the CPU path the caller asked for by placing the tensors
  there.
- **One stream at a time.** ``flash_decode`` and the w4a8 GEMM's split-K
  fold keep arrival counters in ``__device__`` memory across launches, so
  replays run on the current stream and never on two streams at once.
- **Threads.** A capture holds ``kernels._build.DEVICE_LOCK`` from before
  its warm-up to after its instantiation, and starts with a device-wide
  synchronize; every launch and replay takes the same lock. So a capture
  on one thread (a background JIT warm-up) neither overlaps another
  thread's counter kernels on the card nor loses that thread's
  ``LAUNCHES`` counts when it puts the counters back. The graph records in
  ``thread_local`` capture mode: other threads' CUDA calls stay legal
  while it records.

- **Shared pools.** An owner (a model, an engine, a strategy) keeps its
  executables in an ``ExecutableCache(shared_pool=True)``: every capture
  of the owner records into one ``torch.cuda.graph(pool=...)`` memory
  pool, whose reserved bytes the cache reports (``nbytes``), and nothing
  is evicted (an evicted graph would free memory that live static outputs
  use). Sharing is safe because replays run
  one at a time on one stream and every executable keeps its static
  outputs alive, so a later capture never takes their memory. A replay
  may reuse the memory of another executable's intermediates, so a static
  output is consumed (copied, read or reduced on the stream) before the
  next replay of any executable of the pool.
- **Generators.** ``generators`` are registered with the graph
  (``CUDAGraph.register_generator_state``): a replay draws from the
  generator's current seed and offset and advances the offset as the
  eager call would, so reseeding before a replay gives the eager call's
  draws. The warm-up and the capture leave each generator's state as it
  was.

``ExecutableStats.node_count`` is, on the card, the captured graph's node
count (``cuGraphGetNodes`` on the graph torch keeps with ``keep_graph``);
on the CPU, the ATen operations one call dispatches, counted by a call on
clones of the donated arguments when ``node_count`` is first read (so a
CPU capture that nobody asks the count of runs ``fn`` once a replay, not
once more at capture). ``cost_analysis`` is
the per-kernel ``LAUNCHES`` delta of one replay, recorded while capturing
(the Python counters do not tick on replay). ``memory_analysis`` is the
bytes the capture reserved in its pool (its own, or its owner's shared
one), ``stats.capture_s`` the seconds the capture took, warm-up and
instantiation included. ``replayed_launches()`` sums ``cost_analysis()``
over every replay since ``reset_replayed_launches()``: the launches that
the ``LAUNCHES`` counters do not see. The reference's
``_xla_options`` (``PYGPUKIT_XLA_OPTS``) configures the XLA compiler and has
no counterpart here.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
import time
from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode


@dataclass
class ExecutableStats:
    captures: int = 0
    replays: int = 0
    node_count: int = 0
    capture_s: float = 0.0


#: kernel launches made by replays, by ``LAUNCHES`` name (module docstring)
_REPLAYED: Counter = Counter()


def replayed_launches() -> dict:
    """Launches of every replay since ``reset_replayed_launches()``, by
    kernel: each replay adds its executable's ``cost_analysis()``."""
    return {k: n for k, n in _REPLAYED.items() if n}


def reset_replayed_launches() -> None:
    _REPLAYED.clear()


class _OpCounter(TorchDispatchMode):
    """Counts the ATen operations dispatched inside the mode."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _graph_nodes(raw_graph: int) -> int:
    """Node count of a ``cudaGraph_t`` through libcuda's cuGraphGetNodes."""
    cuda = ctypes.CDLL("libcuda.so.1")
    fn = cuda.cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    err = fn(ctypes.c_void_p(raw_graph), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return int(n.value)


def _tensor_leaves(tree) -> list[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _signature(tree) -> list[tuple]:
    return [(t.data_ptr(), tuple(t.shape), t.dtype) for t in _tensor_leaves(tree)]


def _is_number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _clone(tree):
    return pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


class Executable:
    """``fn`` captured at its example arguments (module docstring)."""

    def __init__(self, fn: Callable, *example_args,
                 donate_argnums: tuple[int, ...] = (),
                 static_argnums: tuple[int, ...] = (),
                 bound_argnums: tuple[int, ...] = (),
                 name: str = "executable", pool: "ExecutableCache | None" = None,
                 generators: tuple = ()):
        t0 = time.perf_counter()
        self.name = name
        self._pool = pool
        self._generators = tuple(generators)
        self._fn = fn
        self._donate = frozenset(donate_argnums)
        self._static = frozenset(static_argnums)
        leaves = _tensor_leaves(example_args)
        cuda = [t.device for t in leaves if t.is_cuda]
        self.device = cuda[0] if cuda else torch.device("cpu")
        self._args = [a if i in self._static or not _is_number(a) else
                      torch.full((1,), a, device=self.device,
                                 dtype=torch.int32 if isinstance(a, int) else torch.float32)
                      for i, a in enumerate(example_args)]
        self._bound = frozenset(bound_argnums)
        self._donated = {i: _signature(self._args[i]) for i in self._donate | self._bound}
        self.stats = ExecutableStats(captures=1)
        self._cost: dict[str, int] = {}
        self._pool_bytes: int | None = None
        self._graph = None
        self._outputs = None
        self._released = False
        states = [g.get_state() for g in self._generators]
        try:
            if self.device.type == "cuda":
                self._capture_graph()
        finally:
            for g, st in zip(self._generators, states):
                g.set_state(st)
        self.stats.capture_s = time.perf_counter() - t0

    # -- capture -------------------------------------------------------------

    def _warm_args(self) -> list:
        return [_clone(a) if i in self._donate else a for i, a in enumerate(self._args)]

    def _count_cpu_ops(self) -> None:
        counter = _OpCounter()
        states = [g.get_state() for g in self._generators]
        try:
            with counter:
                self._fn(*self._warm_args())
        finally:
            for g, st in zip(self._generators, states):
                g.set_state(st)
        self.stats.node_count = counter.n

    def _capture_graph(self) -> None:
        from ..kernels._build import LAUNCHES, build, launches_restored
        build()
        with launches_restored() as saved:
            torch.cuda.synchronize(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._fn(*self._warm_args())
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            LAUNCHES.update(saved)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            for g in self._generators:
                graph.register_generator_state(g)
            handle = self._pool.handle(self.device) if self._pool is not None else None
            # no collection inside the capture: a collected graph's reset
            # is an illegal call there and invalidates the capture
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=handle, capture_error_mode="thread_local"):
                    # read inside: entering the capture empties the allocator's cache
                    reserved = torch.cuda.memory_reserved(self.device)
                    outputs = self._fn(*self._args)
            finally:
                if collecting:
                    gc.enable()
            self._cost = {k: n - saved[k] for k, n in LAUNCHES.items() if n != saved[k]}
            self._pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
            if self._pool is not None:
                self._pool.nbytes += self._pool_bytes
            self.stats.node_count = _graph_nodes(graph.raw_cuda_graph())
            graph.instantiate()
        self._graph = graph
        self._outputs = outputs

    # -- replay --------------------------------------------------------------

    def _bind(self, args: tuple) -> None:
        if self._released:
            raise RuntimeError(f"{self.name}: replay after reset()")
        if len(args) != len(self._args):
            raise TypeError(f"{self.name}: captured with {len(self._args)} arguments, "
                            f"replayed with {len(args)}")
        for i, (new, old) in enumerate(zip(args, self._args)):
            if i in self._donated:
                if _signature(new) != self._donated[i]:
                    kind = "donated" if i in self._donate else "bound"
                    raise ValueError(f"{self.name}: {kind} argument {i} is not the tensor "
                                     "it was captured with (data pointer, shape or dtype)")
            elif i in self._static:
                tensors = isinstance(new, torch.Tensor) or isinstance(old, torch.Tensor)
                if new is not old and (tensors or new != old):
                    raise ValueError(f"{self.name}: static argument {i} changed")
            elif _is_number(new) and isinstance(old, torch.Tensor):
                old.fill_(new)
            else:
                self._copy_in(i, new, old)

    def _copy_in(self, i: int, new, old) -> None:
        new_leaves, new_spec = pytree.tree_flatten(new)
        old_leaves, old_spec = pytree.tree_flatten(old)
        if new_spec != old_spec:
            raise ValueError(f"{self.name}: argument {i} has another structure than "
                             "at capture")
        for a, b in zip(new_leaves, old_leaves):
            if isinstance(b, torch.Tensor):
                if not isinstance(a, torch.Tensor) or a.shape != b.shape or a.dtype != b.dtype:
                    raise ValueError(
                        f"{self.name}: argument {i} leaf {getattr(a, 'dtype', type(a))} "
                        f"{tuple(getattr(a, 'shape', ()))} does not match the captured "
                        f"{b.dtype} {tuple(b.shape)}")
                if a.data_ptr() != b.data_ptr() or a.stride() != b.stride():
                    b.copy_(a)
            elif a is not b and a != b:
                raise ValueError(f"{self.name}: argument {i} leaf {a!r} differs from the "
                                 f"captured {b!r}")

    def replay(self, *args) -> Any:
        """Bind ``args`` (module docstring) and run the captured program:
        on the card a graph replay on the current stream, returning its
        static outputs, which the next replay overwrites; on the CPU a
        call of ``fn`` on the static inputs. Never recaptures."""
        from ..kernels._build import DEVICE_LOCK
        with DEVICE_LOCK if self._graph is not None else contextlib.nullcontext():
            self._bind(args)
            self.stats.replays += 1
            _REPLAYED.update(self._cost)
            if self._graph is None:
                return self._fn(*self._args)
            self._graph.replay()
        return self._outputs

    __call__ = replay

    def reset(self) -> None:
        """Release the graph and its memory pool; a later replay raises."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self._outputs = None
        self._args = []
        self._released = True

    @property
    def fn(self) -> Callable:
        """The captured function (an eager call of it is what a replay
        reproduces)."""
        return self._fn

    @property
    def donate_argnums(self) -> frozenset:
        return self._donate

    @property
    def generators(self) -> tuple:
        return self._generators

    @property
    def node_count(self) -> int:
        """Graph nodes on the card, dispatched ATen operations on the CPU
        (counted at the first read)."""
        if self._graph is None and not self.stats.node_count and not self._released:
            self._count_cpu_ops()
        return self.stats.node_count

    def cost_analysis(self) -> dict:
        """Kernel launches of one replay, by kernel (``LAUNCHES`` names)."""
        return dict(self._cost)

    def memory_analysis(self) -> int | None:
        """Bytes the capture reserved in its pool on the card; None on the
        CPU (no graph, no pool)."""
        return self._pool_bytes


def capture(fn: Callable, *example_args, donate_argnums=(), static_argnums=(),
            bound_argnums=(), name: str = "executable",
            pool: "ExecutableCache | None" = None, generators: tuple = ()) -> Executable:
    """Capture ``fn`` at the example arguments into a replayable executable."""
    return Executable(fn, *example_args, donate_argnums=tuple(donate_argnums),
                      static_argnums=tuple(static_argnums),
                      bound_argnums=tuple(bound_argnums), name=name, pool=pool,
                      generators=tuple(generators))


class ExecutableCache:
    """Keyed executable cache (the reference's ``ExecutableCache``): first
    in, first out past ``max_entries``, the evicted graph released. With
    ``shared_pool`` it is an owner's cache (module docstring): its captures
    share one memory pool, whose bytes ``nbytes`` counts, and nothing is
    evicted."""

    def __init__(self, max_entries: int = 256, shared_pool: bool = False):
        self._cache: dict[Any, Executable] = {}
        self._lock = threading.Lock()
        self._max = max_entries
        self._shared = shared_pool
        self._handle = None
        self.nbytes = 0
        self.hits = 0
        self.misses = 0

    def handle(self, device: torch.device):
        """The ``torch.cuda.graph`` pool token, made at the first capture."""
        if self._handle is None:
            with torch.cuda.device(device):
                self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def get_or_capture(self, key, fn, *example_args, **kw) -> Executable:
        """The executable under ``key``, captured at the example arguments
        the first time."""
        with self._lock:
            exe = self._cache.get(key)
            if exe is not None:
                self.hits += 1
                return exe
            self.misses += 1
        exe = capture(fn, *example_args, pool=self if self._shared else None, **kw)
        with self._lock:
            if key in self._cache:            # captured meanwhile by another thread
                exe.reset()
                return self._cache[key]
            if not self._shared and len(self._cache) >= self._max:
                self._cache.pop(next(iter(self._cache))).reset()
            self._cache[key] = exe
        return exe

    def get(self, key) -> Executable | None:
        return self._cache.get(key)

    def executables(self) -> dict:
        """{key: executable} in capture order."""
        return dict(self._cache)

    def reset(self) -> None:
        """Release every executable and the pool."""
        with self._lock:
            for exe in self._cache.values():
                exe.reset()
            self._cache = {}
            self._handle = None
            self.nbytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._cache), "hits": self.hits, "misses": self.misses}


_global_cache = ExecutableCache()


def global_executable_cache() -> ExecutableCache:
    return _global_cache
