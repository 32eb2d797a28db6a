"""Asynchronous host <-> device transfer engine (counterpart of
``pygpukit_tpu/transfer/engine.py``).

Worker threads take transfers from a priority queue: HIGH (decode-critical)
before NORMAL before LOW, first come first served within a class. A
transfer moves through two pinned staging buffers per worker, a chunk at a
time: the host copy of one chunk into a buffer (on the native engine's
threads, ``native/src/transfer.cpp``, when the library loads; else a torch
copy) overlaps the DMA of the previous chunk out of the other buffer.

- ``h2d(arr)`` copies a numpy array (or a CPU tensor) to
  ``resolve_device(device)``: the card by default, the CPU when asked. The
  worker copies on a side stream of its own and resolves the future only
  once the copy is complete on the card. The tensor is allocated on that
  side stream and marked used by the caller's current stream (as of the
  call) with ``record_stream``, so the caching allocator never hands its
  block to another upload while a kernel of the caller still reads it.
- ``d2h(t)`` copies a tensor to a numpy array. On the card it records an
  event on the caller's current stream when ``d2h`` is called, and the
  worker's stream waits for that event: the copy sees what the caller had
  queued by then, whenever the worker runs.

``stats()`` counts the engine's transfers; the native engine's staging
copies (``native_stats()``) are parts of those and are not added in.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .._native import TRANSFER_CALLBACK, PkTransferStats, select_native
from ..core.array import Array
from ..core.backend import resolve_device
from ..core.host import BIT_CARRIERS, ml_dtypes_module

#: bytes of one staging buffer (two per worker)
CHUNK_BYTES = 64 << 20
#: native threads per worker: a chunk's host copy of 1 MiB or more is split
#: among them
STAGING_SPLIT = 8


@dataclass
class TransferStats:
    submitted: int = 0
    completed: int = 0
    bytes_h2d: int = 0
    bytes_d2h: int = 0
    queue_depth: int = 0


class TransferFuture:
    """A transfer in flight. ``finished_at`` is the ``time.perf_counter()``
    at which it resolved (None before)."""

    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._error: Exception | None = None
        self.finished_at: float | None = None

    def _set(self, result=None, error=None):
        self._result = result
        self._error = error
        self.finished_at = time.perf_counter()
        self._ev.set()

    def result(self, timeout: float | None = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("transfer not complete")
        if self._error is not None:
            raise self._error
        return self._result

    def done(self) -> bool:
        return self._ev.is_set()


def _torch_dtype(np_dtype: np.dtype) -> torch.dtype:
    carrier = BIT_CARRIERS.get(np_dtype.name)
    if carrier is not None:
        return carrier[1]
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    for name, (_, torch_dt) in BIT_CARRIERS.items():
        if torch_dt == dtype:
            ml = ml_dtypes_module()
            if ml is None:
                raise TypeError(f"a {dtype} tensor needs ml_dtypes to become a numpy array")
            return np.dtype(getattr(ml, name))
    return torch.empty(0, dtype=dtype).numpy().dtype


def _flat_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


class AsyncTransferEngine:
    """Priority-queue transfer engine with dedicated worker threads
    (module docstring). ``use_native``: None stages through the native
    engine when the library loads, True requires it, False copies in
    torch."""

    HIGH = 0
    NORMAL = 1
    LOW = 2

    def __init__(self, num_workers: int = 2, use_native: bool | None = None):
        self._stats = TransferStats()
        self._lock = threading.Lock()
        self._q: _queue.PriorityQueue = _queue.PriorityQueue()
        self._seq = 0
        self._local = threading.local()
        self._native = select_native(use_native, "transfer engine")
        self._native_handle = (
            self._native.pk_transfer_create(num_workers * STAGING_SPLIT)
            if self._native is not None else None)
        self._workers = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(num_workers)]
        for w in self._workers:
            w.start()

    @property
    def is_native(self) -> bool:
        return self._native_handle is not None

    def _run(self):
        while True:
            _, _, item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            fn, fut = item
            try:
                fut._set(result=fn())
            except Exception as e:  # noqa: BLE001 - surfaced by result()
                fut._set(error=e)
            finally:
                with self._lock:
                    self._stats.completed += 1
                self._q.task_done()

    def _submit(self, fn, priority: int) -> TransferFuture:
        fut = TransferFuture()
        with self._lock:
            self._seq += 1
            self._stats.submitted += 1
            seq = self._seq
        self._q.put((priority, seq, (fn, fut)))
        return fut

    # -- staging -------------------------------------------------------------

    def _host_copy(self, dst: torch.Tensor, src: torch.Tensor, direction: int,
                   priority: int) -> None:
        """Copy ``src`` to ``dst`` (host bytes): on the native engine's
        threads when it is there."""
        if self._native_handle is None:
            dst.copy_(src)
            return
        n = src.numel()
        step = -(-n // STAGING_SPLIT) if n >= 1 << 20 else n
        ops = [self._native.pk_transfer_submit(
            self._native_handle, src.data_ptr() + off, dst.data_ptr() + off,
            min(step, n - off), direction, priority, TRANSFER_CALLBACK(), None)
            for off in range(0, n, step)]
        for op in ops:
            self._native.pk_transfer_wait(self._native_handle, op)

    def _staging(self, device: torch.device):
        """This worker's side stream on ``device``, two pinned buffers and
        the event of the last DMA through each."""
        per = getattr(self._local, "staging", None)
        if per is None:
            per = self._local.staging = {}
        if device not in per:
            per[device] = (torch.cuda.Stream(device),
                           [torch.empty(CHUNK_BYTES, dtype=torch.uint8, pin_memory=True)
                            for _ in range(2)], [None, None])
        return per[device]

    def _upload(self, src: torch.Tensor, device: torch.device, consumer, priority: int):
        """``src`` (CPU bytes) on the card, the copy complete (module
        docstring)."""
        side, bufs, events = self._staging(device)
        n = src.numel()
        with torch.cuda.stream(side):
            out = torch.empty(n, dtype=torch.uint8, device=device)
            for k, off in enumerate(range(0, n, CHUNK_BYTES)):
                m = min(CHUNK_BYTES, n - off)
                i = k % 2
                if events[i] is not None:
                    events[i].synchronize()        # the buffer's last DMA is done
                self._host_copy(bufs[i][:m], src[off:off + m], 0, priority)
                out[off:off + m].copy_(bufs[i][:m], non_blocking=True)
                events[i] = torch.cuda.Event()
                events[i].record(side)
            done = torch.cuda.Event()
            done.record(side)
        done.synchronize()
        out.record_stream(consumer)
        return out

    def _download(self, src: torch.Tensor, out: torch.Tensor, priority: int) -> None:
        """``src`` (card bytes, ordered on the side stream) into ``out``
        (CPU bytes)."""
        side, bufs, events = self._staging(src.device)
        n = src.numel()
        pending = None                             # (buffer, offset, bytes) in flight
        with torch.cuda.stream(side):
            for k, off in enumerate(range(0, n, CHUNK_BYTES)):
                m = min(CHUNK_BYTES, n - off)
                i = k % 2
                bufs[i][:m].copy_(src[off:off + m], non_blocking=True)
                events[i] = torch.cuda.Event()
                events[i].record(side)
                if pending is not None:
                    self._drain(pending, bufs, events, out, priority)
                pending = (i, off, m)
        if pending is not None:
            self._drain(pending, bufs, events, out, priority)

    def _drain(self, pending, bufs, events, out, priority) -> None:
        i, off, m = pending
        events[i].synchronize()
        self._host_copy(out[off:off + m], bufs[i][:m], 1, priority)

    # -- transfers -----------------------------------------------------------

    def h2d(self, arr, priority: int = NORMAL, device=None) -> TransferFuture:
        """Copy a numpy array (or CPU tensor) to ``device`` (the backend's
        device unless named); the future gives the tensor."""
        dev = resolve_device(device)
        if isinstance(arr, torch.Tensor):
            host = arr.detach().cpu().contiguous()
        else:
            a = np.ascontiguousarray(arr)
            host = torch.from_numpy(a.reshape(-1).view(np.uint8)).view(
                _torch_dtype(a.dtype)).reshape(a.shape) if a.size else \
                torch.empty(a.shape, dtype=_torch_dtype(a.dtype))
        consumer = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        nbytes = host.numel() * host.element_size()

        def do():
            src = _flat_bytes(host)
            if dev.type == "cuda":
                out = self._upload(src, dev, consumer, priority)
            else:
                out = torch.empty(src.numel(), dtype=torch.uint8, device=dev)
                if src.numel():
                    self._host_copy(out, src, 0, priority)
            with self._lock:
                self._stats.bytes_h2d += nbytes
            return out.view(host.dtype).reshape(host.shape)
        return self._submit(do, priority)

    def d2h(self, buf, priority: int = NORMAL) -> TransferFuture:
        """Copy a tensor (or Array) to the host; the future gives a new
        numpy array with the tensor's bytes."""
        t = buf.torch if isinstance(buf, Array) else buf
        np_dtype = _numpy_dtype(t.dtype)
        ready = None
        if t.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(t.device))

        def do():
            res = np.empty(tuple(t.shape), np_dtype)
            dst = torch.from_numpy(res.reshape(-1).view(np.uint8))
            if dst.numel():
                if t.is_cuda:
                    side = self._staging(t.device)[0]
                    side.wait_event(ready)
                    with torch.cuda.stream(side):
                        src = _flat_bytes(t.contiguous())
                    self._download(src, dst, priority)
                else:
                    self._host_copy(dst, _flat_bytes(t.contiguous()), 1, priority)
            with self._lock:
                self._stats.bytes_d2h += res.nbytes
            return res
        return self._submit(do, priority)

    def synchronize(self) -> None:
        """Wait for every queued transfer."""
        self._q.join()
        if self._native_handle is not None:
            self._native.pk_transfer_sync(self._native_handle)

    def stats(self) -> TransferStats:
        with self._lock:
            s = TransferStats(**self._stats.__dict__)
        s.queue_depth = self._q.qsize()
        return s

    def native_stats(self) -> TransferStats | None:
        """The native engine's staging copies (None without it)."""
        if self._native_handle is None:
            return None
        raw = PkTransferStats()
        self._native.pk_transfer_stats(self._native_handle, raw)
        return TransferStats(**{f: getattr(raw, f) for f, _ in raw._fields_})

    def shutdown(self) -> None:
        for _ in self._workers:
            self._q.put((99, 1 << 60, None))
        for w in self._workers:
            w.join(timeout=5)
        if self._native_handle is not None:
            self._native.pk_transfer_destroy(self._native_handle)
            self._native_handle = None
