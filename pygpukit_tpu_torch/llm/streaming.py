"""Layer streaming for models larger than device memory (counterpart of
``pygpukit_tpu/llm/streaming.py``): weights stay mapped on the host and a
layer's tensors are brought to the device around its use, with the
eviction order of the strategy.

The reference prefetches the next layer on a worker thread. Here the
prefetch runs on the calling thread with its copies queued on a side CUDA
stream (on the CPU, in place): the loader's ``stats`` and its evictions
come in the reference's order, and an error of the prefetch raises where it
happens instead of being lost on a thread.
"""

from __future__ import annotations

import enum
from contextlib import contextmanager
from dataclasses import dataclass

import torch

from .safetensors import LazyModelLoader


class LoadingStrategy(enum.Enum):
    EAGER = "eager"                  # everything up front
    SIMPLE = "simple"                # load a layer, evict it after use
    SLIDING_WINDOW = "sliding"       # prefetch the next layer, keep a window
    AUTO_LRU = "auto_lru"            # the loader's budget-driven LRU alone


@dataclass
class StreamingConfig:
    strategy: LoadingStrategy = LoadingStrategy.AUTO_LRU
    window: int = 2
    max_device_bytes: int | None = None


class LayerStreamingContext:
    """Iterate over the layers as ``(i, {name: device tensor})``, loading and
    evicting each layer's tensors as the strategy says."""

    def __init__(self, loader: LazyModelLoader, layer_names: list[list[str]],
                 config: StreamingConfig | None = None):
        self.loader = loader
        self.layer_names = layer_names
        self.config = config or StreamingConfig()
        self._stream = None
        self._pending: list = []          # (event, tensors) of the last prefetch

    def _prefetch(self, names) -> None:
        """Queue the next layer's copies on a side stream, so they overlap
        the consumer's work on the current layer (on the CPU: load them)."""
        if self.loader.device.type != "cuda":
            for name in names:
                self.loader.get(name)
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.loader.device)
        self._stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self._stream):
            tensors = [self.loader.get(name) for name in names]
            event = torch.cuda.Event()
            event.record()
        self._pending.append((event, tensors))

    def _drain_pending(self) -> None:
        """Order the current stream after the prefetched copies, and mark
        the tensors as used there (so their memory is not reused by the
        side stream while the current one still reads them)."""
        pending, self._pending = self._pending, []
        for event, tensors in pending:
            torch.cuda.current_stream().wait_event(event)
            for t in tensors:
                t.record_stream(torch.cuda.current_stream())

    def close(self) -> None:
        self._drain_pending()

    def __iter__(self):
        n = len(self.layer_names)
        strat = self.config.strategy
        for i, names in enumerate(self.layer_names):
            self._drain_pending()
            tensors = {name: self.loader.get(name) for name in names}
            if strat == LoadingStrategy.SLIDING_WINDOW and i + 1 < n:
                self._prefetch(self.layer_names[i + 1])
            yield i, tensors
            if strat == LoadingStrategy.SIMPLE:
                for name in names:
                    self.loader.evict(name)
            elif strat == LoadingStrategy.SLIDING_WINDOW and i >= self.config.window - 1:
                for name in self.layer_names[i - self.config.window + 1]:
                    self.loader.evict(name)


@contextmanager
def create_streaming_context(path, layer_names: list[list[str]],
                             strategy: LoadingStrategy = LoadingStrategy.AUTO_LRU,
                             max_device_bytes: int | None = None,
                             dtype=None, device=None):
    """A ``LayerStreamingContext`` over a ``LazyModelLoader`` of ``path`` on
    ``device`` (the card unless the caller names one); every device copy is
    evicted on exit."""
    loader = LazyModelLoader(path, max_device_bytes=max_device_bytes, dtype=dtype,
                             device=device)
    ctx = LayerStreamingContext(loader, layer_names,
                                StreamingConfig(strategy=strategy,
                                                max_device_bytes=max_device_bytes))
    try:
        yield ctx
    finally:
        ctx.close()
        loader.evict_all()
