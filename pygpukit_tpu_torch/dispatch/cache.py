"""Kernel caches (counterpart of ``pygpukit_tpu/dispatch/cache.py``).

``KernelCache`` is an in-memory LRU cache of built objects keyed by
(source, options), with stats. ``PersistentCache`` is an on-disk index
with a fingerprint of the device, so an entry written on another card is
not reused. The reference indexes JAX's serialized executables; a CUDA
graph cannot be serialized, so the port's persistent artifact is the
kernel build (``build/pygpukit_tpu_torch/libpgk_kernels_<digest>.so``),
which ``record_library`` indexes. The index lives in
``PYGPUKIT_COMPILE_CACHE`` or ``~/.cache/pygpukit_tpu_torch``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import torch

INDEX_NAME = "pygpukit_torch_index.json"


@dataclass
class CacheStats:
    entries: int = 0
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    inserts: int = 0


class KernelCache:
    """LRU in-memory cache keyed by (source, options)."""

    def __init__(self, max_entries: int = 512):
        self.max_entries = max_entries
        self._data: dict = {}
        self._order: list = []
        self._lock = threading.Lock()
        self.stats = CacheStats()

    @staticmethod
    def make_key(source: str, options: tuple = ()) -> str:
        h = hashlib.sha256()
        h.update(source.encode())
        h.update(repr(options).encode())
        return h.hexdigest()[:32]

    def get(self, key: str):
        with self._lock:
            if key in self._data:
                self.stats.hits += 1
                self._order.remove(key)
                self._order.append(key)
                return self._data[key]
            self.stats.misses += 1
            return None

    def put(self, key: str, value) -> None:
        with self._lock:
            if key not in self._data and len(self._data) >= self.max_entries:
                old = self._order.pop(0)
                del self._data[old]
                self.stats.evictions += 1
            self._data[key] = value
            if key in self._order:
                self._order.remove(key)
            self._order.append(key)
            self.stats.inserts += 1
            self.stats.entries = len(self._data)

    def get_or_compile(self, source: str, options: tuple, compile_fn):
        key = self.make_key(source, options)
        hit = self.get(key)
        if hit is not None:
            return hit
        value = compile_fn()
        self.put(key, value)
        return value


def _platform_fingerprint() -> str:
    """The card's name and compute capability (``gpu:<name>:sm_<cc>``), or
    ``cpu`` without a card."""
    if not torch.cuda.is_available():
        return "cpu"
    major, minor = torch.cuda.get_device_capability(0)
    return f"gpu:{torch.cuda.get_device_name(0)}:sm_{major}{minor}"


class PersistentCache:
    """On-disk index of built artifacts (module docstring)."""

    def __init__(self, cache_dir: str | None = None):
        self.cache_dir = Path(
            cache_dir
            or os.environ.get("PYGPUKIT_COMPILE_CACHE",
                              os.path.expanduser("~/.cache/pygpukit_tpu_torch")))
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.index_path = self.cache_dir / INDEX_NAME
        self.fingerprint = _platform_fingerprint()
        self._lock = threading.Lock()
        self._index = self._load()

    def _load(self) -> dict:
        if self.index_path.exists():
            try:
                return json.loads(self.index_path.read_text())
            except (OSError, ValueError):
                return {}
        return {}

    def _save(self) -> None:
        tmp = self.index_path.with_suffix(f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(self._index, indent=0))
        os.replace(tmp, self.index_path)

    def record(self, key: str, meta: dict | None = None) -> None:
        with self._lock:
            self._index[key] = {"fingerprint": self.fingerprint, "time": time.time(),
                                **(meta or {})}
            self._save()

    def record_library(self, path: str | Path | None = None) -> str:
        """Index a built kernel library (the port's own by default, built
        first when needed) under its file name; returns the key."""
        if path is None:
            from ..kernels._build import build
            path = build()
        path = Path(path)
        self.record(path.name, {"path": str(path), "bytes": path.stat().st_size})
        return path.name

    def lookup(self, key: str) -> dict | None:
        """The entry, or None when absent, written on another device, or
        naming a file that is gone."""
        with self._lock:
            ent = self._index.get(key)
        if ent is None or ent.get("fingerprint") != self.fingerprint:
            return None
        if "path" in ent and not Path(ent["path"]).is_file():
            return None
        return ent

    def invalidate(self, key: str | None = None) -> None:
        with self._lock:
            if key is None:
                self._index.clear()
            else:
                self._index.pop(key, None)
            self._save()

    def stats(self) -> dict:
        disk_files = sum(1 for p in self.cache_dir.glob("*") if p.name != INDEX_NAME)
        return {"indexed": len(self._index), "disk_entries": disk_files,
                "fingerprint": self.fingerprint, "dir": str(self.cache_dir)}
