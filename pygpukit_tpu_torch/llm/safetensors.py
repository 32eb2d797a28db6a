"""Safetensors checkpoints: an mmap reader, sharded files, a lazy loader
with LRU eviction, and the writer (counterpart of
``pygpukit_tpu/llm/safetensors.py``).

A file is memory-mapped once; a tensor is a zero-copy view of the map
(``tensor``, ``tensor_raw``, ``tensor_numpy``) until it is copied to its
device. Every ``_DTYPE_MAP`` type is read as a torch tensor through
``torch.frombuffer`` on the mapped bytes, so bf16 and the fp8 types need no
``ml_dtypes``; ``tensor_numpy`` gives those three as ``ml_dtypes`` arrays
where that module is installed. The map is read-only: a view is never
written (``torch.frombuffer`` marks it so), and callers copy from it. A
tensor whose offset in the file breaks its element alignment is copied out,
not viewed.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import warnings
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..core.backend import resolve_device
from ..core.dtypes import to_dtype
from ..core.host import BIT_CARRIERS, ml_dtypes_module

_DTYPE_MAP: dict[str, torch.dtype] = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
#: numpy dtype names (ml_dtypes' included) -> safetensors dtype
_NP_TO_ST = {"float64": "F64", "float32": "F32", "float16": "F16", "bfloat16": "BF16",
             "float8_e4m3fn": "F8_E4M3", "float8_e5m2": "F8_E5M2", "int64": "I64",
             "int32": "I32", "int16": "I16", "int8": "I8", "uint8": "U8", "bool": "BOOL"}


@dataclass(frozen=True)
class TensorInfo:
    name: str
    dtype_str: str
    shape: tuple[int, ...]
    data_offsets: tuple[int, int]

    @property
    def torch_dtype(self) -> torch.dtype:
        d = _DTYPE_MAP.get(self.dtype_str)
        if d is None:
            raise ValueError(f"unsupported safetensors dtype {self.dtype_str}")
        return d

    @property
    def np_dtype(self) -> np.dtype:
        """The numpy dtype; bf16 and fp8 need ``ml_dtypes`` (TypeError
        without it)."""
        name = str(self.torch_dtype).removeprefix("torch.")
        if name in BIT_CARRIERS:
            ml = ml_dtypes_module()
            if ml is None:
                raise TypeError(f"a {self.dtype_str} numpy array needs ml_dtypes")
            return np.dtype(getattr(ml, name))
        return np.dtype(name if name != "bool" else np.bool_)

    @property
    def nbytes(self) -> int:
        return self.data_offsets[1] - self.data_offsets[0]


class SafeTensorsFile:
    """One memory-mapped safetensors file."""

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        self._file = open(self.path, "rb")
        self._mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        header_len = int.from_bytes(self._mmap[:8], "little")
        header = json.loads(self._mmap[8:8 + header_len].decode("utf-8"))
        self.metadata: dict = header.pop("__metadata__", {})
        self._data_start = 8 + header_len
        self._tensors: dict[str, TensorInfo] = {}
        for name, info in header.items():
            self._tensors[name] = TensorInfo(
                name=name,
                dtype_str=info["dtype"],
                shape=tuple(info["shape"]),
                data_offsets=tuple(info["data_offsets"]),
            )

    # -- introspection -------------------------------------------------------

    def keys(self) -> list[str]:
        return list(self._tensors.keys())

    tensor_names = property(keys)

    def __contains__(self, name: str) -> bool:
        return name in self._tensors

    def info(self, name: str) -> TensorInfo:
        return self._tensors[name]

    def tensor_shape(self, name: str) -> tuple[int, ...]:
        return self._tensors[name].shape

    def tensor_dtype(self, name: str) -> str:
        return self._tensors[name].dtype_str

    # -- data access ---------------------------------------------------------

    def tensor_bytes(self, name: str) -> memoryview:
        """Zero-copy view of the raw tensor bytes in the map."""
        s, e = self._tensors[name].data_offsets
        return memoryview(self._mmap)[self._data_start + s:self._data_start + e]

    def tensor_raw(self, name: str) -> torch.Tensor:
        """The tensor's bytes as a flat uint8 CPU tensor viewing the map
        (no alignment needed; read-only: copy from it)."""
        raw = self.tensor_bytes(name)
        if not raw.nbytes:
            return torch.empty(0, dtype=torch.uint8)
        with warnings.catch_warnings():        # the map is read-only, by design
            warnings.filterwarnings("ignore", message="The given buffer is not writable")
            return torch.frombuffer(raw, dtype=torch.uint8)

    def tensor(self, name: str) -> torch.Tensor:
        """The tensor as a CPU torch tensor of its own dtype and shape: a
        view of the map (read-only) when its offset is aligned to its
        element size, else a copy."""
        t = self._tensors[name]
        raw = self.tensor_raw(name)
        itemsize = t.torch_dtype.itemsize
        if (self._data_start + t.data_offsets[0]) % itemsize:
            raw = raw.clone()
        return raw.view(t.torch_dtype).reshape(t.shape)

    def tensor_numpy(self, name: str) -> np.ndarray:
        """A zero-copy numpy view (bf16 and fp8 as ``ml_dtypes`` arrays:
        TypeError without it)."""
        t = self._tensors[name]
        return np.frombuffer(self.tensor_bytes(name), dtype=t.np_dtype).reshape(t.shape)

    def close(self) -> None:
        """Unmap and close. Views handed out keep the map alive; the map
        then closes when the last of them is gone."""
        try:
            self._mmap.close()
        except BufferError:
            pass
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ShardedSafeTensorsFile:
    """A checkpoint split over shards, by its model.safetensors.index.json."""

    def __init__(self, index_path: str | os.PathLike):
        index_path = Path(index_path)
        with open(index_path) as f:
            index = json.load(f)
        self.weight_map: dict[str, str] = index["weight_map"]
        self.metadata = index.get("metadata", {})
        base = index_path.parent
        self._shards: dict[str, SafeTensorsFile] = {}
        for shard_name in sorted(set(self.weight_map.values())):
            self._shards[shard_name] = SafeTensorsFile(base / shard_name)

    def keys(self) -> list[str]:
        return list(self.weight_map.keys())

    tensor_names = property(keys)

    def __contains__(self, name: str) -> bool:
        return name in self.weight_map

    def _shard(self, name: str) -> SafeTensorsFile:
        return self._shards[self.weight_map[name]]

    def info(self, name: str) -> TensorInfo:
        return self._shard(name).info(name)

    def tensor_shape(self, name: str) -> tuple[int, ...]:
        return self._shard(name).tensor_shape(name)

    def tensor_dtype(self, name: str) -> str:
        return self._shard(name).tensor_dtype(name)

    def tensor_bytes(self, name: str) -> memoryview:
        return self._shard(name).tensor_bytes(name)

    def tensor_raw(self, name: str) -> torch.Tensor:
        return self._shard(name).tensor_raw(name)

    def tensor(self, name: str) -> torch.Tensor:
        return self._shard(name).tensor(name)

    def tensor_numpy(self, name: str) -> np.ndarray:
        return self._shard(name).tensor_numpy(name)

    def close(self) -> None:
        for s in self._shards.values():
            s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def load_safetensors(path: str | os.PathLike):
    """A single or sharded checkpoint: ``path`` is a .safetensors file, an
    index .json, or a directory holding model.safetensors.index.json,
    model.safetensors or exactly one other .safetensors file."""
    p = Path(path)
    if p.is_dir():
        idx = p / "model.safetensors.index.json"
        if idx.exists():
            return ShardedSafeTensorsFile(idx)
        single = p / "model.safetensors"
        if single.exists():
            return SafeTensorsFile(single)
        cands = sorted(p.glob("*.safetensors"))
        if len(cands) == 1:
            return SafeTensorsFile(cands[0])
        raise FileNotFoundError(f"no safetensors checkpoint found in {p}")
    if p.suffix == ".json":
        return ShardedSafeTensorsFile(p)
    return SafeTensorsFile(p)


# ---------------------------------------------------------------------------
# Lazy loading with LRU eviction
# ---------------------------------------------------------------------------

class TensorState:
    """Lifecycle of a lazily loaded tensor."""
    UNLOADED = "unloaded"
    LOADED = "loaded"
    EVICTED = "evicted"


class LazyModelLoader:
    """Tensors stay mapped on the host until ``get`` copies one to
    ``device`` (the card unless the caller names one); the device copies
    are evicted least recently used first when ``max_device_bytes`` would
    be exceeded. ``stats`` counts loads, hits and evictions."""

    def __init__(self, st, max_device_bytes: int | None = None, dtype=None, device=None):
        self.st = st if not isinstance(st, (str, os.PathLike)) else load_safetensors(st)
        self.max_device_bytes = max_device_bytes
        self.target_dtype = to_dtype(dtype).torch_dtype if dtype is not None else None
        self.device = resolve_device(device)
        self._device: OrderedDict[str, tuple[torch.Tensor, int]] = OrderedDict()
        self._device_bytes = 0
        self.stats = {"loads": 0, "hits": 0, "evictions": 0}

    def keys(self) -> list[str]:
        return self.st.keys()

    def state(self, name: str) -> str:
        return TensorState.LOADED if name in self._device else TensorState.UNLOADED

    def get(self, name: str) -> torch.Tensor:
        """The device tensor of ``name``: a hit, or a load that first evicts
        the least recently used copies until it fits the budget."""
        if name in self._device:
            self.stats["hits"] += 1
            self._device.move_to_end(name)
            return self._device[name][0]
        host = self.st.tensor(name)
        dtype = self.target_dtype or host.dtype
        buf = host.to(device=self.device, dtype=dtype, copy=True)
        nbytes = buf.numel() * buf.element_size()
        if self.max_device_bytes is not None:
            while self._device and self._device_bytes + nbytes > self.max_device_bytes:
                _, (_, old_bytes) = self._device.popitem(last=False)
                self._device_bytes -= old_bytes
                self.stats["evictions"] += 1
        self._device[name] = (buf, nbytes)
        self._device_bytes += nbytes
        self.stats["loads"] += 1
        return buf

    get_array = get

    def evict(self, name: str) -> None:
        if name in self._device:
            _, nbytes = self._device.pop(name)
            self._device_bytes -= nbytes
            self.stats["evictions"] += 1

    def evict_all(self) -> None:
        for k in list(self._device):
            self.evict(k)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _leaf_dtype(a) -> str:
    name = (str(a.dtype).removeprefix("torch.") if isinstance(a, torch.Tensor)
            else np.dtype(a.dtype).name)
    if name not in _NP_TO_ST:
        raise ValueError(f"unsupported dtype {a.dtype}")
    return _NP_TO_ST[name]


def _host_bytes(a) -> memoryview:
    """The bytes of one tensor (any device) or numpy array, C order."""
    if isinstance(a, torch.Tensor):
        t = a.detach().contiguous().cpu()
        return memoryview(t.reshape(-1).view(torch.uint8).numpy())
    return memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def save_safetensors(path: str | os.PathLike, tensors: dict) -> None:
    """Write ``{name: tensor or numpy array}`` as a safetensors file: an
    8-byte little-endian header length, the JSON header padded with spaces
    to 8 bytes, then the raw little-endian buffers. Torch tensors may live
    on any device; each is copied to the host when its turn comes, so the
    host holds one tensor at a time."""
    header: dict = {}
    offset = 0
    for name, arr in tensors.items():
        n = (arr.numel() * arr.element_size() if isinstance(arr, torch.Tensor)
             else np.asarray(arr).nbytes)
        header[name] = {"dtype": _leaf_dtype(arr), "shape": list(arr.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    hjson = json.dumps(header, separators=(",", ":")).encode()
    hjson += b" " * ((8 - (len(hjson) % 8)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for arr in tensors.values():
            f.write(_host_bytes(arr))


def _flatten_params(params: dict, prefix: str = "") -> dict:
    flat: dict = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if v is None:
            continue
        if isinstance(v, dict):
            flat.update(_flatten_params(v, f"{name}."))
        else:
            flat[name] = v
    return flat


def save_model_params(path: str | os.PathLike, params: dict) -> None:
    """Persist a model param tree (quantized ``{"q", "scale"}`` leaves
    included: dict nesting flattens to dotted names) as one file."""
    save_safetensors(path, _flatten_params(params))


def load_model_params(path: str | os.PathLike, device=None) -> dict:
    """Inverse of ``save_model_params``: dotted names unflatten into the
    nested tree, each leaf a copy on ``device`` (the card unless the
    caller names one). An int4_block leaf written by the reference
    loses its ``scale_lo``/``scale_hi`` halves of ``scale_block``, as
    ``convert.params_from_jax`` drops them."""
    from .convert import _drop_split_scales
    device = resolve_device(device)
    out: dict = {}
    with SafeTensorsFile(path) as st:
        for name in st.keys():
            parts = name.split(".")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = st.tensor(name).to(device, copy=True)

    def drop(tree):
        if not isinstance(tree, dict):
            return tree
        if "scale_block" in tree and "scale_lo" in tree:
            tree = _drop_split_scales(tree)
        return {k: drop(v) for k, v in tree.items()}
    return drop(out)
