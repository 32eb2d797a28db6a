"""Data types of the PyTorch port (counterpart of
``pygpukit_tpu/core/dtypes.py``).

``DataType`` and the module constants mirror the reference's registry, each
bound to a torch dtype. ``int4`` has no torch dtype: an int4 Array holds its
values in [-7, 7] as int8 (``ops.matmul.quantize_int4``), so its tensor and
``Array.dtype`` say int8. bf16 and fp8 map to numpy through ``ml_dtypes``
where it is installed (``np_dtype`` None otherwise).

``DTYPES`` / ``resolve_dtype`` name the model's storage types, where
``"int4"`` is the packed layout: two split-half nibbles in one ``uint8``
(``llm/quant.py``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from .host import ml_dtypes_module

#: name -> torch storage dtype of a model leaf
DTYPES: dict[str, torch.dtype] = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f32": torch.float32, "float32": torch.float32,
    "int8": torch.int8,
    "int4": torch.uint8,            # packed: two nibbles per byte
    "uint8": torch.uint8,
    "int32": torch.int32,
}
for _name, _attr in (("fp8", "float8_e4m3fn"), ("fp8_e4m3", "float8_e4m3fn"),
                     ("e4m3", "float8_e4m3fn"), ("fp8_e5m2", "float8_e5m2"),
                     ("e5m2", "float8_e5m2")):
    if hasattr(torch, _attr):
        DTYPES[_name] = getattr(torch, _attr)

#: finite max of each fp8 format; casts beyond it are NaN, so writes clamp
FP8_MAX: dict[torch.dtype, float] = {}
if hasattr(torch, "float8_e4m3fn"):
    FP8_MAX[torch.float8_e4m3fn] = 448.0
if hasattr(torch, "float8_e5m2"):
    FP8_MAX[torch.float8_e5m2] = 57344.0


def resolve_dtype(d) -> torch.dtype:
    """A torch dtype from a name in ``DTYPES`` or a torch dtype."""
    if isinstance(d, torch.dtype):
        return d
    if d not in DTYPES:
        raise ValueError(f"unknown dtype {d!r}; one of {sorted(DTYPES)}")
    return DTYPES[d]


class DataTypeKind(enum.Enum):
    FLOAT = "float"
    INT = "int"
    UINT = "uint"
    BOOL = "bool"


@dataclass(frozen=True)
class DataType:
    """A dtype descriptor bridging numpy and torch."""

    name: str
    kind: DataTypeKind
    itemsize: float  # bytes per element (0.5 for int4, stored as int8 here)
    torch_dtype: torch.dtype
    np_dtype: np.dtype | None

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"DataType({self.name})"

    def __str__(self) -> str:
        return self.name

    @property
    def is_floating(self) -> bool:
        return self.kind is DataTypeKind.FLOAT

    @property
    def is_integer(self) -> bool:
        return self.kind in (DataTypeKind.INT, DataTypeKind.UINT)

    @property
    def bits(self) -> int:
        return int(self.itemsize * 8)


def _np(name: str) -> np.dtype | None:
    if hasattr(np, name):
        return np.dtype(getattr(np, name))
    ml = ml_dtypes_module()
    return np.dtype(getattr(ml, name)) if ml is not None else None


def _dt(name: str, kind: DataTypeKind, itemsize: float, torch_dt: torch.dtype,
        np_name: str) -> DataType:
    return DataType(name=name, kind=kind, itemsize=itemsize, torch_dtype=torch_dt,
                    np_dtype=_np(np_name))


_F, _I, _U = DataTypeKind.FLOAT, DataTypeKind.INT, DataTypeKind.UINT
float64 = _dt("float64", _F, 8, torch.float64, "float64")
float32 = _dt("float32", _F, 4, torch.float32, "float32")
float16 = _dt("float16", _F, 2, torch.float16, "float16")
bfloat16 = _dt("bfloat16", _F, 2, torch.bfloat16, "bfloat16")
float8_e4m3 = _dt("float8_e4m3", _F, 1, torch.float8_e4m3fn, "float8_e4m3fn")
float8_e5m2 = _dt("float8_e5m2", _F, 1, torch.float8_e5m2, "float8_e5m2")
int64 = _dt("int64", _I, 8, torch.int64, "int64")
int32 = _dt("int32", _I, 4, torch.int32, "int32")
int16 = _dt("int16", _I, 2, torch.int16, "int16")
int8 = _dt("int8", _I, 1, torch.int8, "int8")
int4 = _dt("int4", _I, 0.5, torch.int8, "int8")        # values in [-7, 7], one per int8
uint8 = _dt("uint8", _U, 1, torch.uint8, "uint8")
uint16 = _dt("uint16", _U, 2, torch.uint16, "uint16")
uint32 = _dt("uint32", _U, 4, torch.uint32, "uint32")
bool_ = _dt("bool", DataTypeKind.BOOL, 1, torch.bool, "bool_")

# Aliases matching the reference naming (fp8 = e4m3 by default).
fp8 = float8_e4m3

_ALL = [
    float64, float32, float16, bfloat16, float8_e4m3, float8_e5m2,
    int64, int32, int16, int8, int4, uint8, uint16, uint32, bool_,
]
_BY_NAME: dict[str, DataType] = {d.name: d for d in _ALL}
_BY_NAME.update({
    "fp32": float32, "fp16": float16, "bf16": bfloat16, "fp8": float8_e4m3,
    "fp8_e4m3": float8_e4m3, "fp8_e5m2": float8_e5m2, "f32": float32,
    "f16": float16, "f64": float64,
})
#: numpy / ml_dtypes names -> DataType (int8 before int4: an int8 tensor is int8)
_BY_NP_NAME: dict[str, DataType] = {
    "float8_e4m3fn": float8_e4m3, "bool": bool_, "int4": int4,
    **{d.name: d for d in _ALL if d is not int4},
}
_BY_TORCH: dict[torch.dtype, DataType] = {}
for _d in _ALL:
    _BY_TORCH.setdefault(_d.torch_dtype, _d)

#: the reference runs JAX with 64-bit types off: they become 32-bit
_CANONICAL = {torch.int64: torch.int32, torch.float64: torch.float32,
              torch.uint64: torch.uint32, torch.complex128: torch.complex64}


def canonical_dtype(d: torch.dtype) -> torch.dtype:
    """The 32-bit type a 64-bit one becomes (JAX with x64 off)."""
    return _CANONICAL.get(d, d)


def to_dtype(obj) -> DataType:
    """Coerce a DataType / name / torch / numpy dtype into a DataType."""
    if isinstance(obj, DataType):
        return obj
    if isinstance(obj, torch.dtype):
        if obj in _BY_TORCH:
            return _BY_TORCH[obj]
        raise ValueError(f"unsupported dtype: {obj!r}")
    if isinstance(obj, str) and obj in _BY_NAME:
        return _BY_NAME[obj]
    try:
        name = np.dtype(obj).name
    except TypeError as e:
        raise ValueError(f"unknown dtype: {obj!r}") from e
    if name in _BY_NP_NAME:
        return _BY_NP_NAME[name]
    raise ValueError(f"unsupported dtype: {obj!r}")


def all_dtypes() -> list[DataType]:
    return list(_ALL)
