"""Storage dtype map for the PyTorch port (counterpart of
``pygpukit_tpu/core/dtypes.py``).

Packed int4 has no torch dtype: two split-half nibbles ride one ``uint8``
(``llm/quant.py``). fp8 names resolve where this torch build has them; the
slice's kernels take bf16 and these are recorded for the fp8 rung.
"""

from __future__ import annotations

import torch

#: name -> torch storage dtype
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
