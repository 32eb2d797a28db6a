"""The port's hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and runs
the plain version for CPU tensors; nothing falls back from one to the
other. ``LAUNCHES`` counts kernel launches per wrapper.
"""

from ._build import LAUNCHES, build, reset_launches
from .batch_decode_attention import (batch_decode_attention,
                                     batch_decode_attention_plain)
from .flash_attention import (flash_attention, flash_attention_plain,
                              flash_decode, flash_decode_plain)
from .fused_decode import fused_decode, fused_decode_plain
from .gemm import batched_gemm, gemm, gemm_plain
from .gmm import gmm, gmm_plain
from .gemv_quant import (block_w4a8_matmul, block_w4a8_matmul_plain,
                         block_w4a16_matmul, block_w4a16_matmul_plain,
                         conv_matmul, conv_matmul_plain, gemv_quant,
                         gemv_quant_plain, w4a8_matmul, w4a8_matmul_plain,
                         w4a16_matmul, w4a16_matmul_plain)
from .kv_row_write import kv_rows_write, kv_rows_write_plain, kv_write_attention
from .paged_attention import paged_attention, paged_attention_plain

__all__ = ["LAUNCHES", "build", "reset_launches", "batch_decode_attention",
           "batch_decode_attention_plain", "flash_attention",
           "flash_attention_plain", "flash_decode", "flash_decode_plain",
           "fused_decode", "fused_decode_plain",
           "batched_gemm", "gemm", "gemm_plain", "gmm", "gmm_plain",
           "gemv_quant", "gemv_quant_plain",
           "block_w4a8_matmul",
           "block_w4a8_matmul_plain", "block_w4a16_matmul",
           "block_w4a16_matmul_plain", "conv_matmul", "conv_matmul_plain",
           "w4a8_matmul", "w4a8_matmul_plain", "w4a16_matmul",
           "w4a16_matmul_plain", "kv_rows_write", "kv_rows_write_plain",
           "kv_write_attention",
           "paged_attention", "paged_attention_plain"]
