from .embedding import (kv_cache_zeros, kv_dequant, kv_leaf, kv_quant_rows,
                        kv_write, to_kv_dtype)

__all__ = ["kv_cache_zeros", "kv_dequant", "kv_leaf", "kv_quant_rows",
           "kv_write", "to_kv_dtype"]
