from .embedding import (kv_cache_zeros, kv_dequant, kv_leaf, kv_quant_rows,
                        kv_write, to_kv_dtype)
from .paged import (PagedKVCache, paged_attention_batch_fn,
                    paged_attention_dispatch, paged_attention_fn,
                    reshape_and_cache_fn)

__all__ = ["kv_cache_zeros", "kv_dequant", "kv_leaf", "kv_quant_rows",
           "kv_write", "to_kv_dtype", "PagedKVCache", "paged_attention_batch_fn",
           "paged_attention_dispatch", "paged_attention_fn",
           "reshape_and_cache_fn"]
