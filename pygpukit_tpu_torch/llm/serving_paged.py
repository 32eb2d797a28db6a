"""Paged-KV serving path (port of ``pygpukit_tpu/llm/serving_paged.py``):
block pools and per-slot block tables for the continuous-batching engine.

- ONE shared pool per cache side, ``[L, NB, Hk, BS, D]`` (int8: a
  ``{"q", "s"}`` dict with ``[L, NB, BS]`` row scales). KV memory follows
  the blocks that live requests hold, not ``B x MAX`` rows.
- Block 0 is the TRASH block: dead slots' tables point at it, and padded
  prefill rows land there, so their writes never touch a block that a live
  request owns. No live table ever holds block 0. Dead slots write distinct
  rows to the same trash positions in one scatter, and on CUDA which write
  wins is unordered, so block 0 alone is not replayable bit for bit.
- Pools are updated in place (the reference threads donated buffers through
  its loops). The decode step runs every slot's attention through the
  ``paged_attention`` kernel in one launch per layer, where the reference
  engine loops over slots.
- Sampling draws from a ``torch.Generator`` (the reference folds
  ``jax.random`` keys): greedy streams match the reference, sampled streams
  replay under the engine's seed.
- Slots, lengths and the chunk's ``last``/``poss`` are device tensors
  written in place, so the engine captures every function here
  (``core.executable``) and nothing reads the host inside them.
"""

from __future__ import annotations

import torch

from ..kernels.batch_decode_attention import supports as paged_attention_supports
from ..kernels.paged_attention import paged_attention, paged_attention_plain
from ..ops.embedding import kv_leaf, kv_quant_rows, to_kv_dtype
from .config import TransformerConfig
from .model import (_attn_in, _embed_tokens, _final_norm, _last_row, _layer_window,
                    _logits, _prefill_attn, _project_qkv, _residual_tail, _rope_qk,
                    _rope_rows_for, _slice_layer_params, _take_rows, sample_logits)


def _pool_layer(pool, layer: int):
    """Layer ``layer``'s ``[NB, Hk, BS, D]`` view of a pool (dict-safe)."""
    if isinstance(pool, dict):
        return {"q": pool["q"][layer], "s": pool["s"][layer]}
    return pool[layer]


def _paged_write_rows(pool, rows: torch.Tensor, layer: int,
                      blocks: torch.Tensor, offs: torch.Tensor,
                      valid: torch.Tensor | None = None):
    """Scatter per-position KV ``rows`` [N, Hk, D] into layer ``layer`` at
    (blocks[n], offs[n]), in place. int8 dict pools quantize each row (amax
    over its heads) and scatter both leaves; ``valid`` zeroes padded prefill
    rows (they land in the trash block). The index tensors are separated by
    a slice, so the indexed view is ``[N, Hk, D]``, N first, as in JAX."""
    blocks, offs = blocks.to(torch.long), offs.to(torch.long)
    if isinstance(pool, dict):
        q, s = kv_quant_rows(rows, 2)                        # [N,Hk,D], [N]
        if valid is not None:
            q = torch.where(valid[:, None, None], q, torch.zeros_like(q))
            s = torch.where(valid, s, torch.zeros_like(s))
        pool["q"][layer, blocks, :, offs, :] = q
        pool["s"][layer, blocks, offs] = s
        return pool
    if valid is not None:
        rows = torch.where(valid[:, None, None], rows, torch.zeros_like(rows))
    pool[layer, blocks, :, offs, :] = to_kv_dtype(rows, pool.dtype)
    return pool


def paged_decode_step_fn(cfg: TransformerConfig, params: dict, k_pool, v_pool,
                         tables: torch.Tensor, tokens: torch.Tensor,
                         poss: torch.Tensor) -> torch.Tensor:
    """One batched decode step over the shared paged pool.

    Pools ``[L, NB, Hk, BS, D]`` (or int8 dicts) are updated in place;
    tables [B, MB] int32, tokens [B], poss [B] device tensors, every poss
    below the table capacity (the chunk clamps it). Returns f32 logits
    [B, V]. Attention is one ``paged_attention`` launch per layer
    (``paged_attention_route``: the plain version on the card for a shape
    the kernel is not built for).
    Learned positions (GPT-2) are added as the dense batch-rows step adds
    them; the reference's paged step leaves them out."""
    bs = kv_leaf(k_pool).shape[3]
    b = tokens.shape[0]
    h = _embed_tokens(cfg, params, tokens)                   # [B, E]
    if cfg.use_position_embed:
        h = h + _take_rows(params["pos_embed"], poss)
    pl = poss.to(torch.long)
    blocks = tables[torch.arange(b, device=tables.device), pl // bs]
    offs = pl % bs
    # per-row rope tables (the reference's _rope_rows): LongRoPE's long rows
    # where a row's own length passes the threshold, the local ones on
    # Gemma-3's sliding layers, identity tables on NoPE layers
    lens = poss + 1
    rows = _rope_rows_for(params, poss, 1, lens) if cfg.use_rope else None
    for i in range(kv_leaf(k_pool).shape[0]):
        lp = _slice_layer_params(params["layers"], i)
        x = _attn_in(cfg, lp, h)
        q, k, v = _project_qkv(cfg, lp, x)                   # [B, H*, D]
        q, k = _rope_qk(cfg, i, rows, q, k)
        _paged_write_rows(k_pool, k, i, blocks, offs)
        _paged_write_rows(v_pool, v, i, blocks, offs)
        attend = (paged_attention if paged_attention_route(
            kv_leaf(k_pool).device.type, q.shape[1], k.shape[1], q.shape[2]) == "kernel"
            else paged_attention_plain)
        attn = attend(q, _pool_layer(k_pool, i), _pool_layer(v_pool, i), tables, lens,
                      scale=cfg.attn_scale, softcap=cfg.attn_logit_softcap,
                      window=_layer_window(cfg, i))              # [B, Hq, D]
        h = _residual_tail(cfg, lp, h, attn.reshape(b, -1), b, x)
    return _logits(cfg, params, _final_norm(cfg, params, h))


def paged_attention_route(device_type: str, hq: int, hk: int, d: int) -> str:
    """"kernel" or "plain": the paged step's attention over pools on a
    ``device_type`` device, by the shape alone (the kernel shares the
    batch kernel's body and its ``supports``); CPU pools and unbuilt shapes
    take ``paged_attention_plain``."""
    if device_type == "cuda" and paged_attention_supports(hq, hk, d):
        return "kernel"
    return "plain"


def put_at(t: torch.Tensor, at, value) -> None:
    """``t[at] = value`` in place; ``at`` an int, or a one-element integer
    device tensor with ``value`` a device tensor (an index copy: no host
    read)."""
    if isinstance(at, torch.Tensor):
        t.index_copy_(0, at.reshape(1).to(torch.long), value.reshape(1).to(t.dtype))
    else:
        t[at] = value


def paged_serve_chunk_fn(cfg: TransformerConfig, n_steps: int,
                         temperature: float, top_k: int, generator,
                         max_seq_len: int, params: dict, k_pool, v_pool,
                         tables: torch.Tensor, last: torch.Tensor,
                         poss: torch.Tensor, on_logits=None):
    """Advance all slots ``n_steps`` tokens over the paged pool with
    device-resident sampling; positions clamp to ``max_seq_len - 1`` after
    every step, so the table lookups stay in range. ``last`` and ``poss``
    are written in place (the reference donates them and the next chunk
    chains on them). Returns (last, poss, toks [B, n_steps]) on the device;
    ``on_logits`` sees each step's logits."""
    out = []
    tok, ps = last, poss
    for _ in range(n_steps):
        logits = paged_decode_step_fn(cfg, params, k_pool, v_pool, tables,
                                      tok, ps)
        if on_logits is not None:
            on_logits(logits)
        tok = sample_logits(logits, temperature, top_k, generator)
        out.append(tok)
        ps = torch.clamp(ps + 1, max=max_seq_len - 1)
    last.copy_(tok)
    poss.copy_(ps)
    return last, poss, torch.stack(out, dim=1)


def paged_prefill_fn(cfg: TransformerConfig, params: dict, k_pool, v_pool,
                     table: torch.Tensor, tokens: torch.Tensor,
                     true_len) -> torch.Tensor:
    """Prefill one sequence into its blocks (table [MB]), in place; returns
    the f32 logits [V] of position ``true_len - 1`` (an int or a
    one-element device tensor, ``model.prefill_fn``'s rule). Padded rows
    scatter zeros into the trash block (block 0, offset 0)."""
    s = tokens.shape[0]
    bs = kv_leaf(k_pool).shape[3]
    h = _embed_tokens(cfg, params, tokens)
    if cfg.use_position_embed:
        h = h + params["pos_embed"][:s]
    rows = _rope_rows_for(params, 0, s, true_len) if cfg.use_rope else None
    idx = torch.arange(s, device=tokens.device)
    valid = idx < true_len
    blocks = torch.where(valid, table[idx // bs].to(torch.long),
                         torch.zeros_like(idx))
    offs = torch.where(valid, idx % bs, torch.zeros_like(idx))
    for i in range(kv_leaf(k_pool).shape[0]):
        lp = _slice_layer_params(params["layers"], i)
        x = _attn_in(cfg, lp, h)
        q, k, v = _project_qkv(cfg, lp, x)
        q, k = _rope_qk(cfg, i, rows, q, k)
        _paged_write_rows(k_pool, k, i, blocks, offs, valid)
        _paged_write_rows(v_pool, v, i, blocks, offs, valid)
        attn = _prefill_attn(q, k, v, true_len, cfg.attn_scale,
                             cfg.attn_logit_softcap, _layer_window(cfg, i))
        h = _residual_tail(cfg, lp, h, attn, s, x)
    return _logits(cfg, params, _last_row(_final_norm(cfg, params, h), true_len))


def paged_prefill_pl_fn(cfg: TransformerConfig, temperature: float,
                        top_k: int, generator, params: dict, k_pool, v_pool,
                        last: torch.Tensor, poss: torch.Tensor,
                        table: torch.Tensor, tokens: torch.Tensor,
                        true_len, slot, on_logits=None) -> torch.Tensor:
    """Pipelined paged admission: prefill into the request's blocks, sample
    the first token on the device and write it and the position into the
    device-resident ``last``/``poss`` (in place; ``true_len`` and ``slot``
    ints or one-element device tensors). Returns the token, a device
    scalar; nothing is read back."""
    logits = paged_prefill_fn(cfg, params, k_pool, v_pool, table, tokens,
                              true_len)
    if on_logits is not None:
        on_logits(logits)
    tok = sample_logits(logits, temperature, top_k, generator)
    put_at(last, slot, tok)
    put_at(poss, slot, true_len)
    return tok


def paged_prefill_wave_pl_fn(cfg: TransformerConfig, temperature: float,
                             top_k: int, generator, n_wave: int, params: dict,
                             k_pool, v_pool, last: torch.Tensor,
                             poss: torch.Tensor, tables_w: torch.Tensor,
                             tokens_w: torch.Tensor, lens_w, slots_w,
                             on_logits=None) -> torch.Tensor:
    """Pipelined paged admission wave: ``n_wave`` same-bucket prefills in
    order (tables_w [W, MB], tokens_w [W, S], lens_w and slots_w [W] int32,
    all on the device). Returns their first tokens [W] on the device."""
    return torch.stack([
        paged_prefill_pl_fn(cfg, temperature, top_k, generator, params, k_pool,
                            v_pool, last, poss, tables_w[i], tokens_w[i],
                            lens_w[i:i + 1], slots_w[i:i + 1], on_logits)
        for i in range(n_wave)])


# ---------------------------------------------------------------- allocator --

class BlockAllocator:
    """Host-side free-list allocator; block 0 is the permanent trash block."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = list(range(num_blocks - 1, 0, -1))   # 0 reserved
        self.allocated: dict[int, list[int]] = {}

    def alloc_for(self, request_id: int, n_tokens: int) -> list[int]:
        """Ensure the request has blocks covering n_tokens; returns its
        full list."""
        blocks = self.allocated.setdefault(request_id, [])
        need = -(-n_tokens // self.block_size)            # ceil
        while len(blocks) < need:
            if not self._free:
                raise MemoryError("paged KV pool exhausted")
            blocks.append(self._free.pop())
        return blocks

    def free(self, request_id: int) -> None:
        for b in self.allocated.pop(request_id, []):
            self._free.append(b)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def stats(self) -> dict:
        used = sum(len(v) for v in self.allocated.values())
        return {"num_blocks": self.num_blocks, "used_blocks": used,
                "free_blocks": len(self._free),
                "block_size": self.block_size}
