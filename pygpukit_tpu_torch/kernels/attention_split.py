"""The split-KV launch plan of the decode-attention kernels
(``csrc/decode_attention.cuh``): how many blocks share one (slot, kv head)'s
context and which positions each takes. ``batch_decode_attention``,
``paged_attention`` and ``flash_decode`` plan with it; the CUDA body's
``pgk_split_bounds`` mirrors :func:`split_bounds`, and the batch kernel's
fused row write (``bda_writes_row`` in ``csrc/batch_decode_attention.cu``)
:func:`writes_row`.
"""

from __future__ import annotations

#: rows per chunk of the kernel's split and shared-memory ring
ATTN_CHUNK = 64
#: the split aims at about this many pass-one blocks: two per SM of the
#: card's 132
SPLIT_BLOCKS = 264


def attention_splits(b: int, hk: int, capacity: int) -> int:
    """Splits per (slot, kv head) for a batch of ``b`` slots over ``hk`` kv
    heads whose contexts hold at most ``capacity`` rows: enough blocks to
    fill the card, never more splits than chunks. Shapes only, never a
    context length, so a launch captured in a CUDA graph stays valid."""
    chunks = max(1, -(-capacity // ATTN_CHUNK))
    return max(1, min(chunks, -(-SPLIT_BLOCKS // (b * hk))))


def split_bounds(lo: int, live: int, n_split: int) -> list[tuple[int, int]]:
    """[start, end) of each split over the live window ``[max(lo, 0),
    live)``: its 64-row chunks (counted from position 0) dealt out evenly
    and in order, ``ceil(chunks / n_split)`` to a split; the first start
    and the last end fall inside a chunk, every other bound on a chunk
    edge; empty splits are ``(s, s)``. ``pgk_split_bounds`` in
    ``csrc/decode_attention.cuh`` is the same function."""
    lo0 = max(lo, 0)
    if live <= lo0:
        return [(0, 0)] * n_split
    c_begin, c_end = lo0 // ATTN_CHUNK, -(-live // ATTN_CHUNK)
    per = -(-(c_end - c_begin) // n_split)
    out = []
    for split in range(n_split):
        cs = c_begin + split * per
        start = max(lo0, cs * ATTN_CHUNK)
        out.append((start, max(start, min(live, (cs + per) * ATTN_CHUNK))))
    return out


def live_splits(lo: int, live: int, n_split: int) -> int:
    """How many of :func:`split_bounds`' splits are not empty: the first
    ones. ``flash_decode``'s later splits exit at once, and the rest fold
    into one another only when there are two or more
    (``pgk_live_splits`` in ``csrc/decode_attention.cuh``)."""
    lo0 = max(lo, 0)
    if live <= lo0:
        return 0
    chunks = -(-live // ATTN_CHUNK) - lo0 // ATTN_CHUNK
    per = -(-chunks // n_split)
    return -(-chunks // per)


def writes_row(split: int, pos: int, ctx: int, max_len: int, window: int | None,
               n_split: int) -> bool:
    """Whether split ``split``'s block of a (slot, kv head) stores the slot's
    new row in the fused row write of ``batch_decode_attention``'s pass one:
    the row ``clamp(pos, 0, max_len - 1)`` goes to the split whose
    :func:`split_bounds` range of the live window (``ctx`` the slot's
    length, ``window`` as the attention takes it) holds it, or to split 0
    when none does. ``bda_writes_row`` in ``csrc/batch_decode_attention.cu``
    is the same rule."""
    p = min(max(pos, 0), max_len - 1)
    live = min(ctx, max_len)
    lo = ctx - window if window is not None and window > 0 else -(1 << 30)
    if not max(lo, 0) <= p < live:
        return split == 0
    start, end = split_bounds(lo, live, n_split)[split]
    return start <= p < end

