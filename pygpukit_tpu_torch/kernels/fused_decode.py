"""The whole-model decode step (port of ``pygpukit_tpu/kernels/fused_decode.py``).

``fused_decode`` runs every layer of a batch-1 decode step between the
embedding row and the head: per layer rmsnorm, the consolidated q|k|v
product, NeoX rope, attention over the cache rows ``[0, pos)`` plus the
new token, the o product and residual, rmsnorm, the consolidated gate|up
product, ``silu(gate) * up``, the down product and residual; then the
final norm. Every projection output and residual add rounds through bf16,
P stays f32, and the cache is never written: the step returns the new
token's roped k and its v per layer, which the caller scatters at ``pos``.

CUDA tensors launch ``csrc/fused_decode.cu`` (one cooperative launch per
step, every block resident, grid-wide barriers between dependent stages)
or raise; CPU tensors take ``fused_decode_plain``, the same function step
by step in the reference's order and roundings.

The reference's tile arenas (``tile_weight``) and its VMEM gates
(``max_seq <= 2048``, ``max_seq % 128``, ``plan_tiles``, ``kv_d % 128``,
``kv_d <= hidden``, ``intermediate % 128``) serve the TPU's DMA engines and
VMEM and are not ported: the kernel reads the row-major ``[L, K, N]``
leaves and any cache length. Its own limits (``supports``): ``head_dim`` a
multiple of 8 up to 128 (16-byte cache rows, an even split for rope),
hidden and intermediate multiples of 8 (16-byte weight rows), at most 32
query heads per kv head, and one 512-thread block per SM.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..core.numerics import require_full_f32, true_div
from ._build import DEVICE_LOCK, launch, library, require_on, stream_of

_F32 = torch.float32
_BF16 = torch.bfloat16
#: the kernel's limits on the group size and the head dim
MAX_GROUP = 32
MAX_HEAD_DIM = 128

#: the kernel's plan (``pgk_fused_decode_plan``), in order
PLAN_FIELDS = ("grid", "slices_qkv", "slices_o", "slices_gate_up", "slices_down", "chunks",
               "scratch_words", "smem_bytes", "l2_rows")
PLAN_INTS = len(PLAN_FIELDS)

_plans: dict[tuple, ctypes.Array] = {}


def supports(*, hidden: int, intermediate: int, n_heads: int, n_kv_heads: int,
             head_dim: int, max_seq: int, norm_type: str, activation: str,
             use_rope: bool, has_bias: bool, use_qk_norm: bool, is_moe: bool) -> bool:
    """Static eligibility: the reference's architecture checks and the CUDA
    kernel's own limits (module docstring); no limit on ``max_seq``."""
    return (norm_type == "rmsnorm" and activation == "silu" and use_rope
            and not has_bias and not use_qk_norm and not is_moe
            and n_heads * head_dim == hidden
            and n_kv_heads >= 1 and n_heads % n_kv_heads == 0
            and n_heads // n_kv_heads <= MAX_GROUP
            and head_dim % 8 == 0 and head_dim <= MAX_HEAD_DIM
            and hidden % 8 == 0 and intermediate % 8 == 0 and max_seq >= 1)


def _rms(v: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """bf16((v * rsqrt(mean(v^2) + eps)) * w), the mean an IEEE division."""
    vf = v.to(_F32)
    var = true_div(torch.sum(vf * vf, dim=-1, keepdim=True), float(v.shape[-1]))
    return (vf * torch.rsqrt(var + eps) * w.to(_F32)).to(_BF16)


def _mm_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x @ bf16 w, f32 sums, rounded once to bf16."""
    return torch.matmul(x.to(_F32), w.to(_F32)).to(_BF16)


def _rope_half(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """NeoX rope of x [..., D] (bf16) in f32, each half rounded to bf16."""
    half = x.shape[-1] // 2
    v0, v1 = x[..., :half].to(_F32), x[..., half:].to(_F32)
    return torch.cat([(v0 * c - v1 * s).to(_BF16), (v1 * c + v0 * s).to(_BF16)], dim=-1)


def fused_decode_plain(h0, cos_p, sin_p, pos, wqkv, wo, wgu, wd, attn_norm, mlp_norm,
                       final_norm, k_cache, v_cache, *, n_heads: int, n_kv_heads: int,
                       head_dim: int, eps: float = 1e-5):
    """The fused step in plain torch, step by step as the reference kernel
    (``pygpukit_tpu/kernels/fused_decode.py:227-388``): scores of the G
    query heads of a kv head against all MAX rows with rows ``>= pos``
    masked, ``s_new = sum(q * k_new) * scale``, ``m = max(scores, s_new)``,
    ``o = (p @ v + p_new v_new) / denom`` with P in f32 and an IEEE
    division. Returns (h_out [1, H] bf16, k_new and v_new [L, Hk D] f32)."""
    require_full_f32(h0, "fused_decode_plain")
    n_layers, hidden, _ = wqkv.shape
    inter = wgu.shape[2] // 2
    max_len = k_cache.shape[1]
    hk, d = n_kv_heads, head_dim
    g, kvd, half = n_heads // n_kv_heads, n_kv_heads * head_dim, head_dim // 2
    scale = 1.0 / math.sqrt(d)
    dev = h0.device
    mask = torch.arange(max_len, device=dev) < pos.reshape(()).to(torch.long)  # [MAX]
    neg = torch.where(mask, torch.zeros((), device=dev), torch.full((), -1e30, device=dev))
    c = cos_p.reshape(1, -1)[:, :half].to(_F32)
    s = sin_p.reshape(1, -1)[:, :half].to(_F32)
    x = h0.reshape(1, hidden).to(_BF16)
    k_new = torch.empty((n_layers, kvd), dtype=_F32, device=dev)
    v_new = torch.empty((n_layers, kvd), dtype=_F32, device=dev)
    for layer in range(n_layers):
        qkv = _mm_bf16(_rms(x, attn_norm[layer], eps), wqkv[layer])        # [1, H + 2 KvD]
        q = _rope_half(qkv[:, :hidden].reshape(hk, g, d), c, s).to(_F32)    # [Hk, G, D]
        kr = _rope_half(qkv[:, hidden:hidden + kvd].reshape(hk, d), c, s).to(_F32)
        vr = qkv[:, hidden + kvd:].reshape(hk, d).to(_F32)
        k_new[layer] = kr.reshape(-1)
        v_new[layer] = vr.reshape(-1)
        kh = k_cache[layer].reshape(max_len, hk, d).permute(1, 0, 2).to(_F32)   # [Hk, MAX, D]
        vh = v_cache[layer].reshape(max_len, hk, d).permute(1, 0, 2).to(_F32)
        sc = torch.matmul(q, kh.transpose(1, 2)) * scale + neg                   # [Hk, G, MAX]
        s_new = torch.sum(q * kr[:, None, :], dim=-1, keepdim=True) * scale      # [Hk, G, 1]
        m = torch.maximum(torch.amax(sc, dim=-1, keepdim=True), s_new)
        pr = torch.exp(sc - m) * mask.to(_F32)
        p_new = torch.exp(s_new - m)
        denom = torch.sum(pr, dim=-1, keepdim=True) + p_new
        o = torch.matmul(pr, vh) + p_new * vr[:, None, :]
        attn = (o / denom).to(_BF16).reshape(1, hidden)
        x = x + _mm_bf16(attn, wo[layer])
        gu = _mm_bf16(_rms(x, mlp_norm[layer], eps), wgu[layer])
        gf = gu[:, :inter].to(_F32)
        act = ((gf / (1.0 + torch.exp(-gf))) * gu[:, inter:].to(_F32)).to(_BF16)
        x = x + _mm_bf16(act, wd[layer])
    return _rms(x, final_norm.reshape(1, hidden), eps), k_new, v_new


#: the kernel's constants (``csrc/fused_decode.cu``): threads a block, output
#: columns a GEMV unit, cache rows an attention step, K slices and context
#: chunks at most; the H100's SMs and shared bytes a block may opt into
THREADS, UNIT_N, ATTN_ROWS, MAX_SLICES, MAX_CHUNKS = 512, 256, 32, 32, 64
#: cache rows an attention unit takes at least (the live chunks)
CHUNK_ROWS = 16
#: the weight rows of an L2 prefetch box, and of a unit prefetched at most
BOX_ROWS, L2_ROWS = 64, 128
H100_SMS, H100_SMEM_OPTIN = 132, 232448
#: the five stages of a layer; "attention" streams no weight
STAGES = ("qkv", "attention", "o", "gate_up", "down")


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def choose_slices(k: int, n: int, grid: int) -> int:
    """K slices of a [k, n] projection: the fewest rows a block, plus a
    little for every slice its consumer folds (the kernel's rule)."""
    nt = -(-n // UNIT_N)
    best, best_cost = 1, None
    for sl in range(1, MAX_SLICES + 1):
        if sl * 16 > k:
            break
        cost = -(-(nt * sl) // grid) * -(-k // sl) + 8 * sl
        if best_cost is None or cost < best_cost:
            best, best_cost = sl, cost
    return best


def fused_plan(n_layers: int, hidden: int, intermediate: int, n_heads: int, n_kv_heads: int,
               head_dim: int, max_seq: int, sms: int = H100_SMS) -> dict:
    """The launch plan ``pgk_fused_decode_plan`` writes, from the shapes and
    the SMs: a block per SM, the K slices of each projection, the context
    chunks at most, the scratch words, the dynamic shared bytes and
    ``l2_rows``, the rows of a block's next unit it asks for in L2 before a
    barrier."""
    h, i, hq, hk, d = hidden, intermediate, n_heads, n_kv_heads, head_dim
    nqkv = h + 2 * hk * d
    kn = {"qkv": (h, nqkv), "o": (h, h), "gate_up": (h, 2 * i), "down": (i, h)}
    ks = {name: choose_slices(k, n, sms) for name, (k, n) in kn.items()}
    chunks = min(MAX_CHUNKS, max(1, sms // hk))
    words = (_up(ks["qkv"] * nqkv, 4) + _up(ks["o"] * h, 4) + _up(ks["gate_up"] * 2 * i, 4)
             + _up(ks["down"] * h, 4) + 2 * _up(hq * chunks, 4) + _up(hq * chunks * d, 4)
             + 2 * _up(h, 4))
    row_off = (THREADS // 32) * UNIT_N * 4 + 32 * 4
    ks_max = max(-(-h // ks["o"]), -(-i // ks["down"]))
    g = hq // hk
    attn = (_up(((g + 2) * d + g * d + 2 * d + g * ATTN_ROWS + 2 * g + g * d) * 4, 16)
            + ATTN_ROWS * (2 * d + 8) * 2)
    rows = max(_up(h * 4, 16) + _up(h * 2, 16), _up(ks_max * 2, 16), attn)
    return {"grid": sms, "slices_qkv": ks["qkv"], "slices_o": ks["o"],
            "slices_gate_up": ks["gate_up"], "slices_down": ks["down"], "chunks": chunks,
            "scratch_words": words, "smem_bytes": row_off + rows, "l2_rows": L2_ROWS}


def projection_units(plan: dict, name: str, hidden: int, intermediate: int, n_kv_heads: int,
                     head_dim: int) -> list[tuple[int, int, int]]:
    """The GEMV units of one projection, in unit order: (k0, k1, col0), a
    [k0, k1) slice of K times UNIT_N columns from col0."""
    h, i = hidden, intermediate
    k, n = {"qkv": (h, h + 2 * n_kv_heads * head_dim), "o": (h, h),
            "gate_up": (h, 2 * i), "down": (i, h)}[name]
    sl = plan[f"slices_{name}"]
    nt, ks = -(-n // UNIT_N), -(-k // sl)
    out = []
    for u in range(nt * sl):
        k0 = min(k, (u // nt) * ks)
        out.append((k0, min(k, k0 + ks), (u % nt) * UNIT_N))
    return out


def fused_schedule(plan: dict, *, hidden: int, intermediate: int, n_kv_heads: int,
                   head_dim: int, pos: int, max_seq: int) -> dict:
    """What each block does in one layer: ``units[stage]`` a stage's units,
    ``blocks[stage][b]`` those block b runs (round-robin over the grid; an
    attention unit is (kv head, chunk) over the live chunks at ``pos``),
    ``prefetch[stage][b]`` what it asks for in L2 between its arrival at
    the barrier that ends ``stage`` and its wait: (projection, unit, first
    rows of the BOX_ROWS boxes) of its first unit of the next projection
    (none after attention: the o rows asked for after q|k|v are in flight
    across it), and ``barriers`` the arrivals each of the layer's five
    barriers waits for (the counter grows by one a block a barrier)."""
    grid = plan["grid"]
    live = min(max(pos, 0), max_seq)
    nch = min(plan["chunks"], max(1, -(-live // CHUNK_ROWS)))
    units = {name: projection_units(plan, name, hidden, intermediate, n_kv_heads, head_dim)
             for name in ("qkv", "o", "gate_up", "down")}
    units["attention"] = [(u % n_kv_heads, u // n_kv_heads) for u in range(n_kv_heads * nch)]
    per_block = {st: [list(range(b, len(units[st]), grid)) for b in range(grid)]
                 for st in STAGES}
    nxt = {"qkv": "o", "attention": None, "o": "gate_up", "gate_up": "down", "down": "qkv"}
    prefetch = {}
    for st in STAGES:
        target = nxt[st]
        row = []
        for b in range(grid):
            if target is None or b >= len(units[target]):
                row.append(None)
                continue
            k0, k1, _ = units[target][b]
            rows = min(k1 - k0, plan["l2_rows"])
            row.append((target, b, list(range(k0, k0 + rows, BOX_ROWS))))
        prefetch[st] = row
    return {"units": units, "blocks": per_block, "prefetch": prefetch,
            "barriers": [grid] * len(STAGES), "live_chunks": nch}


def _plan(device: torch.device, dims: tuple) -> ctypes.Array:
    """The kernel's launch plan for ``dims`` on ``device`` (cached): grid,
    K slices per projection, context chunks, scratch words, shared bytes."""
    key = (device.index, *dims)
    with DEVICE_LOCK:
        if key not in _plans:
            plan = (ctypes.c_int * PLAN_INTS)()
            with torch.cuda.device(device):
                rc = library().pgk_fused_decode_plan(*dims, ctypes.addressof(plan))
            if rc != 0:
                raise RuntimeError(f"fused_decode cannot run {dims}: CUDA error {rc} "
                                   f"({library().pgk_error_string(rc).decode()})")
            _plans[key] = plan
        return _plans[key]


def plan_of(device: torch.device, *, n_layers: int, hidden: int, intermediate: int,
            n_heads: int, n_kv_heads: int, head_dim: int, max_seq: int) -> dict:
    """The launch plan as a dict (for reports; :func:`fused_plan` is its
    mirror from the shapes)."""
    plan = _plan(device, (n_layers, hidden, intermediate, n_heads, n_kv_heads, head_dim,
                          max_seq))
    return dict(zip(PLAN_FIELDS, list(plan)))


def fused_decode(h0, cos_p, sin_p, pos, wqkv, wo, wgu, wd, attn_norm, mlp_norm, final_norm,
                 k_cache, v_cache, *, n_heads: int, n_kv_heads: int, head_dim: int,
                 eps: float = 1e-5):
    """One decode step through every layer: h0 [1, H] bf16 (the embedded
    token), cos_p/sin_p [1, D] f32 (the rope row at pos), pos [1] int32 on
    the device, wqkv [L, H, H + 2 Hk D] (q|k|v), wo [L, H, H], wgu [L, H,
    2 I] (gate|up), wd [L, I, H] bf16, attn_norm/mlp_norm [L, H] f32,
    final_norm [1, H] f32, caches [L, MAX, Hk D] bf16 -> (h_out [1, H]
    bf16, k_new [L, Hk D] f32, v_new [L, Hk D] f32). CUDA: the fused_decode
    kernel, one launch; CPU: the plain version."""
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, eps=eps)
    if not h0.is_cuda:
        return fused_decode_plain(h0, cos_p, sin_p, pos, wqkv, wo, wgu, wd, attn_norm,
                                  mlp_norm, final_norm, k_cache, v_cache, **kw)
    n_layers, hidden, n_qkv = wqkv.shape
    inter = wgu.shape[2] // 2
    max_len = k_cache.shape[1]
    kvd = n_kv_heads * head_dim
    dev = h0.device
    named = dict(cos_p=cos_p, sin_p=sin_p, pos=pos, wqkv=wqkv, wo=wo, wgu=wgu, wd=wd,
                 attn_norm=attn_norm, mlp_norm=mlp_norm, final_norm=final_norm,
                 k_cache=k_cache, v_cache=v_cache)
    require_on(dev, **named)
    want = {"h0": (h0, _BF16, (1, hidden)), "cos_p": (cos_p, _F32, (1, head_dim)),
            "sin_p": (sin_p, _F32, (1, head_dim)), "pos": (pos, torch.int32, (1,)),
            "wqkv": (wqkv, _BF16, (n_layers, hidden, hidden + 2 * kvd)),
            "wo": (wo, _BF16, (n_layers, hidden, hidden)),
            "wgu": (wgu, _BF16, (n_layers, hidden, 2 * inter)),
            "wd": (wd, _BF16, (n_layers, inter, hidden)),
            "attn_norm": (attn_norm, _F32, (n_layers, hidden)),
            "mlp_norm": (mlp_norm, _F32, (n_layers, hidden)),
            "final_norm": (final_norm, _F32, (1, hidden)),
            "k_cache": (k_cache, _BF16, (n_layers, max_len, kvd)),
            "v_cache": (v_cache, _BF16, (n_layers, max_len, kvd))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"fused_decode: {name} must be a contiguous 16-byte aligned "
                             f"{dtype} tensor of shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if n_qkv != hidden + 2 * kvd or not supports(
            hidden=hidden, intermediate=inter, n_heads=n_heads, n_kv_heads=n_kv_heads,
            head_dim=head_dim, max_seq=max_len, norm_type="rmsnorm", activation="silu",
            use_rope=True, has_bias=False, use_qk_norm=False, is_moe=False):
        raise ValueError(f"fused_decode does not take H {hidden}, I {inter}, heads "
                         f"{n_heads}/{n_kv_heads}, D {head_dim}")
    dims = (n_layers, hidden, inter, n_heads, n_kv_heads, head_dim, max_len)
    plan = _plan(dev, dims)
    scratch = torch.empty((plan[6],), dtype=_F32, device=dev)
    barrier = torch.zeros((4,), dtype=torch.int32, device=dev)
    h_out = torch.empty((1, hidden), dtype=_BF16, device=dev)
    k_new = torch.empty((n_layers, kvd), dtype=_F32, device=dev)
    v_new = torch.empty((n_layers, kvd), dtype=_F32, device=dev)
    launch("fused_decode", "pgk_fused_decode", h0.data_ptr(), cos_p.data_ptr(),
           sin_p.data_ptr(), pos.data_ptr(), wqkv.data_ptr(), wo.data_ptr(), wgu.data_ptr(),
           wd.data_ptr(), attn_norm.data_ptr(), mlp_norm.data_ptr(), final_norm.data_ptr(),
           k_cache.data_ptr(), v_cache.data_ptr(), h_out.data_ptr(), k_new.data_ptr(),
           v_new.data_ptr(), scratch.data_ptr(), barrier.data_ptr(), ctypes.addressof(plan),
           *dims, float(eps), 1.0 / math.sqrt(head_dim), stream_of(h0))
    return h_out, k_new, v_new
