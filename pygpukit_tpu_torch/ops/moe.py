"""MoE dispatch (counterpart of ``pygpukit_tpu/ops/moe.py``): top-k routing
and three exact formulations of the routed expert MLP (no token dropping).

* ``moe_gmm_fn``: token rows replicated top-k times, sorted by expert and
  run through grouped matmuls over contiguous expert segments
  (``kernels.gmm``, the port of megablox ``gmm``): minimal FLOPs, the
  prefill route.
* ``moe_gather_fn``: each token gathers its k experts' weight slabs
  (``w[eids]`` materialises ``[T, in, out]`` per matrix and per j, as the
  reference's XLA gather does); for decode-sized T.
* ``moe_dense_fn``: every expert over every token, a one-hot combine.

The gmm and gather formulations take a routing made elsewhere:
``gmm_experts`` and ``gather_experts`` are given the weights, the expert
ids and the activation between the two products (and a down bias), so the
standalone families (``llm/models``) run their own routers and activations
through them (``routed_experts`` picks the route, the family's one-hot
formula its plain version); ``moe_gmm_fn`` and ``moe_gather_fn`` are them
with the softmax top-k router and the SiLU product.

Rounding points follow the reference, formulation by formulation: dense
rounds gate, up and down to the activation dtype (``_expert_dot``); gmm and
gather keep them in f32 and round only the SiLU product. So moving a token
count between routes changes bf16 results, not only the summation order.

Route (``select_moe_fn``, the reference's rule with "TPU" read as "CUDA
tensors"): ``PYGPUKIT_MOE=dense`` (read per call) forces dense; on CUDA,
gmm from ``T * k >= GMM_MIN_ROWS`` (megablox's 128-row tile minimum,
kept); then gather up to ``GATHER_MAX_TOKENS`` tokens; dense above. CPU
tensors take the reference's off-TPU route: gather to T 4, dense above.
The gmm kernel takes the model's operands as they are, bf16 or f32 (an
f32 model's through its CUDA-core route, ``kernels.gmm``), as the
reference hands megablox an f32 model's operands unchanged.
"""

from __future__ import annotations

import os

import torch

from ..kernels.gemm import xla_dot
from ..kernels.gmm import gmm

_F32 = torch.float32
_BF16 = torch.bfloat16
MOE_ENV = "PYGPUKIT_MOE"
#: replicated rows (T * k) from which CUDA tensors take moe_gmm_fn
GMM_MIN_ROWS = 128
#: the most tokens moe_gather_fn takes
GATHER_MAX_TOKENS = 4


def top_k_fn(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: (values, indices [..., k]) with
    floats in their total order (-0 below +0) and the lower index first on
    ties (a stable descending sort of the f32 bits mapped to
    order-preserving integers)."""
    bits = x.to(_F32).view(torch.int32)
    keys = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    idx = torch.sort(keys, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def topk_route_fn(router_logits: torch.Tensor, k: int):
    """[T, E] logits -> (softmaxed weights [T, k], expert ids [T, k]) in
    ``lax.top_k``'s order (``top_k_fn``)."""
    top, idx = top_k_fn(router_logits, k)
    return torch.softmax(top, dim=-1), idx


def _expert_dot(x: torch.Tensor, w) -> torch.Tensor:
    """x [T, in] @ expert weight [(E,) in, out] rounded to x's dtype; a
    quantized ``{"q", "scale"}`` leaf multiplies bf16 codes in f32 and
    applies the scale after the dot."""
    if isinstance(w, dict):
        acc = xla_dot(x.to(_BF16), w["q"].to(_BF16), _F32)
        return (acc * w["scale"]).to(x.dtype)
    return xla_dot(x, w, x.dtype)


def _dequant_stack(w, dtype: torch.dtype) -> torch.Tensor:
    """A dense [E, in, out] stack from a quantized leaf (the gmm kernel
    takes dense operands)."""
    if isinstance(w, dict):
        return (w["q"].to(_F32) * w["scale"]).to(dtype)
    return w


def _silu_mul(gate: torch.Tensor, up: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``sigmoid(g) * g * u`` in f32, rounded to ``dtype``."""
    g, u = gate.to(_F32), up.to(_F32)
    return (torch.sigmoid(g) * g * u).to(dtype)


def gmm_experts(y, w_in, w_down, weights, topi, act, down_bias=None) -> torch.Tensor:
    """The grouped-matmul formulation over a given routing. y [T, H]; w_in
    a tuple of expert stacks [E, H, *] (gate and up, or one interleaved
    gate_up), w_down [E, I, H]; weights and expert ids topi [T, k] (the
    family's router). ``act(outs, eids)`` takes the first products (f32
    [T*k, *], one per stack, rows sorted by expert) and their expert ids
    and returns the down product's rows in y's dtype; ``down_bias`` [E, H]
    is added to the down rows in f32 by expert. f32 [T, H], each token's
    k rows combined in the reference's scatter order (ascending expert id),
    without atomics."""
    t, k = topi.shape
    flat_expert = topi.reshape(-1)                            # [T*k]
    order = torch.argsort(flat_expert, stable=True)
    sorted_tokens = torch.div(order, k, rounding_mode="floor")
    sorted_w = weights.reshape(-1)[order]
    experts = torch.arange(w_down.shape[0], device=y.device)
    # a one-hot count: bincount would read its output size on the host
    group_sizes = (flat_expert[:, None] == experts).sum(dim=0, dtype=torch.int32)

    lhs = y[sorted_tokens]                                    # [T*k, H]
    outs = [gmm(lhs, w, group_sizes) for w in w_in]           # [T*k, *] f32
    eids = flat_expert[order]
    down = gmm(act(outs, eids), w_down, group_sizes)
    if down_bias is not None:
        down = down + down_bias[eids].to(_F32)
    contrib = down * sorted_w[:, None]
    # token i's rows sit at sorted positions inv[i*k : i*k + k]; in
    # ascending position they are in ascending expert id
    pos = torch.sort(torch.argsort(order).reshape(t, k), dim=1).values
    rows = contrib[pos]                                       # [T, k, H]
    out = torch.zeros((t, down.shape[1]), dtype=_F32, device=y.device)
    for j in range(k):
        out = out + rows[:, j]
    return out


def routed_experts(y, w_in, w_down, weights, topi, act, plain) -> torch.Tensor:
    """The routed experts of y [T, H] at a family's routing, by
    ``moe_route``'s route: CPU tensors and the dense route take
    ``plain(y, weights, topi)`` (the family's one-hot formula, its plain
    version); CUDA tensors otherwise ``gmm_experts`` or ``gather_experts``
    (arguments as theirs). f32 [T, H]."""
    route = moe_route(y.shape[0], topi.shape[1], y.device.type)
    if not y.is_cuda or route == "dense":
        return plain(y, weights, topi)
    experts = gmm_experts if route == "gmm" else gather_experts
    return experts(y, w_in, w_down, weights, topi, act)


def moe_gmm_fn(y, w_gate, w_up, w_down, router_logits, k: int) -> torch.Tensor:
    """Exact ragged MoE via grouped matmuls (``gmm_experts`` with the
    softmax top-k routing and the SiLU product). y [T, H]; w_* [E, H, I] /
    [E, I, H]; router_logits [T, E]; f32 [T, H]."""
    w_gate, w_up, w_down = (_dequant_stack(w, y.dtype) for w in (w_gate, w_up, w_down))
    weights, topi = topk_route_fn(router_logits.to(_F32), k)
    return gmm_experts(y, (w_gate, w_up), w_down, weights, topi,
                       lambda outs, _: _silu_mul(outs[0], outs[1], y.dtype))


def _dot_gathered(x_rows, w_stack, eids):
    """x_rows [T, in] times gathered expert mats [T, in, out] -> f32 [T, out]."""
    if isinstance(w_stack, dict):
        q = w_stack["q"][eids]                                # [T, in, out]
        acc = xla_dot(x_rows.to(_BF16)[:, None], q.to(_BF16), _F32)[:, 0]
        scale = w_stack["scale"]
        per_expert = scale.dim() >= 1 and scale.shape[0] == w_stack["q"].shape[0]
        sc = scale[eids] if per_expert else scale
        return acc * sc.reshape(-1, acc.shape[-1])
    return xla_dot(x_rows[:, None], w_stack[eids], _F32)[:, 0]


def gather_experts(y, w_in, w_down, weights, topi, act, down_bias=None) -> torch.Tensor:
    """The gather formulation over a given routing (arguments as
    ``gmm_experts``; ``act`` sees [T, *] rows and the j-th expert ids): per
    j, each token's expert slabs gathered (``w[eids]``) and multiplied in
    f32."""
    w_out = w_down["q"] if isinstance(w_down, dict) else w_down
    out = torch.zeros((y.shape[0], w_out.shape[-1]), dtype=_F32, device=y.device)
    for j in range(topi.shape[1]):
        eids = topi[:, j]
        outs = [_dot_gathered(y, w, eids) for w in w_in]
        d = _dot_gathered(act(outs, eids), w_down, eids)
        if down_bias is not None:
            d = d + down_bias[eids].to(_F32)
        out = out + d * weights[:, j:j + 1]
    return out


def moe_gather_fn(y, w_gate, w_up, w_down, router_logits, k: int) -> torch.Tensor:
    """Small-T formulation (``gather_experts`` with the softmax top-k
    routing and the SiLU product). Exact (the dense route's math)."""
    weights, topi = topk_route_fn(router_logits.to(_F32), k)
    return gather_experts(y, (w_gate, w_up), w_down, weights, topi,
                          lambda outs, _: _silu_mul(outs[0], outs[1], y.dtype))


def moe_dense_fn(y, w_gate, w_up, w_down, router_logits, k: int) -> torch.Tensor:
    """Dense one-hot formulation: every expert over every token (batched
    over E), then the routing weights' one-hot combine in f32."""
    t = y.shape[0]
    e = (w_gate["q"] if isinstance(w_gate, dict) else w_gate).shape[0]
    weights, topi = topk_route_fn(router_logits.to(_F32), k)
    combine = torch.zeros((t, e), dtype=_F32, device=y.device).scatter(1, topi, weights)
    g = _expert_dot(y, w_gate)                                # [E, T, I]
    u = _expert_dot(y, w_up)
    per_expert = _expert_dot(_silu_mul(g, u, y.dtype), w_down).to(_F32)   # [E, T, H]
    return torch.einsum("te,eth->th", combine, per_expert)


def use_gmm(device_type: str) -> bool:
    """The grouped-matmul route is open: CUDA tensors, unless
    ``PYGPUKIT_MOE=dense``."""
    if os.environ.get(MOE_ENV, "") == "dense":
        return False
    return device_type == "cuda"


def moe_route(n_tokens: int, top_k: int, device_type: str) -> str:
    """"gmm", "gather" or "dense": the formulation for ``n_tokens`` tokens
    at top-``top_k`` on a ``device_type`` tensor (route in the module
    docstring)."""
    if os.environ.get(MOE_ENV, "") == "dense":
        return "dense"
    if use_gmm(device_type) and n_tokens * top_k >= GMM_MIN_ROWS:
        return "gmm"
    if n_tokens <= GATHER_MAX_TOKENS:
        return "gather"
    return "dense"


def select_moe_fn(n_tokens: int, top_k: int, device_type: str):
    """Mixtral's formulation function for ``moe_route``'s route."""
    return {"gmm": moe_gmm_fn, "gather": moe_gather_fn,
            "dense": moe_dense_fn}[moe_route(n_tokens, top_k, device_type)]
