"""The MoE formulations after ``ops.moe`` took the routing and the
activation as arguments (``gmm_experts``, ``gather_experts``): Mixtral's
``moe_gmm_fn`` and ``moe_gather_fn`` give bitwise what they gave before,
held against the earlier bodies kept here verbatim, on f32 and bf16
operands, quantized expert stacks for the gather route, and T from 1 to
130 (ties in the router included); the expert ids handed to the
activation are each row's own.
"""

import numpy as np
import pytest
import torch

from pygpukit_tpu_torch.kernels.gemm import xla_dot
from pygpukit_tpu_torch.kernels.gmm import gmm
from pygpukit_tpu_torch.ops import moe

_F32, _BF16 = torch.float32, torch.bfloat16


def _earlier_gmm_fn(y, w_gate, w_up, w_down, router_logits, k):
    """``moe_gmm_fn`` as it was before the factoring."""
    w_gate, w_up, w_down = (moe._dequant_stack(w, y.dtype) for w in (w_gate, w_up, w_down))
    t = y.shape[0]
    weights, topi = moe.topk_route_fn(router_logits.to(_F32), k)
    flat_expert = topi.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_tokens = torch.div(order, k, rounding_mode="floor")
    sorted_w = weights.reshape(-1)[order]
    experts = torch.arange(w_gate.shape[0], device=y.device)
    group_sizes = (flat_expert[:, None] == experts).sum(dim=0, dtype=torch.int32)
    lhs = y[sorted_tokens]
    gate = gmm(lhs, w_gate, group_sizes)
    up = gmm(lhs, w_up, group_sizes)
    down = gmm(moe._silu_mul(gate, up, lhs.dtype), w_down, group_sizes)
    contrib = down * sorted_w[:, None]
    pos = torch.sort(torch.argsort(order).reshape(t, k), dim=1).values
    rows = contrib[pos]
    out = torch.zeros((t, down.shape[1]), dtype=_F32, device=y.device)
    for j in range(k):
        out = out + rows[:, j]
    return out


def _earlier_gather_fn(y, w_gate, w_up, w_down, router_logits, k):
    """``moe_gather_fn`` as it was before the factoring."""
    weights, topi = moe.topk_route_fn(router_logits.to(_F32), k)

    def dot_gathered(x_rows, w_stack, eids):
        if isinstance(w_stack, dict):
            q = w_stack["q"][eids]
            acc = xla_dot(x_rows.to(_BF16)[:, None], q.to(_BF16), _F32)[:, 0]
            scale = w_stack["scale"]
            per_expert = scale.dim() >= 1 and scale.shape[0] == w_stack["q"].shape[0]
            sc = scale[eids] if per_expert else scale
            return acc * sc.reshape(-1, acc.shape[-1])
        return xla_dot(x_rows[:, None], w_stack[eids], _F32)[:, 0]

    w_out = w_down["q"] if isinstance(w_down, dict) else w_down
    out = torch.zeros((y.shape[0], w_out.shape[-1]), dtype=_F32, device=y.device)
    for j in range(k):
        eids = topi[:, j]
        g = dot_gathered(y, w_gate, eids)
        u = dot_gathered(y, w_up, eids)
        d = dot_gathered(moe._silu_mul(g, u, y.dtype), w_down, eids)
        out = out + d * weights[:, j:j + 1]
    return out


def _operands(seed, t, dtype, e=4, h=32, i=48, ties=False):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((t, h), generator=g).to(dtype)
    ws = [(torch.randn(shape, generator=g) * 0.2).to(dtype)
          for shape in ((e, h, i), (e, h, i), (e, i, h))]
    logits = torch.randn((t, e), generator=g)
    if ties:
        logits = torch.round(logits)
    return y, ws, logits


@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("t,k,ties", [(1, 2, False), (3, 2, True), (64, 2, False),
                                      (130, 4, True)])
def test_mixtral_routes_are_bitwise_what_they_were(dtype, t, k, ties):
    y, ws, logits = _operands(t, t, dtype, ties=ties)
    for new, old in ((moe.moe_gmm_fn, _earlier_gmm_fn), (moe.moe_gather_fn, _earlier_gather_fn)):
        a, b = new(y, *ws, logits, k), old(y, *ws, logits, k)
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("storage", [torch.int8, torch.float8_e4m3fn])
def test_mixtral_gather_on_quantized_stacks_is_bitwise_what_it_was(storage):
    y, ws, logits = _operands(7, 3, _BF16)
    stacks = []
    for w in ws:
        scale = w.float().abs().amax(dim=1, keepdim=True) / 100.0
        q = torch.clamp(torch.round(w.float() / scale), -100, 100).to(storage)
        stacks.append({"q": q, "scale": scale})
    a = moe.moe_gather_fn(y, *stacks, logits, 2)
    b = _earlier_gather_fn(y, *stacks, logits, 2)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("fn", [moe.gmm_experts, moe.gather_experts])
def test_the_activation_sees_each_rows_expert(fn):
    """The expert ids handed to ``act`` are those of the rows it gets: an
    activation that adds 1000 x the expert id to every row gives the sum
    of each token's k expert ids back through an identity down product."""
    t, k, e, h = 9, 2, 4, 8
    y = torch.ones((t, h))
    eye = torch.eye(h).expand(e, h, h).contiguous()
    topi = torch.tensor(np.random.default_rng(3).permutation(np.tile(np.arange(e), 5))[:t * k]
                        ).reshape(t, k)
    w = torch.ones((t, k))
    out = fn(y, (eye,), eye, w, topi, lambda outs, eids: outs[0] * 0 + 1000.0 * eids[:, None])
    assert torch.equal(out[:, 0], 1000.0 * topi.sum(1).float())
