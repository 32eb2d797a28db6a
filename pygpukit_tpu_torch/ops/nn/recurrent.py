"""Recurrent ops: the LSTM (counterpart of
``pygpukit_tpu/ops/nn/recurrent.py``, used by Kokoro's layers).

The reference scans one step with ``lax.scan``; the port runs a plain
step loop, so on the card a captured program records each step's few
kernels. The input projection of every step is one product before the
loop; a step adds ``h @ w_hh.T`` to its row of it. Gates follow torch's
layout [i, f, g, o], the LSTM's formula written out (no ``torch.nn.LSTM``,
whose fused cell rounds differently from the reference's).
"""

from __future__ import annotations

import torch

from ...core.array import Array, as_tensor
from .._common import finish

_F32 = torch.float32


def _gates_to_state(gates: torch.Tensor, c: torch.Tensor):
    """(h, c) after one step from the step's pre-activations [B, 4H]."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_cell_fn(x, h, c, w_ih, w_hh, b_ih=None, b_hh=None):
    """One LSTM step. x [B,I], h/c [B,H], w_ih [4H,I], w_hh [4H,H] (torch gate
    order [i,f,g,o]). Returns (h_new, c_new) in x's dtype."""
    gates = x.to(_F32) @ w_ih.T.to(_F32) + h.to(_F32) @ w_hh.T.to(_F32)
    if b_ih is not None:
        gates = gates + b_ih.to(_F32) + b_hh.to(_F32)
    h_new, c_new = _gates_to_state(gates, c.to(_F32))
    return h_new.to(x.dtype), c_new.to(x.dtype)


def lstm_fn(x, w_ih, w_hh, b_ih=None, b_hh=None, h0=None, c0=None,
            reverse: bool = False):
    """Full-sequence LSTM. x [S,B,I] -> (out [S,B,H], (h, c)); ``reverse``
    steps from the last row to the first, out[t] staying the state after
    row t (``lax.scan(..., reverse=True)``)."""
    s, b, _ = x.shape
    hidden = w_hh.shape[-1]
    zeros = torch.zeros((b, hidden), dtype=_F32, device=x.device)
    h = zeros if h0 is None else h0.to(_F32)
    c = zeros if c0 is None else c0.to(_F32)
    gx = x.to(_F32) @ w_ih.T.to(_F32)                          # [S, B, 4H]
    if b_ih is not None:
        gx = gx + b_ih.to(_F32) + b_hh.to(_F32)
    w_hh_t = w_hh.T.to(_F32)
    out = [None] * s
    for t in (range(s - 1, -1, -1) if reverse else range(s)):
        h, c = _gates_to_state(torch.addmm(gx[t], h, w_hh_t), c)
        out[t] = h
    res = torch.stack(out) if s else x.new_zeros((0, b, hidden), dtype=_F32)
    return res.to(x.dtype), (h.to(x.dtype), c.to(x.dtype))


def bilstm_fn(x, w_ih_f, w_hh_f, b_ih_f, b_hh_f, w_ih_b, w_hh_b, b_ih_b, b_hh_b):
    """Bidirectional LSTM: the forward and backward states concatenated."""
    fwd, _ = lstm_fn(x, w_ih_f, w_hh_f, b_ih_f, b_hh_f)
    bwd, _ = lstm_fn(x, w_ih_b, w_hh_b, b_ih_b, b_hh_b, reverse=True)
    return torch.cat([fwd, bwd], dim=-1)


def lstm(x, w_ih, w_hh, b_ih=None, b_hh=None, *, out: Array | None = None) -> Array:
    """The LSTM's outputs [S,B,H] over Array/tensor/numpy operands (on x's
    device)."""
    xt = as_tensor(x)
    opt = [None if t is None else as_tensor(t, xt.device) for t in (b_ih, b_hh)]
    res, _ = lstm_fn(xt, as_tensor(w_ih, xt.device), as_tensor(w_hh, xt.device), *opt)
    return finish(res, out)
