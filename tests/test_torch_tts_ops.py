"""The port's convolutions (``pygpukit_tpu_torch.ops.conv``) and LSTM
(``pygpukit_tpu_torch.ops.nn.recurrent``) against the JAX package's on the
same seeded inputs at rtol 1e-4 (f32; the reference's products at full
precision, the port's f32 on the CPU), and the LSTM against
``torch.nn.LSTM`` for the gate order [i, f, g, o]."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from pygpukit_tpu.ops import conv as ref_conv  # noqa: E402
from pygpukit_tpu.ops.nn import recurrent as ref_rec  # noqa: E402
import pygpukit_tpu_torch as gp  # noqa: E402
from pygpukit_tpu_torch.ops import conv  # noqa: E402
from pygpukit_tpu_torch.ops.nn import recurrent as rec  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(fn_ref, fn_port, *arrays, **kw):
    """(reference, port) results of the same numpy operands as numpy."""
    ref = fn_ref(*[None if a is None else jnp.asarray(a) for a in arrays], **kw)
    got = fn_port(*[None if a is None else torch.from_numpy(a) for a in arrays], **kw)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("stride,padding,dilation,groups,bias", [
    (1, 0, 1, 1, True), (2, 3, 2, 1, True), (1, 2, 1, 2, False),
    (3, 1, 1, 4, True), (1, 5, 3, 1, False)])
def test_conv1d_fn_matches_the_reference(stride, padding, dilation, groups, bias):
    rng = np.random.default_rng(stride * 10 + padding)
    x, w = _rand(rng, 2, 8, 33), _rand(rng, 12, 8 // groups, 5, scale=0.3)
    b = _rand(rng, 12) if bias else None
    ref, got = _both(ref_conv.conv1d_fn, conv.conv1d_fn, x, w, b, stride=stride,
                     padding=padding, dilation=dilation, groups=groups)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stride,padding,dilation,groups,bias", [
    (1, 0, 1, 1, True), ((2, 1), 1, (1, 2), 1, True), (2, [(1, 2), (0, 3)], 1, 2, False),
    (2, [(1, 1), (2, 2)], 1, 1, True), (1, [(0, 2), (2, 0)], 2, 1, False),
    (2, [(0, 0), (0, 0)], 1, 4, True)])
def test_conv2d_fn_matches_the_reference(stride, padding, dilation, groups, bias):
    rng = np.random.default_rng(7)
    x, w = _rand(rng, 2, 8, 13, 11), _rand(rng, 8, 8 // groups, 3, 3, scale=0.3)
    b = _rand(rng, 8) if bias else None
    ref, got = _both(ref_conv.conv2d_fn, conv.conv2d_fn, x, w, b, stride=stride,
                     padding=padding, dilation=dilation, groups=groups)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stride,padding,k,bias", [
    (1, 0, 3, True), (4, 2, 8, True), (6, 3, 12, False), (10, 5, 20, True), (2, 0, 2, False)])
def test_conv_transpose1d_fn_matches_the_reference(stride, padding, k, bias):
    rng = np.random.default_rng(k)
    x, w = _rand(rng, 1, 6, 10), _rand(rng, 6, 4, k, scale=0.3)
    b = _rand(rng, 4) if bias else None
    ref, got = _both(ref_conv.conv_transpose1d_fn, conv.conv_transpose1d_fn, x, w, b,
                     stride=stride, padding=padding)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_conv_wrappers_take_arrays_and_keep_bf16():
    """``ops.conv1d`` / ``conv2d`` over Arrays (and ``out=``), the reference
    wrappers' results; a bf16 input comes back bf16 (the f32 result cast)."""
    from pygpukit_tpu.core.array import Array as RefArray
    rng = np.random.default_rng(3)
    x, w, b = _rand(rng, 1, 4, 16), _rand(rng, 6, 4, 3), _rand(rng, 6)
    ref = ref_conv.conv1d(RefArray(jnp.asarray(x)), RefArray(jnp.asarray(w)),
                          RefArray(jnp.asarray(b)), padding=1).to_numpy()
    got = gp.ops.conv1d(gp.Array.from_numpy(x, device="cpu"),
                        gp.Array.from_numpy(w, device="cpu"),
                        gp.Array.from_numpy(b, device="cpu"), padding=1)
    np.testing.assert_allclose(got.to_numpy(), ref, rtol=RTOL, atol=ATOL)
    out = gp.zeros((1, 6, 16), dtype=gp.float32, device="cpu")
    assert gp.ops.conv1d(torch.from_numpy(x), torch.from_numpy(w), padding=1, out=out) is out
    x2, w2 = _rand(rng, 1, 3, 9, 9), _rand(rng, 5, 3, 3, 3)
    ref2 = ref_conv.conv2d(RefArray(jnp.asarray(x2)), RefArray(jnp.asarray(w2)),
                           stride=2).to_numpy()
    got2 = gp.ops.conv2d(torch.from_numpy(x2), torch.from_numpy(w2), stride=2)
    np.testing.assert_allclose(got2.to_numpy(), ref2, rtol=RTOL, atol=ATOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = conv.conv1d_fn(xb, torch.from_numpy(w), torch.from_numpy(b), padding=1)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, conv.conv1d_fn(xb.float(), torch.from_numpy(w),
                                         torch.from_numpy(b), padding=1).to(torch.bfloat16))


def _lstm_weights(rng, inp, hid, bias=True):
    s = 1.0 / np.sqrt(hid)
    w = [_rand(rng, 4 * hid, inp, scale=s), _rand(rng, 4 * hid, hid, scale=s)]
    return w + ([_rand(rng, 4 * hid, scale=s), _rand(rng, 4 * hid, scale=s)] if bias
                else [None, None])


def test_lstm_cell_fn_matches_the_reference():
    rng = np.random.default_rng(11)
    x, h, c = _rand(rng, 3, 10), _rand(rng, 3, 7), _rand(rng, 3, 7)
    for bias in (True, False):
        w = _lstm_weights(rng, 10, 7, bias)
        ref = ref_rec.lstm_cell_fn(*[None if a is None else jnp.asarray(a)
                                     for a in (x, h, c, *w)])
        got = rec.lstm_cell_fn(*[None if a is None else torch.from_numpy(a)
                                 for a in (x, h, c, *w)])
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_lstm_fn_matches_the_reference(reverse, initial, bias):
    """Forward and reverse, zero or given (h0, c0), with and without biases:
    the outputs and the final (h, c)."""
    rng = np.random.default_rng(int(reverse) + 2 * int(initial) + 4 * int(bias))
    s, b, inp, hid = 13, 2, 10, 7
    x = _rand(rng, s, b, inp)
    w = _lstm_weights(rng, inp, hid, bias)
    h0 = _rand(rng, b, hid) if initial else None
    c0 = _rand(rng, b, hid) if initial else None
    args = (x, *w, h0, c0)
    ref_out, (ref_h, ref_c) = ref_rec.lstm_fn(
        *[None if a is None else jnp.asarray(a) for a in args], reverse=reverse)
    out, (h, c) = rec.lstm_fn(*[None if a is None else torch.from_numpy(a) for a in args],
                              reverse=reverse)
    for g, r in ((out, ref_out), (h, ref_h), (c, ref_c)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def test_bilstm_fn_matches_the_reference_and_torch():
    """The reference's bidirectional LSTM, and ``torch.nn.LSTM`` on the same
    weights: the gate order [i, f, g, o] and the reversed direction."""
    rng = np.random.default_rng(5)
    s, b, inp, hid = 9, 3, 6, 5
    x = _rand(rng, s, b, inp)
    wf, wb = _lstm_weights(rng, inp, hid), _lstm_weights(rng, inp, hid)
    ref = ref_rec.bilstm_fn(jnp.asarray(x), *map(jnp.asarray, wf), *map(jnp.asarray, wb))
    got = rec.bilstm_fn(torch.from_numpy(x), *map(torch.from_numpy, wf),
                        *map(torch.from_numpy, wb))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    m = torch.nn.LSTM(inp, hid, bidirectional=True)
    with torch.no_grad():
        for suffix, ws in (("", wf), ("_reverse", wb)):
            for name, a in zip(("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"), ws):
                getattr(m, name + suffix).copy_(torch.from_numpy(a))
        want, _ = m(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


def test_lstm_wrappers_match_the_reference():
    """``ops.nn.recurrent.lstm`` and the top level's ``lstm_forward`` over
    Arrays, numpy and tensors, with and without biases, and ``out=``."""
    from pygpukit_tpu.core.array import Array as RefArray
    rng = np.random.default_rng(9)
    x = _rand(rng, 7, 2, 4)
    for bias in (True, False):
        w = _lstm_weights(rng, 4, 3, bias)
        ref = ref_rec.lstm(RefArray(jnp.asarray(x)),
                           *[None if a is None else RefArray(jnp.asarray(a)) for a in w])
        got = gp.lstm_forward(gp.Array.from_numpy(x, device="cpu"), *[
            None if a is None else torch.from_numpy(a) for a in w])
        assert gp.lstm_forward is rec.lstm
        np.testing.assert_allclose(got.to_numpy(), ref.to_numpy(), rtol=RTOL, atol=ATOL)
    out = gp.zeros((7, 2, 3), dtype=gp.float32, device="cpu")
    assert rec.lstm(torch.from_numpy(x), *map(torch.from_numpy, w[:2]), out=out) is out
    np.testing.assert_allclose(out.to_numpy(), ref.to_numpy(), rtol=RTOL, atol=ATOL)


def test_exports_follow_the_reference():
    import pygpukit_tpu.ops.nn.recurrent as r
    for name in ("lstm_cell_fn", "lstm_fn", "bilstm_fn", "lstm"):
        assert callable(getattr(rec, name)) and callable(getattr(r, name))
    assert gp.ops.conv1d is conv.conv1d and gp.ops.conv2d is conv.conv2d
    assert gp.ops.nn.recurrent is rec and "recurrent" in gp.ops.nn.__all__
