"""The port's GEMM and gemv_quant modules against the JAX package on the CPU.

- ``kernels.gemm.gemm`` on its kernel route (``force="pallas"``, CPU tensors:
  the plain version) against the JAX ``gemm(..., force="pallas")`` in
  interpret mode: the result dtype equal, f32 within 1e-4 of max |C| (the
  same f32 sums in another order), bf16 within one bf16 ulp plus 1e-4 of
  max |C| (one rounding of sums that differ in their last f32 bits);
- the route itself: size rule, ``PYGPUKIT_GEMM`` read per call, ``force``
  overriding it, the XLA route below the sizes;
- ``batched_gemm`` against the JAX one;
- ``gemv_quant_plain`` (and ``gemv_quant`` on CPU tensors) against the JAX
  ``gemv_quant`` in interpret mode for fp8 e4m3, int8 and bf16 storage,
  within one bf16 ulp plus 1e-4 of max |y|;
- ``gemv_quant``'s launch plan, the Python mirror of ``csrc/gemv_quant.cu``:
  every output row summed by one warp, in ascending order, and every
  16-byte vector of a row loaded by one lane.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygpukit_tpu.kernels.gemm import batched_gemm as jax_batched_gemm
from pygpukit_tpu.kernels.gemm import gemm as jax_gemm
from pygpukit_tpu.kernels.gemv_quant import gemv_quant as jax_gemv_quant
from pygpukit_tpu_torch.kernels import (LAUNCHES, batched_gemm, gemm, gemm_plain,
                                        gemv_quant, gemv_quant_plain, reset_launches)
from pygpukit_tpu_torch.kernels.gemv_quant import (GEMV_BATCH, GEMV_WARPS,
                                                   gemv_lane_vectors, gemv_quant_plan)
from pygpukit_tpu_torch.llm import params_from_jax

gemm_module = importlib.import_module("pygpukit_tpu_torch.kernels.gemm")

torch.set_num_threads(2)

_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
ULP_REL, NEAR_ZERO = 2.0 ** -7, 1e-4


def _pair(rng, shape, dtype, scale=1.0):
    """The same values as a JAX array and a torch tensor (identical bits)."""
    xj = jnp.asarray((rng.standard_normal(shape) * scale).astype(np.float32), _JDT[dtype])
    return xj, params_from_jax(np.asarray(xj))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32),
                      np.float32)


def _assert_bf16_close(got, ref):
    """Within one bf16 ulp of |ref| plus 1e-4 of max |ref|."""
    got, ref = _f32(got), _f32(ref)
    tol = np.abs(ref) * ULP_REL + NEAR_ZERO * np.abs(ref).max()
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


def _assert_close(got, ref, dtype):
    if dtype == "f32":
        got, ref = _f32(got), _f32(ref)
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    else:
        _assert_bf16_close(got, ref)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mnk", [(64, 128, 128), (300, 260, 384)])
def test_gemm_kernel_route_matches_pallas_interpret(mnk, dtype):
    m, n, k = mnk
    rng = np.random.default_rng(m + n + k)
    aj, at = _pair(rng, (m, k), dtype)
    bj, bt = _pair(rng, (k, n), dtype)
    ref = jax_gemm(aj, bj, force="pallas")
    reset_launches()
    got = gemm(at, bt, force="pallas")
    assert LAUNCHES["gemm"] == 0                  # CPU tensors: the plain version
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    assert got.shape == ref.shape
    _assert_close(got, ref, dtype)
    assert torch.equal(got, gemm_plain(at, bt, got.dtype))


@pytest.mark.parametrize("mode", ["", "xla", "pallas"])
def test_gemm_route_reads_env_per_call(monkeypatch, mode):
    """PYGPUKIT_GEMM is read per call; force overrides it; the kernel route
    needs m >= 64, n >= 128, k >= 128 (below, the XLA dot)."""
    rng = np.random.default_rng(3)
    seen = []
    monkeypatch.setattr(gemm_module, "gemm_plain",
                        lambda a, b, d: seen.append("kernel") or torch.zeros(
                            (a.shape[0], b.shape[1]), dtype=d))
    monkeypatch.setenv("PYGPUKIT_GEMM", mode)
    for m, n, k, want in ((64, 128, 128, mode == "pallas"), (63, 128, 128, False),
                          (64, 127, 128, False), (64, 128, 127, False)):
        seen.clear()
        gemm(torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)),
             torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)))
        assert seen == (["kernel"] if want else []), (m, n, k, mode)
    seen.clear()
    gemm(torch.ones((64, 128)), torch.ones((128, 128)), force="pallas")
    assert seen == ["kernel"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gemm_xla_route_and_mixed_promotion(dtype):
    """Below the kernel's sizes the XLA dot: f32 sums, one rounding; bf16 x
    f32 promotes to f32 on both packages."""
    rng = np.random.default_rng(4)
    aj, at = _pair(rng, (5, 7), dtype)
    bj, bt = _pair(rng, (7, 3), "f32")
    ref, got = jax_gemm(aj, bj), gemm(at, bt)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    _assert_close(got, ref, "f32")
    aj2, at2 = _pair(rng, (96, 160), dtype)
    bj2, bt2 = _pair(rng, (160, 192), "f32")
    ref2, got2 = jax_gemm(aj2, bj2, force="pallas"), gemm(at2, bt2, force="pallas")
    assert got2.dtype == torch.float32 and ref2.dtype == jnp.float32
    _assert_close(got2, ref2, "f32")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batched_gemm_matches_jax(dtype):
    rng = np.random.default_rng(5)
    aj, at = _pair(rng, (3, 17, 24), dtype)
    bj, bt = _pair(rng, (3, 24, 9), dtype)
    ref, got = jax_batched_gemm(aj, bj), batched_gemm(at, bt)
    assert got.shape == ref.shape and got.dtype == at.dtype
    _assert_close(got, ref, dtype)


def _quant_weight(rng, n, k, storage):
    w = rng.standard_normal((n, k)).astype(np.float32)
    if storage == "int8":
        wj = jnp.asarray(np.clip(np.round(w * 40), -127, 127), jnp.int8)
    elif storage == "e4m3":
        wj = jnp.asarray(w * 8, jnp.float8_e4m3fn)
    else:
        wj = jnp.asarray(w, jnp.bfloat16)
    return wj, params_from_jax(np.asarray(wj))


@pytest.mark.parametrize("storage", ["e4m3", "int8", "bf16"])
@pytest.mark.parametrize("nk", [(256, 200), (384, 200)])
def test_gemv_quant_plain_matches_pallas_interpret(nk, storage):
    n, k = nk
    rng = np.random.default_rng(n + k)
    wj, wt = _quant_weight(rng, n, k, storage)
    x = rng.standard_normal(k).astype(np.float32)
    scale = (rng.random(n) * 0.02 + 0.001).astype(np.float32)
    for sj, st in ((jnp.asarray(scale), torch.from_numpy(scale)), (None, None)):
        ref = jax_gemv_quant(wj, jnp.asarray(x), sj, bn=128, bk=128)
        got = gemv_quant_plain(wt, torch.from_numpy(x), st)
        assert got.dtype == torch.bfloat16 and got.shape == (n,)
        _assert_bf16_close(got, ref)
        reset_launches()
        assert torch.equal(gemv_quant(wt, torch.from_numpy(x), st), got)
        assert LAUNCHES["gemv_quant"] == 0


@pytest.mark.parametrize("n", [1, 7, 8, 2048, 2560, 11264])
def test_gemv_quant_plan_covers_n_in_order(n):
    """Whole blocks of GEMV_WARPS warps, no more than cover N; the warps'
    rows, in launch order, are 0..N-1 once each, then none."""
    plan = gemv_quant_plan(n)
    assert len(plan) % GEMV_WARPS == 0 and len(plan) - GEMV_WARPS < n
    assert plan[:n] == list(range(n)) and set(plan[n:]) <= {None}


@pytest.mark.parametrize("n_vec", [1, 31, 256, 257, 704, 7264])
def test_gemv_lane_vectors_cover_a_row(n_vec):
    """A row's vectors (K * elt / 16 of them: 7264 at K 116224 in bf16) are
    loaded once each, at most GEMV_BATCH a lane a batch, and the warp's
    lanes take consecutive vectors (coalesced 512-byte loads)."""
    walks = [gemv_lane_vectors(n_vec, lane) for lane in range(32)]
    loads = sorted(v for walk in walks for batch in walk for v in batch)
    assert loads == list(range(n_vec))
    assert all(len(batch) <= GEMV_BATCH for walk in walks for batch in walk)
    first = [walk[0][0] for walk in walks if walk and walk[0]]
    assert first == list(range(min(32, n_vec)))
