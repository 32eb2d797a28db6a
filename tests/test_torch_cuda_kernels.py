"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the 1.1B slice's shapes (the checks chip_smoke.py makes). Marked
``cuda``; without a CUDA device every test skips with the reason.

Run on a card:  python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q --noconftest
(tests/conftest.py imports jax, which the card needs no part of).
"""

import pytest
import torch

from pygpukit_tpu_torch.kernels import (LAUNCHES, batch_decode_attention,
                                        batch_decode_attention_plain,
                                        kv_rows_write, kv_rows_write_plain,
                                        paged_attention, paged_attention_plain,
                                        w4a8_matmul, w4a8_matmul_plain)
from pygpukit_tpu_torch.ops.paged import (paged_attention_dispatch,
                                          paged_attention_fn)

pytestmark = pytest.mark.cuda

PROJ_SHAPES = [(2560, 2048), (2048, 2048), (11264, 2048), (2048, 5632)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("rows", [1, 8, 32, 256])
@pytest.mark.parametrize("nk", PROJ_SHAPES)
def test_w4a8_kernels_bitwise(dev, nk, rows):
    n, k = nk
    g = _gen(dev, rows)
    w = torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
    sc = torch.rand((n,), generator=g, device=dev) * 1e-3 + 1e-4
    x = (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
    name = "w4a8_gemv" if rows <= 8 else "w4a8_gemm"
    before = LAUNCHES[name]
    y = w4a8_matmul(x, w, sc)
    assert LAUNCHES[name] == before + 1
    assert torch.equal(_bits(y), _bits(w4a8_matmul_plain(x, w, sc)))


def test_kv_rows_write_bitwise_and_clamped(dev):
    g = _gen(dev, 3)
    b, nl, mx, lanes = 8, 22, 1024, 256
    kp = torch.randn((b, nl, mx, lanes), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((b, nl, mx, lanes), generator=g, device=dev).to(torch.bfloat16)
    kn = torch.randn((b, 4, 64), generator=g, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, 4, 64), generator=g, device=dev).to(torch.bfloat16)
    poss = torch.tensor([0, 5, 511, mx - 1, mx, mx + 37, 100, 2 * mx],
                        dtype=torch.int32, device=dev)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    kv_rows_write(k1, v1, kn, vn, 7, poss)
    kv_rows_write_plain(k2, v2, kn, vn, 7, poss)
    assert torch.equal(_bits(k1), _bits(k2)) and torch.equal(_bits(v1), _bits(v2))
    assert torch.equal(_bits(k1[5, 7, mx - 1]), _bits(kn[5].reshape(-1)))


@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, 100)])
def test_batch_decode_attention_close(dev, softcap, window):
    g = _gen(dev, 4)
    b, nl, mx, lanes, hq, d = 8, 22, 1024, 256, 32, 64
    kp = torch.randn((b, nl, mx, lanes), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((b, nl, mx, lanes), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((b, 1, hq, d), generator=g, device=dev).to(torch.bfloat16)
    lens = torch.tensor([1, 513, 1024, 1500, 37, 700, 1025, 256],
                        dtype=torch.int32, device=dev)
    out = batch_decode_attention(q, kp, vp, 5, lens, softcap=softcap, window=window)
    ref = batch_decode_attention_plain(q, kp, vp, 5, lens, 0.125, softcap, window)
    # bf16 output; both round P to bf16 before P@V, against different maxima
    assert torch.allclose(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


def _paged_inputs(dev, max_len, seed, b=8, bs=16, hq=32, hk=4, d=64):
    """Slots over shuffled physical blocks, contexts spread from 1 to
    max_len, the last two slots dead on the trash table (block 0)."""
    g = _gen(dev, seed)
    mb = max_len // bs
    nb = b * mb + 2
    kp = torch.randn((nb, hk, bs, d), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((nb, hk, bs, d), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((b, hq, d), generator=g, device=dev).to(torch.bfloat16)
    perm = torch.randperm(nb - 1, generator=g, device=dev).to(torch.int32) + 1
    tables = perm[:b * mb].reshape(b, mb).contiguous()
    tables[-2:] = 0
    lens = torch.tensor([1, 17, max_len // 2 + 3, max_len - 1, max_len, 300 % max_len,
                         5, 40], dtype=torch.int32, device=dev)
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("max_len", [512, 1024])
@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, 100)])
def test_paged_attention_close(dev, max_len, softcap, window):
    q, kp, vp, tables, lens = _paged_inputs(dev, max_len, 5)
    before = LAUNCHES["paged_attention"]
    out = paged_attention(q, kp, vp, tables, lens, scale=0.125, softcap=softcap,
                          window=window)
    assert LAUNCHES["paged_attention"] == before + 1
    ref = paged_attention_plain(q, kp, vp, tables, lens, 0.125, softcap, window)
    # bf16 output; the kernel rounds P to bf16 before P@V, the plain version
    # keeps it f32
    assert torch.allclose(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


def test_paged_attention_dispatch_uses_the_kernel(dev):
    """ops.paged on CUDA tensors: the kernel over transposed [NB, BS, Hk, D]
    pools, against the gather formulation."""
    q, kp, vp, tables, lens = _paged_inputs(dev, 512, 6)
    kp, vp = kp.transpose(1, 2).contiguous(), vp.transpose(1, 2).contiguous()
    before = LAUNCHES["paged_attention"]
    out = paged_attention_dispatch(q[3], kp, vp, tables[3], int(lens[3]))
    assert LAUNCHES["paged_attention"] == before + 1
    ref = paged_attention_fn(q[3], kp, vp, tables[3], int(lens[3]))
    assert torch.allclose(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


def test_cuda_wrappers_raise_on_unsupported_storage(dev):
    pools = torch.zeros((2, 1, 64, 128), dtype=torch.float32, device=dev)
    rows = torch.zeros((2, 2, 64), dtype=torch.float32, device=dev)
    with pytest.raises(NotImplementedError):
        kv_rows_write(pools, pools.clone(), rows, rows, 0,
                      torch.zeros(2, dtype=torch.int32, device=dev))
    with pytest.raises(NotImplementedError):
        batch_decode_attention(torch.zeros((2, 1, 4, 64), device=dev), pools, pools, 0,
                               torch.ones(2, dtype=torch.int32, device=dev))
    blocks = torch.zeros((4, 2, 16, 64), dtype=torch.int8, device=dev)
    with pytest.raises(NotImplementedError):
        paged_attention(torch.zeros((2, 4, 64), dtype=torch.bfloat16, device=dev),
                        {"q": blocks, "s": torch.zeros((4, 16), device=dev)},
                        {"q": blocks, "s": torch.zeros((4, 16), device=dev)},
                        torch.zeros((2, 2), dtype=torch.int32, device=dev),
                        torch.ones(2, dtype=torch.int32, device=dev))
    w = torch.zeros((64, 16), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="scale"):     # a host scale pointer
        w4a8_matmul(torch.zeros((1, 32), dtype=torch.bfloat16, device=dev), w,
                    torch.ones(64))
