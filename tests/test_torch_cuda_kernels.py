"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the 1.1B slice's shapes (the checks chip_smoke.py makes): among them the
row write and both decode-attention kernels on every KV storage,
flash_attention over short, ragged and GQA shapes at D 64 and 128, a CUDA
graph of the batch-8 step replayed bitwise, and engines on int8 and fp8 KV.
Marked ``cuda``; without a CUDA device every test skips with the reason.

Run on a card:  python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q --noconftest
(tests/conftest.py imports jax, which the card needs no part of).
"""

import pytest
import torch

from pygpukit_tpu_torch.kernels import (LAUNCHES, batch_decode_attention,
                                        batch_decode_attention_plain,
                                        flash_attention, flash_attention_plain,
                                        flash_decode, flash_decode_plain,
                                        gemm, gemm_plain, gemv_quant,
                                        gemv_quant_plain, block_w4a8_matmul, block_w4a8_matmul_plain,
                                        block_w4a16_matmul,
                                        block_w4a16_matmul_plain, conv_matmul,
                                        conv_matmul_plain, kv_rows_write,
                                        kv_rows_write_plain, kv_write_attention,
                                        paged_attention,
                                        paged_attention_plain, w4a8_matmul,
                                        w4a8_matmul_plain, w4a16_matmul,
                                        w4a16_matmul_plain)
from pygpukit_tpu_torch.ops.nn import flash_attention_fn
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


def _launches() -> dict:
    """Kernel launches so far: the wrappers' eager LAUNCHES plus
    cost_analysis() x replays of the captured programs (a replay ticks no
    wrapper counter)."""
    from pygpukit_tpu_torch.core import replayed_launches
    out = dict(LAUNCHES)
    for name, n in replayed_launches().items():
        out[name] = out.get(name, 0) + n
    return out


@pytest.mark.parametrize("rows", [1, 2, 5, 8, 32, 256, 300, 2048])
@pytest.mark.parametrize("nk", PROJ_SHAPES + [(1001, 2048)])
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


def _graph_bitwise(fn):
    """fn() twice, and a CUDA graph of it captured once and replayed twice:
    all bitwise the first eager call."""
    ref = fn()
    assert torch.equal(_bits(fn()), _bits(ref))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("m,nk", [(256, (2048, 2048)), (256, (11264, 2048)), (300, (1001, 2048)),
                                  (40, (2048, 5632))])
def test_w4a8_gemm_replays_a_graph_bitwise(dev, m, nk):
    """Split K (M 256 at o: the last split of a tile to arrive folds, its
    counters back at zero) and unsplit shapes, eager twice and replayed."""
    n, k = nk
    g = _gen(dev, m + n)
    w = torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
    sc = torch.rand((n,), generator=g, device=dev) * 1e-3 + 1e-4
    x = (torch.randn((m, k), generator=g, device=dev) * 2).to(torch.bfloat16)
    _graph_bitwise(lambda: w4a8_matmul(x, w, sc))
    assert torch.equal(_bits(w4a8_matmul(x, w, sc)), _bits(w4a8_matmul_plain(x, w, sc)))


@pytest.mark.parametrize("pdl", [True, False])
@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("nk", [(2048, 5632), (11264, 2048), (1001, 2048), (40, 96),
                                (64, 16384)])
def test_w4a8_gemv_forms_bitwise(dev, nk, rows, pdl):
    """The GEMV as the quantization's programmatic dependent and launched
    after it is bitwise the plain version, bf16 and f32 x (K 16384: rows
    past the registers of the quantization kernel, which act_quant.cuh's
    launch takes)."""
    from pygpukit_tpu_torch.kernels.gemv_quant import w4a8_gemv_launch
    n, k = nk
    g = _gen(dev, rows * 7 + n)
    w = torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
    sc = torch.rand((n,), generator=g, device=dev) * 1e-3 + 1e-4
    x = torch.randn((rows, k), generator=g, device=dev) * 2
    for xt in (x.to(torch.bfloat16), x):
        before = LAUNCHES["w4a8_gemv"]
        y = w4a8_gemv_launch(xt, w, sc, pdl)
        assert LAUNCHES["w4a8_gemv"] == before + 1
        assert torch.equal(_bits(y), _bits(w4a8_matmul_plain(xt, w, sc))), xt.dtype


@pytest.mark.parametrize("pdl", [True, False])
@pytest.mark.parametrize("rows", [1, 8])
def test_w4a8_gemv_replays_a_graph_bitwise(dev, rows, pdl):
    """Two launches, and a CUDA graph captured once and replayed twice
    (the pdl form's programmatic edge included), give the same bits."""
    from pygpukit_tpu_torch.kernels.gemv_quant import w4a8_gemv_launch
    g = _gen(dev, rows + 3)
    n, k = 2048, 5632
    w = torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
    sc = torch.rand((n,), generator=g, device=dev) * 1e-3 + 1e-4
    x = (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
    _graph_bitwise(lambda: w4a8_gemv_launch(x, w, sc, pdl))
    assert torch.equal(_bits(w4a8_matmul(x, w, sc)), _bits(w4a8_matmul_plain(x, w, sc)))


def test_gemv_plans_match_their_python_mirrors(dev):
    """The w4a8 GEMV's and the converting GEMV's C plans equal
    gemv_quant.w4a8_gemv_plan and conv_gemv_plan."""
    import ctypes
    from pygpukit_tpu_torch.kernels._build import library
    from pygpukit_tpu_torch.kernels.gemv_quant import conv_gemv_plan, w4a8_gemv_plan
    plan = (ctypes.c_int * 5)()
    for rows in range(1, 9):
        for n, k in PROJ_SHAPES + [(1001, 2048), (40, 96), (64, 65536), (2060, 2052)]:
            if k % 32 == 0:                        # the w4a8 GEMV takes K % 32 == 0
                assert library().pgk_w4a8_gemv_plan(rows, n, k // 2, plan) == 0
                want = w4a8_gemv_plan(rows, n, k // 2)
                assert list(plan)[:3] == [want["tile_n"], want["blocks"], want["warps"]], (
                    rows, n, k)
            assert library().pgk_conv_gemv_plan(rows, n, k, plan) == 0
            want = conv_gemv_plan(rows, n, k)
            assert list(plan) == [want[key] for key in ("tile_n", "tiles", "splits", "cols",
                                                        "klanes")], (rows, n, k)


def test_block_w4a16_plan_matches_its_python_mirror(dev):
    """The block w4a16 GEMV's C plan equals gemv_quant.block_w4a16_plan."""
    import ctypes
    from pygpukit_tpu_torch.kernels._build import library
    from pygpukit_tpu_torch.kernels.gemv_quant import block_w4a16_plan
    plan = (ctypes.c_int * 6)()
    for rows in range(1, 9):
        for n, k in PROJ_SHAPES + [(2060, 2048), (100, 96), (256, 2080), (132, 40), (4, 8),
                                   (64, 65536)]:
            assert library().pgk_block_w4a16_plan(rows, n, k // 2, plan) == 0
            want = block_w4a16_plan(n, k // 2, rows)
            assert list(plan) == [want[key] for key in ("tile_n", "tiles", "splits", "warps",
                                                        "rounds", "smem")], (rows, n, k)


def test_w4a8_plans_match_their_python_mirrors(dev):
    """The C launch plans equal gemv_quant.w4a8_gemm_plan (on this card's
    SMs) and block_w4a8_plan."""
    import ctypes
    from pygpukit_tpu_torch.kernels._build import library
    from pygpukit_tpu_torch.kernels.gemv_quant import block_w4a8_plan, w4a8_gemm_plan
    plan = (ctypes.c_int * 7)()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m in (9, 256, 300, 2048, 8192):
        for n, k_half in ((2560, 1024), (2048, 1024), (11264, 1024), (2048, 2816), (1001, 16),
                          (14336, 2048)):
            assert library().pgk_w4a8_gemm_plan(m, n, k_half, plan) == 0
            want = w4a8_gemm_plan(m, n, k_half, sms)
            assert list(plan) == [want[key] for key in ("tiles_m", "tiles_n", "n_k", "splits",
                                                        "units", "grid")] + [sms], (m, n)
    bplan = (ctypes.c_int * 3)()
    for n, k_half, b in ((2560, 1024, 32), (2048, 2816, 32), (11264, 1024, 32), (4, 1040, 32),
                         (2060, 1024, 64), (100, 48, 32)):
        assert library().pgk_block_w4a8_plan(n, k_half, b, bplan) == 0
        want = block_w4a8_plan(n, k_half, b)
        assert list(bplan) == [want["tile_n"], want["tiles"], want["segments"]], (n, k_half, b)


@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("nk", PROJ_SHAPES)
def test_block_w4a8_gemv_rows_bitwise(dev, nk, rows):
    """The block w4a8 GEMV at rows 1-8 on the four projections: one launch,
    bitwise its plain version, with the activation quantization fused and
    as a separate launch alike."""
    from pygpukit_tpu_torch.kernels.gemv_quant import block_w4a8_launch
    n, k = nk
    g = _gen(dev, rows * 31 + n)
    w = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
    s = (torch.rand((k // 32, n), generator=g, device=dev) * 1e-3 + 1e-4).to(torch.bfloat16)
    x = (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
    ref = block_w4a8_matmul_plain(x, w, s)
    before = LAUNCHES["block_w4a8_gemv"]
    assert torch.equal(_bits(block_w4a8_matmul(x, w, s)), _bits(ref))
    assert LAUNCHES["block_w4a8_gemv"] == before + 1
    for fused in (True, False):
        assert torch.equal(_bits(block_w4a8_launch(x, w, s, fused)), _bits(ref))


@pytest.mark.parametrize("rows", [1, 5])
def test_block_w4a8_gemv_replays_a_graph_bitwise(dev, rows):
    g = _gen(dev, rows)
    n, k = 2048, 2048
    w = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
    s = (torch.rand((k // 32, n), generator=g, device=dev) * 1e-3 + 1e-4).to(torch.bfloat16)
    x = (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
    _graph_bitwise(lambda: block_w4a8_matmul(x, w, s))


def test_w4a8_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    """K off 32 and a misaligned packed weight (the GEMM's TMA needs 16-byte
    rows and base) raise before a launch; an f16 x raises for both kernels."""
    before = dict(LAUNCHES)
    w = torch.zeros((64, 24), dtype=torch.uint8, device=dev)       # K 48
    sc = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="K % 32"):
        w4a8_matmul(torch.zeros((300, 48), dtype=torch.bfloat16, device=dev), w, sc)
    off = torch.zeros(64 * 32 + 1, dtype=torch.uint8, device=dev)[1:].view(64, 32)
    with pytest.raises(ValueError, match="16-byte"):
        w4a8_matmul(torch.zeros((300, 64), dtype=torch.bfloat16, device=dev), off, sc)
    with pytest.raises(TypeError):
        w4a8_matmul(torch.zeros((300, 64), dtype=torch.float16, device=dev),
                    torch.zeros((64, 32), dtype=torch.uint8, device=dev), sc)
    with pytest.raises(TypeError):
        block_w4a8_matmul(torch.zeros((1, 64), dtype=torch.float16, device=dev),
                          torch.zeros((32, 64), dtype=torch.uint8, device=dev),
                          torch.ones((2, 64), dtype=torch.bfloat16, device=dev))
    assert LAUNCHES == before


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
    """Every storage an engine builds launches (below); f16 pools, f16
    queries, two storages at once and f16 rows raise before a launch."""
    pools = torch.zeros((2, 1, 64, 128), dtype=torch.float16, device=dev)
    rows = torch.zeros((2, 2, 64), dtype=torch.bfloat16, device=dev)
    ones = torch.ones(2, dtype=torch.int32, device=dev)
    before = dict(LAUNCHES)
    with pytest.raises(NotImplementedError):
        kv_rows_write(pools, pools.clone(), rows, rows, 0, ones)
    with pytest.raises(NotImplementedError):
        kv_rows_write(pools.bfloat16(), pools.bfloat16(), rows.half(), rows.half(), 0, ones)
    with pytest.raises(NotImplementedError):
        batch_decode_attention(torch.zeros((2, 1, 4, 64), dtype=torch.bfloat16, device=dev),
                               pools, pools, 0, ones)
    with pytest.raises(NotImplementedError):
        batch_decode_attention(torch.zeros((2, 1, 4, 64), dtype=torch.float16, device=dev),
                               pools.bfloat16(), pools.bfloat16(), 0, ones)
    with pytest.raises(NotImplementedError):
        batch_decode_attention(torch.zeros((2, 1, 4, 64), dtype=torch.bfloat16, device=dev),
                               pools.bfloat16(), pools.float(), 0, ones)
    blocks = torch.zeros((4, 2, 16, 64), dtype=torch.float16, device=dev)
    with pytest.raises(NotImplementedError):
        paged_attention(torch.zeros((2, 4, 64), dtype=torch.bfloat16, device=dev), blocks,
                        blocks, torch.zeros((2, 2), dtype=torch.int32, device=dev), ones)
    assert LAUNCHES == before
    w = torch.zeros((64, 16), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="scale"):     # a host scale pointer
        w4a8_matmul(torch.zeros((1, 32), dtype=torch.bfloat16, device=dev), w,
                    torch.ones(64))


# the storages the engines build: (pool storage, query dtype)
STORAGES = {"bf16": (torch.bfloat16, torch.bfloat16), "f32": (torch.float32, torch.float32),
            "e4m3": (torch.float8_e4m3fn, torch.bfloat16),
            "e5m2": (torch.float8_e5m2, torch.bfloat16), "int8": (torch.int8, torch.bfloat16),
            "int8 f32 queries": (torch.int8, torch.float32),
            "bf16 f32 queries": (torch.bfloat16, torch.float32)}


def _store(rows, dtype, n_red):
    """rows (f32) in a pool storage: int8 as the {"q", "s"} dict (amax over
    the last n_red dims), fp8 clamped."""
    from pygpukit_tpu_torch.ops.embedding import kv_quant_rows, to_kv_dtype
    if dtype == torch.int8:
        q, sc = kv_quant_rows(rows, n_red)
        return {"q": q, "s": sc}
    return to_kv_dtype(rows, dtype)


def _pool_bits(pool):
    leaves = [pool["q"], pool["s"]] if isinstance(pool, dict) else [pool]
    return [t.contiguous().view(torch.uint8) for t in leaves]


@pytest.mark.parametrize("new_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("storage", ["bf16", "f32", "e4m3", "e5m2", "int8"])
def test_kv_rows_write_every_storage_bitwise(dev, storage, new_dtype):
    """The row write on each storage, bitwise its plain version: fp8 clamped
    (rows reach 600, past e4m3's 448), int8 quantized per row with its bf16
    scale; positions past MAX clamp."""
    g = _gen(dev, 31)
    b, nl, mx, lanes = 8, 3, 256, 256
    dtype = STORAGES[storage][0]
    base = torch.randn((b, nl, mx, lanes), generator=g, device=dev)
    kn = (torch.randn((b, 4, 64), generator=g, device=dev) * 200).to(new_dtype)
    vn = torch.randn((b, 4, 64), generator=g, device=dev).to(new_dtype)
    kn[2] = 0                                           # an all-zero row: the 1e-8 scale floor
    poss = torch.tensor([0, 5, 100, mx - 1, mx, mx + 37, 64, 2 * mx],
                        dtype=torch.int32, device=dev)
    pools = [_store(base, dtype, 1) for _ in range(4)]
    before = LAUNCHES["kv_rows_write"]
    kv_rows_write(pools[0], pools[1], kn, vn, 1, poss)
    assert LAUNCHES["kv_rows_write"] == before + 1
    kv_rows_write_plain(pools[2], pools[3], kn, vn, 1, poss)
    for got, ref in ((pools[0], pools[2]), (pools[1], pools[3])):
        assert all(torch.equal(a, r) for a, r in zip(_pool_bits(got), _pool_bits(ref)))


KRW_MAX = 1024
# slot positions of the fused row write: before the pool, its first row, a
# row inside the first split, its last row and past it (clamped), and three
# more spread over the splits
KRW_POSS = ((-1, 0, 37, KRW_MAX - 1, KRW_MAX + 3, 500, 64, 200),
            (3, KRW_MAX + 40, 0, -2, 700, 38, KRW_MAX - 1, 129))


def _krw_inputs(dev, storage, seed, b=8, nl=3, mx=KRW_MAX, hk=4, hq=32, d=64):
    """Pools of a storage, new K/V rows and queries in the query dtype
    (the fused write takes rows in it), both position vectors."""
    g = _gen(dev, seed)
    dtype, qdt = STORAGES[storage]
    pools = [_store(torch.randn((b, nl, mx, hk * d), generator=g, device=dev), dtype, 1)
             for _ in range(2)]
    kn = (torch.randn((b, hk, d), generator=g, device=dev) * 200).to(qdt)
    vn = torch.randn((b, hk, d), generator=g, device=dev).to(qdt)
    kn[2] = 0                                           # an all-zero row: the 1e-8 scale floor
    q = torch.randn((b, 1, hq, d), generator=g, device=dev).to(qdt)
    poss = [torch.tensor(v, dtype=torch.int32, device=dev) for v in KRW_POSS]
    return pools, kn, vn, q, poss


def _pool_copy(pool):
    return {k: v.clone() for k, v in pool.items()} if isinstance(pool, dict) else pool.clone()


def _pools_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_pool_bits(a), _pool_bits(b)))


@pytest.mark.parametrize("window", [None, 30])
@pytest.mark.parametrize("storage", list(STORAGES))
def test_kv_write_attention_bitwise(dev, storage, window):
    """The write-plus-attention: the pools bitwise kv_rows_write_plain's,
    the output bitwise kv_rows_write then batch_decode_attention (both
    kernels) on the same inputs, at positions -1, 0, 37, MAX - 1 and MAX + 3
    among others; one attention launch, counted as a fused write too, and
    no launch of the row-write kernel."""
    (kp, vp), kn, vn, q, poss = _krw_inputs(dev, storage, 61)
    for pv in poss:
        lens = pv + 1
        k1, v1, k2, v2, k3, v3 = (_pool_copy(p) for p in (kp, vp) * 3)
        before = dict(LAUNCHES)
        out = kv_write_attention(q, k1, v1, kn, vn, 1, pv, lens, window=window)
        assert LAUNCHES["kv_rows_write"] == before["kv_rows_write"]
        assert LAUNCHES["kv_rows_write_fused"] == before["kv_rows_write_fused"] + 1
        assert LAUNCHES["batch_decode_attention"] == before["batch_decode_attention"] + 1
        kv_rows_write_plain(k2, v2, kn, vn, 1, pv)
        assert _pools_equal(k1, k2) and _pools_equal(v1, v2), pv.tolist()
        kv_rows_write(k3, v3, kn, vn, 1, pv)
        ref = batch_decode_attention(q, k3, v3, 1, lens, window=window)
        assert torch.equal(out, ref), pv.tolist()
        plain = batch_decode_attention_plain(q, k2, v2, 1, lens, 0.125, None, window)
        assert _storage_close(out, plain, STORAGES[storage][1])


@pytest.mark.parametrize("storage", list(STORAGES))
def test_kv_write_attention_replays_at_two_position_vectors(dev, storage):
    """A CUDA graph of one write-plus-attention captured once, replayed with
    the positions changed in place: each replay gives the pools and output
    of kv_rows_write then batch_decode_attention at those positions, bit
    for bit."""
    (kp, vp), kn, vn, q, poss = _krw_inputs(dev, storage, 67)
    pv = poss[0].clone()
    lens = pv + 1
    k1, v1 = _pool_copy(kp), _pool_copy(vp)

    def call():
        return kv_write_attention(q, k1, v1, kn, vn, 2, pv, lens, window=300)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = call()
    for vec in poss:
        k2, v2 = _pool_copy(kp), _pool_copy(vp)
        kv_rows_write(k2, v2, kn, vn, 2, vec)
        want = batch_decode_attention(q, k2, v2, 2, vec + 1, window=300)
        for dst, src in ((k1, kp), (v1, vp)):
            for a, s0 in zip(_pool_bits(dst), _pool_bits(src)):
                a.copy_(s0)
        pv.copy_(vec)
        lens.copy_(vec + 1)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static, want), vec.tolist()
        assert _pools_equal(k1, k2) and _pools_equal(v1, v2), vec.tolist()


def test_kv_write_attention_raises_on_what_the_fused_form_does_not_take(dev):
    (kp, vp), kn, vn, q, poss = _krw_inputs(dev, "bf16", 71)
    with pytest.raises(NotImplementedError, match="dtype"):       # f32 rows, bf16 queries
        kv_write_attention(q, kp, vp, kn.float(), vn.float(), 1, poss[0], poss[0] + 1)
    with pytest.raises(ValueError, match="positions"):
        kv_write_attention(q, kp, vp, kn, vn, 1, poss[0][:4], poss[0] + 1)


def _attn_pools(dev, g, storage, b, nl, mx, lanes):
    dtype, qdt = STORAGES[storage]
    kp = _store(torch.randn((b, nl, mx, lanes), generator=g, device=dev), dtype, 1)
    vp = _store(torch.randn((b, nl, mx, lanes), generator=g, device=dev), dtype, 1)
    return kp, vp, qdt


def _storage_close(out, ref, qdt):
    """bf16 queries: ATTN_TOL (P rounded to bf16 against running maxima); f32:
    within 1e-4 of max |ref| (the same products summed in another order)."""
    if qdt == torch.bfloat16:
        return torch.allclose(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
    return bool(((out - ref).abs() <= 1e-4 * ref.abs().max()).all())


@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, 300)])
@pytest.mark.parametrize("storage", list(STORAGES))
def test_batch_decode_attention_every_storage(dev, storage, softcap, window):
    """The split kernel on each storage against its plain version: contexts
    from 1 to past MAX, and with window 300 starts inside a split; a second
    launch gives the same bits."""
    g = _gen(dev, 41)
    b, nl, mx, lanes, hq, d = 8, 3, 1024, 256, 32, 64
    kp, vp, qdt = _attn_pools(dev, g, storage, b, nl, mx, lanes)
    q = torch.randn((b, 1, hq, d), generator=g, device=dev).to(qdt)
    lens = torch.tensor([1, 513, 1024, 1500, 37, 700, 1025, 256], dtype=torch.int32, device=dev)
    before = LAUNCHES["batch_decode_attention"]
    out = batch_decode_attention(q, kp, vp, 2, lens, softcap=softcap, window=window)
    assert LAUNCHES["batch_decode_attention"] == before + 1
    assert out.dtype == qdt and torch.isfinite(out.float()).all()
    ref = batch_decode_attention_plain(q, kp, vp, 2, lens, 0.125, softcap, window)
    assert _storage_close(out, ref, qdt), (out.float() - ref.float()).abs().max().item()
    assert torch.equal(out, batch_decode_attention(q, kp, vp, 2, lens, softcap=softcap,
                                                   window=window))


@pytest.mark.parametrize("storage", list(STORAGES))
def test_paged_attention_every_storage(dev, storage):
    q, kp, vp, tables, lens = _paged_inputs(dev, 512, 8)
    dtype, qdt = STORAGES[storage]
    # int8 block pools [NB, Hk, BS, D] with [NB, BS] scales: one scale per
    # (block, offset) row over its heads
    kp, vp = (_store(p.float().transpose(1, 2), dtype, 2) for p in (kp, vp))
    kp, vp = ({"q": p["q"].transpose(1, 2).contiguous(), "s": p["s"]} if isinstance(p, dict)
              else p.transpose(1, 2).contiguous() for p in (kp, vp))
    q = q.to(qdt)
    before = LAUNCHES["paged_attention"]
    out = paged_attention(q, kp, vp, tables, lens, scale=0.125, window=100)
    assert LAUNCHES["paged_attention"] == before + 1
    ref = paged_attention_plain(q, kp, vp, tables, lens, 0.125, None, 100)
    # the plain version dequantizes int8 blocks to bf16 (the reference
    # engine's gather); the kernel folds the exact scales into the scores
    tol_dt = torch.bfloat16 if dtype == torch.int8 else qdt
    assert _storage_close(out, ref, tol_dt), (out.float() - ref.float()).abs().max().item()
    assert torch.equal(out, paged_attention(q, kp, vp, tables, lens, scale=0.125, window=100))


def _ladder_inputs(dev, n, k, rows, seed):
    """x [rows, K] bf16 and the four ladder GEMVs' weights at [N, K]: int4
    [N, K/2] + scale, int4_block [K/2, N] + bf16 block scales (B = 32),
    fp8 e4m3fn [K, N] + scale."""
    g = _gen(dev, seed)
    x = (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
    packed = torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
    kmajor = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
    sblock = (torch.rand((k // 32, n), generator=g, device=dev) * 1e-3 + 1e-4
              ).to(torch.bfloat16)
    sc = torch.rand((n,), generator=g, device=dev) * 1e-3 + 1e-4
    fp8 = (torch.randn((k, n), generator=g, device=dev) * 64).to(torch.float8_e4m3fn)
    return x, packed, kmajor, sblock, sc, fp8


def _close(y, ref):
    """Within one bf16 ulp of the plain version, plus 1e-4 of the largest
    |output| for values near zero: both sum the same exact f32 products,
    in another order."""
    tol = ref.float().abs() * 2.0 ** -7 + 1e-4 * ref.float().abs().max()
    return bool(((y.float() - ref.float()).abs() <= tol).all())


@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("nk", PROJ_SHAPES + [(2060, 2048)])
def test_ladder_gemvs_match_plain(dev, nk, rows):
    n, k = nk
    x, packed, kmajor, sblock, sc, fp8 = _ladder_inputs(dev, n, k, rows, rows + n)
    cases = [("block_w4a8_gemv", block_w4a8_matmul, block_w4a8_matmul_plain, (kmajor, sblock)),
             ("block_w4a16_gemv", block_w4a16_matmul, block_w4a16_matmul_plain,
              (kmajor, sblock)),
             ("w4a16_gemv", w4a16_matmul, w4a16_matmul_plain, (packed, sc)),
             ("conv_gemv", conv_matmul, conv_matmul_plain, (fp8, sc))]
    for name, fn, plain, w in cases:
        before = LAUNCHES[name]
        y = fn(x, *w)
        assert LAUNCHES[name] == before + 1
        ref = plain(x, *w)
        if name == "block_w4a8_gemv":
            assert torch.equal(_bits(y), _bits(ref)), name
        else:
            assert _close(y, ref), (name, (y.float() - ref.float()).abs().max().item())


@pytest.mark.parametrize("n", [2560, 2060])
@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("wdt", [torch.float8_e5m2, torch.int8, torch.bfloat16])
def test_conv_gemv_storage_types(dev, wdt, rows, n):
    """Every storage at rows 1-8 (each row bound of the kernel), at N 2560
    and at a ragged N (a multiple of 4 off the 128-column tile and off the
    16-byte load: the 4-column loads)."""
    g = _gen(dev, 11 + rows)
    x = torch.randn((rows, 2048), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((2048, n), generator=g, device=dev) * 20).clamp(-127, 127)
    w = w.round().to(wdt) if wdt == torch.int8 else w.to(wdt)
    sc = torch.rand((n,), generator=g, device=dev) * 1e-2
    assert _close(conv_matmul(x, w, sc), conv_matmul_plain(x, w, sc))


@pytest.mark.parametrize("rows,n,k", [(1, 2048, 2052), (8, 2048, 2052), (1, 11264, 2048),
                                      (5, 100, 5632), (1, 4, 4)])
@pytest.mark.parametrize("wdt", [torch.float8_e4m3fn, torch.int8])
def test_conv_gemv_replays_a_graph_bitwise(dev, wdt, rows, n, k):
    """K split across a cluster's blocks (K 2052: not a multiple of the
    splits; N 100: two tiles, 8 splits) and unsplit shapes: two launches
    and a graph replayed twice give the same bits (the fold's order is
    fixed), within the tolerance of the plain version."""
    g = _gen(dev, rows * 3 + n)
    x = torch.randn((rows, k), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=g, device=dev) * 20).clamp(-127, 127)
    w = w.round().to(wdt) if wdt == torch.int8 else w.to(wdt)
    sc = torch.rand((n,), generator=g, device=dev) * 1e-2
    _graph_bitwise(lambda: conv_matmul(x, w, sc))
    assert _close(conv_matmul(x, w, sc), conv_matmul_plain(x, w, sc))


@pytest.mark.parametrize("k", [96, 2080])
def test_block_gemvs_straddling_block(dev, k):
    """B = 32 does not divide K/2 (48, 1040): one block straddles the
    halves; the kernels index each k's block as k // B like the plain
    versions."""
    g = _gen(dev, k)
    n = 256
    x = torch.randn((5, k), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
    s = (torch.rand((k // 32, n), generator=g, device=dev) + 0.5).to(torch.bfloat16)
    assert torch.equal(_bits(block_w4a8_matmul(x, w, s)),
                       _bits(block_w4a8_matmul_plain(x, w, s)))
    assert _close(block_w4a16_matmul(x, w, s), block_w4a16_matmul_plain(x, w, s))


@pytest.mark.parametrize("rows", [1, 2, 5, 8])
@pytest.mark.parametrize("n,k,b", [(2048, 2048, 32), (11264, 2048, 32), (2048, 5632, 32),
                                   (2060, 2048, 32), (100, 96, 32), (132, 40, 8), (4, 8, 8)])
def test_block_w4a16_gemv_replays_a_graph_bitwise(dev, rows, n, k, b):
    """Two launches and a graph replayed twice give the same bits (the
    warps and the cluster's splits fold in a fixed order), within the
    tolerance of the plain version: the projections (64- and 128-column
    tiles, K split 2-8 ways), a ragged N (4-byte loads), K/2 % 8 == 4 (a
    lane's high rows straddle a scale block at B 8) and the smallest N."""
    g = _gen(dev, rows * 5 + n + k)
    x = torch.randn((rows, k), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
    s = (torch.rand((k // b, n), generator=g, device=dev) + 0.5).to(torch.bfloat16)
    _graph_bitwise(lambda: block_w4a16_matmul(x, w, s))
    assert _close(block_w4a16_matmul(x, w, s), block_w4a16_matmul_plain(x, w, s))


@pytest.mark.parametrize("rows", [1, 2, 5, 8])
@pytest.mark.parametrize("n,k", PROJ_SHAPES + [(1001, 2048), (37, 64), (16, 5632), (3, 96)])
def test_w4a16_gemv_replays_a_graph_bitwise(dev, rows, n, k):
    """Two launches and a graph replayed twice give the same bits (the
    warps fold in a fixed order), within one bf16 ulp plus 1e-4 of max |y|
    of the plain version: the projections (4, 8 and 16 warps a block), a
    ragged N and the smallest K."""
    g = _gen(dev, rows * 7 + n + k)
    x = (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
    w = torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
    sc = torch.rand((n,), generator=g, device=dev) * 1e-3 + 1e-4
    before = LAUNCHES["w4a16_gemv"]
    _graph_bitwise(lambda: w4a16_matmul(x, w, sc))
    assert LAUNCHES["w4a16_gemv"] > before
    assert _close(w4a16_matmul(x, w, sc), w4a16_matmul_plain(x, w, sc))


def test_w4a16_gemv_takes_a_misaligned_x_and_a_stacked_layer(dev):
    """x off 16 bytes (a view one element in) is copied to an aligned row
    first; a layer of a stacked [L, N, K/2] weight is a free view. The
    results are the aligned, standalone calls'."""
    g = _gen(dev, 79)
    flat = torch.randn((2 * 2048 + 1,), generator=g, device=dev).to(torch.bfloat16)
    x = flat[1:].view(2, 2048)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = torch.randint(0, 256, (3, 2560, 1024), generator=g, device=dev, dtype=torch.uint8)
    sc = torch.rand((3, 2560), generator=g, device=dev) + 0.5
    assert torch.equal(_bits(w4a16_matmul(x, w[1], sc[1])),
                       _bits(w4a16_matmul(x.contiguous().clone(), w[1].clone(),
                                          sc[1].clone())))


def test_w4a16_plan_matches_its_python_mirror(dev):
    """The w4a16 GEMV's C plan equals gemv_quant.w4a16_plan, with at least
    128 blocks at the four projections."""
    import ctypes
    from pygpukit_tpu_torch.kernels._build import library
    from pygpukit_tpu_torch.kernels.gemv_quant import w4a16_plan
    plan = (ctypes.c_int * 4)()
    for rows in range(1, 9):
        for n, k in PROJ_SHAPES + [(1001, 2048), (37, 64), (16, 5632), (5, 65536)]:
            assert library().pgk_w4a16_plan(rows, n, k // 2, plan) == 0
            want = w4a16_plan(n, k // 2, rows)
            assert list(plan) == [want[key] for key in ("tile_n", "blocks", "warps",
                                                        "batch")], (rows, n, k)
            if (n, k) in PROJ_SHAPES:
                assert want["blocks"] >= 128


def test_block_w4a16_gemv_takes_a_misaligned_x(dev):
    """x off 16 bytes (a view one element in) is copied to an aligned row
    first; the result is the aligned call's."""
    g = _gen(dev, 77)
    flat = torch.randn((2 * 2048 + 1,), generator=g, device=dev).to(torch.bfloat16)
    x = flat[1:].view(2, 2048)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = torch.randint(0, 256, (1024, 2048), generator=g, device=dev, dtype=torch.uint8)
    s = (torch.rand((64, 2048), generator=g, device=dev) + 0.5).to(torch.bfloat16)
    assert torch.equal(_bits(block_w4a16_matmul(x, w, s)),
                       _bits(block_w4a16_matmul(x.contiguous(), w, s)))


def test_ladder_wrappers_raise_on_unsupported_storage(dev):
    x = torch.zeros((1, 64), dtype=torch.bfloat16, device=dev)
    kmajor = torch.zeros((32, 64), dtype=torch.uint8, device=dev)
    sblock = torch.ones((2, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="rows"):
        block_w4a8_matmul(torch.zeros((9, 64), device=dev), kmajor, sblock)
    with pytest.raises(TypeError):                      # f32 block scales
        block_w4a16_matmul(x, kmajor, sblock.float())
    with pytest.raises(TypeError):                      # a non-contiguous weight
        block_w4a8_matmul(x, torch.zeros((64, 32), dtype=torch.uint8,
                                         device=dev).t(), sblock)
    with pytest.raises(ValueError, match="B % 8"):      # B = 4
        block_w4a16_matmul(x, kmajor, torch.ones((16, 64), dtype=torch.bfloat16,
                                                 device=dev))
    with pytest.raises(ValueError, match="scale"):      # a host scale pointer
        w4a16_matmul(x, torch.zeros((64, 32), dtype=torch.uint8, device=dev),
                     torch.ones(64))
    with pytest.raises(TypeError):                      # f32 weights
        conv_matmul(x, torch.zeros((64, 64), device=dev), torch.ones(64, device=dev))
    with pytest.raises(ValueError, match="N % 4"):
        conv_matmul(x, torch.zeros((64, 30), dtype=torch.int8, device=dev),
                    torch.ones(30, device=dev))


def test_model_routes_launch_the_ladder_kernels(dev, monkeypatch):
    """_mm on CUDA leaves: each leaf kind and switch launches its kernel
    at rows <= 8 (the head takes the plain convert)."""
    from pygpukit_tpu_torch.llm import model as port_model
    from pygpukit_tpu_torch.llm import quantize_weight
    w = torch.randn((2048, 256), device=dev) * 0.02
    x = torch.randn((1, 2048), device=dev).to(torch.bfloat16)
    for mode, env, name in (("int4", ("PYGPUKIT_INT4_MODE", "w4a16"), "w4a16_gemv"),
                            ("int4_block", ("PYGPUKIT_INT4_BLOCK", "w4a8"),
                             "block_w4a8_gemv"),
                            ("int4_block", ("PYGPUKIT_INT4_BLOCK", "w4a16"),
                             "block_w4a16_gemv"),
                            ("fp8", ("PYGPUKIT_INT8_MODE", "w8a8"), "conv_gemv"),
                            ("int8", ("PYGPUKIT_INT8_MODE", "w8a16"), "conv_gemv")):
        monkeypatch.setenv(*env)
        leaf = quantize_weight(w, mode)
        before = dict(LAUNCHES)
        assert port_model._mm(x, leaf).dtype == torch.bfloat16
        assert LAUNCHES[name] == before[name] + 1, (mode, env)
        assert port_model._mm(x, leaf, torch.float32).dtype == torch.float32
        assert LAUNCHES[name] == before[name] + 1, (mode, env, "head")


def _attn_close(out, ref):
    """bf16: atol/rtol 1e-2 (both round P to bf16, the kernel against a
    running maximum); f32: 1e-4 of max |out| (the same products summed in
    another order)."""
    if ref.dtype == torch.bfloat16:
        return torch.allclose(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
    return bool(((out - ref).abs() <= 1e-4 * ref.abs().max()).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,hq,hk,d", [(1, 4, 2, 64), (65, 4, 2, 64), (300, 8, 2, 128),
                                       (257, 32, 4, 64)])
def test_flash_attention_matches_plain(dev, s, hq, hk, d, causal, dtype):
    g = _gen(dev, s + d)
    q = torch.randn((s, hq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((s, hk, d), generator=g, device=dev).to(dtype)
    v = torch.randn((s, hk, d), generator=g, device=dev).to(dtype)
    before = LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, causal=causal)
    assert LAUNCHES["flash_attention"] == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref = flash_attention_plain(q, k, v, causal=causal)
    assert torch.isfinite(out.float()).all() and _attn_close(out, ref)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal))   # replay


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ctx", [0, 1, 100, 700, 5000])
def test_flash_decode_matches_plain(dev, ctx, dtype):
    g = _gen(dev, ctx)
    q = torch.randn((1, 32, 64), generator=g, device=dev).to(dtype)
    kc = torch.randn((700, 4, 64), generator=g, device=dev).to(dtype)
    vc = torch.randn((700, 4, 64), generator=g, device=dev).to(dtype)
    before = LAUNCHES["flash_decode"]
    out = flash_decode(q, kc, vc, ctx)                   # 5000 > MAX: every row
    assert LAUNCHES["flash_decode"] == before + 1
    assert _attn_close(out, flash_decode_plain(q, kc, vc, ctx))
    assert torch.equal(out, flash_decode(q, kc, vc, ctx))
    ctx_t = torch.tensor([ctx], dtype=torch.int32, device=dev)
    assert torch.equal(out, flash_decode(q, kc, vc, ctx_t))   # read on the card


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_empty_cache_is_zero(dev, dtype):
    """A cache of no rows gives zeros, in one launch, at any ctx_len."""
    q = torch.ones((1, 8, 64), dtype=dtype, device=dev)
    kc = torch.zeros((0, 2, 64), dtype=dtype, device=dev)
    before = LAUNCHES["flash_decode"]
    for ctx in (0, 5):
        assert torch.equal(flash_decode(q, kc, kc, ctx), torch.zeros_like(q))
    assert LAUNCHES["flash_decode"] == before + 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ctx", [1, 333])
@pytest.mark.parametrize("hq,hk,d", [(32, 1, 64), (32, 1, 128), (64, 2, 128), (8, 8, 128),
                                     (32, 8, 128), (48, 4, 64)])
def test_flash_decode_heads_and_dims(dev, hq, hk, d, ctx, dtype):
    """G up to 32 query heads per kv head (the CUDA-core body: a block of
    1024 threads), G 12 (both row halves of the tensor-core tile), G 4 at D
    128 (Mixtral's shape) and G 1."""
    g = _gen(dev, hq + hk + d + ctx)
    q = torch.randn((1, hq, d), generator=g, device=dev).to(dtype)
    kc = torch.randn((400, hk, d), generator=g, device=dev).to(dtype)
    vc = torch.randn((400, hk, d), generator=g, device=dev).to(dtype)
    out = flash_decode(q, kc, vc, ctx)
    assert out.shape == q.shape and out.dtype == dtype
    assert _attn_close(out, flash_decode_plain(q, kc, vc, ctx))
    assert torch.equal(out, flash_decode(q, kc, vc, ctx))


@pytest.mark.parametrize("hq,hk,d,dtype,max_len", [
    (32, 4, 64, torch.bfloat16, 512), (32, 1, 128, torch.bfloat16, 700),
    (32, 1, 64, torch.float32, 700), (8, 2, 128, torch.float32, 300)])
def test_flash_decode_graph_replays_device_context(dev, hq, hk, d, dtype, max_len):
    """One launch captured once with ctx_len on the card; ctx.fill_(v) and a
    replay give the eager call's bits at every v (past MAX and below 0
    included), and the arrival counters it leaves at zero serve the next
    replay."""
    g = _gen(dev, hq * d + max_len)
    q = torch.randn((1, hq, d), generator=g, device=dev).to(dtype)
    kc = torch.randn((max_len, hk, d), generator=g, device=dev).to(dtype)
    vc = torch.randn((max_len, hk, d), generator=g, device=dev).to(dtype)
    ctx = torch.zeros(1, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_decode(q, kc, vc, ctx)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = LAUNCHES["flash_decode"]
    with torch.cuda.graph(graph):
        out = flash_decode(q, kc, vc, ctx)
    assert LAUNCHES["flash_decode"] == before + 1
    for v in (0, 1, 143, max_len, max_len + 7, -3, 143):
        ctx.fill_(v)
        graph.replay()
        eager = flash_decode(q, kc, vc, v)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), v
        assert _attn_close(eager, flash_decode_plain(q, kc, vc, v))


def test_flash_decode_takes_only_an_int32_device_context(dev):
    """A CUDA ctx_len is one int32 element, read by the kernel; another
    dtype or more elements raise rather than cast on the card. A CPU tensor
    is a value."""
    q = torch.ones((1, 8, 64), dtype=torch.bfloat16, device=dev)
    kc = torch.ones((64, 2, 64), dtype=torch.bfloat16, device=dev)
    for bad in (torch.tensor([5], device=dev), torch.tensor([5, 6], dtype=torch.int32,
                                                            device=dev),
                torch.tensor(5, dtype=torch.bool, device=dev)):
        with pytest.raises(ValueError):
            flash_decode(q, kc, kc, bad)
    want = flash_decode(q, kc, kc, 5)
    assert torch.equal(flash_decode(q, kc, kc, torch.tensor(5)), want)
    assert torch.equal(flash_decode(q, kc, kc, torch.tensor(5, dtype=torch.int32,
                                                            device=dev)), want)


def test_flash_attention_fn_routes_on_the_card(dev):
    """The kernel for the default scale (the config's head_dim ** -0.5 at D
    128 included); softcap, window and another scale on the plain route."""
    g = _gen(dev, 9)
    q = torch.randn((70, 8, 128), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((70, 2, 128), generator=g, device=dev).to(torch.bfloat16)
    before = LAUNCHES["flash_attention"]
    flash_attention_fn(q, k, k, scale=128 ** -0.5)
    assert LAUNCHES["flash_attention"] == before + 1
    for kw in (dict(softcap=30.0), dict(window=16), dict(scale=0.1)):
        flash_attention_fn(q, k, k, **kw)
    assert LAUNCHES["flash_attention"] == before + 1


def test_flash_wrappers_raise_on_unsupported_operands(dev):
    q = torch.zeros((8, 4, 64), dtype=torch.float16, device=dev)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q[:, :2], q[:, :2])
    q = torch.zeros((8, 4, 112), dtype=torch.bfloat16, device=dev)    # a D no kernel takes
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :2], q[:, :2])
    q = torch.zeros((1, 4, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        flash_decode(q, torch.zeros((8, 2, 64), dtype=torch.bfloat16), q, 4)


def test_forward_launches_flash_attention_per_layer(dev):
    from pygpukit_tpu_torch.llm import (CausalTransformerModel, TransformerConfig,
                                        fuse_params, init_params)
    cfg = TransformerConfig(vocab_size=256, hidden_size=256, num_layers=3, num_heads=4,
                            num_kv_heads=2, intermediate_size=512,
                            max_position_embeddings=512, tie_word_embeddings=False)
    m = CausalTransformerModel(cfg, fuse_params(init_params(cfg, 0, torch.bfloat16, dev)))
    before = dict(LAUNCHES)
    logits = m.get_logits(list(range(1, 200)))
    assert logits.shape == (199, 256)
    assert LAUNCHES["flash_attention"] == before["flash_attention"] + 3
    assert all(LAUNCHES[n] == before[n] for n in LAUNCHES if n != "flash_attention")


def _bf16_close(y, ref) -> bool:
    """Within one bf16 ulp of |ref| plus 1e-4 of max |ref| (f32 sums in
    another order, rounded once)."""
    r = ref.float()
    return bool(((y.float() - r).abs() <= r.abs() * 2.0 ** -7 + 1e-4 * r.abs().max()).all())


@pytest.mark.parametrize("dtypes", [("bf16", "bf16"), ("f32", "f32"), ("bf16", "f32")])
@pytest.mark.parametrize("mnk", [(64, 128, 128), (65, 130, 136), (300, 260, 384),
                                 (2048, 2560, 2048), (129, 136, 131), (200, 384, 200),
                                 (2048, 2048, 5632), (300, 2560, 520)])
def test_gemm_matches_plain(dev, mnk, dtypes):
    """Ragged edges (M 65, N 130, K 136; K 131 padded for bf16; K 200 and 520
    off the 64-deep stage), N between the tile widths (384) and on the
    128-wide plan (2560), and mixed bf16/f32 operands (an f32 product);
    replay bitwise."""
    m, n, k = mnk
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    g = _gen(dev, m + n + k)
    a = torch.randn((m, k), generator=g, device=dev).to(dt[dtypes[0]])
    b = torch.randn((k, n), generator=g, device=dev).to(dt[dtypes[1]])
    before = LAUNCHES["gemm"]
    y = gemm(a, b, force="pallas")
    assert LAUNCHES["gemm"] == before + 1
    want = torch.promote_types(a.dtype, b.dtype)
    assert y.dtype == want and y.shape == (m, n)
    ref = gemm_plain(a, b, want)
    if want == torch.bfloat16:
        assert _bf16_close(y, ref)
    else:
        assert ((y - ref).abs() <= 1e-4 * ref.abs().max()).all()
    assert torch.equal(y, gemm(a, b, force="pallas"))
    yt = gemm(a, b.t().contiguous().t(), force="pallas")     # a strided B
    assert torch.equal(yt, y)


@pytest.mark.parametrize("m", [1, 7, 63])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gemm_kernel_small_m_and_a_column_slice(dev, m, out_dtype):
    """M below the route's 64 through the kernel entry, and an A whose rows
    are longer than K (a column slice, lda 264 > K 200): TMA reads the
    slice in place."""
    from pygpukit_tpu_torch.kernels.gemm import _gemm_kernel
    g = _gen(dev, m)
    wide = torch.randn((m, 264), generator=g, device=dev).to(torch.bfloat16)
    a = wide[:, 8:208]
    b = torch.randn((200, 384), generator=g, device=dev).to(torch.bfloat16)
    assert a.stride(0) == 264
    before = LAUNCHES["gemm"]
    y = _gemm_kernel(a, b, out_dtype)
    assert LAUNCHES["gemm"] == before + 1
    ref = gemm_plain(a, b, out_dtype)
    if out_dtype == torch.bfloat16:
        assert _bf16_close(y, ref)
    else:
        assert ((y - ref).abs() <= 1e-4 * ref.abs().max()).all()
    assert torch.equal(y, _gemm_kernel(a, b, out_dtype))
    assert torch.equal(y, _gemm_kernel(a.contiguous(), b, out_dtype))


def test_gemm_plan_matches_its_python_mirror(dev):
    """The C launch plan (tile width, persistent grid) equals gemm_plan on
    the clusters this card runs at once."""
    import ctypes
    from pygpukit_tpu_torch.kernels._build import library
    from pygpukit_tpu_torch.kernels.gemm import gemm_plan
    plan = (ctypes.c_int * 4)()
    for m in (1, 64, 300, 2048, 8192):
        for n in (128, 130, 384, 2048, 2560, 11264, 8192):
            assert library().pgk_gemm_plan(m, n, plan) == 0
            want = gemm_plan(m, n, {256: plan[2], 128: plan[3]})
            assert (plan[0], plan[1]) == (want["bn"], want["grid"]), (m, n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert 1 <= plan[2] <= sms // 2 and 1 <= plan[3] <= sms // 4


def test_matmul_counts_gemm_only_under_the_switch(dev, monkeypatch):
    import pygpukit_tpu_torch as gp
    a = gp.randn(128, 256, dtype="bf16", seed=1)
    b = gp.randn(256, 128, dtype="bf16", seed=2)
    assert a.device == dev
    monkeypatch.delenv("PYGPUKIT_GEMM", raising=False)
    before = LAUNCHES["gemm"]
    c1 = gp.matmul(a, b)
    assert LAUNCHES["gemm"] == before
    monkeypatch.setenv("PYGPUKIT_GEMM", "pallas")
    c2 = a @ b
    assert LAUNCHES["gemm"] == before + 1
    gp.matmul(gp.randn(63, 256, dtype="bf16"), b)            # below the size rule
    assert LAUNCHES["gemm"] == before + 1
    assert _bf16_close(c2.torch, c1.torch)


def test_gemm_raises_on_unsupported_dtypes(dev):
    a = torch.zeros((64, 128), dtype=torch.float16, device=dev)
    b = torch.zeros((128, 128), dtype=torch.float16, device=dev)
    with pytest.raises(NotImplementedError):
        gemm(a, b, force="pallas")
    with pytest.raises(NotImplementedError):
        gemm(a.to(torch.int32), b.to(torch.int32), force="pallas")
    with pytest.raises(NotImplementedError):
        gemm(a.bfloat16(), b.bfloat16(), out_dtype=torch.float16, force="pallas")
    with pytest.raises(ValueError):
        gemm(a, a, force="pallas")


@pytest.mark.parametrize("storage", [torch.float8_e4m3fn, torch.float8_e5m2, torch.int8,
                                     torch.bfloat16])
@pytest.mark.parametrize("nk", PROJ_SHAPES + [(256, 200), (37, 13), (130, 2051), (1, 116224),
                                (7, 116224), (7, 2048), (1, 24)])
def test_gemv_quant_matches_plain(dev, nk, storage):
    """Every storage, x in bf16 and f32, with and without a scale: N 1 and 7
    (an odd last warp), K 116224, rows off whole 16-byte vectors (K 13,
    2051 and a column slice), a weight base and an x off 16 bytes, on the
    head-and-tail path; a second launch bitwise."""
    n, k = nk
    g = _gen(dev, n + k)
    if storage == torch.int8:
        w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    else:
        w = (torch.randn((n, k), generator=g, device=dev) * 4).to(storage)
    sc = torch.rand((n,), generator=g, device=dev) + 0.5
    for x in (torch.randn((k,), generator=g, device=dev).to(torch.bfloat16),
              torch.randn((k,), generator=g, device=dev)):
        for s in (sc, None):
            before = LAUNCHES["gemv_quant"]
            y = gemv_quant(w, x, s)
            assert LAUNCHES["gemv_quant"] == before + 1
            assert y.dtype == torch.bfloat16 and y.shape == (n,)
            assert _bf16_close(y, gemv_quant_plain(w, x, s))
            assert torch.equal(y, gemv_quant(w, x, s))
    def off(t):                                    # the same values one element off
        flat = t.reshape(-1)
        return torch.cat([flat[:1], flat])[1:]
    xb = x.to(torch.bfloat16)
    for wq, xq in ((w[:, 1:], xb[1:]), (w[:, 1:], x[1:]), (off(w).view(n, k), off(x)),
                   (w, off(xb))):
        y = gemv_quant(wq, xq, sc)
        assert _bf16_close(y, gemv_quant_plain(wq, xq, sc))
        assert torch.equal(y, gemv_quant(wq, xq, sc))


def test_gemv_quant_plan_matches_its_python_mirror(dev):
    """The kernel's warps a block and vectors in flight a lane are the
    Python mirror's GEMV_WARPS and GEMV_BATCH."""
    import ctypes
    from pygpukit_tpu_torch.kernels._build import library
    from pygpukit_tpu_torch.kernels.gemv_quant import GEMV_BATCH, GEMV_WARPS
    plan = (ctypes.c_int * 2)()
    assert library().pgk_gemv_quant_plan(plan) == 0
    assert (plan[0], plan[1]) == (GEMV_WARPS, GEMV_BATCH)


def test_gemv_quant_raises_on_unsupported_dtypes(dev):
    x = torch.zeros((64,), dtype=torch.bfloat16, device=dev)
    with pytest.raises(NotImplementedError):
        gemv_quant(torch.zeros((8, 64), dtype=torch.float16, device=dev), x)
    with pytest.raises(NotImplementedError):
        gemv_quant(torch.zeros((8, 64), dtype=torch.int8, device=dev), x.to(torch.float16))
    with pytest.raises(ValueError):
        gemv_quant(torch.zeros((8, 64), dtype=torch.int8, device=dev), x[:32])


@pytest.mark.parametrize("mkn", [(100, 64, 40), (1, 2048, 2560), (8192, 64, 136)])
def test_matmul_int8_on_the_card_is_exact(dev, mkn):
    """torch._int_mm with padded M, K and N gives the CPU's int32 product."""
    import pygpukit_tpu_torch as gp
    m, k, n = mkn
    g = _gen(dev, m + k + n)
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    bq = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    sa = torch.rand((m, 1), generator=g, device=dev)
    sb = torch.rand((1, n), generator=g, device=dev)
    y = gp.matmul_int8(gp.Array(aq), gp.Array(bq), gp.Array(sa), gp.Array(sb))
    ref = gp.matmul_int8(*(gp.Array(t.cpu()) for t in (aq, bq, sa, sb)))
    assert torch.equal(y.torch.cpu(), ref.torch)


# -- the single-stream decode: fused_decode, and flash_decode on its route --

CFG_1B = dict(vocab_size=32000, hidden_size=2048, num_layers=22, num_heads=32,
              num_kv_heads=4, intermediate_size=5632, max_position_embeddings=4096,
              tie_word_embeddings=False)


# the fused step against its plain version at 22 layers, relative L2: every
# bf16 rounding of the residual stream that summation order flips moves the
# next layer's input, so two orders drift apart with depth; chip_smoke.py
# phase 3 prints the plain version's own drift (on the card against on the
# CPU) beside the kernel's. A wrong layout, offset or mask gives order 1.
FUSED_DEEP_TOL = 5e-2


@pytest.fixture(scope="module")
def fused_1b():
    """The 1.1B shape's bf16 leaves (seed 0) with the consolidated q|k|v and
    gate|up leaves, as the fused step takes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from pygpukit_tpu_torch.llm import (TransformerConfig, init_params,
                                        prepare_fused_decode_params)
    from pygpukit_tpu_torch.ops.nn import rope_tables
    cfg = TransformerConfig(**CFG_1B)
    dev = torch.device("cuda", 0)
    params = init_params(cfg, 0, torch.bfloat16, dev)
    params["rope_cos"], params["rope_sin"] = rope_tables(
        cfg.max_position_embeddings, cfg.head_dim, cfg.rope_theta, device=dev)
    return cfg, prepare_fused_decode_params(cfg, params)


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("n_layers,pos,max_len", [(2, 1, 512), (2, 143, 512), (2, 511, 512),
                                                  (22, 1, 512), (22, 143, 512),
                                                  (22, 511, 512), (22, 3000, 4096)])
def test_fused_decode_matches_plain(dev, fused_1b, n_layers, pos, max_len):
    """Against the plain fused step (the same roundings, sums in another
    order, the softmax as an online recurrence over context chunks):
    relative L2 of h_out, k_new and v_new within 1e-2 at 2 layers and
    within FUSED_DEEP_TOL at 22; a second launch gives the same bits. MAX
    4096 is past the reference kernel's VMEM gate."""
    from pygpukit_tpu_torch.kernels import fused_decode, fused_decode_plain
    cfg, params = fused_1b
    lp = {k: v[:n_layers] for k, v in params["layers"].items()}
    g = _gen(dev, pos)
    kvd = cfg.num_kv_heads * cfg.head_dim
    kc = (torch.randn((n_layers, max_len, kvd), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    vc = torch.randn((n_layers, max_len, kvd), generator=g, device=dev).to(torch.bfloat16)
    h0 = params["embed"][7:8].to(torch.bfloat16)
    cos = params["rope_cos"][pos:pos + 1].float()
    sin = params["rope_sin"][pos:pos + 1].float()
    pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
    args = (h0, cos, sin, pos_t, lp["w_qkv_cat"], lp["w_o"], lp["w_gu_cat"], lp["w_down"],
            lp["attn_norm_w"].float(), lp["mlp_norm_w"].float(),
            params["final_norm_w"].float().reshape(1, -1), kc, vc)
    heads = dict(n_heads=cfg.num_heads, n_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                 eps=cfg.norm_eps)
    before = LAUNCHES["fused_decode"]
    got = fused_decode(*args, **heads)
    assert LAUNCHES["fused_decode"] == before + 1
    ref = fused_decode_plain(*args, **heads)
    for name, a, b in zip(("h_out", "k_new", "v_new"), got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        tol = 1e-2 if n_layers <= 2 else FUSED_DEEP_TOL
        assert torch.isfinite(a.float()).all() and _rel_l2(a, b) <= tol, (name, _rel_l2(a, b))
    again = fused_decode(*args, **heads)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _fused_args(dev, cfg, params, n_layers, pos, max_len):
    lp = {k: v[:n_layers] for k, v in params["layers"].items()}
    g = _gen(dev, 1000 + max_len)
    kvd = cfg.num_kv_heads * cfg.head_dim
    kc = (torch.randn((n_layers, max_len, kvd), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    vc = torch.randn((n_layers, max_len, kvd), generator=g, device=dev).to(torch.bfloat16)
    cos = params["rope_cos"][pos:pos + 1].float().clone()      # written by the caller
    sin = params["rope_sin"][pos:pos + 1].float().clone()
    pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
    return [params["embed"][7:8].to(torch.bfloat16), cos, sin, pos_t, lp["w_qkv_cat"],
            lp["w_o"], lp["w_gu_cat"], lp["w_down"], lp["attn_norm_w"].float(),
            lp["mlp_norm_w"].float(), params["final_norm_w"].float().reshape(1, -1), kc, vc]


@pytest.mark.parametrize("n_layers", [2, 22])
def test_fused_decode_graph_replays_two_positions(dev, fused_1b, n_layers):
    """A step captured once (pos, the rope row and the caches in device
    memory) and replayed at two positions gives the bits of the eager call
    at each: the kernel reads pos on the card, and its schedule, weight
    ring and barrier counter start over every launch."""
    from pygpukit_tpu_torch.kernels import fused_decode
    cfg, params = fused_1b
    heads = dict(n_heads=cfg.num_heads, n_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                 eps=cfg.norm_eps)
    args = _fused_args(dev, cfg, params, n_layers, 143, 512)
    cos, sin, pos_t = args[1], args[2], args[3]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_decode(*args, **heads)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_decode(*args, **heads)
    for pos in (143, 37, 511, 143):
        pos_t.fill_(pos)
        cos.copy_(params["rope_cos"][pos:pos + 1])
        sin.copy_(params["rope_sin"][pos:pos + 1])
        graph.replay()
        eager = fused_decode(*args, **heads)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, eager)), pos


def test_fused_decode_plan_matches_its_python_mirror(dev):
    """pgk_fused_decode_plan equals fused_decode.fused_plan on this card's
    SMs (the 1.1B shape at three cache lengths, a small model, Mixtral-like
    heads)."""
    from pygpukit_tpu_torch.kernels.fused_decode import PLAN_FIELDS, fused_plan, plan_of
    props = torch.cuda.get_device_properties(dev)
    for dims in ((22, 2048, 5632, 32, 4, 64, 512), (22, 2048, 5632, 32, 4, 64, 4096),
                 (1, 2048, 5632, 32, 4, 64, 64), (2, 256, 512, 4, 2, 64, 100),
                 (4, 4096, 14336, 32, 8, 128, 1024)):
        keys = ("n_layers", "hidden", "intermediate", "n_heads", "n_kv_heads", "head_dim",
                "max_seq")
        got = plan_of(dev, **dict(zip(keys, dims)))
        want = fused_plan(*dims, sms=props.multi_processor_count)
        assert [got[f] for f in PLAN_FIELDS] == [want[f] for f in PLAN_FIELDS], dims


def test_fused_decode_raises_on_bad_operands(dev, fused_1b):
    from pygpukit_tpu_torch.kernels import fused_decode
    cfg, params = fused_1b
    lp = {k: v[:1] for k, v in params["layers"].items()}
    kc = torch.zeros((1, 64, 256), dtype=torch.bfloat16, device=dev)
    args = [params["embed"][:1], params["rope_cos"][:1].float(), params["rope_sin"][:1].float(),
            torch.zeros(1, dtype=torch.int32, device=dev), lp["w_qkv_cat"], lp["w_o"],
            lp["w_gu_cat"], lp["w_down"], lp["attn_norm_w"].float(), lp["mlp_norm_w"].float(),
            params["final_norm_w"].float().reshape(1, -1), kc, kc]
    heads = dict(n_heads=32, n_kv_heads=4, head_dim=64)
    bad = list(args)
    bad[3] = torch.zeros(1, dtype=torch.int32)                       # a host pos
    with pytest.raises(ValueError, match="pos"):
        fused_decode(*bad, **heads)
    bad = list(args)
    bad[11] = kc.float()
    with pytest.raises(ValueError, match="k_cache"):
        fused_decode(*bad, **heads)


def test_sdpa_fixed_cache_route_launches_flash_decode(dev):
    """One bf16 query row launches flash_decode; a lookahead window, an int8
    cache and a softcap take the plain route."""
    from pygpukit_tpu_torch.ops.embedding import kv_quant_rows
    from pygpukit_tpu_torch.ops.nn import sdpa_fixed_cache_fn
    g = _gen(dev, 21)
    kc = torch.randn((512, 4, 64), generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn((512, 4, 64), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((2, 32, 64), generator=g, device=dev).to(torch.bfloat16)
    before = LAUNCHES["flash_decode"]
    out = sdpa_fixed_cache_fn(q[:1], kc, vc, 144)
    assert LAUNCHES["flash_decode"] == before + 1
    assert _attn_close(out, flash_decode_plain(q[:1], kc, vc, 144))
    kq, ks = kv_quant_rows(kc, 2)
    vq, vs = kv_quant_rows(vc, 2)
    sdpa_fixed_cache_fn(q, kc, vc, 144)
    sdpa_fixed_cache_fn(q[:1], {"q": kq, "s": ks}, {"q": vq, "s": vs}, 144)
    sdpa_fixed_cache_fn(q[:1], kc, vc, 144, softcap=30.0)
    assert LAUNCHES["flash_decode"] == before + 1


def test_int4_layer_route_by_rows(dev):
    """An int4 layer leaf under w4a8: the GEMV at 8 rows, the dequant matmul
    (no kernel) at 32, the GEMM at 256."""
    from pygpukit_tpu_torch.llm import model as port_model
    from pygpukit_tpu_torch.llm import quantize_weight
    leaf = quantize_weight(torch.randn((2048, 2560), device=dev) * 0.02, "int4")
    for rows, name in ((8, "w4a8_gemv"), (32, None), (256, "w4a8_gemm")):
        before = dict(LAUNCHES)
        y = port_model._mm(torch.randn((rows, 2048), device=dev).to(torch.bfloat16), leaf)
        assert y.shape == (rows, 2560) and y.dtype == torch.bfloat16
        moved = {k for k in LAUNCHES if LAUNCHES[k] != before[k]}
        assert moved == ({name} if name else set()), (rows, moved)


def test_single_stream_decode_launches(dev, monkeypatch):
    """decode_step on a small bf16 model: one flash_decode per layer and no
    serving kernel; under PYGPUKIT_DECODE=fused one fused_decode launch and
    no flash_decode, the two steps' logits close."""
    from pygpukit_tpu_torch.llm import CausalTransformerModel, TransformerConfig, init_params
    cfg = TransformerConfig(vocab_size=256, hidden_size=256, num_layers=3, num_heads=4,
                            num_kv_heads=2, intermediate_size=512,
                            max_position_embeddings=512, tie_word_embeddings=False)
    m = CausalTransformerModel(cfg, init_params(cfg, 0, torch.bfloat16, dev))
    m.init_fixed_cache(256)
    m.prefill(list(range(1, 40)))
    snap = m.snapshot_kv_cache()
    before = _launches()
    unfused = m.decode_step(5)                 # a replay of the captured step
    after = _launches()
    moved = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
    assert moved == {"flash_decode": 3}
    monkeypatch.setenv("PYGPUKIT_DECODE", "fused")
    m.init_fixed_cache(256)
    m.restore_kv_cache(snap)
    before = _launches()
    fused = m.decode_step(5)
    after = _launches()
    moved = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
    assert moved == {"fused_decode": 1}
    assert _rel_l2(fused, unfused) <= 5e-2


# ---------------------------------------------------------------------------
# gmm (megablox's grouped matmul) and the MoE routes
# ---------------------------------------------------------------------------

GMM_CASES = {                       # name -> (group sizes, rows M, K, N)
    "empty groups": ([100, 0, 156, 0], 256, 256, 384),
    "a one-row group": ([1, 127, 128], 256, 128, 256),
    "all rows in one group": ([0, 300, 0, 0], 300, 136, 264),
    "M off the tile": ([37, 90, 73], 200, 512, 128),
    "M below 16": ([3, 0, 5], 8, 64, 72),
    "rows past the sum": ([100, 50], 300, 128, 128),
    "routed, 8 experts": (None, 1024, 1024, 512),
    "K 136 over four groups": ([50, 70, 0, 80], 200, 136, 256),
    "128 groups of 0-9 rows": ("qwen3", 0, 512, 768),
    "a group that starts mid-tile": ([60, 200, 10, 130], 400, 256, 384),
    "512 groups, top-10 of 13 tokens (M 130)": ("top10", 130, 2048, 512),
    "512 groups, top-10 of 13 tokens, the down product": ("top10", 130, 512, 2048),
    "512 groups, top-10 of 2048 tokens (M 20480)": ("top10", 20480, 2048, 512),
}


def _gmm_inputs(dev, name):
    sizes, m, k, n = GMM_CASES[name]
    g = _gen(dev, m + k + n)
    if sizes is None:                   # a seeded top-2 routing of M / 2 tokens
        top2 = torch.rand((m // 2, 8), generator=g, device=dev).argsort(dim=-1)[:, :2]
        sizes = torch.bincount(top2.reshape(-1), minlength=8).tolist()
    elif sizes == "qwen3":              # many small experts, some empty
        sizes = torch.randint(0, 10, (128,), generator=g, device=dev).tolist()
        m = sum(sizes)
    elif sizes == "top10":              # Qwen3-Next: top-10 of M / 10 tokens, 512 experts
        top10 = torch.rand((m // 10, 512), generator=g, device=dev).argsort(dim=-1)[:, :10]
        sizes = torch.bincount(top10.reshape(-1), minlength=512).tolist()
    lhs = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    rhs = (torch.randn((len(sizes), k, n), generator=g, device=dev) * 0.1).to(torch.bfloat16)
    return lhs, rhs, torch.tensor(sizes, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("name", list(GMM_CASES))
def test_gmm_matches_plain(dev, name):
    """Within 1e-4 of max |out| of the plain version (both sum exact bf16
    products in f32, in another order), rows past the sum of the sizes
    zero, a second launch bitwise."""
    from pygpukit_tpu_torch.kernels import gmm, gmm_plain
    lhs, rhs, sizes = _gmm_inputs(dev, name)
    before = LAUNCHES["gmm"]
    out = gmm(lhs, rhs, sizes)
    assert LAUNCHES["gmm"] == before + 1
    ref = gmm_plain(lhs, rhs, sizes)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert torch.equal(out[int(sizes.sum()):], torch.zeros_like(out[int(sizes.sum()):]))
    assert torch.equal(out, gmm(lhs, rhs, sizes))


def test_gmm_graph_replays_new_group_sizes(dev):
    """gmm captured once in a CUDA graph reads the group sizes at each
    replay: sizes changed in place give each replay the plain version's
    result for the new sizes (rows past the sum zero), replayed bitwise."""
    from pygpukit_tpu_torch.kernels import gmm, gmm_plain
    g = _gen(dev, 11)
    m, k, n = 384, 256, 384
    lhs = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    rhs = (torch.randn((4, k, n), generator=g, device=dev) * 0.1).to(torch.bfloat16)
    sizes = torch.tensor([100, 100, 100, 84], dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gmm(lhs, rhs, sizes)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gmm(lhs, rhs, sizes)
    for new in ([100, 100, 100, 84], [0, 384, 0, 0], [1, 130, 0, 200], [60, 0, 70, 10],
                [0, 0, 0, 0]):
        sizes.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        ref = gmm_plain(lhs, rhs, new)
        assert (out - ref).abs().max() <= 1e-4 * max(ref.abs().max().item(), 1e-30)
        assert torch.equal(out[sum(new):], torch.zeros_like(out[sum(new):]))
        first = out.clone()
        graph.replay()
        assert torch.equal(out, first)


def test_gmm_raises_on_unsupported_operands(dev):
    """f16 operands (neither route's) raise NotImplementedError, host group
    sizes ValueError; nothing launches. f32 and operands off 8 compute
    (test_gmm_f32_and_off_8_match_plain)."""
    from pygpukit_tpu_torch.kernels import gmm
    sizes = torch.tensor([4, 4], dtype=torch.int32, device=dev)
    lhs = torch.zeros((8, 16), dtype=torch.bfloat16, device=dev)
    rhs = torch.zeros((2, 16, 24), dtype=torch.bfloat16, device=dev)
    before = LAUNCHES["gmm"]
    for bad in ((lhs.half(), rhs.half()), (lhs, rhs.half())):
        with pytest.raises(NotImplementedError):
            gmm(*bad, sizes)
    with pytest.raises(ValueError):
        gmm(lhs, rhs, sizes.cpu())
    assert LAUNCHES["gmm"] == before


GMM_SIMT_CASES = {               # name -> (lhs dtype, rhs dtype, group sizes, M, K, N)
    "f32": ("f32", "f32", [100, 0, 156, 0], 256, 256, 384),
    "f32, K and N off 8": ("f32", "f32", [37, 90, 73], 200, 131, 250),
    "f32, rows past the sum": ("f32", "f32", [100, 50], 300, 128, 128),
    "f32, a group that starts mid-tile": ("f32", "f32", [60, 200, 10, 130], 400, 256, 384),
    "bf16, K off 8": ("bf16", "bf16", [60, 200, 10, 130], 400, 261, 384),
    "bf16, N off 8": ("bf16", "bf16", [1, 127, 128], 256, 128, 250),
    "bf16 x f32": ("bf16", "f32", [3, 0, 5], 8, 64, 72),
}


def _gmm_simt_inputs(dev, name):
    lt, rt, sizes, m, k, n = GMM_SIMT_CASES[name]
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = _gen(dev, m + k + n)
    lhs = torch.randn((m, k), generator=g, device=dev).to(dts[lt])
    rhs = (torch.randn((len(sizes), k, n), generator=g, device=dev) * 0.1).to(dts[rt])
    return lhs, rhs, torch.tensor(sizes, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("name", list(GMM_SIMT_CASES))
def test_gmm_f32_and_off_8_match_plain(dev, name):
    """The CUDA-core route (f32 operands, an f32 model's; bf16 with K or N
    off 8; a bf16/f32 pair): within 1e-4 of max |out| of the plain version,
    rows past the sum zero, one gmm launch, a second launch bitwise."""
    from pygpukit_tpu_torch.kernels import gmm, gmm_plain
    from pygpukit_tpu_torch.kernels.gmm import gmm_route
    lhs, rhs, sizes = _gmm_simt_inputs(dev, name)
    assert gmm_route(lhs.dtype, rhs.dtype, lhs.shape[1], rhs.shape[2]) == "simt"
    before = LAUNCHES["gmm"]
    out = gmm(lhs, rhs, sizes)
    assert LAUNCHES["gmm"] == before + 1
    ref = gmm_plain(lhs.float(), rhs.float(), sizes)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    total = int(sizes.sum())
    assert torch.equal(out[total:], torch.zeros_like(out[total:]))
    assert torch.equal(out, gmm(lhs, rhs, sizes))


def test_gmm_f32_graph_replays_new_group_sizes(dev):
    """The CUDA-core route captured once reads the group sizes at each
    replay, as the wgmma route does."""
    from pygpukit_tpu_torch.kernels import gmm, gmm_plain
    lhs, rhs, sizes = _gmm_simt_inputs(dev, "f32, a group that starts mid-tile")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gmm(lhs, rhs, sizes)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gmm(lhs, rhs, sizes)
    for new in ([60, 200, 10, 130], [0, 400, 0, 0], [1, 130, 0, 200], [0, 0, 0, 0]):
        sizes.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        ref = gmm_plain(lhs, rhs, new)
        assert (out - ref).abs().max() <= 1e-4 * max(ref.abs().max().item(), 1e-30)
        assert torch.equal(out[sum(new):], torch.zeros_like(out[sum(new):]))


def _moe_inputs(dev, t, e=4, h=256, inter=384, k=2):
    g = _gen(dev, t)
    y = torch.randn((t, h), generator=g, device=dev).to(torch.bfloat16)
    ws = [(torch.randn(shape, generator=g, device=dev) * 0.05).to(torch.bfloat16)
          for shape in ((e, h, inter), (e, h, inter), (e, inter, h))]
    router = torch.randn((t, e), generator=g, device=dev)
    return y, ws, router, k


def test_moe_gmm_fn_on_the_card_matches_the_cpu(dev):
    """The CUDA moe_gmm_fn (three gmm launches) against the CPU one (the
    plain gmm): within 1e-2 of max |out| (the f32 gate and up summed in
    another order can flip the bf16 rounding of the SiLU product)."""
    from pygpukit_tpu_torch.ops.moe import moe_gmm_fn
    y, ws, router, k = _moe_inputs(dev, 128)
    before = LAUNCHES["gmm"]
    out = moe_gmm_fn(y, *ws, router, k)
    assert LAUNCHES["gmm"] == before + 3
    ref = moe_gmm_fn(y.cpu(), *(w.cpu() for w in ws), router.cpu(), k)
    assert (out.cpu() - ref).abs().max() <= 1e-2 * ref.abs().max()
    assert torch.equal(out, moe_gmm_fn(y, *ws, router, k))


@pytest.mark.parametrize("t,want", [(64, 3), (8, 0), (1, 0)])
def test_moe_mlp_routes_by_rows_on_the_card(dev, t, want, monkeypatch):
    """T * k >= 128 launches gmm three times a layer; T 8 (dense) and T 1
    (gather) launch nothing; PYGPUKIT_MOE=dense forces dense."""
    from pygpukit_tpu_torch.llm import TransformerConfig, init_params
    from pygpukit_tpu_torch.llm.model import _mlp, _slice_layer_params
    cfg = TransformerConfig(vocab_size=64, hidden_size=256, num_layers=1, num_heads=4,
                            num_kv_heads=2, intermediate_size=384, num_experts=4,
                            num_experts_per_tok=2)
    lp = _slice_layer_params(init_params(cfg, 0, torch.bfloat16, dev)["layers"], 0)
    y = torch.randn((t, 256), generator=_gen(dev, t), device=dev).to(torch.bfloat16)
    before = LAUNCHES["gmm"]
    out = _mlp(cfg, lp, y)
    assert out.shape == y.shape and torch.isfinite(out.float()).all()
    assert LAUNCHES["gmm"] == before + want
    monkeypatch.setenv("PYGPUKIT_MOE", "dense")
    _mlp(cfg, lp, y)
    assert LAUNCHES["gmm"] == before + want


@pytest.mark.parametrize("mode,launches", [("", 1), ("pallas", 1), ("jax", 1), ("xla", 0)])
def test_flash_attention_switch_on_the_card(dev, mode, launches, monkeypatch):
    """PYGPUKIT_FLASH_ATTENTION: pallas and jax take the kernel, xla the
    plain route; both routes agree."""
    g = _gen(dev, 10)
    q = torch.randn((70, 8, 128), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((70, 2, 128), generator=g, device=dev).to(torch.bfloat16)
    monkeypatch.setenv("PYGPUKIT_FLASH_ATTENTION", mode)
    before = LAUNCHES["flash_attention"]
    out = flash_attention_fn(q, k, k)
    assert LAUNCHES["flash_attention"] == before + launches
    assert _attn_close(out, flash_attention_plain(q, k, k, causal=True))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hk", [(4, 4), (16, 4), (32, 4)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 129, 1000, 2048])
def test_flash_attention_bf16_shapes(dev, s, causal, hq, hk, d):
    """The TMA + wgmma kernel on short rows, rows off the 128-row tile, full
    and causal, G 1, 4 and 8 at D 64 and 128: within ATTN_TOL of the plain
    version, a second launch bitwise."""
    g = _gen(dev, s * 7 + d + hq)
    q = torch.randn((s, hq, d), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((s, hk, d), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((s, hk, d), generator=g, device=dev).to(torch.bfloat16)
    out = flash_attention(q, k, v, causal=causal)
    ref = flash_attention_plain(q, k, v, causal=causal)
    assert _attn_close(out, ref), (out.float() - ref.float()).abs().max().item()
    assert torch.equal(out, flash_attention(q, k, v, causal=causal))


def _small_1b(dev, n_layers=2, kv_dtype=None):
    from pygpukit_tpu_torch.llm import CausalTransformerModel, TransformerConfig, init_params
    cfg = TransformerConfig(**dict(CFG_1B, num_layers=n_layers, max_position_embeddings=2048))
    return CausalTransformerModel(cfg, init_params(cfg, 0, torch.bfloat16, dev),
                                  dtype=torch.bfloat16, kv_dtype=kv_dtype)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_batch_step_graph_replay_bitwise(dev, kv_dtype):
    """The batch-8 decode step (row write + split attention per layer)
    captured in a CUDA graph: its replay gives the eager step's logits and
    pools bit for bit (the launch plan depends on shapes only)."""
    from pygpukit_tpu_torch.llm import batch_decode_step_fn
    from pygpukit_tpu_torch.ops.embedding import kv_cache_zeros
    m = _small_1b(dev, kv_dtype=kv_dtype)
    cfg, b, mx = m.config, 8, 1024
    shape = (b, cfg.num_layers, mx, cfg.num_kv_heads * cfg.head_dim)
    g = _gen(dev, 51)
    pools = [kv_cache_zeros(shape, m.kv_dtype, device=dev, merged=True) for _ in range(2)]
    for p in pools:
        leaf = p["q"] if isinstance(p, dict) else p
        leaf.copy_((torch.randn(shape, generator=g, device=dev) * 3).to(leaf.dtype))
        if isinstance(p, dict):
            p["s"].copy_(torch.rand(shape[:3], generator=g, device=dev).to(torch.bfloat16))
    toks = torch.arange(1, b + 1, device=dev)
    poss = torch.tensor([0, 300, 511, 1023, 5, 700, 64, 129], dtype=torch.int32, device=dev)
    snap = [[t.clone() for t in _pool_bits(p)] for p in pools]

    def restore():
        for p, saved in zip(pools, snap):
            for t, s0 in zip(_pool_bits(p), saved):
                t.copy_(s0)

    def step():
        return batch_decode_step_fn(cfg, m.params, pools[0], pools[1], toks, poss)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = step()
    restore()
    eager = step().clone()
    after = [[t.clone() for t in _pool_bits(p)] for p in pools]
    restore()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.isfinite(eager).all() and torch.equal(static, eager)
    assert all(torch.equal(a, t) for p, saved in zip(pools, after)
               for a, t in zip(saved, _pool_bits(p)))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_kv_engine_serves_on_the_card(dev, kv_dtype, paged):
    """ContinuousBatchingEngine on a 2-layer model with int8 or fp8 KV: every
    request finishes with finite logits, through the kernels (dense: the split
    attention with the row write fused in, no row-write kernel; paged:
    paged_attention)."""
    from pygpukit_tpu_torch import reset_launches
    from pygpukit_tpu_torch.core import reset_replayed_launches
    from pygpukit_tpu_torch.llm import ContinuousBatchingEngine
    m = _small_1b(dev, kv_dtype=kv_dtype)
    kw = dict(paged=True, block_size=16) if paged else {}
    eng = ContinuousBatchingEngine(m, max_batch=8, max_seq_len=256, steps_per_dispatch=8, **kw)
    reset_launches()
    reset_replayed_launches()
    reqs = [eng.submit(list(range(1 + i, 17 + i)), max_new_tokens=24) for i in range(10)]
    eng.run_until_complete()
    assert all(r.done and len(r.generated) == 24 for r in reqs)
    assert eng.logits_finite()
    n = _launches()                          # the engine's programs replay
    if paged:
        assert n["paged_attention"] > 0 and n["batch_decode_attention"] == 0
    else:
        assert n["batch_decode_attention"] > 0
        assert n["kv_rows_write"] == 0
        assert n["kv_rows_write_fused"] == n["batch_decode_attention"]


# ---------------------------------------------------------------------------
# Capture and replay (core/executable.py) with the device position
# ---------------------------------------------------------------------------

def _cache_copy(m):
    return [t.clone() for t in _pool_bits(m.k_cache) + _pool_bits(m.v_cache)]


def _cache_put(m, saved):
    for t, s0 in zip(_pool_bits(m.k_cache) + _pool_bits(m.v_cache), saved):
        t.copy_(s0)


@pytest.mark.parametrize("route", ["unfused", "fused"])
def test_captured_decode_step_replays_bitwise(dev, route, monkeypatch):
    """The model's captured greedy step (2 layers at the 1.1B widths, MAX
    512), captured once and replayed at four positions: logits and both
    caches bitwise the eager step's from the same cache state; a second
    replay at the same state bitwise the first; the warm-up leaves the
    caches and LAUNCHES as they were; cost_analysis() is one eager step's
    launches; another cache tensor raises."""
    if route == "fused":
        monkeypatch.setenv("PYGPUKIT_DECODE", "fused")
    else:
        monkeypatch.delenv("PYGPUKIT_DECODE", raising=False)
    m = _small_1b(dev)
    m.init_fixed_cache(512)
    m.prefill(list(range(1, 17)))
    saved, before = _cache_copy(m), dict(LAUNCHES)
    exe = m._ensure_decode_exe()
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == before
    assert all(torch.equal(a, b) for a, b in zip(_cache_copy(m), saved))
    kernel = {"unfused": ("flash_decode", 2), "fused": ("fused_decode", 1)}[route]
    assert exe.cost_analysis() == dict([kernel]) and exe.node_count > 0
    assert exe.memory_analysis() >= 0 and m.graphs.nbytes > 0    # the pool the prefill shares
    from pygpukit_tpu_torch.llm import decode_step_fn
    for pos, tok in ((16, 7), (17, 900), (200, 31999), (511, 3)):
        m.pos = pos
        state = _cache_copy(m)
        before = dict(LAUNCHES)
        eager = decode_step_fn(m.config, m.params, m.k_cache, m.v_cache, tok, pos).clone()
        moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
        assert moved == dict([kernel])
        after = _cache_copy(m)
        for _ in range(2):
            _cache_put(m, state)
            m.pos = pos
            before = dict(LAUNCHES)
            got = m.decode_step(tok)
            torch.cuda.synchronize()
            assert dict(LAUNCHES) == before           # a replay ticks no counter
            assert torch.isfinite(eager).all() and torch.equal(got, eager), pos
            assert all(torch.equal(a, b) for a, b in zip(_cache_copy(m), after)), pos
            assert int(m.decode_buffers.sampled) == int(torch.argmax(eager))
    assert exe.stats.replays == 8
    b = m.decode_buffers
    with pytest.raises(ValueError, match="donated argument 1"):
        exe.replay(m.params, m.k_cache.clone(), m.v_cache, 1, 20, m._nonfinite, b.logits,
                   b.sampled)


def test_captured_batch_step_replays_two_position_vectors(dev):
    """batch_decode_step_fn captured with the positions as a static input:
    replays at two position vectors, copied in, give the eager step's
    logits and pools bitwise; 2 kv_write_attention launches a replay."""
    from pygpukit_tpu_torch.core import capture
    from pygpukit_tpu_torch.llm import batch_decode_step_fn
    from pygpukit_tpu_torch.ops.embedding import kv_cache_zeros
    m = _small_1b(dev)
    cfg, b, mx = m.config, 8, 512
    shape = (b, cfg.num_layers, mx, cfg.num_kv_heads * cfg.head_dim)
    g = _gen(dev, 61)
    pools = [kv_cache_zeros(shape, torch.bfloat16, device=dev, merged=True) for _ in range(2)]
    for p in pools:
        p.copy_((torch.randn(shape, generator=g, device=dev) * 2).to(torch.bfloat16))
    toks = torch.arange(1, b + 1, device=dev, dtype=torch.int32)
    poss = torch.zeros(b, dtype=torch.int32, device=dev)

    def fn(params, kp, vp, tokens, positions):
        return batch_decode_step_fn(cfg, params, kp, vp, tokens, positions)
    exe = capture(fn, m.params, pools[0], pools[1], toks, poss, donate_argnums=(1, 2))
    assert exe.cost_analysis() == {"batch_decode_attention": 2, "kv_rows_write_fused": 2}
    for vec in ([0, 300, 511, 17, 5, 200, 64, 129], [1, 301, 511, 18, 6, 201, 65, 130]):
        pv = torch.tensor(vec, dtype=torch.int32, device=dev)
        state = [t.clone() for t in pools]
        eager = fn(m.params, pools[0], pools[1], toks, pv).clone()
        after = [t.clone() for t in pools]
        for t, s0 in zip(pools, state):
            t.copy_(s0)
        got = exe.replay(m.params, pools[0], pools[1], toks, pv)
        torch.cuda.synchronize()
        assert torch.equal(got, eager) and torch.equal(poss, pv)
        assert all(torch.equal(_bits(a), _bits(t)) for a, t in zip(after, pools))


def test_failed_capture_raises(dev):
    """A host read inside the captured function fails the capture, which
    raises (no eager fallback); the card works afterwards."""
    from pygpukit_tpu_torch.core import capture
    state = torch.zeros(4, device=dev)

    def fn(s, x):
        s.add_(x * int(x.sum()))
        return s
    with pytest.raises(RuntimeError):
        capture(fn, state, torch.ones(4, device=dev), donate_argnums=(0,))
    assert torch.equal(state, torch.zeros(4, device=dev))
    assert float(torch.ones(3, device=dev).sum()) == 3.0


@pytest.mark.parametrize("route", ["unfused", "fused"])
def test_m1_graph_tokens_match_m1(dev, route, monkeypatch):
    """DecodeM1Graph's tokens are DecodeM1's on a 2-layer model at the 1.1B
    widths, 48 tokens, unfused and fused."""
    from pygpukit_tpu_torch.llm.decode import DecodeM1, DecodeM1Graph
    if route == "fused":
        monkeypatch.setenv("PYGPUKIT_DECODE", "fused")
    else:
        monkeypatch.delenv("PYGPUKIT_DECODE", raising=False)
    m = _small_1b(dev)
    m.init_fixed_cache(512)
    eager = DecodeM1().bind(m).generate(list(range(1, 17)), 48)
    strat = DecodeM1Graph().bind(m)
    strat.init_graph(512)
    assert strat.node_count > 0
    assert strat.generate(list(range(1, 17)), 48) == eager
    assert m.logits_finite()


@pytest.mark.parametrize("route", ["unfused", "fused"])
def test_device_position_reads_nothing_on_the_host(dev, route, monkeypatch):
    """With the position a device tensor, the step (unfused or fused), a
    lookahead window and three speculative rounds run under
    torch.cuda.set_sync_debug_mode("error"): no host read and no
    synchronizing copy."""
    from pygpukit_tpu_torch.llm import decode_step_fn, decode_window_fn, speculative_scan_fn
    if route == "fused":
        monkeypatch.setenv("PYGPUKIT_DECODE", "fused")
    else:
        monkeypatch.delenv("PYGPUKIT_DECODE", raising=False)
    m = _small_1b(dev)
    m.init_fixed_cache(512)
    m.prefill(list(range(1, 17)))
    cfg, params, kc, vc = m.config, m.params, m.k_cache, m.v_cache
    pos = torch.full((1,), 16, dtype=torch.int32, device=dev)
    tok = torch.full((1,), 5, dtype=torch.int32, device=dev)
    window = torch.tensor([5, 9, 11], dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = decode_step_fn(cfg, params, kc, vc, tok, pos)
        wl = decode_window_fn(cfg, params, kc, vc, window, pos + 1)
        toks, counts, end = speculative_scan_fn(cfg, 3, 3, 1, params, kc, vc, tok, pos + 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(logits).all() and torch.isfinite(wl).all()
    assert toks.shape == (3, 4) and int(end) == 4 + 16 + int(counts.sum())


@pytest.mark.parametrize("sampling", [(0.0, 0), (0.8, 40), (1.0, 0)])
def test_sampled_chunk_replay_draws_the_eager_draws(dev, sampling):
    """``decode_chunk_device`` replays its captured chunk with the
    executable's registered generator reseeded with seed + pos: the tokens
    and both caches bitwise those of the eager ``generate_scan_fn`` with a
    generator seeded alike, from the same cache state, at two seeds and
    two positions; one capture serves them all."""
    from pygpukit_tpu_torch.llm import generate_scan_fn
    temperature, top_k = sampling
    m = _small_1b(dev)
    m.init_fixed_cache(512)
    m.prefill(list(range(1, 17)))
    for seed, pos, tok in ((3, 16, 7), (11, 40, 900)):
        m.pos = pos
        state = _cache_copy(m)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + pos)
        eager = generate_scan_fn(m.config, 8, temperature, top_k, m.params, m.k_cache,
                                 m.v_cache, tok, pos, gen if temperature > 0 else None)
        eager = eager.clone()
        after = _cache_copy(m)
        _cache_put(m, state)
        m.pos = pos
        got = m.decode_chunk_device(tok, 8, temperature, top_k, seed)
        torch.cuda.synchronize()
        assert torch.equal(got, eager), (seed, pos)
        assert all(torch.equal(a, b) for a, b in zip(_cache_copy(m), after))
    exes = [e for k, e in m.graphs.executables().items() if k[0] == "generate"]
    assert len(exes) == 1 and exes[0].stats.replays == 2


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("pipelined", [False, True])
def test_engine_replays_identical_streams_and_pools(dev, paged, pipelined):
    """The engine on a 2-layer model at the 1.1B widths replays its
    captured prefills and chunk: two engines serve the same 12 requests
    with identical streams and bitwise pools (paged: outside the trash
    block 0), every request finishing with its count."""
    from pygpukit_tpu_torch.llm import ContinuousBatchingEngine
    m = _small_1b(dev)
    g = torch.Generator().manual_seed(5)
    reqs_in = [(torch.randint(1, 32000, (int(n),), generator=g).tolist(), 20 + i)
               for i, n in enumerate(torch.randint(4, 60, (12,), generator=g))]
    runs = []
    for _ in range(2):
        eng = ContinuousBatchingEngine(m, max_batch=4, max_seq_len=256, steps_per_dispatch=8,
                                       pipelined=pipelined, paged=paged, block_size=16)
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in reqs_in]
        eng.run_until_complete()
        assert all(r.done and len(r.generated) == n for r, (_, n) in zip(reqs, reqs_in))
        assert eng.logits_finite() and eng.graphs.executables()
        pools = [c[:, 1:] if paged else c for c in (eng.k_cache, eng.v_cache)]
        runs.append(([r.generated for r in reqs], [_bits(p).clone() for p in pools]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.parametrize("copies", ["pinned", "pageable"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shards", [1, 2])
def test_checkpoint_loads_on_the_card_as_on_the_cpu(dev, tmp_path, monkeypatch, copies,
                                                     dtype, shards):
    """A small Llama checkpoint in Hugging Face layout (f32 on disk, [out,
    in] projections), loaded with device="cuda" through pinned
    double-buffered copies or pageable ones (PYGPUKIT_ASYNC_LOAD=0),
    converted and transposed on the card: every leaf equals the CPU load's
    bitwise, and the model runs."""
    import json
    from pygpukit_tpu_torch.llm import (TransformerConfig, init_params,
                                        load_model_from_safetensors, save_safetensors)
    monkeypatch.setenv("PYGPUKIT_ASYNC_LOAD", "1" if copies == "pinned" else "0")
    cfg = TransformerConfig(vocab_size=512, hidden_size=256, num_layers=3, num_heads=4,
                            num_kv_heads=2, intermediate_size=320,
                            max_position_embeddings=256, tie_word_embeddings=False)
    p = init_params(cfg, 7, torch.float32, device="cpu")
    lp = p["layers"]
    tensors = {"model.embed_tokens.weight": p["embed"], "model.norm.weight": p["final_norm_w"],
               "lm_head.weight": p["lm_head"].t()}
    names = {"w_q": "self_attn.q_proj", "w_k": "self_attn.k_proj", "w_v": "self_attn.v_proj",
             "w_o": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    for i in range(cfg.num_layers):
        tensors[f"model.layers.{i}.input_layernorm.weight"] = lp["attn_norm_w"][i]
        tensors[f"model.layers.{i}.post_attention_layernorm.weight"] = lp["mlp_norm_w"][i]
        for leaf, name in names.items():
            tensors[f"model.layers.{i}.{name}.weight"] = lp[leaf][i].t()
    keys = list(tensors)
    weight_map = {}
    for k in range(shards):
        part = keys[k * len(keys) // shards:(k + 1) * len(keys) // shards]
        shard = "model.safetensors" if shards == 1 else f"model-{k + 1:05d}-of-00002.safetensors"
        save_safetensors(tmp_path / shard, {n: tensors[n] for n in part})
        weight_map.update({n: shard for n in part})
    if shards > 1:
        (tmp_path / "model.safetensors.index.json").write_text(
            json.dumps({"weight_map": weight_map}))
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": 512, "hidden_size": 256, "intermediate_size": 320,
        "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 2,
        "max_position_embeddings": 256, "tie_word_embeddings": False}))
    on_card = load_model_from_safetensors(tmp_path, dtype=dtype, device=dev)
    on_cpu = load_model_from_safetensors(tmp_path, dtype=dtype, device="cpu")
    card, cpu = on_card.params, on_cpu.params
    for key in ("embed", "final_norm_w", "lm_head"):
        assert torch.equal(card[key].cpu(), cpu[key]), key
    for key, leaf in cpu["layers"].items():
        assert leaf.dtype == card["layers"][key].dtype, key
        assert torch.equal(card["layers"][key].cpu(), leaf), key
    ids = [3, 17, 200, 45, 9]
    assert on_card(ids).shape == (5, 512)


@pytest.mark.parametrize("strategy", ["SIMPLE", "SLIDING_WINDOW", "AUTO_LRU"])
def test_streaming_on_the_card_matches_the_cpu(dev, tmp_path, strategy):
    """Layer streaming with the device copies on the card (the sliding
    window's prefetch on a side stream): the tensors, the loader's stats
    and its resident names after each layer equal a CPU run's."""
    from pygpukit_tpu_torch.llm import (LoadingStrategy, create_streaming_context,
                                        save_safetensors)
    path = tmp_path / "model.safetensors"
    save_safetensors(path, {f"layer.{i}.{w}": torch.full((64, 32), float(i + j))
                            for i in range(5) for j, w in enumerate(("a", "b"))})
    names = [[f"layer.{i}.a", f"layer.{i}.b"] for i in range(5)]
    runs = []
    for device in (dev, "cpu"):
        seen = []
        with create_streaming_context(str(path), names, getattr(LoadingStrategy, strategy),
                                      max_device_bytes=4 * 64 * 32 * 4, device=device) as ctx:
            for i, tensors in ctx:
                seen.append((i, {k: t.sum().item() for k, t in tensors.items()},
                             dict(ctx.loader.stats), list(ctx.loader._device)))
        runs.append((seen, dict(ctx.loader.stats)))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# The new families' attention shapes: head_dim 256 (Gemma-2-2B: 8/4 heads,
# softcap 50, windows; Gemma-3-1B: 4/1 heads, window 512 or global), G 1
# (GPT-2, 12/12 heads) and G 7 (Qwen2.5-0.5B, 14/2 heads) at D 64, and
# head_dim 96 (Phi-3.5-mini: 32/32 heads; G 4 with a softcap and a window
# for the masks), and G 16 (GLM-4: 32/2 heads; the kernels' 512-thread
# blocks), and head_dim 80 (Phi-2: 32/32 heads; G 4 and G 16 with a softcap
# and a window), the first D that is not a multiple of 32
# ---------------------------------------------------------------------------

#: (Hq, Hk, D, softcap, window) of the rows 5/6 and 17 checks
FAMILY_ATTN = {"gemma2": (8, 4, 256, 50.0, 300), "gemma3": (4, 1, 256, None, 512),
               "gemma3 global": (4, 1, 256, None, None), "gpt2 G1": (12, 12, 64, None, None),
               "qwen2.5 G7": (14, 2, 64, None, None), "phi3.5 D96": (32, 32, 96, None, None),
               "D96 G4": (32, 8, 96, 50.0, 300), "glm4 G16": (32, 2, 128, None, None),
               "D96 G16": (32, 2, 96, 50.0, 300), "phi2 D80": (32, 32, 80, None, None),
               "D80 G4": (32, 8, 80, 50.0, 300), "D80 G16": (32, 2, 80, 50.0, 300)}


@pytest.mark.parametrize("storage", list(STORAGES))
@pytest.mark.parametrize("shape", list(FAMILY_ATTN))
def test_family_kv_write_attention(dev, shape, storage):
    """Rows 5 and 6 at the families' shapes: the fused write's pools
    bitwise kv_rows_write_plain's, its output bitwise kv_rows_write then
    batch_decode_attention and within ATTN_TOL of the plain version, at
    positions before, inside and past MAX (window 300 starts inside a
    split)."""
    hq, hk, d, softcap, window = FAMILY_ATTN[shape]
    (kp, vp), kn, vn, q, poss = _krw_inputs(dev, storage, 81, b=8, nl=2, hk=hk, hq=hq, d=d)
    for pv in poss:
        lens = pv + 1
        k1, v1, k2, v2, k3, v3 = (_pool_copy(p) for p in (kp, vp) * 3)
        before = dict(LAUNCHES)
        out = kv_write_attention(q, k1, v1, kn, vn, 1, pv, lens, scale=d ** -0.5,
                                 softcap=softcap, window=window)
        assert LAUNCHES["batch_decode_attention"] == before["batch_decode_attention"] + 1
        assert LAUNCHES["kv_rows_write_fused"] == before["kv_rows_write_fused"] + 1
        kv_rows_write_plain(k2, v2, kn, vn, 1, pv)
        assert _pools_equal(k1, k2) and _pools_equal(v1, v2), pv.tolist()
        kv_rows_write(k3, v3, kn, vn, 1, pv)
        ref = batch_decode_attention(q, k3, v3, 1, lens, d ** -0.5, softcap, window)
        assert torch.equal(out, ref), pv.tolist()
        plain = batch_decode_attention_plain(q, k2, v2, 1, lens, d ** -0.5, softcap, window)
        assert _storage_close(out, plain, STORAGES[storage][1]), \
            (out.float() - plain.float()).abs().max().item()


@pytest.mark.parametrize("storage", list(STORAGES))
@pytest.mark.parametrize("shape", list(FAMILY_ATTN))
def test_family_paged_attention(dev, shape, storage):
    """Row 17 at the families' shapes over shuffled blocks, every storage,
    within ATTN_TOL of the plain version; a second launch bitwise."""
    hq, hk, d, softcap, window = FAMILY_ATTN[shape]
    q, kp, vp, tables, lens = _paged_inputs(dev, 1024, 9, hq=hq, hk=hk, d=d)
    dtype, qdt = STORAGES[storage]
    kp, vp = (_store(p.float().transpose(1, 2), dtype, 2) for p in (kp, vp))
    kp, vp = ({"q": p["q"].transpose(1, 2).contiguous(), "s": p["s"]} if isinstance(p, dict)
              else p.transpose(1, 2).contiguous() for p in (kp, vp))
    q = q.to(qdt)
    before = LAUNCHES["paged_attention"]
    out = paged_attention(q, kp, vp, tables, lens, d ** -0.5, softcap, window)
    assert LAUNCHES["paged_attention"] == before + 1
    ref = paged_attention_plain(q, kp, vp, tables, lens, d ** -0.5, softcap, window)
    # int8 blocks: the plain version's bf16 gather (test_paged_attention_every_storage)
    tol_dt = torch.bfloat16 if dtype == torch.int8 else qdt
    assert _storage_close(out, ref, tol_dt), (out.float() - ref.float()).abs().max().item()
    assert torch.equal(out, paged_attention(q, kp, vp, tables, lens, d ** -0.5, softcap,
                                            window))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 63, 65, 300, 2048])
@pytest.mark.parametrize("hq,hk,d", [(8, 4, 256), (4, 1, 256), (12, 12, 64), (14, 2, 64),
                                     (32, 32, 96), (32, 8, 96), (32, 32, 80), (32, 8, 80)])
def test_family_flash_attention(dev, hq, hk, d, s, causal, dtype):
    """Row 14 at the families' heads: D 256 on the 64-key tile, D 96 on
    32-column sub-tiles, D 80 on three of them (the last half out of the
    tensor maps' bounds), G 1 and G 7; within ATTN_TOL of the plain
    version, a second launch bitwise."""
    g = _gen(dev, s * 3 + hq + d)
    q = torch.randn((s, hq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((s, hk, d), generator=g, device=dev).to(dtype)
    v = torch.randn((s, hk, d), generator=g, device=dev).to(dtype)
    before = LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, causal=causal)
    assert LAUNCHES["flash_attention"] == before + 1
    ref = flash_attention_plain(q, k, v, causal=causal)
    assert torch.isfinite(out.float()).all()
    assert _attn_close(out, ref), (out.float() - ref.float()).abs().max().item()
    assert torch.equal(out, flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ctx", [1, 333, 4100, 9000])
@pytest.mark.parametrize("hq,hk,d", [(8, 4, 256), (4, 1, 256), (16, 1, 256), (12, 12, 64),
                                     (14, 2, 64), (32, 32, 96), (32, 8, 96), (32, 2, 96),
                                     (32, 32, 80), (32, 8, 80), (32, 2, 80)])
def test_family_flash_decode(dev, hq, hk, d, ctx, dtype):
    """Row 15 at the families' heads (G 16 at D 256, 96 and 80: both row
    halves of the tensor-core tile), contexts of one split to past MAX, an
    int and a device context alike."""
    g = _gen(dev, hq + hk + d + ctx)
    q = torch.randn((1, hq, d), generator=g, device=dev).to(dtype)
    kc = torch.randn((8192, hk, d), generator=g, device=dev).to(dtype)
    vc = torch.randn((8192, hk, d), generator=g, device=dev).to(dtype)
    before = LAUNCHES["flash_decode"]
    out = flash_decode(q, kc, vc, ctx)
    assert LAUNCHES["flash_decode"] == before + 1
    assert _attn_close(out, flash_decode_plain(q, kc, vc, ctx)), \
        (out.float() - flash_decode_plain(q, kc, vc, ctx).float()).abs().max().item()
    ctx_t = torch.tensor([ctx], dtype=torch.int32, device=dev)
    assert torch.equal(out, flash_decode(q, kc, vc, ctx_t))


@pytest.mark.parametrize("hq,hk,d", [(4, 1, 256), (32, 32, 96), (32, 32, 80)])
def test_family_flash_decode_graph_replays_device_context(dev, hq, hk, d):
    """Gemma-3-1B's head shape at D 256, Phi-3.5's at D 96 and Phi-2's at
    D 80: one graph
    captured once serves every context, bitwise the eager call."""
    g = _gen(dev, d)
    q = torch.randn((1, hq, d), generator=g, device=dev).to(torch.bfloat16)
    kc = torch.randn((2048, hk, d), generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn((2048, hk, d), generator=g, device=dev).to(torch.bfloat16)
    ctx = torch.tensor([5], dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_decode(q, kc, vc, ctx)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = flash_decode(q, kc, vc, ctx)
    for v in (1, 64, 65, 777, 2048, 3000, -3):
        ctx.fill_(v)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static, flash_decode(q, kc, vc, v)), v


def test_an_unbuilt_head_dim_raises(dev):
    """D 112 (whole 16-byte vectors, but no kernel is built for it): every
    wrapper raises before a launch, and every C entry returns an error
    instead of running a body that would cover fewer dims."""
    from pygpukit_tpu_torch.kernels import _build
    g = _gen(dev, 112)
    d, hq, hk = 112, 8, 2
    q = torch.randn((1, hq, d), generator=g, device=dev).to(torch.bfloat16)
    kc = torch.randn((64, hk, d), generator=g, device=dev).to(torch.bfloat16)
    lens = torch.tensor([40], dtype=torch.int32, device=dev)
    pools = [torch.zeros((1, 1, 64, hk * d), device=dev, dtype=torch.bfloat16)
             for _ in range(2)]
    blocks = [torch.zeros((4, hk, 16, d), device=dev, dtype=torch.bfloat16) for _ in range(2)]
    tables = torch.arange(4, dtype=torch.int32, device=dev)[None]
    before = dict(LAUNCHES)
    for call in (lambda: flash_attention(q[0][None].expand(4, hq, d).contiguous(),
                                         kc[:4], kc[:4]),
                 lambda: flash_decode(q, kc, kc, 40),
                 lambda: batch_decode_attention(q[:, None], *pools, 0, lens, d ** -0.5),
                 lambda: paged_attention(q, *blocks, tables, lens, d ** -0.5)):
        with pytest.raises(ValueError):
            call()
    assert dict(LAUNCHES) == before
    out = torch.empty_like(q)
    part = torch.empty(hq * 64 * (d + 2), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.library()
    rcs = [lib.pgk_flash_attention(q.data_ptr(), kc.data_ptr(), kc.data_ptr(), out.data_ptr(),
                                   1, hq, hk, d, 1, 0, d ** -0.5, stream),
           lib.pgk_flash_decode(q.data_ptr(), kc.data_ptr(), kc.data_ptr(), None, 40,
                                out.data_ptr(), part.data_ptr(), hq, hk, d, 64, 1, 0,
                                d ** -0.5, stream),
           lib.pgk_batch_decode_attention(q.data_ptr(), pools[0].data_ptr(),
                                          pools[1].data_ptr(), None, None, lens.data_ptr(),
                                          None, None, None, out.data_ptr(), part.data_ptr(),
                                          1, hq, hk, d, 0, 1, 64, 1, 0, 0, d ** -0.5, 0.0, 0,
                                          stream),
           lib.pgk_paged_attention(q.data_ptr(), blocks[0].data_ptr(), blocks[1].data_ptr(),
                                   None, None, tables.data_ptr(), lens.data_ptr(),
                                   out.data_ptr(), part.data_ptr(), 1, hq, hk, d, 16, 4, 1,
                                   0, 0, d ** -0.5, 0.0, 0, stream)]
    torch.cuda.synchronize()
    assert all(rc != 0 for rc in rcs), rcs


UNBUILT_SHAPES = {"d32": (32, 4, 2), "d112": (112, 4, 2), "g24": (64, 48, 2)}


def _rel(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("shape", list(UNBUILT_SHAPES))
def test_unbuilt_attention_shapes_serve_on_the_card(dev, shape):
    """D 32, D 112 and G 24: the uncached forward, the single-stream step
    and both engines run on the card in f32 (the routes send the shapes
    their kernels are not built for to the plain versions) and match the
    CPU plain path: forward logits within 1e-3 relative L2 of the CPU's,
    each engine's stream the card's own greedy generate. No kernel launches
    for an unbuilt shape; G 24 keeps flash_attention and flash_decode."""
    from pygpukit_tpu_torch.llm import (CausalTransformerModel, ContinuousBatchingEngine,
                                        TransformerConfig, init_params)
    d, hq, hk = UNBUILT_SHAPES[shape]
    cfg = TransformerConfig(vocab_size=512, hidden_size=hq * d, num_layers=2, num_heads=hq,
                            num_kv_heads=hk, intermediate_size=256,
                            max_position_embeddings=256, tie_word_embeddings=False)
    params = init_params(cfg, 0, torch.float32, device="cpu")
    cpu = CausalTransformerModel(cfg, params, dtype=torch.float32)
    card = CausalTransformerModel(cfg, _to_dev(params, dev), dtype=torch.float32)
    prompt = list(range(3, 40))
    before = _launches()
    assert _rel(card(prompt), cpu(prompt)) < 1e-3
    card.init_fixed_cache(128)
    want = card.generate(prompt, 12, chunk_size=4)
    streams = []
    for paged in (False, True):
        eng = ContinuousBatchingEngine(card, max_batch=2, max_seq_len=128,
                                       steps_per_dispatch=4, paged=paged)
        req = eng.submit(prompt, max_new_tokens=12)
        eng.run_until_complete()
        streams.append(req.generated)
    assert streams == [want, want]
    moved = {k for k, n in _launches().items() if n != before.get(k, 0)}
    served = {"flash_attention", "flash_decode"} if shape == "g24" else set()
    assert moved & {"flash_attention", "flash_decode", "batch_decode_attention",
                    "paged_attention", "kv_rows_write_fused"} == served


@pytest.mark.parametrize("family", ["deepseek", "gptoss"])
def test_standalone_families_on_the_card(dev, family):
    """A small random DeepSeek-V3 (noaux_tc) or gpt-oss in bf16 on the card:
    the 160-token forward launches gmm (T * k >= 128) and is within 3e-2
    relative L2 of the CPU plain path's logits (the one-hot experts in
    f32); greedy generate twice gives the same tokens (captured programs
    replayed); the hybrid engine's streams equal generate's at the same
    cache length, and a second run over the same requests replays its
    programs to the same caches, bit for bit."""
    from pygpukit_tpu_torch.llm.models import deepseek, gptoss
    from pygpukit_tpu_torch.llm.serving_hybrid import HybridServingEngine
    if family == "deepseek":
        cfg = deepseek.DeepseekV3Config(
            vocab_size=512, hidden_size=256, num_layers=2, num_heads=4, q_lora_rank=64,
            kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
            intermediate_size=256, moe_intermediate_size=64, n_routed_experts=16,
            n_group=4, topk_group=2, num_experts_per_tok=4, first_k_dense=1,
            max_position_embeddings=512)
        mod, cls = deepseek, deepseek.DeepseekV3Model
    else:
        cfg = gptoss.GptOssConfig(
            vocab_size=512, hidden_size=256, num_layers=2, num_heads=8, num_kv_heads=2,
            head_dim=32, intermediate_size=128, num_experts=8, num_experts_per_tok=2,
            sliding_window=16, layer_types=("sliding_attention", "full_attention"),
            max_position_embeddings=512)
        mod, cls = gptoss, gptoss.GptOssModel
    params = mod.init_params(cfg, 0, torch.bfloat16, "cpu")
    cpu = cls(cfg, params, dtype=torch.bfloat16)
    card = cls(cfg, _to_dev(params, dev), dtype=torch.bfloat16)
    prompt = list(range(5, 165))
    before = LAUNCHES["gmm"]
    assert _rel(card.forward(prompt), cpu.forward(prompt)) < 3e-2
    launched = LAUNCHES["gmm"] > before
    card.init_fixed_cache(256)
    want = card.generate(prompt[:40], 16, chunk_size=8)
    card.init_fixed_cache(256)
    assert card.generate(prompt[:40], 16, chunk_size=8) == want
    eng = HybridServingEngine(card, max_batch=2, max_seq_len=256, steps_per_dispatch=8)
    caches = []
    for _ in range(2):                       # the second run replays the first's programs
        reqs = [eng.submit(prompt[:40], max_new_tokens=16) for _ in range(3)]
        eng.run_until_complete()
        assert all(r.generated == want for r in reqs)
        caches.append({k: v.clone() for k, v in eng._caches.items()})
    assert all(torch.equal(caches[0][k], caches[1][k]) for k in caches[0])
    assert launched


def _to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_dev(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lfm2_decode_step_launches_flash_decode(dev, dtype, monkeypatch):
    """A 2-layer LFM2 (a conv layer, then attention at LFM2-1.2B's 32/8
    heads, D 64) on the card: one decode step at a device position
    launches flash_decode once (its attention layer), the kernel's output
    within ATTN_TOL (bf16) or 1e-4 of max |ref| (f32) of the plain version
    on the same inputs, the logits finite; the step's logits within 1e-2
    (bf16) or 1e-4 (f32) relative L2 of the CPU plain path's."""
    from pygpukit_tpu_torch.llm.models import lfm2
    cfg = lfm2.Lfm2Config(vocab_size=512, hidden_size=512, num_layers=2, num_heads=32,
                          num_kv_heads=8, head_dim=64, intermediate_size=1024,
                          layer_types=("conv", "full_attention"), max_position_embeddings=512)
    params = lfm2.init_params(cfg, 0, dtype, "cpu")
    seen = []

    def traced(q, kc, vc, ctx_len, *a, **kw):
        out = real(q, kc, vc, ctx_len, *a, **kw)
        seen.append((out, flash_decode_plain(q, kc, vc, ctx_len)))
        return out
    real = lfm2.sdpa_fixed_cache_fn
    logits = []
    for where in (dev, torch.device("cpu")):
        model = lfm2.Lfm2Model(cfg, _to_dev(params, where), dtype=dtype)
        caches = lfm2.init_caches(cfg, 256, dtype, where)
        toks = torch.tensor(list(range(3, 43)) + [0] * 24, dtype=torch.int32, device=where)
        lfm2.prefill_fn(cfg, model.params, caches, toks, 40)
        pos = torch.tensor([40], dtype=torch.int32, device=where)
        monkeypatch.setattr(lfm2, "sdpa_fixed_cache_fn", traced)
        before = LAUNCHES["flash_decode"]
        _, out = lfm2.decode_step_fn(cfg, model.params, caches, 7, pos)
        monkeypatch.setattr(lfm2, "sdpa_fixed_cache_fn", real)
        assert LAUNCHES["flash_decode"] == before + (1 if where.type == "cuda" else 0)
        assert torch.isfinite(out).all()
        logits.append(out)
    (kernel, plain), _ = seen
    assert kernel.dtype == dtype and _attn_close(kernel, plain)
    assert _rel(logits[0], logits[1]) < (1e-2 if dtype == torch.bfloat16 else 1e-4)



def _qwen3next_2layer(dtype, moe: bool):
    """A 2-layer Qwen3-Next on the CPU: a DeltaNet layer (16 K / 32 V heads
    of 128) then attention at Qwen3-Next-80B-A3B's 16/2 heads, D 256;
    with ``moe``, 64 experts top-10 on both layers."""
    from pygpukit_tpu_torch.llm.models import qwen3next
    cfg = qwen3next.Qwen3NextConfig(
        vocab_size=512, hidden_size=512, num_layers=2, num_heads=16, num_kv_heads=2,
        head_dim=256, intermediate_size=1024, layer_types=("linear_attention", "full_attention"),
        num_experts=64 if moe else 0, num_experts_per_tok=10, moe_intermediate_size=128,
        shared_expert_intermediate_size=128, max_position_embeddings=512)
    return qwen3next, cfg, qwen3next.init_params(cfg, 0, dtype, "cpu")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qwen3next_decode_step_launches_flash_decode(dev, dtype, monkeypatch):
    """A 2-layer Qwen3-Next (a DeltaNet layer, then gated attention at 16/2
    heads, D 256) on the card: one decode step at a device position
    launches flash_decode once (its attention layer), the kernel's output
    within ATTN_TOL (bf16) or 1e-4 of max |ref| (f32) of the plain version
    on the same inputs, the logits finite; the step's logits within 1e-2
    (bf16) or 1e-4 (f32) relative L2 of the CPU plain path's."""
    qwen3next, cfg, params = _qwen3next_2layer(dtype, moe=False)
    seen = []

    def traced(q, kc, vc, ctx_len, *a, **kw):
        out = real(q, kc, vc, ctx_len, *a, **kw)
        seen.append((out, flash_decode_plain(q, kc, vc, ctx_len)))
        return out
    real = qwen3next.sdpa_fixed_cache_fn
    logits = []
    for where in (dev, torch.device("cpu")):
        model = qwen3next.Qwen3NextModel(cfg, _to_dev(params, where), dtype=dtype)
        caches = qwen3next.init_caches(cfg, 256, dtype, where)
        toks = torch.tensor(list(range(3, 43)) + [0] * 24, dtype=torch.int32, device=where)
        qwen3next.prefill_fn(cfg, model.params, caches, toks, 40)
        pos = torch.tensor([40], dtype=torch.int32, device=where)
        monkeypatch.setattr(qwen3next, "sdpa_fixed_cache_fn", traced)
        before = LAUNCHES["flash_decode"]
        _, out = qwen3next.decode_step_fn(cfg, model.params, caches, 7, pos)
        monkeypatch.setattr(qwen3next, "sdpa_fixed_cache_fn", real)
        assert LAUNCHES["flash_decode"] == before + (1 if where.type == "cuda" else 0)
        assert torch.isfinite(out).all()
        logits.append(out)
    (kernel, plain), _ = seen
    assert kernel.dtype == dtype and _attn_close(kernel, plain)
    assert _rel(logits[0], logits[1]) < (1e-2 if dtype == torch.bfloat16 else 1e-4)


def test_qwen3next_prefill_runs_its_experts_on_gmm(dev):
    """The bf16 2-layer Qwen3-Next with 64 experts top-10 on the card: a
    16-token prefill (T * k 160) launches gmm three times a MoE layer and
    no gather; its MoE block through gmm_experts against gather_experts on
    the same routing within 1e-2 relative L2 (both f32 sums of bf16
    products, in another order); the logits finite."""
    from pygpukit_tpu_torch.ops import moe
    qwen3next, cfg, params = _qwen3next_2layer(torch.bfloat16, moe=True)
    model = qwen3next.Qwen3NextModel(cfg, _to_dev(params, dev), dtype=torch.bfloat16)
    caches = qwen3next.init_caches(cfg, 64, torch.bfloat16, dev)
    toks = torch.tensor(list(range(3, 17)) + [0] * 2, dtype=torch.int32, device=dev)
    before = _launches()
    _, logits = qwen3next.prefill_fn(cfg, model.params, caches, toks, 14)
    torch.cuda.synchronize()
    after = _launches()
    moved = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
    assert moved == {"gmm": 6} and torch.isfinite(logits).all()
    lp = model.params["layers"][1]
    x = torch.randn((16, cfg.hidden_size), generator=_gen(dev, 23), device=dev).to(torch.bfloat16)
    w, ids = qwen3next._router(cfg, lp, x)

    def act(outs, _):
        return (torch.nn.functional.silu(outs[0]) * outs[1]).to(x.dtype)
    stacks = ((lp["w_experts_gate"], lp["w_experts_up"]), lp["w_experts_down"])
    a = moe.gmm_experts(x, *stacks, w, ids, act)
    b = moe.gather_experts(x, *stacks, w, ids, act)
    assert _rel(a, b) < 1e-2


def test_whisper_on_the_card_matches_the_cpu(dev):
    """A tiny random Whisper (2 + 2 layers, width 64, 80 mel bins) on the
    card against the same params on the CPU, TF32 switched on outside the
    model (its f32 scope turns it off for cuBLAS and cuDNN): the features
    within 1e-3 absolute, the encoder output and the decoder logits within
    1e-4 relative L2, the greedy tokens identical; the greedy loop a CUDA
    graph replayed step by step, a second transcription the same tokens,
    the TF32 flags back on after, and no port kernel launched (the path
    has none)."""
    import numpy as np
    from pygpukit_tpu_torch.asr.whisper import WhisperConfig, WhisperModel
    from pygpukit_tpu_torch.asr.whisper import model as wm
    cfg = WhisperConfig(n_mels=80, d_model=64, encoder_layers=2, decoder_layers=2, n_heads=4,
                        vocab_size=256, max_target_positions=64, eos_token_id=3,
                        sot_token_id=2, ffn_dim=128)
    params = wm.init_params(cfg, 0, device="cpu")
    for k in params["dec_layers"]:
        if not k.startswith("ln"):
            params["dec_layers"][k] *= 10.0           # a greedy stream that varies
    cpu, card = WhisperModel(cfg, params), WhisperModel(cfg, _to_dev(params, dev))
    audio = (np.random.default_rng(25).standard_normal(24000) * 0.1).astype(np.float32)
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = _launches()
    try:
        mm.allow_tf32 = cudnn.allow_tf32 = True
        mel = card.compute_mel(audio)
        assert mel.is_cuda and (mel.cpu() - cpu.compute_mel(audio)).abs().max() < 1e-3
        feats = card.encode(mel)
        assert _rel(feats, cpu.encode(mel.cpu())) < 1e-4
        toks = [2, 7, 40, 41, 200]
        assert _rel(card.decoder_logits(toks, feats),
                    cpu.decoder_logits(toks, feats.cpu())) < 1e-4
        got = card.transcribe_tokens(audio, [2, 9], max_new_tokens=12)
        assert got == cpu.transcribe_tokens(audio, [2, 9], max_new_tokens=12)
        assert got == card.transcribe_tokens(audio, [2, 9], max_new_tokens=12)
        assert (mm.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        mm.allow_tf32 = cudnn.allow_tf32 = False
    assert len(set(got)) > 2
    (exe,) = card.graphs.executables().values()
    assert exe.node_count > 0 and exe.stats.replays == 2 * (2 + 12 + 1 - 1)
    assert _launches() == before


def test_kokoro82m_on_the_card_matches_the_cpu(dev, monkeypatch):
    """A tiny Kokoro-82M tree (init_random_flat, seed 3) on the card against
    the same tree on the CPU, TF32 switched on outside the model (its f32
    scope turns it off for cuBLAS and cuDNN), the same sine-source draws on
    both: the float durations within 1e-4, the rounded ones and the true
    frame count equal, the audio within 1e-4 relative L2 with the STFT
    phase's branch cut read on one side (-pi as +pi: the end frames'
    spectra are real up to rounding, tests/test_torch_kokoro.py); the
    captured program replayed bitwise a second time, the flags back on
    after, no port kernel launched (the path has none)."""
    import math
    from pygpukit_tpu_torch.ops.precision import f32_matmul_context
    from pygpukit_tpu_torch.tts.kokoro import Kokoro82M, arch, checkpoint
    d = checkpoint.KokoroDims()
    d.hidden_dim, d.max_dur, d.albert_emb, d.albert_hidden = 32, 8, 16, 24
    d.albert_heads, d.albert_ffn, d.albert_layers, d.albert_max_pos = 4, 32, 2, 64
    d.dec_hidden, d.gen_ch = 48, 16
    flat = checkpoint.init_random_flat(d, seed=3, scale=0.05)
    stft = arch._stft_mag_phase

    def one_side(*a):
        mag, ph = stft(*a)
        return mag, torch.where(ph < -math.pi + 1e-4, ph + 2 * math.pi, ph)
    monkeypatch.setattr(arch, "_stft_mag_phase", one_side)
    cpu = Kokoro82M(checkpoint.load_params(flat, d, device="cpu"), d, device="cpu")
    card = Kokoro82M(checkpoint.load_params(flat, d, device=dev), d, device=dev)
    ids = torch.tensor([10, 43, 57, 61, 47, 50, 83], dtype=torch.int32)
    ref_s = torch.randn(256, generator=_gen("cpu", 4)) * 0.3
    draws = cpu.draws(len(ids), seed=5)
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = _launches()
    try:
        mm.allow_tf32 = cudnn.allow_tf32 = True
        out = card.forward(ids.to(dev), ref_s.to(dev), 1.0, [t.to(dev) for t in draws])
        again = card.forward(ids.to(dev), ref_s.to(dev), 1.0, [t.to(dev) for t in draws])
        want = cpu.forward(ids, ref_s, 1.0, draws)

        def durations(m, where):
            p = m.params
            with f32_matmul_context(p):
                ids_b = torch.cat([torch.zeros(1, dtype=torch.int32), ids, torch.zeros(
                    1, dtype=torch.int32)]).to(where)
                bert = arch.albert_forward(ids_b, p["bert"], n_layers=2, n_heads=4)
                d_en = arch.linear(bert, p["bert_encoder"]).T[None]
                return arch.predict_durations(d_en, ref_s.to(where)[128:], p["predictor"],
                                              1.0)[1]
        dur_card, dur_cpu = durations(card, dev), durations(cpu, "cpu")
        assert (mm.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        mm.allow_tf32 = cudnn.allow_tf32 = False
    assert torch.allclose(dur_card.cpu(), dur_cpu, rtol=1e-4, atol=0)
    assert torch.equal(out[1].cpu(), want[1]) and int(out[2]) == int(want[2])
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert torch.isfinite(out[0]).all() and _rel(out[0], want[0]) < 1e-4
    (exe,) = card.graphs.executables().values()
    assert exe.node_count > 0 and exe.stats.replays == 2
    assert _launches() == before


def test_diffusion_on_the_card_matches_the_cpu(dev):
    """A tiny FLUX pipeline (a bf16 transformer promoting to f32 products,
    an f32 VAE) on the card against the same weights on the CPU, TF32
    switched on outside (the pipeline's scope and the VAE's own turn it
    off for cuBLAS and cuDNN): text to image at 3 steps and img2img at 2,
    the same latents and noise on both sides, within 1e-4 relative L2 and
    images within one level; the denoise loops CUDA graphs replayed
    bitwise a second time; the VAE alone (decode and encode, no pipeline
    scope) within 1e-4 too; the flags back on after, no port kernel
    launched (the path has none)."""
    import numpy as np
    from pygpukit_tpu_torch.diffusion import FluxPipeline
    from pygpukit_tpu_torch.diffusion.models.flux import FluxConfig, FluxTransformer
    from pygpukit_tpu_torch.diffusion.models.vae import VAE, VAEConfig
    fcfg = FluxConfig(in_channels=16, hidden_size=64, num_heads=4, depth=2, depth_single=2,
                      context_dim=32, pooled_dim=24, axes_dim=(4, 6, 6), guidance_embed=False)
    vcfg = VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_groups=4,
                     latent_channels=4, scaling_factor=0.3611, shift_factor=0.1159)
    tr = FluxTransformer.init_random(fcfg, seed=0, dtype=torch.bfloat16, device="cpu")
    v = VAE.init_random(vcfg, seed=1, device="cpu")
    cpu = FluxPipeline(tr, v)
    card = FluxPipeline(FluxTransformer(fcfg, _to_dev(tr.params, dev)),
                        VAE(vcfg, _to_dev(v.params, dev)))
    g = _gen("cpu", 2)
    lat, noise = torch.randn((4, 8, 8), generator=g), torch.randn((4, 8, 8), generator=g)
    txt, pooled = torch.randn((12, 32), generator=g), torch.randn((24,), generator=g)
    # the tiny VAE halves once: a 16 x 16 image is an 8 x 8 latent
    image = np.random.default_rng(3).integers(0, 255, (16, 16, 3), dtype=np.uint8)
    z, x = torch.randn((2, 4, 8, 8), generator=g), torch.rand((1, 3, 16, 16), generator=g)
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = _launches()
    try:
        mm.allow_tf32 = cudnn.allow_tf32 = True
        runs = [card(height=64, width=64, num_inference_steps=3, txt_embeds=txt.to(dev),
                     pooled=pooled.to(dev), latents=lat.to(dev)) for _ in range(2)]
        i2i = [card.img2img(image, strength=0.5, num_inference_steps=4, txt_embeds=txt,
                            pooled=pooled, noise=noise.to(dev)) for _ in range(2)]
        dec, enc = card.vae.decode(z.to(dev)), card.vae.encode(x.to(dev), noise=z[:1])
        assert (mm.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        mm.allow_tf32 = cudnn.allow_tf32 = False
    want = cpu(height=64, width=64, num_inference_steps=3, txt_embeds=txt, pooled=pooled,
               latents=lat)
    want_i2i = cpu.img2img(image, strength=0.5, num_inference_steps=4, txt_embeds=txt,
                           pooled=pooled, noise=noise)
    for got, ref in ((runs, want), (i2i, want_i2i)):
        assert np.array_equal(got[0].latents, got[1].latents)
        assert np.array_equal(got[0].images, got[1].images)
        assert _rel(torch.from_numpy(got[0].latents), torch.from_numpy(ref.latents)) < 1e-4
        assert np.abs(got[0].images.astype(int) - ref.images.astype(int)).max() <= 1
    assert _rel(dec, v.decode(z)) < 1e-4
    assert _rel(enc, v.encode(x, noise=z[:1])) < 1e-4
    exes = card.graphs.executables()
    assert len(exes) == 2 and all(e.node_count > 0 and e.stats.replays == 2
                                  for e in exes.values())
    assert _launches() == before
