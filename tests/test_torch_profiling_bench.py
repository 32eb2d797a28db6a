"""The port's profiler, memory profiler and benchmark suites
(``pygpukit_tpu_torch.{profiling,benchmark}``) on the CPU.

``BenchResult`` and ``KernelRecord`` derive the reference's TFLOP/s and
GB/s from the same numbers (exactly: the same float expressions);
``report_markdown``'s rows equal the reference's, apart from the device
line (both on the CPU's nominal peaks). Every suite's ``run()`` runs once
at a tiny size (the constructor arguments past the reference's) so that a
broken suite shows here and not only on the card; the CLI's ``main`` takes
its arguments in-process.
"""

import json
import os

import pytest
import torch

from pygpukit_tpu.benchmark.base import Benchmark as RefBenchmark
from pygpukit_tpu.benchmark.base import BenchResult as RefBenchResult
from pygpukit_tpu.profiling.profiler import KernelRecord as RefKernelRecord
from pygpukit_tpu_torch.benchmark import SUITES, Benchmark, BenchResult, time_fn
from pygpukit_tpu_torch.benchmark import __main__ as cli
from pygpukit_tpu_torch.benchmark import suites
from pygpukit_tpu_torch.core import backend
from pygpukit_tpu_torch.llm import TransformerConfig
from pygpukit_tpu_torch.profiling import (KernelRecord, MemoryProfiler, Profiler,
                                          get_profile_stats, get_profiler, profile_matmul)

@pytest.fixture(autouse=True, scope="module")
def _threads():
    """1 torch thread for this module's tests, the count put back after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


NUMBERS = [("a", 2.0, 10**9, 10**6), ("b", 0.5, 0, 10**8), ("c", 0.0, 5, 7),
           ("d", 1.234567, 3 * 10**12, 4 * 10**9), ("e", 1e-3, 12345, 0)]
TINY = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4, num_kv_heads=2,
            intermediate_size=64, head_dim_override=8, max_position_embeddings=256)


@pytest.fixture
def cpu_backend():
    backend.set_backend("cpu")
    yield
    backend.reset_backend()


@pytest.mark.parametrize("name,ms,flops,nbytes", NUMBERS)
def test_derivations_match_the_reference(name, ms, flops, nbytes):
    for port_cls, ref_cls in ((BenchResult, RefBenchResult), (KernelRecord, RefKernelRecord)):
        p, r = port_cls(name, ms, flops, nbytes), ref_cls(name, ms, flops, nbytes)
        assert (p.tflops, p.gbps) == (r.tflops, r.gbps)
    assert KernelRecord(name, ms).us == RefKernelRecord(name, ms).us


def test_report_rows_match_the_reference(cpu_backend):
    from pygpukit_tpu.core import backend as ref_backend
    ref_backend.set_backend("cpu")
    port_b, ref_b = Benchmark(), RefBenchmark()
    port_b.results = [BenchResult(*n) for n in NUMBERS if n[1]]
    ref_b.results = [RefBenchResult(*n) for n in NUMBERS if n[1]]
    port_lines, ref_lines = port_b.report_markdown().split("\n"), ref_b.report_markdown().split("\n")
    assert len(port_lines) == len(ref_lines) == 6 + len(port_b.results)
    for i, (p, r) in enumerate(zip(port_lines, ref_lines)):
        if p.startswith("Device:"):
            assert p == "Device: cpu (peak 1 bf16 TFLOPS, 50 GB/s HBM)"
        else:
            assert p == r, i


def test_time_fn_replays_a_capture(cpu_backend):
    calls = []

    def f(x):
        calls.append(1)
        return x * 2
    ms = time_fn(f, torch.ones(4), iters=5, warmup=2)
    assert ms > 0 and len(calls) == 7          # a CPU capture runs nothing itself


def _tiny_suite(name: str):
    cfg = TransformerConfig(**TINY)
    return {
        "gemm": lambda: suites.GemmBenchmark(sizes=(32,)),
        "gemv": lambda: suites.GemvBenchmark(shapes=[(32, 48), (48, 16)]),
        "attention": lambda: suites.AttentionBenchmark(shapes=((40, 4, 16),)),
        "decode": lambda: suites.DecodeBenchmark(config=cfg, new_tokens=4, max_seq_len=64),
        "moe": lambda: suites.MoEBenchmark(
            config=TransformerConfig(**TINY, num_experts=4, num_experts_per_tok=2,
                                     moe_intermediate_size=32), new_tokens=4),
        "serving": lambda: suites.ServingBenchmark(config=cfg, requests=2, new_tokens=2,
                                                   max_seq_len=32),
    }[name]()


@pytest.mark.parametrize("name", list(SUITES))
def test_each_suite_runs_on_the_cpu(name, cpu_backend):
    suite = _tiny_suite(name)
    assert isinstance(suite, SUITES[name])
    suite.run()
    want = {"gemm": 3, "gemv": 4, "attention": 2, "decode": 1, "moe": 1, "serving": 3}[name]
    assert len(suite.results) == want
    assert all(r.ms > 0 for r in suite.results)
    if name in ("decode", "moe", "serving"):
        assert all(r.extra["tokens_per_s"] > 0 for r in suite.results)
    table = suite.report_markdown()
    assert table.startswith(f"## {suite.title}") and table.count("\n| ") == want + 1


def test_cli_main_in_process(cpu_backend, monkeypatch, capsys):
    monkeypatch.setitem(cli.SUITES, "gemm",
                        lambda sizes=(32,): suites.GemmBenchmark(sizes=sizes, dtypes=("float32",)))
    assert cli.main(["gemm", "--sizes", "16", "24"]) == 0
    out = capsys.readouterr().out
    assert "gemm 16x16 float32" in out and "gemm 24x24 w8a16(fp8)" in out
    with pytest.raises(SystemExit):
        cli.main(["nope"])


def test_profiler_records_and_sums(cpu_backend):
    prof = Profiler()
    with prof.record("off"):
        pass
    assert prof.records == []                  # nothing while disabled
    prof.enable()
    for _ in range(2):
        with prof.record("mm", flops=2 * 8**3, bytes=3 * 8 * 8 * 4) as h:
            h["result"] = torch.ones(8, 8) @ torch.ones(8, 8)
    rec = prof.profile_fn("add", torch.add, torch.ones(4), torch.ones(4), iters=3)
    assert rec.count == 3 and rec.ms > 0
    st = prof.stats()
    assert st["mm"].count == 2 and st["mm"].flops == 2 * 2 * 8**3
    assert prof.summary().splitlines()[0].startswith("name")
    prof.reset()
    assert prof.stats() == {}


def test_profile_matmul_keeps_the_f32_output(cpu_backend):
    rec = profile_matmul(16, 8, 24, "bfloat16")
    assert rec.name == "matmul_16x8x24_bfloat16" and rec.flops == 2 * 16 * 8 * 24
    assert rec.bytes == (16 * 24 + 24 * 8) * 2 + 16 * 8 * 4
    assert get_profile_stats()[rec.name] is not None and get_profiler() is not None
    from pygpukit_tpu_torch.profiling.profiler import _f32_product
    a = torch.randn(5, 7).to(torch.bfloat16)
    b = torch.randn(7, 3).to(torch.bfloat16)
    out = _f32_product(a, b)
    assert out.dtype == torch.float32
    assert torch.equal(out, a.float() @ b.float())   # exact bf16 products, f32 sums


def test_trace_writes_a_chrome_trace(tmp_path, cpu_backend):
    prof = Profiler()
    with prof.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.last_trace and os.path.dirname(prof.last_trace) == str(tmp_path)
    with open(prof.last_trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_memory_profiler_on_the_cpu(cpu_backend):
    from pygpukit_tpu_torch.memory import MemoryPool
    pool = MemoryPool(1 << 20, use_native=False)
    mp = MemoryProfiler(pool)
    mp.snapshot("a")
    pool.alloc(4096)
    s = mp.snapshot()
    assert s.label == "snap_1" and s.pool_stats["used_bytes"] == 4096
    assert mp.delta() == 0 and s.device_total > 0   # the CPU reports no used bytes
    assert "used GiB" in mp.summary()
