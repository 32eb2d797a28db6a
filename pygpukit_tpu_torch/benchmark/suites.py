"""Benchmark suites: gemm, gemv, attention, decode, moe, serving
(counterpart of ``pygpukit_tpu/benchmark/suites.py``), on the reference's
shapes and presets. Operands are drawn from seeded generators on the
suite's device. The constructor arguments past the reference's (a
``config``, token and request counts, ``shapes``) exist so that tests can
run every suite at a tiny size on the CPU; the CLI uses the defaults.
"""

from __future__ import annotations

import time

import torch

from .base import Benchmark, BenchResult, time_fn

_BF16 = torch.bfloat16
_E4M3 = getattr(torch, "float8_e4m3fn", None)


def _normal(shape, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32)


class GemmBenchmark(Benchmark):
    title = "GEMM (dense + quantized)"

    def __init__(self, sizes=(2048, 4096, 8192), dtypes=("bfloat16", "float32"),
                 device=None):
        super().__init__(device)
        self.sizes = sizes
        self.dtypes = dtypes

    def run(self) -> None:
        from ..ops.matmul import _dot
        dev = self._device()
        for n in self.sizes:
            a32 = _normal((n, n), 0, dev)
            for dt in self.dtypes:
                a = a32.to(getattr(torch, dt))
                ms = time_fn(_dot, a, a)
                size = a.element_size()
                self.results.append(BenchResult(
                    f"gemm {n}x{n} {dt}", ms, flops=2 * n**3,
                    bytes=2 * n * n * size + n * n * size))
            # fp8-stored weights (w8a16: bf16 activations x fp8 weights)
            w8, act = a32.to(_E4M3), a32.to(_BF16)
            ms = time_fn(lambda x, w: _dot(x, w.to(_BF16)), act, w8)
            self.results.append(BenchResult(
                f"gemm {n}x{n} w8a16(fp8)", ms, flops=2 * n**3,
                bytes=n * n * 2 + n * n * 1 + n * n * 2))


class GemvBenchmark(Benchmark):
    title = "GEMV (decode M=1) — bandwidth-bound"

    # the reference's shapes (BASELINE.md): Qwen2.5-7B gate/down proj + hidden
    SHAPES = [(2048, 8192), (4096, 14336), (3584, 18944), (18944, 3584),
              (4096, 4096)]

    def __init__(self, shapes=None, device=None):
        super().__init__(device)
        self.shapes = shapes or self.SHAPES

    def run(self) -> None:
        dev = self._device()
        for k, n in self.shapes:
            w = _normal((n, k), 1, dev).to(_BF16)
            x = _normal((k,), 1, dev).to(_BF16)
            ms = time_fn(torch.mv, w, x, iters=50)
            self.results.append(BenchResult(f"gemv bf16 K={k} N={n}", ms, bytes=n * k * 2))
            w8 = w.to(_E4M3)
            ms = time_fn(lambda w, x: torch.mv(w.to(_BF16), x), w8, x, iters=50)
            self.results.append(BenchResult(f"gemv w8a16 K={k} N={n}", ms, bytes=n * k * 1))


class AttentionBenchmark(Benchmark):
    title = "Attention (prefill)"

    def __init__(self, shapes=((1024, 32, 128), (4096, 32, 128)), device=None):
        super().__init__(device)
        self.shapes = shapes

    def run(self) -> None:
        from ..ops.nn.attention import flash_attention_fn, sdpa_causal_fn
        dev = self._device()
        for s, h, d in self.shapes:
            q, k, v = (_normal((s, h, d), 2, dev).to(_BF16) for _ in range(3))
            flops = 4 * h * s * s * d  # QK^T + PV, causal ~ /2 then *2 passes
            ms = time_fn(sdpa_causal_fn, q, k, v, iters=10)
            self.results.append(BenchResult(f"sdpa_causal S={s} H={h} D={d}", ms,
                                            flops=flops // 2))
            ms = time_fn(lambda q, k, v: flash_attention_fn(q, k, v, chunk_size=512),
                         q, k, v, iters=10)
            self.results.append(BenchResult(f"flash(chunked) S={s} H={h} D={d}", ms,
                                            flops=flops // 2))


def _timed_generate(model, prompt: list[int], warm_new: int, new: int, max_seq_len: int,
                    chunk: int) -> tuple[float, int]:
    """(seconds, tokens) of one greedy generate after a warm one, which
    captures the prefill and chunk programs. The timed run keeps the cache
    (its prefill starts again at position 0): ``init_fixed_cache`` would
    release the programs, where the reference's compiled ones stay."""
    model.init_fixed_cache(max_seq_len)
    model.generate(prompt, max_new_tokens=warm_new, chunk_size=chunk)
    t0 = time.perf_counter()
    out = model.generate(prompt, max_new_tokens=new, chunk_size=chunk)
    return time.perf_counter() - t0, len(out)


class DecodeBenchmark(Benchmark):
    title = "End-to-end decode (random-weight model)"

    def __init__(self, preset: str = "small", config=None, new_tokens: int = 256,
                 max_seq_len: int = 1024, device=None):
        super().__init__(device)
        self.preset = preset
        self.config = config
        self.new_tokens = new_tokens
        self.max_seq_len = max_seq_len

    def run(self) -> None:
        from ..llm.config import TransformerConfig
        from ..llm.model import CausalTransformerModel, init_params
        presets = {
            # about GPT-2-124M
            "small": TransformerConfig(
                vocab_size=50257, hidden_size=768, num_layers=12,
                num_heads=12, intermediate_size=3072, norm_type="layernorm",
                activation="gelu", use_rope=False, use_position_embed=True,
                max_position_embeddings=1024),
            # about 1B
            "1b": TransformerConfig(
                vocab_size=32000, hidden_size=2048, num_layers=22,
                num_heads=32, num_kv_heads=4, intermediate_size=5632,
                max_position_embeddings=2048),
        }
        cfg = self.config or presets[self.preset]
        params = init_params(cfg, seed=0, dtype=_BF16, device=self._device())
        model = CausalTransformerModel(cfg, params, dtype=_BF16)
        chunk = min(64, self.new_tokens)
        dt, n = _timed_generate(model, list(range(1, 17)), chunk + 1, self.new_tokens + 1,
                                self.max_seq_len, chunk)
        tps = n / dt
        self.results.append(BenchResult(f"decode {self.preset} tok/s={tps:.1f}",
                                        dt * 1e3 / n, extra={"tokens_per_s": tps}))


class MoEBenchmark(Benchmark):
    """Mixtral-arch decode through the token-count-routed MoE dispatch
    (``ops.moe.select_moe_fn``: the expert gather at decode)."""
    title = "MoE decode (Mixtral-arch, 8 experts top-2)"

    def __init__(self, config=None, new_tokens: int = 128, device=None):
        super().__init__(device)
        self.config = config
        self.new_tokens = new_tokens

    def run(self) -> None:
        from ..llm.config import TransformerConfig
        from ..llm.model import CausalTransformerModel, init_params
        cfg = self.config or TransformerConfig(
            vocab_size=32000, hidden_size=1024, num_layers=8, num_heads=16,
            num_kv_heads=8, intermediate_size=3584,
            max_position_embeddings=2048, num_experts=8,
            num_experts_per_tok=2, moe_intermediate_size=1792)
        params = init_params(cfg, seed=0, dtype=_BF16, device=self._device())
        model = CausalTransformerModel(cfg, params, dtype=_BF16)
        chunk = min(32, self.new_tokens)
        dt, n = _timed_generate(model, list(range(1, 9)), chunk + 1, self.new_tokens + 1,
                                512, chunk)
        tps = n / dt
        self.results.append(BenchResult(f"moe decode tok/s={tps:.1f}", dt * 1e3 / n,
                                        extra={"tokens_per_s": tps}))


class ServingBenchmark(Benchmark):
    """Continuous-batching aggregate throughput: pipelined, paged and
    dense engines (``llm.serving``)."""
    title = "Continuous-batching serving (batch 8, 128-tok requests)"

    def __init__(self, config=None, requests: int = 16, new_tokens: int = 128,
                 max_seq_len: int = 1024, device=None):
        super().__init__(device)
        self.config = config
        self.requests = requests
        self.new_tokens = new_tokens
        self.max_seq_len = max_seq_len

    def run(self) -> None:
        from ..llm.config import TransformerConfig
        from ..llm.model import CausalTransformerModel, fuse_params, init_params
        from ..llm.serving import ContinuousBatchingEngine
        cfg = self.config or TransformerConfig(
            vocab_size=32000, hidden_size=1024, num_layers=8, num_heads=16,
            num_kv_heads=8, intermediate_size=2816,
            max_position_embeddings=2048)
        params = fuse_params(init_params(cfg, seed=0, dtype=_BF16, device=self._device()))
        model = CausalTransformerModel(cfg, params, dtype=_BF16)
        prompt = list(range(1, 17))
        warm_new = min(32, self.new_tokens)
        for label, kw in (("pipelined", {"pipelined": True}),
                          ("paged", {"paged": True, "block_size": 16}),
                          ("dense", {})):
            eng = ContinuousBatchingEngine(model, max_batch=8, max_seq_len=self.max_seq_len,
                                           steps_per_dispatch=16, **kw)
            for _ in range(2):                       # warm, the wave programs too
                for _ in range(9):
                    eng.submit(prompt, max_new_tokens=warm_new)
                eng.run_until_complete()
            reqs = [eng.submit(prompt, max_new_tokens=self.new_tokens)
                    for _ in range(self.requests)]
            t0 = time.perf_counter()
            eng.run_until_complete()
            dt = time.perf_counter() - t0
            toks = sum(len(r.generated) for r in reqs)
            self.results.append(BenchResult(f"serving {label} tok/s={toks / dt:.1f}",
                                            dt * 1e3, extra={"tokens_per_s": toks / dt}))


SUITES = {
    "gemm": GemmBenchmark,
    "gemv": GemvBenchmark,
    "attention": AttentionBenchmark,
    "decode": DecodeBenchmark,
    "moe": MoEBenchmark,
    "serving": ServingBenchmark,
}
