"""The port's JIT front end, dispatch services and determinism harness
(``pygpukit_tpu_torch.{jit,dispatch,profiling.determinism}``) on the CPU.

The cases of tests/test_jit_dispatch.py run on the port (a compile is a
``core.capture``; on CPU tensors it records no graph and runs the function
once on clones of the donated arguments, so a broken function fails at
compile). ``run_sliced`` gives the reference's result on the same numpy
input (f32 products, rtol 1e-6 and atol 1e-6: another BLAS may sum in
another order). ``verify_strategy_equivalence``'s verdict and the M1
tokens equal the reference's on the same f32 model (``params_from_jax``).
The shared launch counters stay exact under two launching threads and a
third that keeps taking and restoring them as a capture does.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygpukit_tpu.dispatch import SliceConfig as RefSliceConfig
from pygpukit_tpu.dispatch import SliceScheduler as RefSliceScheduler
from pygpukit_tpu_torch.dispatch import (KernelCache, KernelPacingEngine, PacingConfig,
                                         PersistentCache, SliceConfig, SliceScheduler)
from pygpukit_tpu_torch.dispatch import cache as cache_mod
from pygpukit_tpu_torch.jit import (CompileError, CompileErrorCode, JITKernel,
                                    check_platform_compatibility, get_warmup_error,
                                    is_warmup_done, jit, reset_warmup_state, warmup)
from pygpukit_tpu_torch.jit.compiler import _classify
from pygpukit_tpu_torch.kernels import _build

@pytest.fixture(autouse=True, scope="module")
def _threads():
    """2 torch threads for this module's tests, the count put back after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=64, head_dim_override=8, max_position_embeddings=256,
            tie_word_embeddings=True)


class TestJIT:
    def test_decorator_and_launch(self):
        @jit
        def double(x):
            return x * 2

        out = double(torch.ones(4))
        assert torch.equal(out, torch.full((4,), 2.0))
        assert double.stats.compiles == 1
        double(torch.ones(4))
        assert double.stats.compiles == 1       # cached
        assert double.stats.launches == 2

    def test_per_signature_compile(self):
        k = JITKernel(lambda x: x + 1, name="inc")
        k(torch.ones(2))
        k(torch.ones(3))
        k(torch.ones(3, dtype=torch.float64))
        assert k.stats.compiles == 3

    def test_static_argnums(self):
        k = JITKernel(lambda x, n: x * n, static_argnums=(1,))
        assert torch.equal(k(torch.ones(2), 3), torch.full((2,), 3.0))
        assert torch.equal(k(torch.ones(2), 4), torch.full((2,), 4.0))
        assert k.stats.compiles == 2

    def test_call_copies_new_inputs_in(self):
        k = JITKernel(lambda x: x * 3)
        assert torch.equal(k(torch.arange(4.0)), torch.arange(4.0) * 3)
        assert torch.equal(k(torch.arange(4.0) + 1), (torch.arange(4.0) + 1) * 3)
        assert k.stats.compiles == 1

    def test_donated_state_is_bound_by_address(self):
        def step(state, x):
            state.add_(x)
            return state.sum()
        k = JITKernel(step, donate_argnums=(0,))
        s1 = torch.zeros(3)
        k.compile(s1, torch.ones(3))
        assert torch.equal(s1, torch.zeros(3))          # compiling left the state alone
        assert float(k(s1, torch.ones(3))) == 3.0
        assert float(k(s1, torch.ones(3))) == 6.0
        s2 = torch.zeros(3)                              # another state: another program
        assert float(k(s2, torch.ones(3))) == 3.0
        assert k.stats.compiles == 2

    def test_compile_error_classified(self):
        k = JITKernel(lambda x: x.bad_attr, name="broken")
        with pytest.raises(CompileError) as ei:
            k.compile(torch.ones(2))
        assert ei.value.code in (CompileErrorCode.INVALID_INPUT,
                                 CompileErrorCode.COMPILATION_FAILED)
        assert k.stats.compiles == 0

    def test_classify_knows_torch_errors(self):
        assert _classify(torch.cuda.OutOfMemoryError("CUDA out of memory")) \
            == CompileErrorCode.OUT_OF_MEMORY
        assert _classify(ValueError("shape")) == CompileErrorCode.INVALID_INPUT
        assert _classify(RuntimeError("connection reset")) == CompileErrorCode.TRANSIENT
        assert _classify(RuntimeError("capture failed")) == CompileErrorCode.COMPILATION_FAILED

    def test_transient_errors_retry(self):
        calls = []

        def flaky(x):
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("UNAVAILABLE: try again")
            return x + 1
        k = JITKernel(flaky, backoff_s=0.0)
        k.compile(torch.ones(2))
        assert k.stats.compiles == 1 and len(calls) == 3

    def test_warmup_background(self):
        reset_warmup_state()
        k = JITKernel(lambda x: x - 1)
        t = warmup(k, torch.ones(4))
        t.join(timeout=120)
        assert k.stats.compiles == 1 and is_warmup_done() and get_warmup_error() is None
        k(torch.ones(4))
        assert k.stats.compiles == 1

    def test_warmup_keeps_the_first_error(self):
        reset_warmup_state()
        warmup(JITKernel(lambda x: x.nope), torch.ones(2)).join(120)
        err = get_warmup_error()
        assert isinstance(err, CompileError)
        warmup(JITKernel(lambda x: x + 1), torch.ones(2)).join(120)   # a new batch
        assert get_warmup_error() is None
        reset_warmup_state()

    def test_platform_probe(self):
        info = check_platform_compatibility()
        if torch.cuda.is_available():
            assert info["compatible"] and info["platform"] == "gpu" and info["devices"] >= 1
        else:
            assert not info["compatible"] and info["platform"] is None
            assert "no CUDA device" in info["error"]


class TestKernelCache:
    def test_hit_miss_evict(self):
        c = KernelCache(max_entries=2)
        k1 = c.make_key("src1")
        assert c.get(k1) is None
        c.put(k1, "a")
        assert c.get(k1) == "a"
        c.put(c.make_key("src2"), "b")
        c.put(c.make_key("src3"), "c")   # evicts the least recently used: src1
        assert c.stats.evictions == 1
        assert c.stats.entries == 2
        assert c.get(k1) is None and c.get(c.make_key("src2")) == "b"

    def test_get_or_compile(self):
        c = KernelCache()
        calls = []
        v = c.get_or_compile("s", (), lambda: calls.append(1) or "v")
        assert v == "v" and len(calls) == 1
        c.get_or_compile("s", (), lambda: calls.append(1) or "v")
        assert len(calls) == 1           # cached

    def test_keys_match_the_reference(self):
        from pygpukit_tpu.dispatch import KernelCache as RefKernelCache
        assert KernelCache.make_key("src", (1, "a")) == RefKernelCache.make_key("src", (1, "a"))


class TestPersistentCache:
    def test_record_lookup_fingerprint(self, tmp_path):
        pc = PersistentCache(cache_dir=str(tmp_path))
        assert pc.fingerprint == ("cpu" if not torch.cuda.is_available()
                                  else pc.fingerprint)
        pc.record("k1", {"note": "x"})
        assert pc.lookup("k1") is not None
        pc._index["k2"] = {"fingerprint": "gpu:Other Card:sm_80", "time": 0}
        assert pc.lookup("k2") is None     # written on another device
        pc.invalidate("k1")
        assert pc.lookup("k1") is None
        assert "dir" in pc.stats()
        assert PersistentCache(cache_dir=str(tmp_path)).lookup("k2") is None

    def test_indexes_a_kernel_library(self, tmp_path):
        lib = tmp_path / "libpgk_kernels_0123456789abcdef.so"
        lib.write_bytes(b"\0" * 64)
        pc = PersistentCache(cache_dir=str(tmp_path / "idx"))
        key = pc.record_library(lib)
        ent = PersistentCache(cache_dir=str(tmp_path / "idx")).lookup(key)
        assert ent["path"] == str(lib) and ent["bytes"] == 64
        lib.unlink()
        assert pc.lookup(key) is None       # the file is gone

    def test_default_dir_is_the_ports_own(self, tmp_path, monkeypatch):
        monkeypatch.delenv("PYGPUKIT_COMPILE_CACHE", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path))
        pc = PersistentCache()
        assert pc.cache_dir == tmp_path / ".cache" / "pygpukit_tpu_torch"
        assert pc.index_path.name == cache_mod.INDEX_NAME
        monkeypatch.setenv("PYGPUKIT_COMPILE_CACHE", str(tmp_path / "c"))
        assert PersistentCache().cache_dir == tmp_path / "c"


class TestPacing:
    def test_throttles(self):
        eng = KernelPacingEngine(PacingConfig(window_s=0.05, max_launches_per_window=2))
        t0 = time.monotonic()
        for _ in range(5):
            assert eng.admit()
        assert eng.stats.throttled >= 1
        assert time.monotonic() - t0 >= 0.05           # at least one window wait

    def test_nonblocking_reject(self):
        eng = KernelPacingEngine(PacingConfig(window_s=10.0, max_launches_per_window=1))
        assert eng.admit(block=False)
        assert not eng.admit(block=False)


class TestSlicing:
    def test_sliced_matches_full(self):
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((100, 8)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
        yields = []
        sched = SliceScheduler(SliceConfig(slice_rows=32, yield_fn=lambda: yields.append(1)))
        out = sched.run_sliced(lambda a: a @ w, x)
        torch.testing.assert_close(out, x @ w, rtol=1e-5, atol=1e-6)
        assert sched.stats.slices == 4
        assert len(yields) == 4

    @pytest.mark.parametrize("axis,rows", [(0, 32), (1, 3), (0, 200)])
    def test_matches_the_reference(self, axis, rows):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((100, 8)).astype(np.float32)
        w = rng.standard_normal((8, 8)).astype(np.float32)
        ref = RefSliceScheduler(RefSliceConfig(slice_rows=rows)).run_sliced(
            lambda a: jnp.tanh(a) @ w if axis == 0 else jnp.tanh(a) * 2.0,
            jnp.asarray(x), axis=axis)
        port_sched = SliceScheduler(SliceConfig(slice_rows=rows))
        out = port_sched.run_sliced(
            lambda a: torch.tanh(a) @ torch.from_numpy(w) if axis == 0 else torch.tanh(a) * 2.0,
            torch.from_numpy(x), axis=axis)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
        assert port_sched.stats.slices == -(-x.shape[axis] // rows)


class TestDeterminismHarness:
    def test_bitwise_replay(self):
        from pygpukit_tpu_torch.profiling import verify_bitwise_replay
        f = JITKernel(lambda x: torch.tanh(x @ x))
        rep = verify_bitwise_replay(f, torch.ones(16, 16))
        assert rep and rep.runs == 3

    def test_replay_that_drifts_is_caught(self):
        from pygpukit_tpu_torch.profiling import verify_bitwise_replay
        state = torch.zeros(2)

        def drift(x):
            state.add_(1e-3)
            return x + state
        rep = verify_bitwise_replay(drift, torch.ones(2))
        assert not rep and rep.runs == 2

    def test_recompile_parity(self):
        from pygpukit_tpu_torch.profiling import verify_recompile_parity
        x = torch.linspace(0, 1, 64).reshape(8, 8)
        assert verify_recompile_parity(lambda: JITKernel(lambda a: torch.exp(a) @ a), x)

    def test_leaves_compare_as_bits(self):
        from pygpukit_tpu_torch.profiling.determinism import _leaves_equal
        a = torch.tensor([1.0, 2.0], dtype=torch.bfloat16)
        b = a.clone()
        assert _leaves_equal({"x": a, "n": np.arange(3)}, {"x": b, "n": np.arange(3)})
        b.view(torch.int16)[0] += 1                       # one bf16 ulp
        assert not _leaves_equal({"x": a}, {"x": b})
        assert not _leaves_equal(a, a.float())            # same values, other dtype
        assert not _leaves_equal(np.zeros(2), np.zeros(3))
        assert not _leaves_equal(torch.tensor([0.0]), torch.tensor([-0.0]))

    def test_strategy_equivalence_matches_the_reference(self):
        from pygpukit_tpu.llm import CausalTransformerModel as RefModel
        from pygpukit_tpu.llm import TransformerConfig as RefConfig
        from pygpukit_tpu.llm import decode as ref_decode
        from pygpukit_tpu.llm.model import init_params as ref_init_params
        from pygpukit_tpu.profiling import verify_strategy_equivalence as ref_verify
        from pygpukit_tpu_torch.llm import (CausalTransformerModel, TransformerConfig,
                                            params_from_jax)
        from pygpukit_tpu_torch.llm import decode as port_decode
        from pygpukit_tpu_torch.profiling import verify_strategy_equivalence
        jparams = ref_init_params(RefConfig(**TINY), 9, jnp.float32)
        rm = RefModel(RefConfig(**TINY), jparams, dtype=jnp.float32)
        pm = CausalTransformerModel(TransformerConfig(**TINY),
                                    params_from_jax(jax.tree.map(np.asarray, jparams)),
                                    dtype=torch.float32)
        want = ref_verify(rm, [3, 7], n_tokens=8)
        got = verify_strategy_equivalence(pm, [3, 7], n_tokens=8)
        assert bool(got) == bool(want) and got.runs == want.runs, (got, want)
        rm.init_fixed_cache(256)
        pm.init_fixed_cache(256)
        assert (port_decode.DecodeM1().bind(pm).generate([3, 7], 8)
                == ref_decode.DecodeM1().bind(rm).generate([3, 7], 8))


def test_launch_counters_stay_exact_under_threads(monkeypatch):
    """Two threads launch 20 000 times each while a third keeps doing what a
    capture does to the counters (take them, launch inside, put them back):
    every outside launch is counted, none of the inside ones."""
    class FakeLib:
        @staticmethod
        def pgk_gemm(*_):
            return 0
    monkeypatch.setattr(_build, "library", lambda: FakeLib)
    _build.reset_launches()
    stop = threading.Event()

    def launcher():
        for _ in range(20_000):
            _build.launch("gemm", "pgk_gemm")

    def capturer():
        while not stop.is_set():
            with _build.launches_restored():
                for _ in range(5):
                    _build.launch("gemm", "pgk_gemm")
                _build.count("kv_rows_write_fused")

    cap = threading.Thread(target=capturer)
    cap.start()
    workers = [threading.Thread(target=launcher) for _ in range(2)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    stop.set()
    cap.join()
    assert _build.LAUNCHES["gemm"] == 40_000
    assert _build.LAUNCHES["kv_rows_write_fused"] == 0
    _build.reset_launches()
