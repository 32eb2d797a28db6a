"""Every program the port captures, on the CPU, against the JAX package and
against the host-int paths they replace:

- ``prefill_fn`` with the true length a one-element tensor (and the rows
  written into a pool slot given as a tensor) gives bitwise the int path's
  logits and caches, on f32, bf16 and int8 caches;
- the dense engine (pipelined or not) and the paged engine give the
  reference engine's greedy streams on an int8-KV model, their slots and
  lengths uploaded as tensors; the dense pools hold the reference's int8
  rows and scales of layer 0 bit for bit (deeper layers take inputs that
  XLA's and torch's f32 CPU sums round apart, so their rows differ by
  quantization steps there), and a second engine's pools, dense or paged
  outside the trash block 0, bit for bit the first's;
- ``DecodeBatch`` on a model built with ``kv_dtype=int8`` gives the JAX
  ``DecodeBatch``'s tokens, with its pools in the model's dtype (the
  reference's);
- a host-read guard: a ``TorchDispatchMode`` that raises on
  ``aten._local_scalar_dense`` (what ``int()`` and ``.item()`` dispatch)
  wraps every captured program's calls (``Executable``'s CPU path), and
  the model's, the engines', ``DecodeBatch``'s and the separate draft's
  entry points run through it, greedy and sampled; each program the slice
  captures runs at least once;
- the weights are bound by address: a strategy rebound to another model of
  the same shapes leaves the first model's weights as they were, and a
  replay handed other weights raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pygpukit_tpu.llm import CausalTransformerModel as JaxModel
from pygpukit_tpu.llm import TransformerConfig as JaxConfig
from pygpukit_tpu.llm import init_params as jax_init_params
from pygpukit_tpu.llm.decode import DecodeBatch as JaxDecodeBatch
from pygpukit_tpu.llm.model import fuse_params as jax_fuse_params
from pygpukit_tpu.llm.serving import ContinuousBatchingEngine as JaxEngine
from pygpukit_tpu_torch.core import executable as executable_mod
from pygpukit_tpu_torch.llm import (CausalTransformerModel, ContinuousBatchingEngine,
                                    TransformerConfig, init_params, params_from_jax,
                                    prefill_fn, slice_layers)
from pygpukit_tpu_torch.llm.decode import DecodeBatch, DecodeSpeculative
from pygpukit_tpu_torch.llm.model import slot_cache
from pygpukit_tpu_torch.ops import sample_token_gpu
from pygpukit_tpu_torch.ops.embedding import kv_cache_zeros
from pygpukit_tpu_torch.ops.sampling import sampling_generator

torch.set_num_threads(2)

CPU = torch.device("cpu")
CFG = dict(vocab_size=97, hidden_size=48, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_size=96, head_dim_override=12,
           max_position_embeddings=256, tie_word_embeddings=False)
PROMPTS = [[5, 11, 42], [7, 3], [9, 9, 1, 4, 60, 2, 8], [1, 2], [13, 1, 6]]
N_NEW = [8, 8, 6, 9, 5]


def _pair(kv_dtype=None, seed=5):
    """(JAX model, port model) over identical f32 params, scaled up tenfold
    so greedy streams move (test_torch_paged's pair)."""
    jcfg = JaxConfig(**CFG)
    params = jax.tree.map(lambda a: a * 10.0 if a.ndim >= 2 else a,
                          jax_init_params(jcfg, seed, jnp.float32))
    jm = JaxModel(jcfg, jax_fuse_params(params), dtype=jnp.float32, kv_dtype=kv_dtype)
    tm = CausalTransformerModel(TransformerConfig(**CFG),
                                params_from_jax(jax.tree.map(np.asarray, jm.params)),
                                dtype=torch.float32, kv_dtype=kv_dtype)
    return jm, tm


@pytest.fixture(scope="module")
def int8_pair():
    return _pair("int8")


def _serve(engine_cls, model, **kw):
    kw = dict(dict(max_batch=3, max_seq_len=64, steps_per_dispatch=4), **kw)
    eng = engine_cls(model, **kw)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, N_NEW)]
    eng.run_until_complete()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs], eng


def _bits(t):
    if isinstance(t, dict):
        return [_bits(t["q"]), _bits(t["s"])]
    t = t.contiguous()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]).numpy()


def _jbits(a):
    if isinstance(a, dict):
        return [_jbits(a["q"]), _jbits(a["s"])]
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _same(a, b) -> bool:
    if isinstance(a, list):
        return all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and np.array_equal(a, b)


# ------------------------------------------------------- device true length --

@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n", [1, 5, 13, 16])
def test_prefill_device_true_len_is_the_int_path(kv, n):
    """``prefill_fn`` with ``true_len`` a one-element int32 tensor: the int
    path's logits and caches, bitwise; with the slot a tensor too, the rows
    land in that slot of a pool as the int path's slot view has them."""
    cfg = TransformerConfig(**CFG)
    dtype = torch.bfloat16 if kv == "bf16" else torch.float32
    kv_dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[kv]
    params = CausalTransformerModel(cfg, init_params(cfg, 3, dtype, CPU), dtype=dtype).params
    rng = np.random.default_rng(n)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, 16))
    shape = (cfg.num_layers, 32, cfg.num_kv_heads * cfg.head_dim)
    caches = [[kv_cache_zeros(shape, kv_dtype, device=CPU, merged=True) for _ in range(2)]
              for _ in range(2)]
    li = prefill_fn(cfg, params, *caches[0], tokens, n)
    lt = prefill_fn(cfg, params, *caches[1], tokens, torch.tensor([n], dtype=torch.int32))
    assert torch.equal(li, lt)
    assert all(_same(_bits(a), _bits(b)) for a, b in zip(*caches))
    pools = [[kv_cache_zeros((3,) + shape, kv_dtype, device=CPU, merged=True)
              for _ in range(2)] for _ in range(2)]
    li = prefill_fn(cfg, params, *(slot_cache(p, 2) for p in pools[0]), tokens, n)
    lt = prefill_fn(cfg, params, *pools[1], tokens, torch.tensor([n], dtype=torch.int32),
                    torch.tensor([2], dtype=torch.int32))
    assert torch.equal(li, lt)
    assert all(_same(_bits(a), _bits(b)) for a, b in zip(*pools))


# ------------------------------------------------------------------ engines --

@pytest.mark.parametrize("pipelined", [False, True])
def test_dense_engine_streams_and_int8_pools_match_reference(int8_pair, monkeypatch,
                                                             pipelined):
    """The dense engine on int8 KV, slots and lengths uploaded as tensors:
    the reference engine's greedy streams, its layer-0 int8 rows and bf16
    scales bit for bit in every slot, and a second engine's whole pools
    bit for bit the first's."""
    jm, tm = int8_pair
    monkeypatch.setenv("PYGPUKIT_SERVING_STEP", "batch")
    ref, jeng = _serve(JaxEngine, jm, pipelined=pipelined)
    got, eng = _serve(ContinuousBatchingEngine, tm, pipelined=pipelined)
    assert got == ref
    assert eng.graphs.executables()
    for tp, jp in ((eng.k_cache, jeng.k_cache), (eng.v_cache, jeng.v_cache)):
        jq = np.asarray(jp["q"]).reshape(tuple(tp["q"].shape))
        assert _same(_bits(tp["q"])[:, 0], _jbits(jq)[:, 0])
        assert _same(_bits(tp["s"])[:, 0], _jbits(np.asarray(jp["s"]))[:, 0])
    again, eng2 = _serve(ContinuousBatchingEngine, tm, pipelined=pipelined)
    assert again == got
    assert _same(_bits(eng.k_cache), _bits(eng2.k_cache))
    assert _same(_bits(eng.v_cache), _bits(eng2.v_cache))


@pytest.mark.parametrize("pipelined", [False, True])
def test_paged_engine_streams_match_reference(int8_pair, pipelined):
    """The paged engine on int8 KV, pipelined or not: the reference's
    non-pipelined paged streams; a second engine's pools outside the trash
    block 0 bit for bit the first's."""
    jm, tm = int8_pair
    kw = dict(paged=True, block_size=8, pipelined=pipelined)
    ref, _ = _serve(JaxEngine, jm, **dict(kw, pipelined=False))
    got, eng = _serve(ContinuousBatchingEngine, tm, **kw)
    assert got == ref
    again, eng2 = _serve(ContinuousBatchingEngine, tm, **kw)
    assert again == got
    for a, b in ((eng.k_cache, eng2.k_cache), (eng.v_cache, eng2.v_cache)):
        assert _same(_bits(a["q"][:, 1:]), _bits(b["q"][:, 1:]))
        assert _same(_bits(a["s"][:, 1:]), _bits(b["s"][:, 1:]))


# -------------------------------------------------------------- DecodeBatch --

def test_decode_batch_int8_model_matches_reference():
    """DecodeBatch on a model built with ``kv_dtype=int8``: the JAX
    DecodeBatch's greedy tokens, with pools in the model's f32 (the
    reference allocates them in ``model.dtype``)."""
    jm, tm = _pair("int8")
    prompts = [[5, 11, 42], [7, 3, 9, 9, 1], [13, 1]]
    ref = JaxDecodeBatch(max_seq_len=64).bind(jm).generate(prompts, 10)
    strat = DecodeBatch(max_seq_len=64).bind(tm)
    got = strat.generate(prompts, 10)
    assert got == ref
    assert strat.k_cache.dtype == tm.dtype == torch.float32
    pools = strat.k_cache
    assert strat.generate(prompts, 10) == ref and strat.k_cache is pools


# --------------------------------------------------------- host-read guard --

class NoHostReads(TorchDispatchMode):
    """Raises on a host read of a tensor's value (``int()``, ``.item()``):
    what fails a CUDA-graph capture on the card."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a host read inside a captured program")
        return func(*args, **(kwargs or {}))


def test_guard_catches_host_reads():
    t = torch.tensor([3])
    for read in (int, lambda x: x.item()):
        with pytest.raises(AssertionError, match="host read"):
            with NoHostReads():
                read(t)


@pytest.fixture
def guarded(monkeypatch):
    """Run every captured program's CPU calls (the call that counts its
    operations, asked for at capture here, and each replay) under
    NoHostReads; yields the names of the programs that ran."""
    ran: set = set()
    init, replay = executable_mod.Executable.__init__, executable_mod.Executable.replay

    def guarded_fn(name, fn):
        def call(*a, **k):
            with NoHostReads():
                out = fn(*a, **k)
            ran.add(name)
            return out
        return call

    def new_init(self, fn, *args, **kw):
        init(self, guarded_fn(kw.get("name", "executable"), fn), *args, **kw)
        assert self.node_count > 0         # a CPU capture runs fn when its count is read

    monkeypatch.setattr(executable_mod.Executable, "__init__", new_init)
    monkeypatch.setattr(executable_mod.Executable, "replay", replay)
    monkeypatch.setattr(executable_mod.Executable, "__call__", replay)
    yield ran


def _model(kv_dtype=None):
    cfg = TransformerConfig(**CFG)
    return CausalTransformerModel(cfg, init_params(cfg, 1, torch.float32, CPU),
                                  dtype=torch.float32, kv_dtype=kv_dtype)


def test_model_programs_read_nothing_on_the_host(guarded):
    m = _model()
    m.init_fixed_cache(128)
    m.generate([5, 6, 7], 12, chunk_size=5)
    m.generate([5, 6, 7], 12, temperature=0.8, top_k=5, seed=2, chunk_size=5)
    list(m.generate_stream([5, 6, 7], 4))
    m.decode_window([3, 4, 5])
    m.decode_spec_chunk(3, 2, 3, 1)
    names = {n.rstrip("0123456789_") for n in guarded}
    assert {"prefill", "decode_step", "decode_window", "generate",
            "spec"} <= {n.split("_")[0] if n.startswith("spec") else n for n in names}
    assert {"generate_5", "generate_1", "decode_window_3", "spec_2x3_d1"} <= guarded


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_engine_programs_read_nothing_on_the_host(guarded, paged, pipelined, temperature):
    m = _model("int8")
    eng = ContinuousBatchingEngine(m, max_batch=4, max_seq_len=64, steps_per_dispatch=3,
                                   temperature=temperature, top_k=7, pipelined=pipelined,
                                   paged=paged, block_size=8)
    eng.warmup(prompt_lens=(3, 40))
    reqs = [eng.submit([i + 1, 2, 3], max_new_tokens=5 + i) for i in range(7)]
    eng.run_until_complete()
    assert all(r.done for r in reqs)
    names = set(guarded)
    want = {(False, False): {"serve_prefill_32", "serve_prefill_64", "serve_decode_br_3"},
            (False, True): {"serve_prefill_pl_32", "serve_prefill_wave_2_32",
                            "serve_prefill_wave_4_64", "serve_chunk_br_3"},
            (True, False): {"serve_prefill_paged_32", "serve_chunk_paged_3"},
            (True, True): {"serve_prefill_paged_pl_32", "serve_prefill_paged_plw_4_32",
                           "serve_chunk_paged_pl_3"}}[(paged, pipelined)]
    assert want <= names, want - names


def test_strategy_programs_read_nothing_on_the_host(guarded):
    m = _model()
    DecodeBatch(max_seq_len=64).bind(m).generate([[5, 6, 7], [8, 9]], 6)
    draft = CausalTransformerModel(TransformerConfig(**dict(CFG, num_layers=1)),
                                   slice_layers(m.params, 1), dtype=torch.float32)
    m.init_fixed_cache(128)
    DecodeSpeculative(gamma=3, draft_model=draft).bind(m).generate([5, 6, 7], 10)
    assert {"batch_prefill_2x32", "batch_decode_2", "draft_prefill_32",
            "draft_scan_3"} <= guarded


def test_sampling_runs_captured_with_its_generator(guarded):
    """``sample_token_gpu`` captured with ``sampling_generator`` registered:
    the replays draw what eager calls from the same generator state draw."""
    logits = torch.randn(2, 50, generator=torch.Generator().manual_seed(0))

    def draw(lg):
        return sample_token_gpu(lg, temperature=0.7, top_k=9).torch

    gen = sampling_generator(CPU)
    gen.manual_seed(4)
    eager = [int(draw(logits)) for _ in range(3)]
    exe = executable_mod.capture(draw, logits, generators=(gen,), name="sample_token")
    gen.manual_seed(4)
    assert [int(exe.replay(logits)) for _ in range(3)] == eager
    assert "sample_token" in guarded


def test_shared_pool_reset_releases_everything():
    m = _model()
    m.init_fixed_cache(64)
    m.prefill([1, 2, 3])
    m.decode_step(4)
    exes = m.graphs.executables()
    assert set(exes) == {("prefill", 32), ("decode", False)}
    m.init_fixed_cache(64)
    assert m.graphs.executables() == {}
    for exe in exes.values():
        with pytest.raises(RuntimeError, match="after reset"):
            exe.replay()


def test_executable_names_are_the_references():
    """Executable names follow the reference's f-strings."""
    m = _model()
    m.init_fixed_cache(128)
    m.prefill([1, 2])
    m.decode_chunk(3, 4)
    m.decode_window([1, 2])
    names = {e.name for e in m.graphs.executables().values()}
    assert names == {"prefill_32", "generate_4", "decode_window_2"}


# ------------------------------------------------------------ bound weights --

@pytest.mark.parametrize("strategy", ["batch", "speculative"])
def test_rebinding_a_strategy_leaves_the_first_models_weights(strategy):
    """A strategy bound to model A, run, then bound to model B of the same
    shapes: B's run uses B's programs (its tokens are a fresh strategy's on
    B) and A's weights stay bit for bit what they were."""
    cfg = TransformerConfig(**CFG)
    a, b = (CausalTransformerModel(cfg, init_params(cfg, seed, torch.float32, CPU),
                                   dtype=torch.float32) for seed in (1, 2))
    draft = CausalTransformerModel(TransformerConfig(**dict(CFG, num_layers=1)),
                                   slice_layers(a.params, 1), dtype=torch.float32)

    def make():
        if strategy == "batch":
            return DecodeBatch(max_seq_len=64)
        return DecodeSpeculative(gamma=3, draft_model=draft)

    def run(strat, m):
        if strategy == "batch":
            return strat.bind(m).generate([[5, 6, 7], [8, 9]], 6)
        m.init_fixed_cache(64)
        return strat.bind(m).generate([5, 6, 7], 10)

    saved = [t.clone() for t in jax.tree.leaves(a.params)]
    strat = make()
    run(strat, a)
    got = run(strat, b)
    assert got == run(make(), b)
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a.params), saved))


def test_bound_argument_raises_instead_of_copying():
    """A bound argument (the weights) is checked by address at replay: other
    tensors raise ValueError and nothing is copied into the captured ones."""
    w = torch.arange(6.0).reshape(2, 3)
    other = torch.ones(2, 3)
    exe = executable_mod.capture(lambda p, x: p["w"] @ x, {"w": w}, torch.ones(3),
                                 bound_argnums=(0,), name="bound")
    assert torch.equal(exe.replay({"w": w}, torch.ones(3)), w.sum(1))
    with pytest.raises(ValueError, match="bound argument 0"):
        exe.replay({"w": other}, torch.ones(3))
    assert torch.equal(w, torch.arange(6.0).reshape(2, 3))
