"""The port's core backend API (``pygpukit_tpu_torch.core.backend``) and its
public names against the reference's.

The backend is the card unless the caller asks for the CPU
(``set_backend("cpu")`` or ``PYGPUKIT_BACKEND=cpu``); it never falls to the
CPU on its own. Every name of the reference's public API (the top level's
public names, and the ``__all__`` of ``core``, ``llm``, ``ops`` and the
seven subpackages of the runtime services) exists in the port, or stands
in one of two lists: not ported on purpose (each with its reason), or
still to port (``parallel``). Each listed name must really be missing, so
the lists stay true.
"""

import __future__

import importlib
import importlib.util

import pytest
import torch

import pygpukit_tpu as ref
import pygpukit_tpu_torch as port
from pygpukit_tpu_torch.core import backend

#: reference names the port leaves out, and why
NOT_PORTED = {
    "as_jax": "a JAX array view; the port's counterpart is Array.torch / as_tensor",
    "Array.from_jax": "builds an Array from a JAX array",
    "Array.jax": "the Array's JAX array; the port's is Array.torch",
    "is_tpu_available": "a TPU query; the port's counterpart is is_cuda_available",
    "repack_weight": "repacks for the TPU's 128-lane tiles; no port kernel reads that layout",
    "repack_linear": "as repack_weight",
    "repack_norm": "as repack_weight",
    "repack_model_weights": "as repack_weight",
}
#: reference names of modules still to port (ROADMAP A.10)
STILL_TO_PORT = {"parallel"}

SUBPACKAGES = ("memory", "scheduler", "transfer", "dispatch", "jit", "profiling",
               "benchmark")


@pytest.fixture
def fresh_backend(monkeypatch):
    monkeypatch.delenv("PYGPUKIT_BACKEND", raising=False)
    backend.reset_backend()
    yield
    backend.reset_backend()


# ------------------------------------------------------------- A.13 --------

def test_cpu_backend_makes_the_default_device_the_cpu(fresh_backend):
    b = backend.set_backend("cpu")
    assert b == backend.get_backend() and b.platform == "cpu" and b.is_simulation
    assert backend.resolve_device() == torch.device("cpu")
    assert backend.default_device() == torch.device("cpu")
    assert b.devices() == [torch.device("cpu")] and b.device_count == 1
    assert backend.interpret_mode()
    assert port.zeros((2, 3)).device.type == "cpu"
    assert port.get_device_info().platform == "cpu"
    assert port.get_memory_info().total_bytes > 0
    assert backend.resolve_device("cpu") == torch.device("cpu")   # a named device wins


def test_reset_backend_without_a_card_raises(fresh_backend):
    backend.set_backend("cpu")
    backend.reset_backend()
    if torch.cuda.is_available():
        assert backend.get_backend().platform == "gpu"
        assert backend.resolve_device() == torch.device("cuda", 0)
        assert not backend.interpret_mode()
    else:
        for call in (backend.get_backend, backend.resolve_device, backend.interpret_mode,
                     backend.default_device, lambda: port.zeros(2)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_the_variable_names_the_backend(fresh_backend, monkeypatch):
    monkeypatch.setenv("PYGPUKIT_BACKEND", "cpu")
    assert backend.get_backend().platform == "cpu"
    assert backend.resolve_device() == torch.device("cpu")
    backend.reset_backend()
    monkeypatch.setenv("PYGPUKIT_BACKEND", "cuda")
    b = backend.get_backend()
    assert b.platform == "gpu" and not b.interpret
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            backend.resolve_device()
    backend.reset_backend()
    monkeypatch.setenv("PYGPUKIT_BACKEND", "tpu")
    with pytest.raises(ValueError, match="unknown backend"):
        backend.get_backend()


def test_set_backend_checks_its_arguments(fresh_backend):
    with pytest.raises(ValueError, match="unknown backend"):
        backend.set_backend("tpu")
    with pytest.raises(ValueError, match="plain versions"):
        backend.set_backend("cpu", interpret=False)
    with pytest.raises(ValueError, match="plain versions"):
        backend.set_backend("gpu", interpret=True)
    assert backend.set_backend("GPU").platform == "gpu"
    assert backend.set_backend("cpu", interpret=True).interpret


def test_backend_is_shared_across_threads(fresh_backend):
    import threading
    backend.set_backend("cpu")
    seen = []
    t = threading.Thread(target=lambda: seen.append(backend.resolve_device()))
    t.start()
    t.join()
    assert seen == [torch.device("cpu")]


def test_exported_where_the_reference_exports_them():
    for name in ("Backend", "get_backend", "set_backend", "reset_backend",
                 "interpret_mode"):
        assert getattr(port.core, name) is getattr(backend, name)
        assert name in port.core.__all__
    for name in ("get_backend", "set_backend", "interpret_mode", "JITKernel", "warmup",
                 "is_warmup_done", "get_warmup_error", "is_cuda_available"):
        assert hasattr(port, name), name
    assert port.llm.Dtype is port.core.dtypes.DataType
    assert port.llm.PoolStats is port.memory.PoolStats
    for sub in SUBPACKAGES:
        assert getattr(port, sub) is importlib.import_module(f"pygpukit_tpu_torch.{sub}")


# ------------------------------------------------------------- the names ---

def _public(mod) -> set:
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in dir(mod) if not n.startswith("_")
                 and not isinstance(getattr(mod, n), __future__._Feature)]
    return set(names)


def _missing() -> set:
    """Reference names with no counterpart in the port."""
    gone = {n for n in _public(ref) if not hasattr(port, n)}
    for sub in ("core", "llm", "ops", *SUBPACKAGES):
        r = importlib.import_module(f"pygpukit_tpu.{sub}")
        p = importlib.import_module(f"pygpukit_tpu_torch.{sub}")
        gone |= {n for n in _public(r) if not hasattr(p, n)}
        if sub in SUBPACKAGES:
            assert _public(r) <= set(p.__all__), sub
    gone |= {f"Array.{n}" for n in dir(ref.Array)
             if not n.startswith("_") and not hasattr(port.Array, n)}
    return gone


def test_every_reference_name_is_ported_or_listed():
    gone = _missing()
    unlisted = gone - set(NOT_PORTED) - STILL_TO_PORT
    assert not unlisted, f"reference names missing from the port: {sorted(unlisted)}"
    stale = (set(NOT_PORTED) | STILL_TO_PORT) - gone
    assert not stale, f"listed as missing but present in the port: {sorted(stale)}"


def test_still_to_port_is_the_parallel_subpackage():
    r = importlib.import_module("pygpukit_tpu.parallel")
    assert r.__all__ and not hasattr(port, "parallel")
    assert importlib.util.find_spec("pygpukit_tpu_torch.parallel") is None
