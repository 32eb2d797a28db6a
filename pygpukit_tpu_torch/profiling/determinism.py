"""Determinism and replay-parity harness (counterpart of
``pygpukit_tpu/profiling/determinism.py``):

- ``verify_bitwise_replay``: the same program on the same inputs gives the
  same bits;
- ``verify_recompile_parity``: a freshly built (captured) program gives the
  same bits;
- ``verify_strategy_equivalence``: every decode strategy emits the same
  greedy tokens.

Each run's outputs are copied to the host before the next run (a captured
program's outputs are overwritten by its next replay) and compared as raw
bytes with their dtypes and shapes, so bf16 and fp8 leaves compare bit for
bit too.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils import _pytree as pytree


@dataclass
class DeterminismReport:
    name: str
    passed: bool
    runs: int = 0
    detail: str = ""

    def __bool__(self) -> bool:
        return self.passed


def _snapshot(tree) -> list:
    """Every leaf as (dtype, shape, bytes) on the host; other leaves as
    they are."""
    out = []
    for x in pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous()
            out.append((str(t.dtype), tuple(t.shape),
                        t.reshape(-1).view(torch.uint8).numpy().tobytes()))
        elif isinstance(x, np.ndarray):
            out.append((str(x.dtype), x.shape, np.ascontiguousarray(x).tobytes()))
        else:
            out.append(x)
    return out


def _leaves_equal(a, b) -> bool:
    """True when ``a`` and ``b`` hold the same leaves bit for bit."""
    return _snapshot(a) == _snapshot(b)


def verify_bitwise_replay(fn, *args, runs: int = 3,
                          name: str = "replay") -> DeterminismReport:
    """Run ``fn(*args)`` ``runs`` times; every run must give the first
    run's bits."""
    first = _snapshot(fn(*args))
    for i in range(runs - 1):
        if _snapshot(fn(*args)) != first:
            return DeterminismReport(name, False, i + 2, "outputs diverged across replays")
    return DeterminismReport(name, True, runs)


def verify_recompile_parity(make_fn, *args, runs: int = 2,
                            name: str = "recompile") -> DeterminismReport:
    """``make_fn()`` returns a freshly built callable; each must give the
    first one's bits."""
    first = _snapshot(make_fn()(*args))
    for i in range(runs - 1):
        if _snapshot(make_fn()(*args)) != first:
            return DeterminismReport(name, False, i + 2, "fresh compile changed the bits")
    return DeterminismReport(name, True, runs)


def verify_strategy_equivalence(model, prompt, n_tokens: int = 16,
                                strategies: list[str] | None = None,
                                max_seq_len: int = 256) -> DeterminismReport:
    """Every strategy of ``llm.decode.STRATEGIES`` named (by default M1,
    M1Graph, Speculative and Jacobi) must emit the first one's greedy
    tokens."""
    from ..llm.decode import STRATEGIES
    names = strategies or ["m1", "m1_graph", "speculative", "jacobi"]
    outputs = {}
    for nm in names:
        model.init_fixed_cache(max_seq_len)
        outputs[nm] = STRATEGIES[nm]().bind(model).generate(list(prompt), n_tokens)
    ref = outputs[names[0]]
    bad = [nm for nm, out in outputs.items() if out != ref]
    if bad:
        return DeterminismReport("strategy_equivalence", False, len(names), f"mismatch: {bad}")
    return DeterminismReport("strategy_equivalence", True, len(names))
