#!/usr/bin/env python3
"""Time what the port's device lock (``kernels._build.DEVICE_LOCK``, held
around every launch, replay and capture) costs its single-stream decode on
the CUDA card:

    python3 scripts/torch_lock_cost.py

Builds the TinyLlama-1.1B-shape model (random bf16 weights, seed 0,
quantized int4 and fused; a 512-row cache) and times, in turns (lock, none,
none, lock), with the lock as it is and with it swapped for a no-op
context: the eager decode step (``decode_step_fn``, STEPS steps, host wall
a step, synchronized at the end), the replayed step (``decode_step``,
STEPS steps likewise) and a NEW-token greedy ``generate`` (tok/s). The
tokens of every generate must be equal. Prints one JSON line: the card
(nvidia-smi name and power limit), each turn's numbers and the lock's
launches a step. Exits 2 without a card.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CFG_1B = dict(vocab_size=32000, hidden_size=2048, num_layers=22, num_heads=32,
              num_kv_heads=4, intermediate_size=5632, max_position_embeddings=2048,
              tie_word_embeddings=False)
STEPS, NEW, PROMPT = 64, 64, 100


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_lock_cost: no CUDA device is visible", file=sys.stderr)
        return 2
    from pygpukit_tpu_torch.kernels import _build, fused_decode
    from pygpukit_tpu_torch.llm import (CausalTransformerModel, TransformerConfig,
                                        fuse_params, init_params, quantize_model_params)
    from pygpukit_tpu_torch.llm.model import decode_step_fn
    dev = torch.device("cuda", 0)
    cfg = TransformerConfig(**CFG_1B)
    model = CausalTransformerModel(
        cfg, fuse_params(quantize_model_params(init_params(cfg, 0, torch.bfloat16, dev),
                                               "int4")), dtype=torch.bfloat16)
    prompt = list(range(1, PROMPT + 1))
    lock = _build.DEVICE_LOCK

    def use(held) -> None:
        _build.DEVICE_LOCK = fused_decode.DEVICE_LOCK = held

    def turn() -> dict:
        model.init_fixed_cache(512)
        kc, vc = model.k_cache, model.v_cache
        decode_step_fn(cfg, model.params, kc, vc, 1, PROMPT)          # warm
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        for i in range(STEPS):
            decode_step_fn(cfg, model.params, kc, vc, 1 + i % 7, PROMPT + i)
        torch.cuda.synchronize()
        eager = (time.perf_counter() - t0) / STEPS * 1e3
        launches = sum(_build.LAUNCHES.values()) / STEPS
        model.init_fixed_cache(512)
        model.prefill(prompt)
        model.decode_step(1)                                           # capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(STEPS):
            model.decode_step(1 + i % 7)
        torch.cuda.synchronize()
        replayed = (time.perf_counter() - t0) / STEPS * 1e3
        model.init_fixed_cache(512)
        model.generate(prompt, max_new_tokens=NEW)                     # capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = model.generate(prompt, max_new_tokens=NEW)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return {"eager_step_ms": eager, "replayed_step_ms": replayed,
                "generate_tok_s": NEW / secs, "launches_a_step": launches, "tokens": toks}

    turns = []
    for held in ("lock", "none", "none", "lock"):
        use(lock if held == "lock" else contextlib.nullcontext())
        try:
            turns.append(dict(turn(), lock=held))
        finally:
            use(lock)
    if any(t["tokens"] != turns[0]["tokens"] for t in turns):
        raise SystemExit("torch_lock_cost: the generates' tokens differ between turns")
    for t in turns:
        del t["tokens"]
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"card": res.stdout.strip().splitlines()[0], "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
