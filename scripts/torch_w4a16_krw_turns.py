#!/usr/bin/env python3
"""Time the port's int4 w4a16 GEMV (pygpukit_tpu_torch kernels row 8), its
row write and batch decode attention pair (rows 5 and 6) and the two
decode steps they sit in, of one source tree on the CUDA card, for
comparing two trees in turns on one card:

    python3 scripts/torch_w4a16_krw_turns.py --root .            # this tree
    python3 scripts/torch_w4a16_krw_turns.py --root /path/parent # another checkout

Only public wrappers and model functions are called (``w4a16_matmul``,
``kv_rows_write``, ``batch_decode_attention``, ``kv_write_attention`` where
the tree has it, ``batch_decode_step_fn``, ``decode_step_fn``), so any tree
of the port runs it. Device times by CUDA-graph replay (calls over distinct
weights or layers captured once, replayed between CUDA events). The first
call of each case is held against the tree's plain version: row 8 within
one bf16 ulp plus 1e-4 of max |y|, the write-plus-attention pools bitwise
``kv_rows_write_plain``'s and its output bitwise the two kernels launched
one after the other. Prints one JSON line: the card (nvidia-smi name and
power limit) and ms per case:

- row 8 summed over the 1.1B model's four projections at rows 1, 2, 5, 8;
- the write plus attention at the serving shape (B 8, 32/4 heads, D 64,
  MAX 1024, chip_smoke.py phase 3's contexts), per layer over 22 layers,
  in ``--pair-turns`` alternating turns (a list of ms each): the two
  kernels launched one after the other (``pair_separate``, every tree),
  ``kv_write_attention`` where the tree has it (``pair_fused``), and the
  attention alone (``attention``); each with its median and spread;
- the batch-8 dense step of the int4 1.1B model at context 301, MAX 1024
  (chip_smoke.py phase 6), the tree's own step;
- the single-stream step of the int4 w4a16 rung (chip_smoke.py phase 9:
  ``PYGPUKIT_INT4_MODE=w4a16``, cache 512, position 80);
the steps each STEP_REPEATS times, one graph a time.

``--only gemv,pair,steps`` picks cases. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# (N, K) of the 1.1B model's four fused projections: qkv, o, gate_up, down
PROJ = {"qkv": (2560, 2048), "o": (2048, 2048), "gate_up": (11264, 2048), "down": (2048, 5632)}
N_VAR = 8
CFG_1B = dict(vocab_size=32000, hidden_size=2048, num_layers=22, num_heads=32, num_kv_heads=4,
              intermediate_size=5632, max_position_embeddings=2048, tie_word_embeddings=False)
# the serving shape of the pair: slots, layers, MAX, Hk*D, Hq, D; the contexts
PAIR = (8, 22, 1024, 256, 32, 64)
PAIR_POSS = (0, 512, 1023, 1499, 36, 699, 1024, 255)   # lens = poss + 1: phase 3's BDA_LENS
# each step is captured and timed this many times in turn (a list of ms)
STEP_REPEATS = 5


def time_ms(fn, n_variants: int, reps: int = 10) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n_variants):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_variants):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n_variants)


def time_gemv(dev, g, out: dict) -> None:
    import torch
    from pygpukit_tpu_torch.kernels import w4a16_matmul, w4a16_matmul_plain
    for name, (n, k) in PROJ.items():
        w = torch.randint(0, 256, (N_VAR, n, k // 2), generator=g, device=dev, dtype=torch.uint8)
        s = torch.rand((N_VAR, n), generator=g, device=dev) * 1e-3 + 1e-4
        for rows in (1, 2, 5, 8):
            x = (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
            y = w4a16_matmul(x, w[0], s[0]).float()
            ref = w4a16_matmul_plain(x, w[0], s[0]).float()
            tol = ref.abs() * 2.0 ** -7 + 1e-4 * ref.abs().max()
            if not bool(((y - ref).abs() <= tol).all()):
                raise SystemExit(f"w4a16 {name} rows {rows}: off the tolerance, max abs err "
                                 f"{(y - ref).abs().max().item()}")
            key = f"w4a16_gemv_four_rows{rows}"
            out[key] = out.get(key, 0.0) + time_ms(lambda i: w4a16_matmul(x, w[i], s[i]), N_VAR)
        del w, s


def _bits(pool):
    import torch
    leaves = [pool["q"], pool["s"]] if isinstance(pool, dict) else [pool]
    return [t.contiguous().view(torch.uint8) for t in leaves]


def time_pair(dev, g, out: dict, pair_turns: int) -> None:
    import torch
    from pygpukit_tpu_torch import kernels as K
    b, nl, mx, lanes, hq, d = PAIR
    bf16 = torch.bfloat16
    kp = torch.randn((b, nl, mx, lanes), generator=g, device=dev).to(bf16)
    vp = torch.randn((b, nl, mx, lanes), generator=g, device=dev).to(bf16)
    kn = torch.randn((b, lanes // d, d), generator=g, device=dev).to(bf16)
    vn = torch.randn((b, lanes // d, d), generator=g, device=dev).to(bf16)
    q = torch.randn((b, 1, hq, d), generator=g, device=dev).to(bf16)
    poss = torch.tensor(PAIR_POSS, dtype=torch.int32, device=dev)
    lens = poss + 1
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    K.kv_rows_write(k1, v1, kn, vn, 3, poss)
    K.kv_rows_write_plain(k2, v2, kn, vn, 3, poss)
    if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
        raise SystemExit("kv_rows_write: not bitwise its plain version")

    def separate(i):
        K.kv_rows_write(kp, vp, kn, vn, i, poss)
        K.batch_decode_attention(q, kp, vp, i, lens)
    forms = {"pair_separate": separate,
             "attention": lambda i: K.batch_decode_attention(q, kp, vp, i, lens)}
    if hasattr(K, "kv_write_attention"):
        k3, v3 = kp.clone(), vp.clone()
        k4, v4 = kp.clone(), vp.clone()
        K.kv_rows_write(k4, v4, kn, vn, 3, poss)
        want = K.batch_decode_attention(q, k4, v4, 3, lens)
        got = K.kv_write_attention(q, k3, v3, kn, vn, 3, poss, lens)
        if not (torch.equal(got, want) and all(
                torch.equal(a, c) for a, c in zip(_bits(k3) + _bits(v3), _bits(k4) + _bits(v4)))):
            raise SystemExit("kv_write_attention: not bitwise the two kernels")
        del k3, v3, k4, v4
        forms["pair_fused"] = lambda i: K.kv_write_attention(q, kp, vp, kn, vn, i, poss, lens)
    turns: dict = {f: [] for f in forms}
    for _ in range(pair_turns):
        for f, fn in forms.items():
            turns[f].append(time_ms(fn, nl, reps=20))
    for f, v in turns.items():
        out[f] = v
        out[f"{f}_median"] = statistics.median(v)
        out[f"{f}_spread"] = max(v) - min(v)


def _int4_model(dev):
    import torch
    from pygpukit_tpu_torch.llm import (CausalTransformerModel, TransformerConfig, fuse_params,
                                        init_params, quantize_model_params)
    cfg = TransformerConfig(**CFG_1B)
    params = quantize_model_params(init_params(cfg, 0, torch.bfloat16, dev), "int4")
    return CausalTransformerModel(cfg, fuse_params(params), dtype=torch.bfloat16)


def time_steps(dev, out: dict) -> None:
    import torch
    from pygpukit_tpu_torch.llm import batch_decode_step_fn, decode_step_fn
    from pygpukit_tpu_torch.ops.embedding import kv_cache_zeros
    model = _int4_model(dev)
    cfg, params = model.config, model.params
    b, mx = 8, 1024
    shape = (b, cfg.num_layers, mx, cfg.num_kv_heads * cfg.head_dim)
    kp = kv_cache_zeros(shape, torch.bfloat16, device=dev, merged=True)
    vp = kv_cache_zeros(shape, torch.bfloat16, device=dev, merged=True)
    toks = torch.arange(1, b + 1, device=dev)
    poss = torch.full((b,), 300, dtype=torch.int32, device=dev)
    out["batch8_step"] = [time_ms(
        lambda _: batch_decode_step_fn(cfg, params, kp, vp, toks, poss), 1, reps=20)
        for _ in range(STEP_REPEATS)]
    del kp, vp
    shape = (cfg.num_layers, 512, cfg.num_kv_heads, cfg.head_dim)
    kc = kv_cache_zeros(shape, torch.bfloat16, device=dev, merged=False)
    vc = kv_cache_zeros(shape, torch.bfloat16, device=dev, merged=False)
    tok = torch.tensor([1], device=dev)
    os.environ["PYGPUKIT_INT4_MODE"] = "w4a16"
    try:
        out["int4_w4a16_step"] = [time_ms(
            lambda _: decode_step_fn(cfg, params, kc, vc, tok, 80), 1, reps=20)
            for _ in range(STEP_REPEATS)]
    finally:
        os.environ.pop("PYGPUKIT_INT4_MODE", None)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="the tree whose pygpukit_tpu_torch to time")
    ap.add_argument("--only", default="gemv,pair,steps", help="cases, comma-separated")
    ap.add_argument("--pair-turns", type=int, default=10,
                    help="alternating turns of the write-plus-attention forms")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_w4a16_krw_turns: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    from pygpukit_tpu_torch import set_deterministic_numerics
    set_deterministic_numerics()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    out: dict = {}
    only = set(args.only.split(","))
    if "gemv" in only:
        time_gemv(dev, g, out)
    if "pair" in only:
        time_pair(dev, g, out, args.pair_turns)
    if "steps" in only:
        time_steps(dev, out)
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"root": args.root, "card": res.stdout.strip().splitlines()[0], "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
