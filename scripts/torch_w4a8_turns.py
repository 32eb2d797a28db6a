#!/usr/bin/env python3
"""Time the port's w4a8 GEMM and int4_block w4a8 GEMV (pygpukit_tpu_torch
kernels rows 4 and 11) of one source tree on the CUDA card, for comparing
two trees in turns on one card:

    python3 scripts/torch_w4a8_turns.py --root .            # this tree
    python3 scripts/torch_w4a8_turns.py --root /path/parent # another checkout

Only the public wrappers (``w4a8_matmul``, ``block_w4a8_matmul``) are
called, so any tree of the port runs it. Device times by CUDA-graph replay
(the calls over 8 weight variants captured once, replayed between CUDA
events); the first call of each case is held bitwise against the tree's
plain version. Prints one JSON line: the card (nvidia-smi name and power
limit) and ms per case: the w4a8 GEMM's four 1.1B projections at M 256 and
2048 (activation quantization included), the reference's int4 GEMM cell
(M 8192, K 4096, N 14336) and the block GEMV's four projections at rows 1
and 8. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# (N, K) of the 1.1B model's four fused projections: qkv, o, gate_up, down
PROJ = {"qkv": (2560, 2048), "o": (2048, 2048), "gate_up": (11264, 2048), "down": (2048, 5632)}
CELL = (8192, 4096, 14336)            # M, K, N of bench.py:142-170's int4 GEMM cell
N_VAR = 8


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


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="the tree whose pygpukit_tpu_torch to time")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_w4a8_turns: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    from pygpukit_tpu_torch import set_deterministic_numerics
    from pygpukit_tpu_torch.kernels import (block_w4a8_matmul, block_w4a8_matmul_plain,
                                            w4a8_matmul, w4a8_matmul_plain)
    set_deterministic_numerics()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    out: dict = {}

    def bitwise(y, ref, what):
        if not torch.equal(y.view(torch.int16), ref.view(torch.int16)):
            raise SystemExit(f"{what}: not bitwise")

    for name, (n, k) in PROJ.items():
        w = torch.randint(0, 256, (N_VAR, n, k // 2), generator=g, device=dev, dtype=torch.uint8)
        sc = torch.rand((N_VAR, n), generator=g, device=dev) * 1e-3 + 1e-4
        for m in (256, 2048):
            x = (torch.randn((m, k), generator=g, device=dev) * 2).to(torch.bfloat16)
            bitwise(w4a8_matmul(x, w[0], sc[0]), w4a8_matmul_plain(x, w[0], sc[0]),
                    f"w4a8 {name} M {m}")
            key = f"w4a8_gemm_four_M{m}"
            out[key] = out.get(key, 0.0) + time_ms(lambda i: w4a8_matmul(x, w[i], sc[i]), N_VAR)
        del w
        kb = torch.randint(0, 256, (N_VAR, k // 2, n), generator=g, device=dev,
                           dtype=torch.uint8)
        sb = (torch.rand((N_VAR, k // 32, n), generator=g, device=dev) * 1e-3
              + 1e-4).to(torch.bfloat16)
        for rows in (1, 8):
            x = (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
            bitwise(block_w4a8_matmul(x, kb[0], sb[0]), block_w4a8_matmul_plain(x, kb[0], sb[0]),
                    f"block {name} rows {rows}")
            key = f"block_w4a8_four_rows{rows}"
            out[key] = out.get(key, 0.0) + time_ms(
                lambda i: block_w4a8_matmul(x, kb[i], sb[i]), N_VAR)
        del kb, sb
    m, k, n = CELL
    w = torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
    sc = torch.rand((n,), generator=g, device=dev) * 1e-3 + 1e-4
    x = (torch.randn((m, k), generator=g, device=dev) * 2).to(torch.bfloat16)
    bitwise(w4a8_matmul(x, w, sc), w4a8_matmul_plain(x, w, sc), "w4a8 cell")
    out["w4a8_gemm_cell"] = time_ms(lambda i: w4a8_matmul(x, w, sc), 1, 5)
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"root": args.root, "card": res.stdout.strip().splitlines()[0], "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
