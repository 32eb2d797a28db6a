#!/usr/bin/env python3
"""Time the port's w4a8 GEMV and converting GEMV (pygpukit_tpu_torch
kernels rows 1 and 10) of one source tree on the CUDA card, for comparing
two trees in turns on one card:

    python3 scripts/torch_gemv_turns.py --root .            # this tree
    python3 scripts/torch_gemv_turns.py --root /path/parent # another checkout

Only the public wrappers (``w4a8_matmul``, ``conv_matmul``) are called, so
any tree of the port runs it. Device times by CUDA-graph replay (the calls
over 8 weight variants captured once, replayed between CUDA events); the
first call of each case is held against the tree's plain version (row 1
bitwise, row 10 within one bf16 ulp plus 1e-4 of max |y|). Prints one JSON
line: the card (nvidia-smi name and power limit) and ms per case, each
summed over the 1.1B model's four projections: row 1 at rows 1, 2, 5 and 8
(activation quantization included), row 10 on e4m3 and int8 weights at
rows 1 and 8. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# (N, K) of the 1.1B model's four fused projections: qkv, o, gate_up, down
PROJ = {"qkv": (2560, 2048), "o": (2048, 2048), "gate_up": (11264, 2048), "down": (2048, 5632)}
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
        print("torch_gemv_turns: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    from pygpukit_tpu_torch import set_deterministic_numerics
    from pygpukit_tpu_torch.kernels import (conv_matmul, conv_matmul_plain, w4a8_matmul,
                                            w4a8_matmul_plain)
    set_deterministic_numerics()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    out: dict = {}

    def add(key: str, ms: float) -> None:
        out[key] = out.get(key, 0.0) + ms

    for name, (n, k) in PROJ.items():
        w = torch.randint(0, 256, (N_VAR, n, k // 2), generator=g, device=dev, dtype=torch.uint8)
        sc = torch.rand((N_VAR, n), generator=g, device=dev) * 1e-3 + 1e-4
        for rows in (1, 2, 5, 8):
            x = (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
            y, ref = w4a8_matmul(x, w[0], sc[0]), w4a8_matmul_plain(x, w[0], sc[0])
            if not torch.equal(y.view(torch.int16), ref.view(torch.int16)):
                raise SystemExit(f"w4a8 {name} rows {rows}: not bitwise")
            add(f"w4a8_gemv_four_rows{rows}", time_ms(lambda i: w4a8_matmul(x, w[i], sc[i]),
                                                      N_VAR))
        del w
        for storage in ("e4m3", "int8"):
            if storage == "int8":
                wc = torch.randint(-127, 128, (N_VAR, k, n), generator=g, device=dev,
                                   dtype=torch.int8)
            else:
                wc = (torch.randn((N_VAR, k, n), generator=g, device=dev) * 64).to(
                    torch.float8_e4m3fn)
            sc = torch.rand((N_VAR, n), generator=g, device=dev) * 1e-2 + 1e-3
            for rows in (1, 8):
                x = torch.randn((rows, k), generator=g, device=dev).to(torch.bfloat16)
                y, ref = conv_matmul(x, wc[0], sc[0]).float(), conv_matmul_plain(
                    x, wc[0], sc[0]).float()
                tol = ref.abs() * 2.0 ** -7 + 1e-4 * ref.abs().max()
                if not bool(((y - ref).abs() <= tol).all()):
                    raise SystemExit(f"conv {storage} {name} rows {rows}: off the tolerance")
                add(f"conv_gemv_{storage}_four_rows{rows}",
                    time_ms(lambda i: conv_matmul(x, wc[i], sc[i]), N_VAR))
            del wc
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"root": args.root, "card": res.stdout.strip().splitlines()[0], "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
