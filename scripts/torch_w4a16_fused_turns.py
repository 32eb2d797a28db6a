#!/usr/bin/env python3
"""Time the port's block w4a16 GEMV and whole-model decode step
(pygpukit_tpu_torch kernels rows 12 and 18) of one source tree on the CUDA
card, for comparing two trees in turns on one card:

    python3 scripts/torch_w4a16_fused_turns.py --root .            # this tree
    python3 scripts/torch_w4a16_fused_turns.py --root /path/parent # another checkout

Only the public wrappers and model functions (``block_w4a16_matmul``,
``fused_decode``, ``fused_decode_step_fn``) are called, so any tree of the
port runs it. Device times by CUDA-graph replay (the calls over distinct
weights captured once, replayed between CUDA events). The first call of
each case is held against the tree's plain version: row 12 within one bf16
ulp plus 1e-4 of max |y|, row 18 within 5e-2 relative L2 at 22 layers and
a second launch bitwise. Prints one JSON line: the card (nvidia-smi name
and power limit) and ms per case: row 12 summed over the 1.1B model's four
projections at rows 1, 2, 5 and 8 (``--gemv-only``: only these), row 18
at 22 layers, pos 143, cache 512 (the kernel alone and the whole fused
step: kernel, k/v scatter, head). Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# (N, K) of the 1.1B model's four fused projections: qkv, o, gate_up, down
PROJ = {"qkv": (2560, 2048), "o": (2048, 2048), "gate_up": (11264, 2048), "down": (2048, 5632)}
N_VAR = 8
FUSED_TIMED = (22, 143, 512)          # layers, pos, cache rows
CFG_1B = dict(vocab_size=32000, hidden_size=2048, num_layers=22, num_heads=32, num_kv_heads=4,
              intermediate_size=5632, max_position_embeddings=2048, tie_word_embeddings=False)


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
    from pygpukit_tpu_torch.kernels import block_w4a16_matmul, block_w4a16_matmul_plain
    for name, (n, k) in PROJ.items():
        w = torch.randint(0, 256, (N_VAR, k // 2, n), generator=g, device=dev, dtype=torch.uint8)
        s = (torch.rand((N_VAR, k // 32, n), generator=g, device=dev) * 1e-3 + 1e-4).to(
            torch.bfloat16)
        for rows in (1, 2, 5, 8):
            x = (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
            y = block_w4a16_matmul(x, w[0], s[0]).float()
            ref = block_w4a16_matmul_plain(x, w[0], s[0]).float()
            tol = ref.abs() * 2.0 ** -7 + 1e-4 * ref.abs().max()
            if not bool(((y - ref).abs() <= tol).all()):
                raise SystemExit(f"block_w4a16 {name} rows {rows}: off the tolerance, max abs "
                                 f"err {(y - ref).abs().max().item()}")
            key = f"block_w4a16_gemv_four_rows{rows}"
            out[key] = out.get(key, 0.0) + time_ms(
                lambda i: block_w4a16_matmul(x, w[i], s[i]), N_VAR)
        del w, s


def time_fused(dev, g, out: dict) -> None:
    import torch
    from pygpukit_tpu_torch.kernels import fused_decode, fused_decode_plain
    from pygpukit_tpu_torch.llm import (TransformerConfig, fused_decode_step_fn, init_params,
                                        prepare_fused_decode_params)
    from pygpukit_tpu_torch.ops.nn import rope_tables
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = TransformerConfig(**CFG_1B)
    n, pos, mx = FUSED_TIMED
    params = init_params(cfg, 0, bf16, dev)
    params["rope_cos"], params["rope_sin"] = rope_tables(2048, cfg.head_dim, cfg.rope_theta,
                                                         device=dev)
    params = prepare_fused_decode_params(cfg, params)
    lp = params["layers"]
    hk, d = cfg.num_kv_heads, cfg.head_dim
    heads = dict(n_heads=cfg.num_heads, n_kv_heads=hk, head_dim=d, eps=cfg.norm_eps)
    kc = (torch.randn((n, mx, hk * d), generator=g, device=dev) * 0.5).to(bf16)
    vc = torch.randn((n, mx, hk * d), generator=g, device=dev).to(bf16)
    args = (params["embed"][7:8], params["rope_cos"][pos:pos + 1].to(f32),
            params["rope_sin"][pos:pos + 1].to(f32),
            torch.tensor([pos], dtype=torch.int32, device=dev), lp["w_qkv_cat"], lp["w_o"],
            lp["w_gu_cat"], lp["w_down"], lp["attn_norm_w"].to(f32), lp["mlp_norm_w"].to(f32),
            params["final_norm_w"].to(f32).reshape(1, -1), kc, vc)
    got = fused_decode(*args, **heads)
    ref = fused_decode_plain(*args, **heads)
    rel = max(((a.float() - b.float()).norm() / b.float().norm()).item()
              for a, b in zip(got, ref))
    if rel > 5e-2:
        raise SystemExit(f"fused_decode: relative L2 {rel} against the plain version")
    if not all(torch.equal(a, b) for a, b in zip(got, fused_decode(*args, **heads))):
        raise SystemExit("fused_decode: a second launch differs")
    out["fused_decode_rel_l2"] = rel
    out["fused_decode_kernel"] = time_ms(lambda i: fused_decode(*args, **heads), 1, reps=20)
    kc4, vc4 = kc.reshape(n, mx, hk, d), vc.reshape(n, mx, hk, d)
    tok = torch.tensor([7], device=dev)
    out["fused_decode_step"] = time_ms(
        lambda i: fused_decode_step_fn(cfg, params, kc4, vc4, tok, pos), 1, reps=20)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="the tree whose pygpukit_tpu_torch to time")
    ap.add_argument("--gemv-only", action="store_true", help="time row 12 alone")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_w4a16_fused_turns: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    from pygpukit_tpu_torch import set_deterministic_numerics
    set_deterministic_numerics()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    out: dict = {}
    time_gemv(dev, g, out)
    if not args.gemv_only:
        time_fused(dev, g, out)
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"root": args.root, "card": res.stdout.strip().splitlines()[0], "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
