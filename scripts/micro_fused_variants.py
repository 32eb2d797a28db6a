#!/usr/bin/env python3
"""Time variants of the whole-model decode step (``csrc/fused_decode.cu``,
row 18) on the CUDA card.

    python3 scripts/micro_fused_variants.py [--out build/fused_variants.json]

A variant is the committed source with a text substituted (the live-chunk
rule), in a copy under build/, compiled by nvcc (sm_90a) into its own
library, or the committed library launched with another number of weight
rows a block asks for in L2 before a barrier than its plan's (0: none);
a diagnostic variant stamps the time of each stage of each layer; others
(DIAGNOSTICS, outputs not checked) leave a part of the step out. Each is launched through its C entry at 22 layers of the 1.1B
model (seed 0 weights), pos 143, cache 512, held against
``fused_decode_plain`` (relative L2 of h_out, k_new, v_new within 5e-2)
and timed by CUDA-graph replay. Prints and writes one JSON object: the
card (nvidia-smi name and power limit) and ms per variant. Exits 2 without
a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "pygpukit_tpu_torch" / "csrc"
N_LAYERS, POS, MAX = 22, 143, 512
CFG_1B = dict(vocab_size=32000, hidden_size=2048, num_layers=22, num_heads=32, num_kv_heads=4,
              intermediate_size=5632, max_position_embeddings=2048, tie_word_embeddings=False)
LIVE_RULE = "const int nch = min(a.p.chunks, max(1, (live + kChunkRows - 1) / kChunkRows));"
# name -> ([(old text, new text)] in fused_decode.cu, rows prefetched into L2,
# None: the plan's)
# a diagnostic variant: thread 0 of every block stamps %globaltimer at 12
# points of each layer into words past the scratch (STAMPS); the script
# prints the mean time of each interval over the blocks and the middle
# layers. Its output is checked like the others'.
STAMP_DEF = ("#define PGK_TS(i)                                                          "
             "  if (threadIdx.x == 0) {                                                 "
             "    unsigned long long t_;                                                "
             "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_));             "
             "    reinterpret_cast<unsigned long long*>(a.scratch + lay.total)          "
             "        [((size_t)l * 12 + (i)) * gridDim.x + blockIdx.x] = t_;           "
             "  }\n")
STAMPS = [("namespace {\n\nusing bf16 = __nv_bfloat16;",
           STAMP_DEF.replace("  ", " ") + "namespace {\n\nusing bf16 = __nv_bfloat16;"),
          ("    // A: x = x1 + down(l - 1) (the embedding row at layer 0); q|k|v\n",
           "    PGK_TS(0)\n"),
          ("    rms_row(xs, a.attn_norm + (size_t)l * m.H, m.H, m.eps, small, xn);\n",
           "    rms_row(xs, a.attn_norm + (size_t)l * m.H, m.H, m.eps, small, xn);\n    PGK_TS(1)\n"),
          ("    stage_end(a, epoch, 1, l);", "    PGK_TS(2) stage_end(a, epoch, 1, l); PGK_TS(3)"),
          ("    attention_stage(a, lay, l, live, nch, smem);",
           "    attention_stage(a, lay, l, live, nch, smem); PGK_TS(4)"),
          ("    stage_end(a, epoch, -1, l);", "    stage_end(a, epoch, -1, l); PGK_TS(5)"),
          ("    stage_end(a, epoch, 2, l);", "    PGK_TS(6) stage_end(a, epoch, 2, l); PGK_TS(7)"),
          ("    rms_row(xs, a.mlp_norm + (size_t)l * m.H, m.H, m.eps, small, xn);\n",
           "    rms_row(xs, a.mlp_norm + (size_t)l * m.H, m.H, m.eps, small, xn);\n    PGK_TS(8)\n"),
          ("    stage_end(a, epoch, 3, l);", "    PGK_TS(9) stage_end(a, epoch, 3, l); PGK_TS(10)"),
          ("    stage_end(a, epoch, l + 1 < m.L ? 0 : -1, l + 1);",
           "    PGK_TS(11) stage_end(a, epoch, l + 1 < m.L ? 0 : -1, l + 1);")]
INTERVALS = ("A residual+rms", "A q|k|v GEMV", "barrier A", "B attention", "barrier B",
             "C o GEMV", "barrier C", "D residual+rms", "D gate|up GEMV", "barrier D",
             "E down GEMV", "barrier E")
OLD_BARRIER = [
    ('    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar) : "memory");',
     "  {\n    __threadfence();\n    atomicAdd(bar, 1u);\n  }"),
    ("    while (ld_acquire(bar) < target) __nanosleep(32);\n",
     "    while (ld_acquire(bar) < target) __nanosleep(32);\n    __threadfence();\n")]
# stamps inside the attention stage (the first unit of each block that has
# one): after the q|k|v fold, the rope, the new token's term, the K/V
# staging, the scores, the softmax and P.V, the stores
ATT_DEF = STAMP_DEF.replace("PGK_TS(i)", "PGK_TA(i)").replace(
    "(size_t)l * 12 + (i)", "(size_t)layer * 8 + (i)").replace(
    "lay.total)", "lay.total + (size_t)a.m.L * 12 * 2 * gridDim.x)").replace(
    "if (threadIdx.x == 0)", "if (threadIdx.x == 0 && u == blockIdx.x)")
ATT_STAMPS = [STAMPS[0], ("namespace {\n\nusing bf16 = __nv_bfloat16;",
                          ATT_DEF.replace("  ", " ") + "namespace {\n\nusing bf16 = __nv_bfloat16;"),
              ("    const int h = u % m.HK, c = u / m.HK;\n",
               "    const int h = u % m.HK, c = u / m.HK;\n    PGK_TA(0)\n"),
              ("      raw[i] = rbf(fold(pqkv, a.p.ks_qkv, nqkv, col));\n    }\n    __syncthreads();\n",
               "      raw[i] = rbf(fold(pqkv, a.p.ks_qkv, nqkv, col));\n    }\n    __syncthreads();\n    PGK_TA(1)\n"),
              ("    for (int i = threadIdx.x; i < d; i += kThreads) vn[i] = raw[(g_heads + 1) * d + i];\n    __syncthreads();\n",
               "    for (int i = threadIdx.x; i < d; i += kThreads) vn[i] = raw[(g_heads + 1) * d + i];\n    __syncthreads();\n    PGK_TA(2)\n"),
              ("    const int r0 = c * rows_per, r1 = min(live, r0 + rows_per);\n",
               "    PGK_TA(3)\n    const int r0 = c * rows_per, r1 = min(live, r0 + rows_per);\n"),
              ("            *reinterpret_cast<const uint4*>((v ? vbase : kbase) + (size_t)(t0 + r) * kvd + e);\n      }\n      __syncthreads();\n",
               "            *reinterpret_cast<const uint4*>((v ? vbase : kbase) + (size_t)(t0 + r) * kvd + e);\n      }\n      __syncthreads();\n      PGK_TA(4)\n"),
              ("        st[g * kTR + r] = s;\n      }\n      __syncthreads();\n",
               "        st[g * kTR + r] = s;\n      }\n      __syncthreads();\n      PGK_TA(5)\n"),
              ("          ll[g] = fmaf(ll[g], alpha, psum);\n        }\n      }\n      __syncthreads();\n",
               "          ll[g] = fmaf(ll[g], alpha, psum);\n        }\n      }\n      __syncthreads();\n      PGK_TA(6)\n"),
              ("      for (int e = lane; e < d; e += 32) __stcg(a.scratch + lay.acc + slot * d + e, acc[g * d + e]);\n    }\n    __syncthreads();\n",
               "      for (int e = lane; e < d; e += 32) __stcg(a.scratch + lay.acc + slot * d + e, acc[g * d + e]);\n    }\n    __syncthreads();\n    PGK_TA(7)\n")]
ATT_INTERVALS = ("q|k|v fold", "rope", "new token's term", "K/V staging", "scores",
                 "softmax and P.V", "stores")
VARIANTS = {
    "committed": ([], None),
    "attention timestamps": (ATT_STAMPS, None),
    "stage timestamps": (STAMPS, None),
    "barrier by fence + atomicAdd": (OLD_BARRIER, None),
    "no L2 prefetch": ([], 0),
    "L2 prefetch 384 rows": ([], 384),
    "live chunks of 32 rows": ([(LIVE_RULE, "const int nch = min(a.p.chunks, max(1, (live + 31) / 32));")], None),
    "K rows unpadded in shared memory": ([("  bf16* vs = ks + kTR * (d + 8);", "  bf16* vs = ks + kTR * (d + 8);\n  constexpr int kPad = 0;"),
                                          ("ks + r * (d + 8) + e) =", "ks + r * (d + kPad) + e) ="),
                                          ("const bf16* kr = ks + r * (d + 8);", "const bf16* kr = ks + r * (d + kPad);")], None),
    "all chunks": ([(LIVE_RULE, "const int nch = a.p.chunks;")], None),
}
# diagnostic variants, outputs not checked: a part of the step left out
DIAGNOSTICS = {
    "no attention stage": ([("    attention_stage(a, lay, l, live, nch, smem);", "")], None),
    "attention without the cache rows": ([(
        "const int r0 = c * rows_per, r1 = min(live, r0 + rows_per);",
        "const int r0 = 0, r1 = 0;")], None),
    "residual rows without the fold": ([("rbf(fold(part, slices, h, n))", "0.f")], None),
    "barriers that do not wait": ([("    while (ld_acquire(bar) < target) __nanosleep(32);\n", "")],
                                  None),
}
VARIANTS.update(DIAGNOSTICS)


def time_ms(fn, reps: int = 20) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build_variants(out_dir: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    from pygpukit_tpu_torch.kernels._build import NVCC_FLAGS, nvcc_path
    srcs = {}
    for name, (subs, _) in VARIANTS.items():
        key = tuple(subs)
        if key in srcs:
            continue
        d = out_dir / f"v{len(srcs)}"
        d.mkdir(parents=True, exist_ok=True)
        for src in ("common.cuh", "mma.cuh", "hopper.cuh", "fused_decode.cu"):
            text = (CSRC / src).read_text()
            if src == "fused_decode.cu":
                for old, new in subs:
                    if old not in text:
                        raise SystemExit(f"variant {name}: {old!r} not in the source")
                    text = text.replace(old, new)
            (d / src).write_text(text)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "fused_decode.cu")]
        srcs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True), d / "lib.so")
    libs = {}
    for key, (p, lib) in srcs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed\n{log[-3000:]}")
        cdll = ctypes.CDLL(str(lib))
        cdll.pgk_fused_decode_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
        cdll.pgk_fused_decode.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 7
                                          + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        libs[key] = cdll
    return libs


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "fused_variants.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("micro_fused_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    libs = build_variants(ROOT / "build" / "fused_variants")
    from pygpukit_tpu_torch.kernels import fused_decode_plain
    from pygpukit_tpu_torch.llm import (TransformerConfig, init_params,
                                        prepare_fused_decode_params)
    from pygpukit_tpu_torch.ops.nn import rope_tables
    bf16, f32 = torch.bfloat16, torch.float32
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    cfg = TransformerConfig(**CFG_1B)
    params = init_params(cfg, 0, bf16, dev)
    params["rope_cos"], params["rope_sin"] = rope_tables(2048, cfg.head_dim, cfg.rope_theta,
                                                         device=dev)
    params = prepare_fused_decode_params(cfg, params)
    lp = params["layers"]
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    e, inter = cfg.hidden_size, cfg.intermediate_size
    kvd = hk * d
    kc = (torch.randn((N_LAYERS, MAX, kvd), generator=g, device=dev) * 0.5).to(bf16)
    vc = torch.randn((N_LAYERS, MAX, kvd), generator=g, device=dev).to(bf16)
    ins = (params["embed"][7:8], params["rope_cos"][POS:POS + 1].to(f32).clone(),
           params["rope_sin"][POS:POS + 1].to(f32).clone(),
           torch.tensor([POS], dtype=torch.int32, device=dev), lp["w_qkv_cat"], lp["w_o"],
           lp["w_gu_cat"], lp["w_down"], lp["attn_norm_w"].to(f32).contiguous(),
           lp["mlp_norm_w"].to(f32).contiguous(),
           params["final_norm_w"].to(f32).reshape(1, -1).contiguous(), kc, vc)
    heads = dict(n_heads=hq, n_kv_heads=hk, head_dim=d, eps=cfg.norm_eps)
    ref = fused_decode_plain(*ins, **heads)
    dims = (N_LAYERS, e, inter, hq, hk, d, MAX)
    res: dict = {}
    for name, (subs, l2_rows) in VARIANTS.items():
        lib = libs[tuple(subs)]
        plan = (ctypes.c_int * 9)()
        rc = lib.pgk_fused_decode_plan(*dims, ctypes.addressof(plan))
        if rc != 0:
            raise SystemExit(f"variant {name}: plan failed ({rc})")
        if l2_rows is not None:
            plan[8] = l2_rows
        stamped = name in ("stage timestamps", "attention timestamps")
        scratch = torch.zeros((plan[6] + (N_LAYERS * 20 * plan[0] * 2 if stamped else 0),),
                              dtype=f32, device=dev)
        h_out = torch.empty((1, e), dtype=bf16, device=dev)
        k_new = torch.empty((N_LAYERS, kvd), dtype=f32, device=dev)
        v_new = torch.empty((N_LAYERS, kvd), dtype=f32, device=dev)
        barrier = torch.zeros((4,), dtype=torch.int32, device=dev)

        def call(lib=lib, plan=plan, scratch=scratch, h_out=h_out, k_new=k_new, v_new=v_new,
                 barrier=barrier):
            barrier.zero_()
            rc = lib.pgk_fused_decode(*(t.data_ptr() for t in ins), h_out.data_ptr(),
                                      k_new.data_ptr(), v_new.data_ptr(), scratch.data_ptr(),
                                      barrier.data_ptr(), ctypes.addressof(plan), *dims,
                                      float(cfg.norm_eps), 1.0 / math.sqrt(d),
                                      torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise SystemExit(f"variant {name}: CUDA error {rc}")
        call()
        torch.cuda.synchronize()
        rel = max(((a.float() - b.float()).norm() / b.float().norm()).item()
                  for a, b in zip((h_out, k_new, v_new), ref))
        if name not in DIAGNOSTICS and rel > 5e-2:
            raise SystemExit(f"variant {name}: relative L2 {rel}")
        res[name] = {"ms": time_ms(call), "rel_l2": rel, "l2_rows": plan[8]}
        if name == "attention timestamps":
            call()
            torch.cuda.synchronize()
            base = plan[6] + N_LAYERS * 12 * plan[0] * 2
            ts = scratch[base:base + N_LAYERS * 8 * plan[0] * 2].view(torch.int64).reshape(
                N_LAYERS, 8, plan[0]).double()
            units = ts[:, 0, :] > 0                            # blocks that ran a unit
            dur = (ts[:, 1:] - ts[:, :-1])[1:-1]               # [L - 2, 7, grid]
            mask = units[1:-1].unsqueeze(1).expand_as(dur)
            us = (dur * mask).sum(dim=(0, 2)) / mask.sum(dim=(0, 2)) / 1e3
            res[name]["us_per_unit"] = {k: round(v, 3) for k, v in zip(ATT_INTERVALS, us.tolist())}
        elif stamped:
            call()
            torch.cuda.synchronize()
            ts = scratch[plan[6]:plan[6] + N_LAYERS * 12 * plan[0] * 2].view(torch.int64).reshape(
                N_LAYERS, 12, plan[0]).double()
            nxt = torch.cat([ts[1:, :1], ts[-1:, -1:].expand(1, 1, plan[0])], 0)
            edges = torch.cat([ts, nxt], 1)                       # [L, 13, grid]
            dur = (edges[:, 1:] - edges[:, :-1])[1:-1].mean(dim=(0, 2)) / 1e3   # us
            res[name]["us_per_layer"] = {k: round(v, 3) for k, v in
                                         zip(INTERVALS, dur.tolist())}
        print(name, res[name], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out = {"card": smi.stdout.strip().splitlines()[0], "ms": res}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
