#!/usr/bin/env python3
"""Time variants of the int4 w4a16 GEMV (``csrc/w4a16_gemv.cu`` on
``csrc/w4a16_mma.cuh``, row 8) on the CUDA card.

    python3 scripts/micro_w4a16_gemv_variants.py [--parent DIR] [--out FILE]

A variant is the committed source with one or two texts substituted (a
``constexpr`` constant given another value, the L2 hint or the launch's
programmatic attribute taken out), in a copy under build/, compiled by nvcc
(sm_90a) into its own library, all variants at once, and called through its
C entry; the committed source runs too, and with ``--parent DIR`` the
``w4a16_gemv.cu`` of another checkout as the variant "parent". Diagnostic
variants (DIAGNOSTICS: without the dequantization, without the products;
outputs not checked) split the time. Device times by CUDA-graph replay
(calls over 8 weight variants captured once, replayed between CUDA
events), per projection of the 1.1B model and summed over the four, at
rows 1, 2, 5 and 8. Each variant's first call (but the diagnostics') is
held against ``w4a16_matmul_plain`` within one bf16 ulp plus 1e-4 of max
|y|. Prints and writes one JSON object: the card (nvidia-smi name and
power limit), each variant's ptxas register line and ms per variant,
projection and rows. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "pygpukit_tpu_torch" / "csrc"
PROJ = {"qkv": (2560, 2048), "o": (2048, 2048), "gate_up": (11264, 2048), "down": (2048, 5632)}
ROWS = (1, 2, 5, 8)
N_VAR = 8
HDR, CU = "w4a16_mma.cuh", "w4a16_gemv.cu"
# name -> [(file, old text, new text)]
VARIANTS = {
    "committed": [],
    "1 round in flight": [(CU, "constexpr int kBatch = 2;", "constexpr int kBatch = 1;")],
    "3 rounds in flight": [(CU, "constexpr int kBatch = 2;", "constexpr int kBatch = 3;")],
    "4 rounds in flight": [(CU, "constexpr int kBatch = 2;", "constexpr int kBatch = 4;")],
    "warps doubled": [(CU, "constexpr int kNarrowChunks = 32;", "constexpr int kNarrowChunks = 16;"),
                      (CU, "constexpr int kWideChunks = 128;", "constexpr int kWideChunks = 64;")],
    "warps halved": [(CU, "constexpr int kNarrowChunks = 32;", "constexpr int kNarrowChunks = 64;"),
                     (CU, "constexpr int kWideChunks = 128;", "constexpr int kWideChunks = 256;")],
    "no L2 hint": [(CU, "ld.global.nc.L1::no_allocate.L2::256B.v4.u32",
                    "ld.global.nc.L1::no_allocate.v4.u32")],
    "ordinary launch": [(CU, "attr[0].val.programmaticStreamSerializationAllowed = 1;",
                         "attr[0].val.programmaticStreamSerializationAllowed = 0;")],
}
# diagnostic variants, outputs not checked: without the dequantization (the
# loaded word taken as the pair), without the products (the A and B
# registers XORed into the sums)
NO_DEQUANT = [(HDR, "  return __hsub2(as_bf2(u), as_bf2(0x43084308u));               // the nibble",
               "  return as_bf2(wd ^ wd4);")]
NO_MMA = [(HDR, '  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "\n'
                '      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"\n'
                '      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])\n'
                '      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));',
           "  d[0] += __uint_as_float((a0 ^ a1 ^ a2 ^ a3 ^ b0 ^ b1) & 0x3fffffffu);")]
DIAGNOSTICS = {"no dequantization": NO_DEQUANT, "no products": NO_MMA}
VARIANTS.update(DIAGNOSTICS)


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


def build_variants(out_dir: Path, parent: Path | None) -> tuple[dict, dict]:
    """Compile every variant in parallel: (name -> C entry, name -> ptxas
    register lines)."""
    sys.path.insert(0, str(ROOT))
    from pygpukit_tpu_torch.kernels._build import NVCC_FLAGS, nvcc_path
    variants = dict(VARIANTS)
    if parent is not None:
        variants["parent"] = None
    procs = {}
    for name, subs in variants.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        src_dir = parent / "pygpukit_tpu_torch" / "csrc" if subs is None else CSRC
        for src in sorted(p.name for p in src_dir.glob("*.cuh")) + [CU]:
            text = (src_dir / src).read_text()
            for f, old, new in subs or []:
                if f == src:
                    if old not in text:
                        raise SystemExit(f"variant {name}: {old!r} not in {src}")
                    text = text.replace(old, new)
            (d / src).write_text(text)
        lib = d / "lib.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-shared", "-o", str(lib), str(d / CU)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs, regs = {}, {}
    for name, (p, lib) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc failed\n{log[-3000:]}")
        regs[name] = [line.strip() for line in log.splitlines() if "registers" in line]
        fn = ctypes.CDLL(str(lib)).pgk_w4a16_gemv
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs, regs


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="another checkout whose kernel to time")
    ap.add_argument("--out", default=str(ROOT / "build" / "w4a16_gemv_variants.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("micro_w4a16_gemv_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    libs, regs = build_variants(ROOT / "build" / "w4a16_gemv_variants",
                                Path(args.parent).resolve() if args.parent else None)
    from pygpukit_tpu_torch.kernels import w4a16_matmul_plain
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    res: dict = {name: {} for name in libs}
    for proj, (n, k) in PROJ.items():
        w = torch.randint(0, 256, (N_VAR, n, k // 2), generator=g, device=dev, dtype=torch.uint8)
        s = torch.rand((N_VAR, n), generator=g, device=dev) * 1e-3 + 1e-4
        for rows in ROWS:
            x = (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
            y = torch.empty((rows, n), dtype=torch.bfloat16, device=dev)
            ref = w4a16_matmul_plain(x, w[0], s[0]).float()
            tol = ref.abs() * 2.0 ** -7 + 1e-4 * ref.abs().max()
            for name, fn in libs.items():
                def call(i, fn=fn, name=name):
                    rc = fn(x.data_ptr(), w[i].data_ptr(), s[i].data_ptr(), y.data_ptr(), rows,
                            n, k // 2, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise SystemExit(f"variant {name}: CUDA error {rc}")
                call(0)
                torch.cuda.synchronize()
                if name not in DIAGNOSTICS and not bool(((y.float() - ref).abs() <= tol).all()):
                    raise SystemExit(f"variant {name} {proj} rows {rows}: off the tolerance")
                ms = time_ms(call, N_VAR)
                res[name][f"{proj}_rows{rows}"] = ms
                key = f"four_rows{rows}"
                res[name][key] = res[name].get(key, 0.0) + ms
        del w, s
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out = {"card": smi.stdout.strip().splitlines()[0], "registers": regs, "ms": res}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"card": out["card"], "four": {
        name: {k: v for k, v in r.items() if k.startswith("four")} for name, r in res.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
