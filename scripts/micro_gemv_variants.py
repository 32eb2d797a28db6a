#!/usr/bin/env python3
"""Time variants of the w4a8 GEMV (``csrc/w4a8_gemv.cu``, row 1) and the
converting GEMV (``csrc/conv_gemv.cu``, row 10) on the CUDA card.

    python3 scripts/micro_gemv_variants.py [--out build/gemv_variants.json]

A variant is the committed source with one ``constexpr`` constant given
another value (a text substitution in a copy under build/), compiled by
nvcc (sm_90a) into its own library, all variants at once, and called
through its C entry; the committed values run too. Device times by
CUDA-graph replay (calls over 8 weight variants captured once, replayed
between CUDA events), summed over the 1.1B model's four projections:
row 1 at rows 1, 2, 5 and 8 launched after its activation quantization and
as its programmatic dependent,
row 10 on e4m3 weights at rows 1 and 8 (the committed versions also per
projection, and row 1 at rows 1 and 8 launched eagerly between CUDA
events beside the graph time, as the host issues them and queued behind a
spin kernel); two diagnostic variants of row 1 (DIAGNOSTICS, outputs not
checked); a graph of one-element adds gives the floor a graph node costs.
Each variant's first call is held
against the plain version (row 1 bitwise, row 10 within one bf16 ulp plus
1e-4 of max |y|). Prints and writes one JSON object: the card (nvidia-smi
name and power limit) and ms per variant and case. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROJ = {"qkv": (2560, 2048), "o": (2048, 2048), "gate_up": (11264, 2048), "down": (2048, 5632)}
N_VAR = 8
# source -> constant -> values tried beside the committed one
VARIANTS = {"w4a8_gemv.cu": {"kBatch": (2,), "kNarrowChunks": (64,)},
            "conv_gemv.cu": {"kTargetBlocks": (132, 528)}}
FORMS = {"separate": 0, "pdl": 1}
# diagnostic variants of row 1, outputs not checked: a text substituted in
# the source. Without the quantization launch the kernel alone runs (on stale
# xq); without its wait the pdl form overlaps the quantization as far as
# the graph lets it
DIAGNOSTICS = {"no quantization launch": (
    "w4a8_gemv.cu",
    "cudaError_t e = x_f32 ? launch_quant<float>(x, rows, 2 * k_half, a.xq, a.sx, a.st)\n"
    "                          : launch_quant<__nv_bfloat16>(x, rows, 2 * k_half, a.xq, a.sx, a.st);",
    "cudaError_t e = cudaSuccess;"),
    "pdl without its wait": (
    "w4a8_gemv.cu", 'asm volatile("griddepcontrol.wait;" ::: "memory");', "")}


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


def eager_ms(fn, n_variants: int, iters: int = 64, queued: bool = False) -> float:
    """Time per call of ``fn(i)`` launched eagerly (no graph), CUDA events
    around the whole loop. ``queued``: a spin kernel of 4e7 cycles first, so every
    launch is queued before the device reaches it and the time is the
    device's, launch gaps included, not the host's."""
    import torch
    for i in range(n_variants):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(40_000_000)            # cycles: about 20 ms
    start.record()
    for i in range(iters):
        fn(i % n_variants)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def build_variants(out_dir: Path) -> dict:
    """(source, constant or "committed", value) -> built library path; all
    nvcc processes started together."""
    sys.path.insert(0, str(ROOT))
    from pygpukit_tpu_torch.kernels._build import CSRC, nvcc_path
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src, consts in VARIANTS.items():
        text = (CSRC / src).read_text()
        cases = [("committed", None)] + [(c, v) for c, vals in consts.items() for v in vals]
        cases += [(name, "diagnostic") for name, (f, _, _) in DIAGNOSTICS.items() if f == src]
        for const, value in cases:
            body = text
            if value == "diagnostic":
                _, old, new = DIAGNOSTICS[const]
                if text.count(old) != 1:
                    raise SystemExit(f"{src}: {old!r} not found once")
                body = text.replace(old, new)
            elif const != "committed":
                body, n = re.subn(rf"(constexpr int {const} = )\d+;", rf"\g<1>{value};", text)
                if n != 1:
                    raise SystemExit(f"{src}: constant {const} not found once")
            stem = f"{Path(src).stem}_{re.sub(r'[^A-Za-z0-9]', '_', const)}_{value}"
            cu = out_dir / f"{stem}.cu"
            cu.write_text(body)
            lib = out_dir / f"lib{stem}.so"
            cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                   "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", "-I", str(CSRC), "-o",
                   str(lib), str(cu)]
            jobs[(src, const, value)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {key}:\n{log[-3000:]}")
        built[key] = lib
    return built


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/gemv_variants.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("micro_gemv_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    built = build_variants(ROOT / "build" / "gemv_variants")
    from pygpukit_tpu_torch import set_deterministic_numerics
    from pygpukit_tpu_torch.kernels import conv_matmul_plain, w4a8_matmul_plain
    set_deterministic_numerics()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    P = ctypes.c_void_p
    I = ctypes.c_int
    weights = {}
    for name, (n, k) in PROJ.items():
        weights[name] = (
            torch.randint(0, 256, (N_VAR, n, k // 2), generator=g, device=dev, dtype=torch.uint8),
            (torch.randn((N_VAR, k, n), generator=g, device=dev) * 64).to(torch.float8_e4m3fn),
            torch.rand((N_VAR, n), generator=g, device=dev) * 1e-3 + 1e-4)
    xs = {(name, rows): (torch.randn((rows, k), generator=g, device=dev) * 2).to(torch.bfloat16)
          for name, (n, k) in PROJ.items() for rows in (1, 2, 5, 8)}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    result: dict = {}
    for (src, const, value), path in built.items():
        lib = ctypes.CDLL(str(path))
        tag = (f"{src} committed" if const == "committed" else f"{src} {const}"
               if value == "diagnostic" else f"{src} {const}={value}")
        checked = value != "diagnostic"
        ms: dict = {}
        if src == "w4a8_gemv.cu":
            fn = lib.pgk_w4a8_gemv
            fn.argtypes = [P, I, P, P, P, P, P, I, I, I, I, P]
            fn.restype = I
            for name, (n, k) in PROJ.items():
                w, _, sc = weights[name]
                for rows in (1, 2, 5, 8):
                    x = xs[(name, rows)]
                    xq = torch.empty((rows, k), dtype=torch.int8, device=dev)
                    sx = torch.empty((rows,), dtype=torch.float32, device=dev)
                    for form, code in FORMS.items():
                        out = torch.empty((rows, n), dtype=torch.bfloat16, device=dev)

                        def call(i, out=out, x=x, xq=xq, sx=sx, code=code):
                            rc = fn(x.data_ptr(), 0, w[i].data_ptr(), sc[i].data_ptr(),
                                    xq.data_ptr(), sx.data_ptr(), out.data_ptr(), rows, n,
                                    k // 2, code, stream())
                            if rc:
                                raise SystemExit(f"{tag}: CUDA error {rc}")
                        call(0)
                        ref = w4a8_matmul_plain(x, w[0], sc[0])
                        if checked and not torch.equal(out.view(torch.int16),
                                                       ref.view(torch.int16)):
                            raise SystemExit(f"{tag} {name} rows {rows} {form}: not bitwise")
                        key = f"rows{rows}_{form}"
                        t = time_ms(call, N_VAR)
                        ms[key] = ms.get(key, 0.0) + t
                        if const == "committed":
                            ms[f"{key}_{name}"] = t
                            if rows in (1, 8):
                                ms[f"{key}_eager"] = ms.get(f"{key}_eager", 0.0) + eager_ms(
                                    call, N_VAR)
                                ms[f"{key}_queued"] = ms.get(f"{key}_queued", 0.0) + eager_ms(
                                    call, N_VAR, queued=True)
        else:
            fn = lib.pgk_conv_gemv
            fn.argtypes = [P, P, I, P, P, I, I, I, P]
            fn.restype = I
            plan_fn = lib.pgk_conv_gemv_plan
            plan_fn.argtypes = [I, I, I, P]
            plan_fn.restype = I
            plan = (ctypes.c_int * 5)()
            for name, (n, k) in PROJ.items():
                _, wc, sc = weights[name]
                for rows in (1, 8):
                    x = xs[(name, rows)]
                    plan_fn(rows, n, k, ctypes.addressof(plan))
                    out = torch.empty((rows, n), dtype=torch.bfloat16, device=dev)

                    def call(i, out=out, x=x):
                        rc = fn(x.data_ptr(), wc[i].data_ptr(), 0, sc[i].data_ptr(),
                                out.data_ptr(), rows, n, k, stream())
                        if rc:
                            raise SystemExit(f"{tag}: CUDA error {rc}")
                    call(0)
                    ref = conv_matmul_plain(x, wc[0], sc[0]).float()
                    tol = ref.abs() * 2.0 ** -7 + 1e-4 * ref.abs().max()
                    if checked and not bool(((out.float() - ref).abs() <= tol).all()):
                        raise SystemExit(f"{tag} {name} rows {rows}: off the tolerance")
                    key = f"e4m3_rows{rows}"
                    t = time_ms(call, N_VAR)
                    ms[key] = ms.get(key, 0.0) + t
                    if const == "committed":
                        ms[f"{key}_{name}"] = t
                    ms[f"{key}_blocks_{name}"] = plan[1] * plan[2]
        result[tag] = ms
        print(tag, json.dumps(ms), flush=True)
    # the floor a graph node costs: one 4-byte add_ a call
    one = torch.zeros(1, device=dev)
    result["graph node floor"] = {"add_one_element": time_ms(lambda i: one.add_(1), N_VAR)}
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    doc = {"card": res.stdout.strip().splitlines()[0], "ms": result}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(doc, indent=1))
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
