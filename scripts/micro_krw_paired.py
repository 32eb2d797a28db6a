#!/usr/bin/env python3
"""Time the paired design of the batch-rows step's row write and attention
(pygpukit_tpu_torch kernels rows 5 and 6), a design the port does not keep,
against the one it keeps, on the CUDA card:

    python3 scripts/micro_krw_paired.py [--turns 10] [--out build/krw_paired.json]

The paired design launches the row write (``csrc/kv_row_write.cu``) and then
the split attention (``csrc/batch_decode_attention.cu``) as its programmatic
dependent: the write signals ``griddepcontrol.launch_dependents`` first, the
attention's blocks start while it runs and wait (``griddepcontrol.wait``)
before they read anything. It is built here from copies of the committed
sources under build/ with PAIRED's text substitutions, by nvcc (sm_90a) into
a library of its own, and called through the port's own wrappers
(``kv_rows_write``, ``batch_decode_attention``) with that library loaded in
place of the port's.

At the serving shape (B 8, 32/4 heads, D 64, MAX 1024, chip_smoke.py phase
3's contexts), each form over 22 layers captured once in a CUDA graph and
replayed between CUDA events, in ``--turns`` alternating turns:
``paired``; ``fused`` (``kv_write_attention``, the kept design: the rows
stored by the attention's own pass one); ``separate`` (the two committed
kernels one after the other); ``attention`` (the attention alone). Before
timing, the paired form's pools and output are held bitwise against the
separate form's. Prints and writes one JSON object: the card (nvidia-smi
name and power limit) and, per form, the ms a layer of every turn, their
median and spread. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the serving shape: slots, layers, MAX, Hk*D, Hq, D; lens = poss + 1
PAIR = (8, 22, 1024, 256, 32, 64)
PAIR_POSS = (0, 512, 1023, 1499, 36, 699, 1024, 255)

_PDL_LAUNCH = '''
// pgk_launch_attention with pass one as the programmatic dependent of the
// grid before it
template <class Q, class KV, int D, class Kernel, class... Args>
static cudaError_t launch_attention_pdl(Kernel kernel, int g, int n_split, int bh, int heads,
                                        float* part, Q* out, cudaStream_t st, Args... args) {
  const size_t smem = PgkAttnSmem<KV, D>::bytes(g);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, bh);
  cfg.blockDim = dim3(32 * g);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)heads * n_split;
  pgk_attn_combine_kernel<Q, D><<<heads, 32, 0, st>>>(part, part + n, part + 2 * n, out, n_split);
  return cudaGetLastError();
}

template <class Q, class KV, int D>
struct LaunchBda {'''

# source -> (text, replacement), each text found once in the committed source
PAIRED = {
    "kv_row_write.cu": [
        ("  const int b = blockIdx.x;\n  const bool is_v = blockIdx.y == 1;",
         '  asm volatile("griddepcontrol.launch_dependents;");\n'
         "  const int b = blockIdx.x;\n  const bool is_v = blockIdx.y == 1;")],
    "batch_decode_attention.cu": [
        ("  const int g_heads = hq / hk;\n  const int b = blockIdx.y / hk;",
         '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
         "  const int g_heads = hq / hk;\n  const int b = blockIdx.y / hk;"),
        ("template <class Q, class KV, int D>\nstruct LaunchBda {", _PDL_LAUNCH),
        ("    return pgk_launch_attention<Q, KV, D>(\n        bda_kernel<Q, KV, D>,",
         "    return launch_attention_pdl<Q, KV, D>(\n        bda_kernel<Q, KV, D>,")],
    "runtime.cu": []}


def build_paired(out_dir: Path) -> Path:
    """The paired design's library: the substituted copies, one nvcc."""
    sys.path.insert(0, str(ROOT))
    from pygpukit_tpu_torch.kernels._build import CSRC, NVCC_FLAGS, nvcc_path
    out_dir.mkdir(parents=True, exist_ok=True)
    cus = []
    for src, subs in PAIRED.items():
        text = (CSRC / src).read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"{src}: {old!r} not found once")
            text = text.replace(old, new)
        cu = out_dir / f"paired_{src}"
        cu.write_text(text)
        cus.append(str(cu))
    lib = out_dir / "libpaired.so"
    res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-shared", "-I", str(CSRC), "-o", str(lib),
                          *cus], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (out_dir / "build.log").write_text(res.stdout)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on the paired design:\n{res.stdout[-3000:]}")
    return lib


@contextmanager
def loaded(path: Path):
    """The port's wrappers launch from the library at ``path`` inside."""
    from pygpukit_tpu_torch.kernels import _build
    lib = ctypes.CDLL(str(path))
    for name in ("pgk_kv_rows_write", "pgk_batch_decode_attention"):
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.pgk_error_string.argtypes = [ctypes.c_int]
    lib.pgk_error_string.restype = ctypes.c_char_p
    kept = _build.library()
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = kept


def time_ms(fn, n_variants: int, reps: int = 20) -> float:
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
    ap.add_argument("--turns", type=int, default=10)
    ap.add_argument("--out", default="build/krw_paired.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("micro_krw_paired: no CUDA device is visible", file=sys.stderr)
        return 2
    paired_lib = build_paired(ROOT / "build" / "krw_paired")
    from pygpukit_tpu_torch import set_deterministic_numerics
    from pygpukit_tpu_torch import kernels as K
    set_deterministic_numerics()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    b, nl, mx, lanes, hq, d = PAIR
    bf16 = torch.bfloat16
    kp = torch.randn((b, nl, mx, lanes), generator=g, device=dev).to(bf16)
    vp = torch.randn((b, nl, mx, lanes), generator=g, device=dev).to(bf16)
    kn = torch.randn((b, lanes // d, d), generator=g, device=dev).to(bf16)
    vn = torch.randn((b, lanes // d, d), generator=g, device=dev).to(bf16)
    q = torch.randn((b, 1, hq, d), generator=g, device=dev).to(bf16)
    poss = torch.tensor(PAIR_POSS, dtype=torch.int32, device=dev)
    lens = poss + 1

    def separate(i):
        K.kv_rows_write(kp, vp, kn, vn, i, poss)
        return K.batch_decode_attention(q, kp, vp, i, lens)

    def paired(i):
        with loaded(paired_lib):
            return separate(i)
    k1, v1 = kp[:, :2].clone(), vp[:, :2].clone()
    want = separate(1)
    with loaded(paired_lib):
        K.kv_rows_write(k1, v1, kn, vn, 1, poss)
        got = K.batch_decode_attention(q, k1, v1, 1, lens)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(k1[:, 1], kp[:, 1])
            and torch.equal(v1[:, 1], vp[:, 1])):
        raise SystemExit("paired: not bitwise the separate launches")
    del k1, v1
    forms = {"paired": paired,
             "fused": lambda i: K.kv_write_attention(q, kp, vp, kn, vn, i, poss, lens),
             "separate": separate,
             "attention": lambda i: K.batch_decode_attention(q, kp, vp, i, lens)}
    turns: dict = {f: [] for f in forms}
    for _ in range(args.turns):
        for f, fn in forms.items():
            turns[f].append(time_ms(fn, nl))
    ms = {f: {"turns": v, "median": statistics.median(v), "spread": max(v) - min(v)}
          for f, v in turns.items()}
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    doc = {"card": res.stdout.strip().splitlines()[0], "layers": nl, "ms_a_layer": ms}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(doc, indent=1))
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
