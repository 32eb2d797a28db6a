"""Benchmark CLI: ``python -m pygpukit_tpu_torch.benchmark [suite ...]``
(counterpart of ``python -m pygpukit_tpu.benchmark``); each suite's table
is printed as markdown. It runs on the backend's device (the card)."""

from __future__ import annotations

import argparse

from .suites import SUITES


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="pygpukit_tpu_torch.benchmark")
    ap.add_argument("suites", nargs="*", default=[],
                    help=f"suites to run: {', '.join(SUITES)} (default: all)")
    ap.add_argument("--sizes", type=int, nargs="*", default=None,
                    help="gemm sizes override")
    args = ap.parse_args(argv)

    names = args.suites or list(SUITES)
    for name in names:
        if name not in SUITES:
            raise SystemExit(f"unknown suite {name!r}; choose from {list(SUITES)}")
        cls = SUITES[name]
        suite = (cls(sizes=tuple(args.sizes)) if name == "gemm" and args.sizes
                 else cls())
        suite.run()
        print(suite.report_markdown())
        print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
