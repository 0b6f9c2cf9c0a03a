"""Run one cell of the root BENCHMARK.json once.

  python3 foldbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer ones with `--trace 1`), `device`, with tracing
`breakdown`, and last `checks`, each number compared beside its limit
(also the last lines of standard error). Exits non-zero, with no result,
when no CUDA card is present, when the program cannot be imported, or
when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for p in (ROOT, os.path.join(ROOT, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import json
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {c["name"]: c for c in json.load(f)["workloads"]}
    if args.workload not in cells:
        print(f"foldbench: no cell {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print("foldbench: no CUDA card present; nothing was run",
              file=sys.stderr)
        return 2
    from foldbench import bench
    result = bench.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), device="cuda", t_start=T_START)
    bad = bench.forbidden_modules()
    if bad:
        print(f"foldbench: these modules were loaded and must not be: {bad}",
              file=sys.stderr)
        return 3
    bench.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
