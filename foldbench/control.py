"""Read the control and the program on several seeds at a cell's own size,
in one process on the card.

  python3 foldbench/control.py --workload <cell> --seeds 11,12,13 \
      --seconds 30 [--fault <name>]

For each seed it runs the cell as `run.py --trace 0` does and judges, beside
the program's verdicts, the control of the configuration's reference, put in
the program's place over the same batches: for `exact`, the exact pipeline
on 16-bit MinHash lanes, the integer precision below the configurations'
32-bit lanes. With `--fault`, the program
runs with that fault of `faults.py` planted in its timed path. Prints one
JSON line per seed: the program's compared numbers and recall, and the
control's. The benchmark's own runs never run the control.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("foldbench: no CUDA card present", file=sys.stderr)
        return 2
    from foldbench import bench
    from foldbench.faults import FAULTS
    plant = FAULTS[args.fault] if args.fault else None
    for seed in (int(s) for s in args.seeds.split(",")):
        r = bench.run(args.workload, seed, args.seconds, False,
                      control=True, on_ready=plant)
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": r["correct"],
                          "checks": r["checks"], "metrics": r["metrics"],
                          "control": r["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
