"""CLI: `python -m repro_torch.analysis check` (exit 1 on violations).

Subcommands:

  check   run every registered program spec once, enforce the budgets and
          compare against the golden fingerprints (the gate)
  update  re-baseline: analyze and overwrite the golden fingerprints
          (refused while a budget fails); written on the CPU
  list    print the registered program specs and exit (runs nothing)

`--device` defaults to the card, as every entry point of the port does;
with no card it raises and never falls back. On the card the budgets, card
syncs and temp bytes are checked and the goldens are not compared (they
hold for the CPU install that wrote them). `--device cpu` runs the gate on
the CPU against the goldens; `update` writes them there and needs it.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.gate import (REBASELINE, render_report, run_gate,
                                       write_fingerprints)
from repro_torch.device import resolve_device


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Program-fingerprint gate for the port's hot-path "
                    "programs (each run once and observed).")
    ap.add_argument("command", nargs="?", default="check",
                    choices=("check", "update", "list"))
    ap.add_argument("--select", default=None,
                    help="comma-separated program names, name prefixes "
                         "(e.g. 'hnsw') or families to analyze "
                         "(default: all; disables the orphan-golden sweep)")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="default: cuda (raises without a card)")
    ap.add_argument("--fingerprints", default=None,
                    help="golden fingerprint directory override (default: "
                         "src/repro_torch/analysis/fingerprints)")
    args = ap.parse_args(argv)

    select = ([s.strip() for s in args.select.split(",") if s.strip()]
              if args.select else None)

    if args.command == "list":
        from repro_torch.analysis import default_specs
        for spec in default_specs(select):
            fam = f"  family={spec.family}" if spec.family else ""
            print(f"{spec.name}  alias={spec.alias_expect}{fam}")
        return 0

    if args.command == "update" and args.device != "cpu":
        ap.error("goldens are written on the CPU: pass --device cpu")
    device = resolve_device(args.device)
    golden = args.command == "check" and device.type == "cpu"
    reports, violations = run_gate(select=select, golden_dir=args.fingerprints,
                                   golden=golden, device=device)

    if args.command == "update":
        if violations:
            print(render_report(reports, violations), file=sys.stderr)
            print("\nrefusing to write goldens while budget checks fail — "
                  "fix the programs (or their budgets) first",
                  file=sys.stderr)
            return 1
        for p in write_fingerprints(reports, args.fingerprints):
            print(f"wrote {p}")
        return 0

    print(render_report(reports, violations),
          file=sys.stderr if violations else sys.stdout)
    if not golden:
        print(f"golden fingerprints not compared on {device.type}")
    if violations:
        print(f"\n{len(violations)} violation(s); re-baseline with "
              f"`{REBASELINE}` only if the drift is intended",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
