"""The program-fingerprint gate of the port (counterpart of `tools/foldprog`).

It drives `repro_torch.analysis` over the registered hot-path program specs
(each run once, observed) and enforces two layers of checks:

  * per-program BUDGETS (F151-F156, F161): dtype discipline, aliasing of
    the updated state, memory, host syncs, gather/scatter ceilings, and
    the bucketed families' one-program-per-bucket budget;
  * golden FINGERPRINT drift (F162): each program's interface, aliasing,
    aten op counts, data-dependent op count and argument/output bytes are
    checked against `fingerprints/<name>.json` beside this module. Any
    structural change, intended or not, fails until re-baselined with
    `python -m repro_torch.analysis update`, so a program-shape regression
    arrives as a reviewable JSON diff.

`temp_bytes` compares within a band, and only when both sides have it (the
goldens are written on the CPU, which has no allocator counter); everything
else compares exactly. aten op names and counts depend on the torch
version, so the goldens hold for the install that wrote them: on a card,
compare a CUDA run with a CPU run in one process (chip_smoke.py phase 12),
never with the goldens.
"""
from __future__ import annotations

import json
import pathlib
from typing import Iterable

from repro_torch.analysis.analyze import (CHECK_DOCS, Violation,
                                          analyze_family, analyze_program)
from repro_torch.analysis.programs import default_specs, spec_families

FINGERPRINT_DIR = pathlib.Path(__file__).resolve().parent / "fingerprints"
REBASELINE = "python -m repro_torch.analysis update"

# fields compared exactly against the golden
_EXACT = ("in_avals", "out_avals", "ops", "aliased", "data_dependent_ops",
          "f64", "interface64", "family")
# memory fields fully determined by the interface -> exact
_MEM_EXACT = ("argument_bytes", "output_bytes")
# memory fields compared within a band: (field, allowed ratio either way)
_BANDED = (("temp_bytes", 1.25),)

__all__ = ["FINGERPRINT_DIR", "REBASELINE", "fingerprint_path",
           "load_golden", "write_fingerprints", "compare_fingerprint",
           "run_gate", "render_report"]


def fingerprint_path(name: str, out_dir=None) -> pathlib.Path:
    base = pathlib.Path(out_dir) if out_dir else FINGERPRINT_DIR
    return base / (name.replace("/", "__") + ".json")


def load_golden(name: str, out_dir=None) -> dict | None:
    p = fingerprint_path(name, out_dir)
    if not p.exists():
        return None
    return json.loads(p.read_text())


def write_fingerprints(reports: dict, out_dir=None) -> list[pathlib.Path]:
    """Write one golden JSON per analyzed program; returns written paths."""
    base = pathlib.Path(out_dir) if out_dir else FINGERPRINT_DIR
    base.mkdir(parents=True, exist_ok=True)
    written = []
    for name in sorted(reports):
        p = fingerprint_path(name, base)
        p.write_text(json.dumps(reports[name].fingerprint, indent=2,
                                sort_keys=True) + "\n")
        written.append(p)
    return written


def compare_fingerprint(name: str, golden: dict | None, fresh: dict
                        ) -> list[Violation]:
    """F162: structural diff of a fresh fingerprint against its golden."""
    if golden is None:
        return [Violation("F162", name,
                          f"no golden fingerprint checked in — run "
                          f"`{REBASELINE}` and commit the result")]
    out = []
    for field in _EXACT:
        g, f = golden.get(field), fresh.get(field)
        if g != f:
            if isinstance(g, dict) and isinstance(f, dict):
                keys = sorted(k for k in set(g) | set(f)
                              if g.get(k) != f.get(k))
                detail = "; ".join(
                    f"{k}: {g.get(k, 0)} (golden) -> {f.get(k, 0)} (current)"
                    for k in keys[:8])
            else:
                detail = f"{g!r} (golden) -> {f!r} (current)"
            out.append(Violation("F162", name, f"{field} drift: {detail}"))
    gm, fm = golden.get("memory") or {}, fresh.get("memory") or {}
    for field in _MEM_EXACT:
        if gm.get(field) != fm.get(field):
            out.append(Violation(
                "F162", name,
                f"memory.{field} drift: {gm.get(field)} (golden) -> "
                f"{fm.get(field)} (current)"))
    for field, tol in _BANDED:
        g, f = gm.get(field), fm.get(field)
        if g is None or f is None or g == f:
            continue
        if not (g / tol <= f <= g * tol):
            out.append(Violation(
                "F162", name,
                f"memory.{field} outside the ±{tol}x band: {g:,} (golden) "
                f"-> {f:,} (current)"))
    return out


def run_gate(select: Iterable[str] | None = None, golden_dir=None,
             golden: bool = True, device=None):
    """Analyze the registered specs on `device` (None: cuda, which raises
    without a card); return (reports, violations).

    reports: {name: ProgramReport}. violations: budget checks (F151-F161)
    plus, when `golden`, fingerprint drift (F162) including orphaned
    golden files for programs that no longer exist."""
    specs = default_specs(select)
    reports, violations = {}, []
    for spec in specs:
        rep = analyze_program(spec, device)
        reports[spec.name] = rep
        violations.extend(rep.violations)
    for fam, fspecs in spec_families(specs).items():
        violations.extend(analyze_family(fam, fspecs, reports))
    if golden:
        for name, rep in reports.items():
            violations.extend(compare_fingerprint(
                name, load_golden(name, golden_dir), rep.fingerprint))
        if select is None:     # the orphan sweep only makes sense on a full run
            base = pathlib.Path(golden_dir) if golden_dir else FINGERPRINT_DIR
            known = {fingerprint_path(n, base) for n in reports}
            for p in sorted(base.glob("*.json")) if base.exists() else []:
                if p not in known:
                    violations.append(Violation(
                        "F162", p.stem.replace("__", "/"),
                        f"orphaned golden {p.name}: no registered program "
                        f"spec produces it — delete it or restore the spec"))
    return reports, violations


def render_report(reports: dict, violations: list) -> str:
    """Diff-style failure report: program, check, what moved, how to fix."""
    if not violations:
        return (f"repro_torch.analysis: {len(reports)} programs analyzed, "
                f"all budgets and golden fingerprints hold")
    lines = [f"repro_torch.analysis: {len(violations)} violation(s) across "
             f"{len({v.program for v in violations})} program(s)", ""]
    by_prog: dict[str, list] = {}
    for v in violations:
        by_prog.setdefault(v.program, []).append(v)
    for prog in sorted(by_prog):
        lines.append(f"program {prog}")
        for v in by_prog[prog]:
            doc = CHECK_DOCS.get(v.check, "")
            lines.append(f"  {v.check} [{doc}]" if doc else f"  {v.check}")
            lines.append(f"      {v.message}")
        lines.append("")
    lines.append(f"If every change above is intended, re-baseline with "
                 f"`{REBASELINE}` and commit the fingerprint diff; "
                 f"otherwise fix the offending program.")
    return "\n".join(lines)
