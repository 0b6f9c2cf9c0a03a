"""repro_torch.analysis — program analysis for the port's hot-path tensor
programs (port of `repro.analysis`): each program is run ONCE at its spec's
pinned geometry and observed, where the reference traces, lowers and
compiles without executing (see analyze.py for why, and for what each
check means in PyTorch).

  programs.py  the registry of analyzable hot-path PROGRAM SPECS: each
               backend / service surface registers makers of `(fn, args,
               kwargs)` for its search, insert, delete/compact, fused
               sharded step and the service's bucketed variants, with
               per-program budgets and the expected state aliasing.
  inputs.py    the specs' seeded inputs: a small filled index per geometry,
               built once per process.
  analyze.py   the analyzer: one observed run per spec, a JSON-able
               FINGERPRINT (interface, aten op counts, aliasing, bytes,
               host syncs) and budget violations.
  gate.py      golden fingerprints and drift (F162);
               `python -m repro_torch.analysis check|list|update`.
"""
from repro_torch.analysis.analyze import (CHECK_DOCS, ProgramReport,
                                          RunMeasure, Violation,
                                          analyze_family, analyze_program,
                                          measure_run)
from repro_torch.analysis.programs import (ProgramBudget, ProgramSpec,
                                           default_specs, iter_specs,
                                           register_programs, spec_families)

__all__ = [
    "CHECK_DOCS", "ProgramBudget", "ProgramReport", "ProgramSpec",
    "RunMeasure", "Violation", "analyze_family", "analyze_program",
    "default_specs", "iter_specs", "measure_run", "register_programs",
    "spec_families",
]
