"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix and metric found by name; the import rule."""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from foldbench import bench
from foldbench.traffic.generate import load_mix

ROOT = bench.ROOT
HERE = ROOT / "foldbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = bench.load_spec()


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["foldbench"]
    assert SPEC["command"][:2] == ["python3", "foldbench/run.py"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    # a full check of 24 cells fits its time
    assert ((2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


def test_names_units_and_keys():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"] + SPEC["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("foldbench/")
        assert (ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        ends = {m["name"] for m in bench.cell_metrics(SPEC, cell, False)}
        assert "setup_s" in ends and len(ends) >= 2
        assert bench.cell_metrics(SPEC, cell, True)


def test_every_piece_is_found_by_name():
    for c in SPEC["configs"]:
        cfg = bench.load_config(c["name"])
        assert (HERE / "drivers" / f"{cfg['driver']}.py").is_file()
        assert (HERE / "reference"
                / f"{cfg.get('reference', 'exact')}.py").is_file()
        assert {"fold", "prefill", "limits", "guarantees",
                "source"} <= set(cfg)
    for w in SPEC["workloads"]:
        mix = load_mix(w["traffic"])
        assert mix["loop"] in ("closed", "open")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert bench.read_metric(m["name"], {"judge": {"exact_dups": 0},
                                             "setup_s": 1.0}) in (None, 1.0)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in HERE.rglob("*.py") if "cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_import_rule(path):
    names = _imports(path)
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names
    if {"reference", "roofline"} & set(path.relative_to(HERE).parts):
        assert "repro_torch" not in names, names


def test_import_rule_compares_whole_top_level_names(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import repro_torch.core\nfrom reprox import y\n"
                 "import jax.numpy\n")
    assert _imports(p) == {"repro_torch", "reprox", "jax"}
    assert bench.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    assert json.loads(json.dumps(SPEC)) == SPEC
