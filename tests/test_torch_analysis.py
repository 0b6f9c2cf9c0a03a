"""repro_torch.analysis, the port's program gate (counterpart of the
reference's tests/test_foldprog.py):

  * the registry and its selection by name, prefix and family;
  * the gate runs CLEAN on the real tree on the CPU: every registered
    program within its budgets and equal to its checked-in golden;
  * one canary per check that makes it fire (F151-F156, F161, F162);
  * golden round trip and drift, and the CLI's exit codes.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch.analysis import (ProgramBudget, ProgramSpec, analyze_family,
                                  analyze_program, default_specs,
                                  measure_run, spec_families)
from repro_torch.analysis import gate
from repro_torch.analysis.__main__ import main
from repro_torch.core import hnsw as T
from repro_torch.core.dedup import FoldConfig
from repro_torch.service.batcher import default_batch_buckets

NAMES = ["brute/chunk_best", "hnsw/compact", "hnsw/delete", "hnsw/insert",
         "hnsw/search", "hnsw_raw/search", "hnsw_sharded/fused_step",
         "service/search_b016", "service/search_b032", "service/search_b064",
         "service/search_b128"]


# --------------------------------------------------------------- registry
def test_registry_covers_every_surface():
    assert [s.name for s in default_specs()] == NAMES
    fams = spec_families(default_specs())
    assert list(fams) == ["service/search"]
    assert len(fams["service/search"]) == len(default_batch_buckets(128))


@pytest.mark.parametrize("select,want", [
    (["brute"], {"brute/chunk_best"}),
    (["hnsw"], {"hnsw/search", "hnsw/insert", "hnsw/delete", "hnsw/compact"}),
    (["service/search"], {f"service/search_b{b:03d}"
                          for b in default_batch_buckets(128)}),
    (["hnsw/delete", "hnsw_raw"], {"hnsw/delete", "hnsw_raw/search"}),
])
def test_select_by_name_prefix_and_family(select, want):
    assert {s.name for s in default_specs(select)} == want


# ------------------------------------------------------ real tree: clean
@pytest.fixture(scope="module")
def gate_run():
    torch.set_num_threads(1)
    return gate.run_gate(device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_real_tree_program_is_clean_and_matches_its_golden(gate_run, name):
    reports, violations = gate_run
    mine = [v.render() for v in violations if v.program == name]
    assert mine == [], "\n".join(mine)
    fp = reports[name].fingerprint
    assert fp["f64"] == [] and fp["interface64"] == []
    assert fp == gate.load_golden(name)


def test_real_tree_gate_is_clean(gate_run):
    """The whole gate: budgets, the family budget, goldens, no orphan."""
    reports, violations = gate_run
    assert violations == [], gate.render_report(reports, violations)
    assert sorted(reports) == NAMES
    on_disk = {p.stem.replace("__", "/")
               for p in gate.FINGERPRINT_DIR.glob("*.json")}
    assert on_disk == set(NAMES)


# ------------------------------------------------------------- canaries
_TINY = FoldConfig(capacity=1024, T=1024).hnsw()


@pytest.fixture(scope="module")
def tiny_index():
    """A 256-doc index at capacity 1024, W=32, from seeded random rows."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(5)
    vecs = torch.from_numpy(
        rng.integers(0, 2**32, (320, _TINY.words), dtype=np.uint64)
        .astype(np.uint32).view(np.int32))
    vecs &= torch.from_numpy(np.where(rng.random((320, _TINY.words)) < 0.3,
                                      -1, 0).astype(np.int32))
    pcs = T.popc(vecs).sum(-1).to(torch.int32)
    state = T.hnsw_init(_TINY, "cpu")
    for i in range(4):
        sl = slice(64 * i, 64 * (i + 1))
        state, _ = T.hnsw_insert_batch(_TINY, state, vecs[sl], pcs[sl],
            torch.from_numpy(T.sample_levels(64, _TINY, seed=i)),
            torch.ones(64, dtype=torch.bool))
    return state, vecs[256:], pcs[256:]


def _spec(name, fn, args, kwargs=None, **kw):
    def make(device):
        return fn, tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                         for a in args), dict(kwargs or {})
    return ProgramSpec(name=name, make=make, **kw)


def _on_cpu(spec):
    return analyze_program(spec, "cpu")


def _clone(state):
    return T.HNSWState(*(t.clone() for t in state))


def _search_args(tiny_index):
    state, q, _ = tiny_index
    return (_TINY, _clone(state), q)


def test_clean_search_fires_nothing(tiny_index):
    rep = _on_cpu(_spec("canary/search", T.hnsw_search,
                                _search_args(tiny_index), {"k": 2}))
    assert rep.violations == []
    assert rep.fingerprint["in_avals"][-1] == "int32[64,32]"
    assert rep.fingerprint["out_avals"] == ["int32[64,2]", "float32[64,2]"]
    assert rep.fingerprint["data_dependent_ops"] > 0
    assert rep.fingerprint["memory"]["temp_bytes"] is None


def test_f151_float64_canary(tiny_index, monkeypatch):
    """A float64 promotion in the bitmap distance (the reference's canary)
    names the program and the promoted dtype."""
    def dist64(px, pa, pb):
        denom = pa.to(torch.int64) + pb.to(torch.int64) + px
        d = 2.0 * px.to(torch.float64) / torch.clamp(denom, min=1)
        return torch.where(denom > 0, d, torch.zeros_like(d)).float()
    monkeypatch.setattr(T, "_bitmap_dist", dist64)
    rep = _on_cpu(_spec("canary/f64_search", T.hnsw_search,
                                _search_args(tiny_index), {"k": 2}))
    hits = [v for v in rep.violations if v.check == "F151"]
    assert hits and hits[0].program == "canary/f64_search"
    assert "float64" in hits[0].message
    assert rep.fingerprint["out_avals"][1] == "float32[64,2]"  # F152 quiet


def test_f152_64bit_interface_canary(tiny_index):
    state, q, _ = tiny_index

    def widened(cfg, st, queries):
        ids, sims = T.hnsw_search(cfg, st, queries, k=2)
        return ids.to(torch.int64), sims
    rep = _on_cpu(_spec("canary/wide_out", widened,
                                (_TINY, _clone(state), q)))
    assert [v.check for v in rep.violations] == ["F152"]
    assert "out:int64[64,2]" in rep.violations[0].message


def test_f153_cloned_state_canary(tiny_index):
    """A delete that works on a copy of the state (a full copy per call)
    aliases no input leaf where the in-place delete aliases all eight."""
    state = tiny_index[0]
    ids = torch.arange(0, 64, 4, dtype=torch.int32)
    clean = _on_cpu(_spec(
        "canary/delete", T.hnsw_delete, (_TINY, _clone(state), ids),
        alias_expect=8))
    assert clean.violations == [] and clean.fingerprint["aliased"] == 8

    def copying(cfg, st, i):
        return T.hnsw_delete(cfg, _clone(st), i)
    rep = _on_cpu(_spec("canary/delete_copy", copying,
                                (_TINY, _clone(state), ids), alias_expect=8))
    hits = [v for v in rep.violations if v.check == "F153"]
    assert hits and "copied per call" in hits[0].message
    assert rep.fingerprint["aliased"] == 0


def test_f154_peak_bytes_canary(tiny_index):
    """The CPU has no temp counter, but argument + output bytes are exact:
    a peak ceiling below them fires."""
    rep = _on_cpu(_spec("canary/search", T.hnsw_search,
                                _search_args(tiny_index), {"k": 2}))
    mem = rep.fingerprint["memory"]
    need = mem["argument_bytes"] + mem["output_bytes"]
    fits = _on_cpu(_spec("canary/search", T.hnsw_search,
                                 _search_args(tiny_index), {"k": 2},
                                 budget=ProgramBudget(peak_bytes=need)))
    assert fits.violations == []
    over = _on_cpu(_spec("canary/search", T.hnsw_search,
                                 _search_args(tiny_index), {"k": 2},
                                 budget=ProgramBudget(peak_bytes=need - 1)))
    assert [v.check for v in over.violations] == ["F154"]


def test_f155_extra_item_canary(tiny_index):
    """A ceiling at today's count holds; one more `.item()` breaks it."""
    clean = _on_cpu(_spec("canary/search", T.hnsw_search,
                                  _search_args(tiny_index), {"k": 2}))
    n = clean.fingerprint["data_dependent_ops"]

    def with_item(cfg, st, q):
        ids, sims = T.hnsw_search(cfg, st, q, k=2)
        ids.max().item()
        return ids, sims
    budget = ProgramBudget(host_syncs=n)
    assert _on_cpu(_spec("canary/search", T.hnsw_search,
                                 _search_args(tiny_index), {"k": 2},
                                 budget=budget)).violations == []
    rep = _on_cpu(_spec("canary/item", with_item,
                                _search_args(tiny_index), budget=budget))
    assert [v.check for v in rep.violations] == ["F155"]
    assert f"host_syncs {n + 1} over budget {n}" in rep.violations[0].message


def test_f156_gather_canary(tiny_index):
    clean = _on_cpu(_spec("canary/search", T.hnsw_search,
                                  _search_args(tiny_index), {"k": 2}))
    n = clean.fingerprint["gather"]

    def with_gather(cfg, st, q):
        ids, sims = T.hnsw_search(cfg, st, q, k=2)
        st.vectors[torch.clamp(ids[:, 0], min=0).to(torch.int64)]
        return ids, sims
    rep = _on_cpu(_spec("canary/gather", with_gather,
                                _search_args(tiny_index),
                                budget=ProgramBudget(gather=n)))
    assert [v.check for v in rep.violations] == ["F156"]
    assert f"gather count {n + 1} over budget {n}" in rep.violations[0].message


def test_f161_duplicate_bucket_canary(tiny_index):
    """A bucket menu with a duplicate collapses to fewer signatures."""
    state, q, _ = tiny_index

    def variant(name, B, n):
        return _spec(name, T.hnsw_search, (_TINY, _clone(state), q[:B]),
                     {"k": 2}, family="canary/search",
                     budget=ProgramBudget(max_programs=n))
    good = [variant(f"canary/b{b}", b, 2) for b in (16, 32)]
    dup = [variant("canary/b16", 16, 3), variant("canary/b16bis", 16, 3),
           variant("canary/b32", 32, 3)]
    reports = {s.name: _on_cpu(s) for s in good + dup}
    assert analyze_family("canary/search", good, reports) == []
    bad = analyze_family("canary/search", dup, reports)
    assert [v.check for v in bad] == ["F161"]
    assert "redundant bucket" in bad[0].message
    over = [variant(f"canary/b{b}", b, 1) for b in (16, 32)]
    assert "over the recompilation budget" in \
        analyze_family("canary/search", over, reports)[0].message


def test_measure_run_counts_data_dependent_ops():
    x = torch.arange(10)

    def prog(t):
        m = t > 3
        return t[m], torch.nonzero(m), int(t.sum()), t.repeat_interleave(2)
    m = measure_run(prog, x, device="cpu")
    # boolean-mask index, nonzero, _local_scalar_dense; int repeats are not
    assert m.data_dependent == 3
    assert m.syncs is None and m.launches is None and m.temp_bytes is None
    assert m.count(("index",)) == 1


# ------------------------------------------------------- golden mechanics
def _fingerprint(name="toy/prog", **over):
    fp = {"program": name, "family": "", "device": "cpu",
          "in_avals": ["int32[8]"], "out_avals": ["float32[8]"],
          "ops": {"add.Tensor": 2, "gather.default": 1}, "gather": 1,
          "scatter": 0, "aliased": 0, "data_dependent_ops": 1,
          "card_syncs": None, "launches": None, "f64": [], "interface64": [],
          "memory": {"argument_bytes": 32, "output_bytes": 40,
                     "temp_bytes": 1000},
          "note": ""}
    fp.update(over)
    return fp


def test_golden_roundtrip_and_drift(tmp_path):
    from repro_torch.analysis import ProgramReport
    fp = _fingerprint()
    gate.write_fingerprints({"toy/prog": ProgramReport(
        name="toy/prog", fingerprint=fp, violations=[])}, tmp_path)
    golden = gate.load_golden("toy/prog", tmp_path)
    assert golden == json.loads(json.dumps(fp))
    assert gate.compare_fingerprint("toy/prog", golden, fp) == []

    drifted = _fingerprint(ops={"add.Tensor": 2, "gather.default": 3})
    viol = gate.compare_fingerprint("toy/prog", golden, drifted)
    assert [v.check for v in viol] == ["F162"]
    assert "gather.default: 1 (golden) -> 3 (current)" in viol[0].message

    for field, value in (("aliased", 5), ("data_dependent_ops", 2),
                         ("in_avals", ["int32[9]"])):
        viol = gate.compare_fingerprint("toy/prog", golden,
                                        _fingerprint(**{field: value}))
        assert [v.check for v in viol] == ["F162"], field
        assert field in viol[0].message

    near = _fingerprint(memory=dict(fp["memory"], temp_bytes=1200))
    assert gate.compare_fingerprint("toy/prog", golden, near) == []
    far = _fingerprint(memory=dict(fp["memory"], temp_bytes=2000))
    assert gate.compare_fingerprint("toy/prog", golden, far)[0].check == "F162"
    # temp bytes compare only when both sides have them
    cpu = _fingerprint(memory=dict(fp["memory"], temp_bytes=None))
    assert gate.compare_fingerprint("toy/prog", golden, cpu) == []
    exact = _fingerprint(memory=dict(fp["memory"], output_bytes=48))
    assert "output_bytes" in \
        gate.compare_fingerprint("toy/prog", golden, exact)[0].message

    viol = gate.compare_fingerprint("toy/other", None, fp)
    assert viol[0].check == "F162" and gate.REBASELINE in viol[0].message


def test_render_report_names_program_check_and_rebaseline():
    from repro_torch.analysis import Violation
    text = gate.render_report(
        {"hnsw/insert": None},
        [Violation("F153", "hnsw/insert", "0 input leaf(s) aliased")])
    assert "program hnsw/insert" in text
    assert "F153" in text and "aliased" in text
    assert gate.REBASELINE in text


# ------------------------------------------------------------------ CLI
def test_cli_list_shows_every_spec(capsys):
    assert main(["list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == NAMES
    assert "hnsw/insert  alias=5" in lines


def test_cli_check_update_and_drift(tmp_path, capsys):
    torch.set_num_threads(1)
    assert main(["check", "--select", "brute", "--device", "cpu"]) == 0
    assert "all budgets and golden fingerprints hold" in capsys.readouterr().out
    # update writes what check reads
    assert main(["update", "--select", "brute", "--device", "cpu",
                 "--fingerprints", str(tmp_path)]) == 0
    written = tmp_path / "brute__chunk_best.json"
    assert json.loads(written.read_text()) == \
        gate.load_golden("brute/chunk_best")
    # a drifted golden fails the check with exit 1
    golden = json.loads(written.read_text())
    golden["data_dependent_ops"] += 1
    written.write_text(json.dumps(golden))
    assert main(["check", "--select", "brute", "--device", "cpu",
                 "--fingerprints", str(tmp_path)]) == 1
    assert "data_dependent_ops drift" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["check", "--select", "brute", "--device", "cuda"],
    ["check", "--select", "brute"],          # the default device is cuda
])
def test_cli_cuda_without_a_card_raises(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda gate runs in "
                    "tests/test_torch_cuda.py")
    with pytest.raises(RuntimeError, match="found no GPU"):
        main(argv)


def test_library_entry_points_default_to_cuda():
    """analyze_program and run_gate treat device=None as cuda, as every
    entry point of the port does: with no card they raise, never fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda gate runs in "
                    "tests/test_torch_cuda.py")
    spec, = default_specs(["brute"])
    with pytest.raises(RuntimeError, match="found no GPU"):
        analyze_program(spec)
    with pytest.raises(RuntimeError, match="found no GPU"):
        gate.run_gate(select=["brute"])


def test_cli_update_needs_the_cpu_named():
    with pytest.raises(SystemExit):
        main(["update", "--select", "brute"])
