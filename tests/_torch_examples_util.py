"""Helpers shared by tests/test_torch_examples*.py: read the reference
examples' size literals, run a reference example from its own source with
those literals rewritten, freeze the clocks of both packages, and make
the reference's snapshot rotation deterministic. A port
example runs through chip_smoke.py's `run_example`, and `mask_clock`
masks the wall-clock fields of what either prints."""
from __future__ import annotations

import ast
import contextlib
import functools
import io
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
# chip_smoke.py runs the port examples on the card with the same helpers
sys.path.insert(0, str(ROOT))
from chip_smoke import load_example, mask_clock, run_example  # noqa: E402,F401

# Per example: each flag of the port example (its argparse dest) and the
# name the reference binds the same literal to. A plain name is an
# assignment target or a keyword argument, the first in source order; an
# argparse example keeps its flags. `--device` is the port's own.
FLAGS = {
    "quickstart": {"cycles": "cycles", "batch": "batch",
                   "capacity": "capacity"},
    "service_demo": {"waves": "waves", "docs_per_wave": "docs_per_wave",
                     "capacity": "capacity"},
    "cluster_demo": {"waves": "waves", "per_wave": "per_wave",
                     "capacity": "capacity", "burst": "burst",
                     "max_live_docs": "max_live_docs"},
    "distributed_dedup": {},
    "serve_demo": {"arch": "arch", "full": "full", "batch": "batch",
                   "prompt_len": "prompt_len", "gen": "gen",
                   "cache_len": "cache_len"},
    "train_dedup_lm": {"steps": "steps", "batch": "batch", "seq": "seq",
                       "tiny": "tiny"},
}
# where each side's argparse lives when the example only wraps a CLI
PARSER_SOURCE = {
    "serve_demo": (ROOT / "src/repro/launch/serve.py",
                   ROOT / "src/repro_torch/launch/serve.py"),
}

def reference_path(name: str) -> Path:
    return EXAMPLES / f"{name}.py"


def port_path(name: str) -> Path:
    return EXAMPLES / f"{name}_torch.py"


def _const(node: ast.AST):
    """The value of a constant expression (`4`, `1 << 14`, `-1.0`), or
    raise ValueError."""
    allowed = (ast.Constant, ast.BinOp, ast.UnaryOp, ast.operator,
               ast.unaryop)
    if not all(isinstance(n, allowed) for n in ast.walk(node)):
        raise ValueError(ast.dump(node))
    return eval(compile(ast.Expression(node), "<literal>", "eval"),
                {"__builtins__": {}})


def _dest(call: ast.Call) -> str | None:
    for a in call.args:
        if isinstance(a, ast.Constant) and str(a.value).startswith("--"):
            return a.value[2:].replace("-", "_")
    return None


def argparse_defaults(path: Path) -> dict:
    """dest -> default of every `add_argument("--x", ...)` in `path`
    (store_true flags default to False)."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        dest = _dest(node)
        if "default" in kw:
            out[dest] = _const(kw["default"])
        elif "action" in kw and _const(kw["action"]) == "store_true":
            out[dest] = False
        else:
            out[dest] = None
    return out


def _literal_sites(tree: ast.AST) -> dict:
    """name -> (value node) of the first binding in source order: `x = 4`,
    `a, b = 4, 512`, or a keyword argument `capacity=1 << 14`."""
    sites = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt, val = node.targets[0], node.value
            if isinstance(tgt, ast.Name):
                sites.append((tgt.id, val))
            elif (isinstance(tgt, ast.Tuple) and isinstance(val, ast.Tuple)
                  and len(tgt.elts) == len(val.elts)):
                sites += [(t.id, v) for t, v in zip(tgt.elts, val.elts)
                          if isinstance(t, ast.Name)]
        elif isinstance(node, ast.Call):
            sites += [(k.arg, k.value) for k in node.keywords if k.arg]
    first = {}
    for name, val in sorted(sites, key=lambda s: (s[1].lineno,
                                                  s[1].col_offset)):
        try:
            _const(val)
        except ValueError:
            continue
        first.setdefault(name, val)
    return first


def reference_literals(name: str) -> dict:
    """name -> value of the reference example's literals named in FLAGS."""
    if name in PARSER_SOURCE:
        return argparse_defaults(PARSER_SOURCE[name][0])
    path = reference_path(name)
    if "add_argument" in path.read_text():
        return argparse_defaults(path)
    sites = _literal_sites(ast.parse(path.read_text()))
    return {k: _const(v) for k, v in sites.items()}


def port_defaults(name: str) -> dict:
    path = PARSER_SOURCE[name][1] if name in PARSER_SOURCE else port_path(name)
    return argparse_defaults(path)


def run_reference(name: str, sizes: dict | None = None,
                  argv: list | None = None, setup=None) -> str:
    """Run the reference example's `main()` in this process from its own
    source, each literal of `sizes` (port flag dest -> value) rewritten,
    with `sys.argv[1:]` set to `argv`; `setup(namespace)` may replace
    names of the module before `main` runs. Returns what it printed."""
    path = reference_path(name)
    src = path.read_text()
    sites = _literal_sites(ast.parse(src))
    edits = []
    for dest, value in (sizes or {}).items():
        node = sites[FLAGS[name][dest]]
        edits.append((node.lineno, node.col_offset, node.end_lineno,
                      node.end_col_offset, repr(value)))
    starts = [0]
    for ln in src.splitlines(keepends=True):
        starts.append(starts[-1] + len(ln))
    for l0, c0, l1, c1, text in sorted(edits, reverse=True):
        a, b = starts[l0 - 1] + c0, starts[l1 - 1] + c1
        src = src[:a] + text + src[b:]
    ns = {"__name__": f"reference_{name}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    if setup is not None:
        setup(ns)
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [str(path)] + list(argv or [])
    try:
        with contextlib.redirect_stdout(out):
            ns["main"]()
    finally:
        sys.argv = saved
    return out.getvalue()


def size_flags(sizes: dict) -> list:
    return [a for dest, v in sizes.items()
            for a in (f"--{dest.replace('_', '-')}", str(v))]


def sync_reference_snapshots(monkeypatch) -> None:
    """Make the reference service's periodic snapshots synchronous. Its
    rotation lists the committed steps while its own asynchronous write
    may or may not have landed, and keeps one step fewer either way, so
    under load it sometimes keeps one snapshot instead of two (the race
    the port's index manager leaves out; ROADMAP.md, hazard F). A
    synchronous write lands first every time, and the rotation then keeps
    `max_snapshots` steps as intended."""
    from repro.service.index_manager import IndexManager
    snapshot = IndexManager.snapshot
    monkeypatch.setattr(IndexManager, "snapshot",
                        lambda self, sync=True: snapshot(self, sync=True))


def freeze_clocks(monkeypatch) -> None:
    """Freeze the service batcher's clock and the cluster writer's tenant
    clock at 0 in both packages: a partial micro-batch then leaves only
    when its ticket's results are asked for, and a QPS bucket serves its
    burst and nothing after it, whatever the number of clock calls."""
    import repro.cluster.router as jrouter
    import repro.service.service as jservice
    import repro_torch.cluster.router as trouter
    import repro_torch.service.service as tservice
    frozen = lambda: 0.0  # noqa: E731
    for mod in (jservice, tservice):
        monkeypatch.setattr(mod, "MicroBatcher",
                            functools.partial(mod.MicroBatcher, clock=frozen))
    for mod in (jrouter, trouter):
        monkeypatch.setattr(mod, "ClusterWriter",
                            functools.partial(mod.ClusterWriter,
                                              clock=frozen))
