"""The program analyzer: run a program ONCE and observe it (port of
`repro/analysis/analyze.py`).

The one design difference. The reference traces, lowers and compiles each
program and never executes it. Eager PyTorch has no trace of these
programs short of running them, because they are data-dependent: the
lockstep beam loops stop on `nonzero` / `bool(any)` reads
(`core/hnsw.py::_greedy_step`, `_search_layer`, `_discover_candidates`),
the commit plans its back-links on the host from one copy of its per-row
arrays (`_commit_batch`), and meta tensors stop at the first of these. So
`measure_run` runs the program once, on inputs the spec makes from a fixed
seed, and observes the run:

  * a TorchDispatchMode records every aten op, the dtypes of its outputs
    and which input tensors it touched (any device);
  * on a card, also the caching allocator's peak (Python's cycle collector
    runs before the run and is held off during it), the kernel launches
    and device operations of a `torch.profiler` trace, and the
    synchronizations `torch.cuda.set_sync_debug_mode` reports. Launches and
    device ops are counted from the host's runtime calls that enqueue them
    (`device_op_calls`), not from the device's own records of them: on an
    H100 under torch 2.11 a trace has come back short of some of a
    program's kernel records, or of all of a 2 ms program's, while its
    launch calls were the same in every run. A trace with no launch call
    reads as not measured: `launches` and `device_ops` are None.

The port's CUDA kernels launch through ctypes and are invisible to the
dispatch mode (the profiler sees them, and counts them among `launches`).
On a card, `hnsw/insert` and `hnsw_sharded/fused_step` reach one: K5, the
commit's back-links (`kernels/hnsw_commit.py`), once per insert; on the
CPU its plain version runs in their place and its aten ops are counted.

Checks (the reference's rule ids, see also `repro_torch/analysis/gate.py`):

  F151  float64/complex leak: any aten op output of float64 or complex
        dtype during the run. int64 is tolerated inside a program: the
        port emulates uint32 in int64 on the CPU.
  F152  64-bit interface: program inputs and outputs must be 32-bit or
        narrower. Weak types have no torch meaning.
  F153  aliasing: how many leaves of the input state the returned state
        shares storage with (`untyped_storage().data_ptr()`), against the
        spec's `alias_expect` (the reference's donated-parameter count; a
        lost alias is a full copy of that leaf per call).
  F154  memory: argument and output bytes from the interface (exact on any
        device); on a card, temp bytes are the allocator's peak during the
        call above the bytes allocated before it, checked against the
        budget. The CPU has no such counter and records temp_bytes null.
  F155  host syncs: on any device, the data-dependent ops of the run
        (`_local_scalar_dense`, `nonzero`, `masked_select`, `unique`,
        `equal`, a boolean-mask `index`, a boolean-mask `index_put_` of more
        than one value, a `repeat_interleave` of tensor repeats): a LOWER
        bound, since `.cpu()` of a CPU tensor and a host-to-device copy
        dispatch nothing that needs data. On a card, also the count sync-debug mode
        reports, which is the true one. Each has a ceiling in the budget.
  F156  gather/scatter counts: gather-class (`gather`, `index`,
        `index_select`, `take`) and scatter-class (`index_put_`,
        `scatter*`, `index_add`, `index_copy`, `put_`) aten ops against the
        spec's ceilings. The reference's `while` count has no torch
        meaning: a Python loop shows up as the syncs of F155.
  F161  recompilation budget: a bucketed family's variants must have one
        distinct input signature per bucket, at most `max_programs`.

What does not carry over, and why: donation read from the StableHLO
lowering (eager PyTorch has no lowering; aliasing is read from the
returned tensors instead), HLO primitive counts (aten op counts stand in;
they depend on the torch version, so goldens compare on one install),
weak types (torch has none), `while` primitives (Python loops), and
generated-code bytes (nothing is compiled).
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import json
import os
import tempfile
import time
import warnings
from typing import Any, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.programs import ProgramSpec
from repro_torch.device import resolve_device

__all__ = ["Violation", "ProgramReport", "RunMeasure", "measure_run",
           "tensor_leaves", "aval", "analyze_program", "analyze_family",
           "CHECK_DOCS"]

CHECK_DOCS = {
    "F151": "float64/complex output of an aten op during the run",
    "F152": "64-bit program input/output",
    "F153": "aliased state leaves differ from the spec's expectation",
    "F154": "temp/peak bytes over the program budget",
    "F155": "host syncs (data-dependent ops; on a card, sync-debug "
            "synchronizations) over the program budget",
    "F156": "gather/scatter aten op count over the program budget",
    "F161": "bucketed family runs more distinct programs than its budget",
}

_WIDE = (torch.float64, torch.complex64, torch.complex128)
# aten ops whose result size or value needs the tensor's data on the host
_DATA_DEPENDENT = ("_local_scalar_dense", "nonzero", "masked_select",
                   "_unique", "_unique2", "unique_dim", "unique_consecutive",
                   "equal")
_MASK_INDEXED = ("index", "index_put", "index_put_")
_TENSOR_REPEATS = ("repeat_interleave.Tensor", "repeat_interleave.self_Tensor")
_GATHER = ("gather", "index", "index_select", "take")
_SCATTER = ("index_put", "index_put_", "scatter", "scatter_", "scatter_add",
            "scatter_add_", "scatter_reduce", "scatter_reduce_", "index_add",
            "index_add_", "index_copy", "index_copy_", "put_")
# the device's records of its operations in a profiler trace, by category
DEVICE_OP_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the runtime/driver calls that launch one kernel each, and the prefixes of
# those that enqueue one copy or set each
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")
_COPY_CALLS = ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")
# the reference's memory_analysis counts one 8-byte pointer per output leaf
# (the result tuple); the port keeps that convention so the bytes compare
_OUT_POINTER_BYTES = 8


@dataclasses.dataclass(frozen=True)
class Violation:
    check: str
    program: str
    message: str

    def render(self) -> str:
        return f"{self.program}: {self.check} {self.message}"


@dataclasses.dataclass
class ProgramReport:
    name: str
    fingerprint: dict
    violations: list[Violation]
    measure: "RunMeasure | None" = None


@dataclasses.dataclass
class RunMeasure:
    """One observed run. The card-only fields are None on the CPU."""
    outputs: Any
    ops: dict[str, int]            # aten op overload -> count
    wide: list[str]                # "op:dtype" of float64/complex outputs
    data_dependent: int            # F155's lower bound
    touched: set[int]              # indices of the input leaves an op read
    wall_ms: float
    syncs: int | None = None       # sync-debug synchronizations
    launches: int | None = None    # kernel launch calls (None: lost)
    device_ops: int | None = None  # launch + memcpy + memset calls
    temp_bytes: int | None = None  # allocator peak above the start

    def count(self, names: Iterable[str]) -> int:
        names = set(names)
        return sum(n for op, n in self.ops.items()
                   if op.split(".")[0] in names)


def tensor_leaves(tree) -> list[torch.Tensor]:
    """The tensors of nested tuples / lists / dicts, in order (args, then
    kwargs in insertion order, as the reference's trace flattens them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensor_leaves(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in tensor_leaves(x)]
    return []


def aval(t: torch.Tensor) -> str:
    """`dtype[d0,d1]` as the reference writes an aval."""
    dtype = str(t.dtype).removeprefix("torch.")
    return f"{dtype}[{','.join(str(d) for d in t.shape)}]"


def _mask_needs_nonzero(name: str, args) -> bool:
    """A boolean-mask index needs the mask's true count, except a one-mask
    `index_put_` of a single value, which ATen runs as `masked_fill_`."""
    masks = [i for i in args[1]
             if isinstance(i, torch.Tensor) and i.dtype == torch.bool]
    if not masks:
        return False
    return not (name != "index" and len(args[1]) == 1
                and isinstance(args[2], torch.Tensor) and args[2].numel() == 1)


def _ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _Observer(TorchDispatchMode):
    """Counts aten ops, notes wide outputs, data-dependent ops and the
    input storages that any op reads or writes."""

    def __init__(self, inputs: list[torch.Tensor]):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()
        self.wide: set[str] = set()
        self.data_dependent = 0
        self._inputs = {}
        for i, t in enumerate(inputs):
            if _ptr(t):
                self._inputs.setdefault(_ptr(t), []).append(i)
        self.touched: set[int] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._overloadpacket.__name__
        self.ops[func.__name__] += 1
        for t in tensor_leaves((args, kwargs)):
            self.touched.update(self._inputs.get(_ptr(t), ()))
        if name in _DATA_DEPENDENT or (
                name in _MASK_INDEXED and _mask_needs_nonzero(name, args)) or (
                func.__name__ in _TENSOR_REPEATS
                and kwargs.get("output_size") is None):
            self.data_dependent += 1
        out = func(*args, **kwargs)
        for t in tensor_leaves(out):
            if t.dtype in _WIDE:
                self.wide.add(f"{name}:{str(t.dtype).removeprefix('torch.')}")
        return out


def trace_events(prof, path: str | None = None) -> list[dict]:
    """The events of a finished torch.profiler run, from its chrome trace
    (written to `path`, or to a temporary file)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = path or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_events(events: list[dict]) -> list[dict]:
    """The device's records of its operations in a trace: its kernel,
    memcpy and memset events (for device time; some may be lost)."""
    return [e for e in events if e.get("cat") in DEVICE_OP_CATS]


def device_op_calls(events: list[dict]) -> tuple[int, int]:
    """(kernel launches, device ops) of a trace, counted from the host's
    runtime and driver calls that enqueue them: one launch call per kernel,
    one copy or set call per memcpy or memset. This is what the port means
    by a device op."""
    launches = ops = 0
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        name = e.get("name", "")
        if name in _LAUNCH_CALLS:
            launches += 1
            ops += 1
        elif name.startswith(_COPY_CALLS):
            ops += 1
    return launches, ops


def measure_run(fn, *args, device, **kwargs) -> RunMeasure:
    """Run `fn(*args, **kwargs)` once on `device` and observe it (see the
    module docstring). The arguments must already lie on `device`."""
    dev = torch.device(device)
    obs = _Observer(tensor_leaves((args, kwargs)))
    if dev.type != "cuda":
        t0 = time.perf_counter()
        with obs:
            out = fn(*args, **kwargs)
        return RunMeasure(outputs=out, ops=dict(sorted(obs.ops.items())),
                          wide=sorted(obs.wide),
                          data_dependent=obs.data_dependent,
                          touched=obs.touched,
                          wall_ms=(time.perf_counter() - t0) * 1e3)

    from torch.profiler import ProfilerActivity, profile
    # no collection inside the run: a cycle of earlier card tensors freed
    # there lowers the allocated bytes under `base`, and the run's own
    # temporaries then read as 0 temp bytes (hnsw/compact's 1.2 GB did)
    gc.collect()
    gc_was_enabled = gc.isenabled()
    gc.disable()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                with obs:
                    out = fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                if gc_was_enabled:
                    gc.enable()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches, n_ops = device_op_calls(trace_events(prof))
    if not launches:                 # the trace lost its runtime calls
        launches = n_ops = None
    syncs = sum("synchronizing CUDA operation" in str(w.message)
                for w in caught)
    return RunMeasure(outputs=out, ops=dict(sorted(obs.ops.items())),
                      wide=sorted(obs.wide), data_dependent=obs.data_dependent,
                      touched=obs.touched, wall_ms=wall_ms, syncs=syncs,
                      launches=launches, device_ops=n_ops,
                      temp_bytes=torch.cuda.max_memory_allocated(dev) - base)


# ---------------------------------------------------------------- checks
def _check_budgets(spec: ProgramSpec, m: RunMeasure, memory: dict):
    b = spec.budget
    out = []
    temp = memory.get("temp_bytes")
    if b.temp_bytes is not None and temp is not None and temp > b.temp_bytes:
        out.append(Violation("F154", spec.name,
                             f"temp bytes {temp:,} over budget "
                             f"{b.temp_bytes:,}"))
    peak = sum(memory.get(k) or 0 for k in
               ("argument_bytes", "output_bytes", "temp_bytes"))
    if b.peak_bytes is not None and peak > b.peak_bytes:
        out.append(Violation("F154", spec.name,
                             f"peak bytes {peak:,} over budget "
                             f"{b.peak_bytes:,}"))
    for attr, n in (("host_syncs", m.data_dependent),
                    ("card_syncs", m.syncs)):
        ceil = getattr(b, attr)
        if ceil is not None and n is not None and n > ceil:
            out.append(Violation("F155", spec.name,
                                 f"{attr} {n} over budget {ceil}"))
    for attr, names in (("gather", _GATHER), ("scatter", _SCATTER)):
        ceil = getattr(b, attr)
        n = m.count(names)
        if ceil is not None and n > ceil:
            out.append(Violation("F156", spec.name,
                                 f"{attr} count {n} over budget {ceil}"))
    return out


def analyze_program(spec: ProgramSpec,
                    device: str | torch.device | None = None
                    ) -> ProgramReport:
    """Make the spec's inputs on `device`, run the program once, and
    return its fingerprint and budget violations. `device=None` means
    cuda, and cuda with no card raises (resolve_device): the analysis
    never falls back to the CPU unless `device="cpu"` is passed."""
    dev = resolve_device(device)
    fn, args, kwargs = spec.make(dev)
    ins = tensor_leaves((args, kwargs))
    m = measure_run(fn, *args, device=dev, **kwargs)
    outs = tensor_leaves(m.outputs)
    violations: list[Violation] = []

    if m.wide:
        violations.append(Violation(
            "F151", spec.name,
            f"float64/complex op outputs: {', '.join(m.wide[:6])}"))
    iface = ([f"in:{aval(t)}" for t in ins if t.element_size() > 4]
             + [f"out:{aval(t)}" for t in outs if t.element_size() > 4])
    if iface:
        violations.append(Violation(
            "F152", spec.name, f"64-bit interface: {', '.join(iface[:6])}"))

    out_ptrs = {_ptr(t) for t in outs} - {0}
    aliased = [i for i, t in enumerate(ins) if _ptr(t) in out_ptrs]
    if len(aliased) != spec.alias_expect:
        violations.append(Violation(
            "F153", spec.name,
            f"{len(aliased)} input leaf(s) aliased by the outputs, spec "
            f"expects {spec.alias_expect} — "
            + ("a state leaf is copied per call?"
               if len(aliased) < spec.alias_expect
               else "update the spec's alias_expect")))

    # an input no op reads and no output returns is not an argument of the
    # program (XLA prunes such parameters from its argument bytes)
    used = m.touched | set(aliased)
    memory = {
        "argument_bytes": sum(t.nbytes for i, t in enumerate(ins)
                              if i in used),
        "output_bytes": sum(t.nbytes + _OUT_POINTER_BYTES for t in outs),
        "temp_bytes": m.temp_bytes,
    }
    violations.extend(_check_budgets(spec, m, memory))

    fingerprint = {
        "program": spec.name,
        "family": spec.family,
        "device": dev.type,
        "in_avals": [aval(t) for t in ins],
        "out_avals": [aval(t) for t in outs],
        "ops": m.ops,
        "gather": m.count(_GATHER),
        "scatter": m.count(_SCATTER),
        "aliased": len(aliased),
        "data_dependent_ops": m.data_dependent,
        "card_syncs": m.syncs,
        "launches": m.launches,
        "f64": m.wide,
        "interface64": iface,
        "memory": memory,
        "note": spec.budget.note,
    }
    return ProgramReport(name=spec.name, fingerprint=fingerprint,
                         violations=violations, measure=m)


def analyze_family(family: str, specs: Iterable[ProgramSpec],
                   reports: dict[str, ProgramReport]) -> list[Violation]:
    """F161: the bucketed variants of `family` must have exactly one
    distinct input signature per bucket, bounded by max_programs."""
    specs = list(specs)
    sigs = {tuple(reports[s.name].fingerprint["in_avals"]) for s in specs}
    out = []
    if len(sigs) != len(specs):
        out.append(Violation(
            "F161", family,
            f"{len(specs)} bucket variants collapse to {len(sigs)} distinct "
            f"input signatures — redundant bucket in the menu"))
    ceil = max((s.budget.max_programs or 0) for s in specs) or None
    if ceil is not None and len(sigs) > ceil:
        out.append(Violation(
            "F161", family,
            f"{len(sigs)} distinct programs over the recompilation "
            f"budget {ceil}"))
    return out
