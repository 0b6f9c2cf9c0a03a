"""What the host did during a window, to tell a slow run's cause: the
caller's CPU time and involuntary context switches, the CPU time the
machine's hypervisor stole, the traffic generator's CPU time, and the
collector's pauses. Read at the window's start and end; printed on
standard error, never a metric."""
from __future__ import annotations

import gc
import os
import resource
import time

__all__ = ["HostWatch"]


def _tick() -> float:
    return float(os.sysconf("SC_CLK_TCK"))


def _steal_s() -> float:
    """The machine's stolen CPU seconds so far, over all its cores."""
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
        return int(parts[8]) / _tick()
    except (OSError, IndexError, ValueError):
        return float("nan")


def _cpu_s(pid: int) -> float:
    """User and system CPU seconds of process `pid` so far."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / _tick()
    except (OSError, IndexError, ValueError):
        return float("nan")


class HostWatch:
    def __init__(self, producer_pid: int | None = None):
        self.producer_pid = producer_pid
        self._at: dict = {}
        self._gc_t0 = 0.0
        self.gc_s = 0.0
        self.gc_n = 0

    def _read(self) -> dict:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {"wall": time.perf_counter(), "cpu": time.process_time(),
                "nivcsw": ru.ru_nivcsw, "steal": _steal_s(),
                "producer": (_cpu_s(self.producer_pid)
                             if self.producer_pid else float("nan"))}

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._gc_t0
            self.gc_n += 1

    def start(self) -> None:
        self.gc_s, self.gc_n = 0.0, 0
        gc.callbacks.append(self._on_gc)
        self._at = self._read()

    def stop(self) -> dict:
        end = self._read()
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        d = {k: end[k] - self._at[k] for k in end}
        return {"wall_s": round(d["wall"], 3),
                "caller_cpu_s": round(d["cpu"], 3),
                "involuntary_switches": d["nivcsw"],
                "stolen_cpu_s": round(d["steal"], 3),
                "generator_cpu_s": round(d["producer"], 3),
                "gc_pauses": self.gc_n, "gc_s": round(self.gc_s, 4)}
