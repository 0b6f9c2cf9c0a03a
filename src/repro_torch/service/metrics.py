"""Serving metrics: counters + fixed-bucket log-scale latency histograms
(port of `repro/service/metrics.py`; numpy only, quantiles bit for bit).

Dependency-free: a registry of monotone counters and log-bucketed
histograms. The histogram covers the FULL observation stream with O(1)
memory and O(1) observe, so tail quantiles (p99/p99.9) are over every
request, not a recency window. `snapshot()` is cheap and side-effect
free except for the interval-QPS bookkeeping.

Bucket layout: 20 log-spaced buckets per decade over [1e-3, 1e5) ms —
1 µs resolution at the bottom, 100 s at the top, ~12% relative error per
bucket — plus underflow/overflow clamp buckets. Quantiles interpolate the
geometric midpoint of the containing bucket and are clamped to the exact
observed [min, max], so single-value streams report exactly that value.
"""
from __future__ import annotations

import collections
import math
import time

import numpy as np

__all__ = ["MetricsRegistry", "LogHistogram"]

_LO_MS = 1e-3            # bottom of the tracked range (1 µs)
_HI_MS = 1e5             # top of the tracked range (100 s)
_PER_DECADE = 20
_DECADES = 8             # log10(_HI_MS / _LO_MS)
_NBUCKETS = _PER_DECADE * _DECADES + 2          # + underflow / overflow
_LOG_LO = math.log10(_LO_MS)
_SCALE = _PER_DECADE     # buckets per decade


class LogHistogram:
    """Fixed-bucket log-scale histogram over milliseconds (see module doc)."""
    __slots__ = ("counts", "total", "sum", "vmin", "vmax")

    def __init__(self):
        self.counts = np.zeros(_NBUCKETS, np.int64)
        self.total = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    @staticmethod
    def _bucket(v: float) -> int:
        if v < _LO_MS:
            return 0
        if v >= _HI_MS:
            return _NBUCKETS - 1
        return 1 + int((math.log10(v) - _LOG_LO) * _SCALE)

    def observe(self, v: float):
        v = float(v)
        self.counts[self._bucket(v)] += 1
        self.total += 1
        self.sum += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def quantile(self, q: float) -> float:
        """Value at quantile q in [0, 1] (geometric bucket midpoint,
        clamped to the exact observed range)."""
        if self.total == 0:
            return 0.0
        rank = min(self.total - 1, int(q * self.total))
        cum = 0
        for b, c in enumerate(self.counts):
            cum += int(c)
            if cum > rank:
                if b == 0:
                    mid = _LO_MS
                elif b == _NBUCKETS - 1:
                    mid = _HI_MS
                else:
                    lo = 10.0 ** (_LOG_LO + (b - 1) / _SCALE)
                    mid = lo * 10.0 ** (0.5 / _SCALE)
                return float(min(max(mid, self.vmin), self.vmax))
        return float(self.vmax)

    def summary(self) -> dict:
        if self.total == 0:
            return {"n": 0}
        return {
            "n": self.total,
            "mean": self.sum / self.total,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
            "p999": self.quantile(0.999),
            "max": float(self.vmax),
        }


class MetricsRegistry:
    """Counters (`inc`) + latency histograms (`observe`, milliseconds)."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self.counters: dict[str, int] = collections.defaultdict(int)
        self.histograms: dict[str, LogHistogram] = collections.defaultdict(
            LogHistogram)
        self._last_snap_t = self._t0
        self._last_docs = 0

    def inc(self, name: str, n: int = 1):
        self.counters[name] += n

    def observe(self, name: str, value_ms: float):
        self.histograms[name].observe(value_ms)

    def snapshot(self) -> dict:
        """Point-in-time view: counters, latency summaries, overall and
        since-last-snapshot docs/sec (keyed on the `docs_out` counter)."""
        now = self._clock()
        uptime = max(now - self._t0, 1e-9)
        docs = self.counters.get("docs_out", 0)
        interval = max(now - self._last_snap_t, 1e-9)
        qps_interval = (docs - self._last_docs) / interval
        self._last_snap_t, self._last_docs = now, docs
        return {
            "uptime_s": uptime,
            "qps": docs / uptime,
            "qps_interval": qps_interval,
            "counters": dict(self.counters),
            "latency_ms": {k: h.summary() for k, h in self.histograms.items()},
        }
