"""Multi-tenant namespaces: per-tenant quotas and admission accounting
(port of `repro/cluster/tenancy.py`).

A tenant is a named traffic source sharing the single writer. Two quota
axes, both optional per tenant:

  qps (+ burst)   — a token bucket over submitted DOCS per second. Refill
                    is continuous (elapsed * rate); an over-rate submit is
                    rejected with Backpressure("qps_quota") and an exact
                    retry-after (time until the bucket holds enough
                    tokens). Rejection happens BEFORE any doc is enqueued,
                    so one tenant's overload never occupies queue slots.
  max_live_docs   — a live-document budget enforced by the writer with the
                    index's deletion contract: admitting doc N+1 evicts
                    that tenant's oldest live doc (LRU by admission order),
                    exactly like the service-level lifecycle but scoped to
                    the tenant's own ledger.

Quotas are enforced by ClusterWriter; this module is the bookkeeping.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

__all__ = ["TenantSpec", "TenantState", "TokenBucket"]

Clock = Callable[[], float]


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    name: str
    qps: float | None = None          # docs/second (None = unlimited)
    burst: float | None = None        # bucket depth (None = max(qps, 1))
    max_live_docs: int | None = None  # live-doc budget (None = unlimited)


class TokenBucket:
    """Continuous-refill token bucket (tokens = docs)."""

    def __init__(self, rate: float, burst: float | None = None,
                 clock: Clock = time.perf_counter):
        assert rate > 0, rate
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(rate, 1.0))
        self._clock = clock
        self._tokens = self.burst
        self._t = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now

    def try_take(self, n: int = 1) -> bool:
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def eta(self, n: int = 1) -> float:
        """Seconds until the bucket would hold n tokens (0 if it does)."""
        self._refill()
        need = n - self._tokens
        return max(0.0, need / self.rate)


class TenantState:
    """Runtime accounting for one tenant (writer-private)."""

    def __init__(self, spec: TenantSpec, clock: Clock = time.perf_counter):
        self.spec = spec
        self.bucket = (TokenBucket(spec.qps, spec.burst, clock)
                       if spec.qps else None)
        # admission-ordered ledger of this tenant's LIVE docs:
        # (doc_id, index slot) — drives the live-doc budget eviction
        self.ledger: collections.deque[tuple[int, int]] = collections.deque()
        self.submitted = 0
        self.admitted = 0
        self.rejected_qps = 0
        self.rejected_queue = 0
        self.evicted = 0

    @property
    def live_docs(self) -> int:
        return len(self.ledger)

    def over_budget(self) -> int:
        """How many docs past the live budget (0 when unlimited/under)."""
        if self.spec.max_live_docs is None:
            return 0
        return max(0, len(self.ledger) - self.spec.max_live_docs)

    def stats(self) -> dict:
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "live_docs": self.live_docs,
            "rejected_qps": self.rejected_qps,
            "rejected_queue": self.rejected_queue,
            "evicted": self.evicted,
            "qps_limit": self.spec.qps,
            "max_live_docs": self.spec.max_live_docs,
        }
