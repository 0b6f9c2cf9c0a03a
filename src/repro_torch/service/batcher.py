"""Dynamic micro-batching with bucketed shapes (port of
`repro/service/batcher.py`; host numpy, semantics unchanged).

Callers submit variable-length documents one at a time or in chunks; the
batcher coalesces them under a `max_batch` / `max_wait_ms` policy and pads
every emitted micro-batch to a small fixed menu of (B, L) shapes. The
reference bounds its XLA compile count with the menu; eager PyTorch
compiles nothing per shape, but the menu still bounds the set of shapes
the service ever feeds the card (and keeps its verdicts equal to the
reference's, batch for batch).

Padding is inert by construction: length-padding beyond a doc's token count
is masked inside shingle_hashes, and batch-padding rows are appended at the
END with valid=False — the greedy in-batch sweep walks ascending indices, so
a padding row can never shadow a real document, and `dedup_step` masks them
out of admission entirely.
"""
from __future__ import annotations

import time
from typing import Iterable, NamedTuple

import numpy as np

__all__ = ["MicroBatch", "MicroBatcher", "Backpressure",
           "default_batch_buckets", "pow2_buckets"]


class Backpressure(RuntimeError):
    """Explicit admission rejection (bounded queue / tenant quota).

    Raised by the ticket API *before* any document is enqueued — a rejected
    submit leaves no partial state, so the caller retries the whole request
    after `retry_after_s`. reason is "queue_full" (bounded admission queue)
    or "qps_quota" (per-tenant token bucket, repro_torch.cluster).
    """

    def __init__(self, reason: str, retry_after_s: float,
                 tenant: str | None = None):
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        self.tenant = tenant
        who = f" (tenant {tenant!r})" if tenant else ""
        super().__init__(f"admission rejected: {reason}{who}; "
                         f"retry after {self.retry_after_s:.3f}s")


class MicroBatch(NamedTuple):
    tokens: np.ndarray    # (B, L) uint32, bucketed shape
    lengths: np.ndarray   # (B,) int32 (0 for padding rows)
    valid: np.ndarray     # (B,) bool — False rows are shape padding
    doc_ids: np.ndarray   # (B,) int64 — -1 for padding rows
    n_docs: int           # number of valid rows (== valid.sum())

    @property
    def shape(self) -> tuple[int, int]:
        return self.tokens.shape


def pow2_buckets(lo: int, hi: int) -> tuple[int, ...]:
    """Powers of two covering [lo, hi], with the last bucket clamped to
    `hi` so the padded length never exceeds the configured maximum."""
    out = []
    b = 1
    while b < lo:
        b *= 2
    while b < hi:
        out.append(b)
        b *= 2
    out.append(min(b, hi))
    return tuple(out)


def default_batch_buckets(max_batch: int) -> tuple[int, ...]:
    """The default batch-size menu: max_batch and its /2 /4 /8 subdivisions
    (deduped, ascending), the menu the batcher pads to."""
    return tuple(sorted({max(max_batch // 8, 1), max(max_batch // 4, 1),
                         max(max_batch // 2, 1), max_batch}))


def _bucket_up(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class MicroBatcher:
    """Coalesce a document stream into bucket-shaped micro-batches.

    max_batch     — emit a full batch as soon as this many docs are pending
    max_wait_ms   — emit a partial batch once the OLDEST pending doc has
                    waited this long (checked on every add/drain; the
                    batcher is driven by its caller, there is no thread)
    len_buckets   — allowed padded lengths L (docs longer than the largest
                    bucket are truncated to it; counted in `truncated`)
    batch_buckets — allowed batch sizes B (ascending, last == max_batch)
    max_pending   — bound on the pending-doc queue (None = unbounded, the
                    historical behavior). `add` raises Backpressure once
                    the bound is hit; callers that want atomic all-or-
                    nothing admission check `would_accept` first (the
                    service does). `requeue` is exempt — those docs were
                    already admitted and must not be lost.
    """

    def __init__(self, max_batch: int = 128, max_wait_ms: float = 5.0,
                 len_buckets: tuple[int, ...] | None = None,
                 batch_buckets: tuple[int, ...] | None = None,
                 max_len: int = 512, max_pending: int | None = None,
                 clock=time.perf_counter):
        if len_buckets is None:
            len_buckets = pow2_buckets(32, max_len)
        if batch_buckets is None:
            batch_buckets = default_batch_buckets(max_batch)
        assert batch_buckets[-1] == max_batch, (batch_buckets, max_batch)
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.len_buckets = tuple(sorted(len_buckets))
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.max_pending = max_pending
        self.rejected = 0       # docs refused with Backpressure
        self._clock = clock
        # (doc_id, tokens, arrival time) — arrival drives the wait deadline
        self._docs: list[tuple[int, np.ndarray, float]] = []
        self.truncated = 0      # docs clipped to the largest length bucket
        self.emitted_shapes: set[tuple[int, int]] = set()

    # ------------------------------------------------------------------ add
    def would_accept(self, n: int = 1) -> bool:
        """True iff `n` more docs fit under max_pending right now."""
        return (self.max_pending is None
                or len(self._docs) + n <= self.max_pending)

    def add(self, doc_id: int, tokens: np.ndarray):
        """Queue one document (1-D token array). Raises Backpressure when
        the bounded queue is full."""
        if not self.would_accept(1):
            self.rejected += 1
            raise Backpressure("queue_full",
                               retry_after_s=self.max_wait_ms / 1e3)
        tokens = np.asarray(tokens)  # foldlint: sync-ok(host ingress: tickets arrive as host token arrays by contract)
        cap = self.len_buckets[-1]
        if len(tokens) > cap:
            tokens = tokens[:cap]
            self.truncated += 1
        self._docs.append((doc_id, tokens.astype(np.uint32), self._clock()))

    def add_many(self, ids: Iterable[int], tokens: np.ndarray,
                 lengths: np.ndarray):
        """Queue a padded (N, L) chunk with per-doc lengths."""
        for i, did in enumerate(ids):
            self.add(did, tokens[i, : int(lengths[i])])

    @property
    def pending(self) -> int:
        return len(self._docs)

    def requeue(self, mb: MicroBatch) -> None:
        """Put an emitted-but-unprocessed batch back at the FRONT of the
        queue (dispatch failed downstream). Original arrival times are
        gone, so the docs re-age from now — they may wait up to one extra
        max_wait_ms, which is the acceptable cost of not losing them."""
        now = self._clock()
        docs = [(int(mb.doc_ids[i]),
                 mb.tokens[i, : int(mb.lengths[i])].copy(), now)
                for i in np.flatnonzero(mb.valid)]
        self._docs[:0] = docs

    # ---------------------------------------------------------------- drain
    def _overdue(self) -> bool:
        # the queue is FIFO, so element 0 carries the oldest arrival time
        return (bool(self._docs)
                and (self._clock() - self._docs[0][2]) * 1e3
                >= self.max_wait_ms)

    def drain(self, force: bool = False) -> list[MicroBatch]:
        """Emit every batch the policy allows right now.

        Full batches are always emitted; the ragged remainder only when
        `force` or the oldest pending doc has exceeded max_wait_ms."""
        out = []
        while len(self._docs) >= self.max_batch:
            out.append(self._emit(self._docs[: self.max_batch]))
            self._docs = self._docs[self.max_batch:]
        if self._docs and (force or self._overdue()):
            out.append(self._emit(self._docs))
            self._docs = []
        return out

    def _emit(self, docs: list[tuple[int, np.ndarray, float]]) -> MicroBatch:
        n = len(docs)
        B = _bucket_up(n, self.batch_buckets)
        L = _bucket_up(max((len(t) for _, t, _ in docs), default=1),
                       self.len_buckets)
        tokens = np.zeros((B, L), np.uint32)
        lengths = np.zeros((B,), np.int32)
        valid = np.zeros((B,), bool)
        doc_ids = np.full((B,), -1, np.int64)
        for i, (did, t, _) in enumerate(docs):
            tokens[i, : len(t)] = t
            lengths[i] = len(t)
            valid[i] = True
            doc_ids[i] = did
        self.emitted_shapes.add((B, L))
        return MicroBatch(tokens, lengths, valid, doc_ids, n)
