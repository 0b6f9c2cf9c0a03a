"""FOLD-integrated training ingestion: the paper's technique as a
data-pipeline stage (port of `repro/data/ingest.py`).

DedupIngest wraps any batch source (tokens, lengths) with a dedup
pipeline: incoming documents are deduplicated online and only admitted
documents flow into training. PackedBatches then packs admitted documents
into fixed-shape (batch, seq_len) training batches with next-token labels.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dedup import FoldConfig
from repro_torch.index import make_pipeline

__all__ = ["DedupIngest", "PackedBatches"]


class DedupIngest:
    """Dedup stage of the data pipeline, in one of two modes.

    Direct (default): a private DedupPipeline over any registered
    `repro_torch.index` backend (default "hnsw" — the FOLD pipeline), one
    blocking process_batch per raw batch — simple, per-stage-timed, the
    Fig. 7 measurement path. It runs on cuda unless the factory option
    `device="cpu"` is passed.

    Service-backed: pass a repro_torch.service.DedupService and raw
    batches are submitted through its micro-batcher + executor instead —
    ingestion shares the serving layer's shape bucketing, index growth and
    snapshot rotation, and runs on the service's device. The service may
    also be shared with other producers (its doc ids stay globally
    unique); its own `backend` config key picks the index.
    """

    def __init__(self, source, fold_cfg: FoldConfig | None = None,
                 service=None, backend: str = "hnsw", **backend_opts):
        self.source = source
        self.service = service
        self.pipe = (service.pipeline if service is not None
                     else make_pipeline(backend, cfg=fold_cfg or FoldConfig(),
                                        **backend_opts))
        self.total_in = 0
        self.total_admitted = 0

    def next_clean_batch(self, batch_size: int):
        """Pull one raw batch, dedup it, return admitted (tokens, lengths)."""
        tokens, lengths, _ = self.source.next_batch(batch_size)
        if self.service is not None:
            ticket = self.service.submit(tokens, lengths)
            verdicts = self.service.results(ticket)
            keep = np.asarray([v.admitted for v in verdicts])
            stats = {"n_insert": int(keep.sum()),
                     "service": self.service.metrics.counters.copy()}
        else:
            keep, stats = self.pipe.process_batch(tokens, lengths)
        self.total_in += len(keep)
        self.total_admitted += int(keep.sum())
        return tokens[keep], lengths[keep], stats


class PackedBatches:
    """Greedy sequence packing of admitted docs into (B, S) training batches.

    Documents are concatenated with an EOS separator; sequences are filled
    greedily and a new doc always starts within the sequence (no doc spans
    two sequences — simpler loss masking, negligible waste at our lengths).
    """

    def __init__(self, batch: int, seq_len: int, eos_id: int = 1,
                 pad_id: int = 0):
        self.batch = batch
        self.seq_len = seq_len
        self.eos = eos_id
        self.pad = pad_id
        self._open: list[np.ndarray] = []     # current partially-filled seqs
        self._ready: list[np.ndarray] = []

    def add_docs(self, tokens: np.ndarray, lengths: np.ndarray):
        for row, ln in zip(tokens, lengths):
            doc = np.concatenate([row[:ln].astype(np.int32), [self.eos]])
            doc = doc[: self.seq_len]
            placed = False
            for i, seq in enumerate(self._open):
                if len(seq) + len(doc) <= self.seq_len:
                    self._open[i] = np.concatenate([seq, doc])
                    placed = True
                    break
            if not placed:
                self._open.append(doc)
            # promote full-enough sequences
            self._open, full = (
                [s for s in self._open if len(s) < self.seq_len],
                [s for s in self._open if len(s) >= self.seq_len])
            self._ready.extend(full)

    def pop_batch(self):
        """Return (tokens (B,S) int32, loss_mask (B,S) f32) or None."""
        if len(self._ready) < self.batch:
            return None
        rows = self._ready[: self.batch]
        self._ready = self._ready[self.batch:]
        out = np.full((self.batch, self.seq_len), self.pad, np.int32)
        mask = np.zeros((self.batch, self.seq_len), np.float32)
        for i, seq in enumerate(rows):
            seq = seq[: self.seq_len]
            out[i, :len(seq)] = seq
            mask[i, :len(seq)] = 1.0
        return out, mask

    def flush_batch(self):
        """Like pop_batch but pads with open sequences when short."""
        self._ready.extend(self._open)
        self._open = []
        while len(self._ready) < self.batch:
            self._ready.append(np.asarray([self.eos], np.int32))
        return self.pop_batch()
