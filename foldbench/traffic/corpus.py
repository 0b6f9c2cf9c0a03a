"""Synthetic evolving corpora with controllable near-duplicate structure: a
frozen copy of `repro_torch/data/corpus.py`, so that a change to the
program cannot change the traffic it is measured on (the same seed gives
the same batches as the program's copy; `tests/test_foldbench_traffic.py`).

Real datasets (LM1B, C4, RealNews, Common Crawl) are not available offline,
so benchmarks use synthetic corpora whose *dedup-relevant statistics* mirror
Table 2: duplicate proportion, document length distribution, and edit
intensity (how far near-duplicates drift from their source). Near-dups are
produced by token substitution/insertion/deletion on a previously emitted
document — the same edit model the paper describes ("documents share
substantial text but differ due to edits, formatting changes, or copied
passages").

Each emitted doc carries provenance: `dup_of >= 0` marks it as a planted
near-duplicate of an earlier doc (global index). Ground truth for recall is
still computed by a *reference pipeline* (brute force / DPK), exactly as in
the paper — provenance is only used for sanity checks and corpus stats.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CorpusConfig", "SyntheticCorpus", "DATASET_PRESETS"]


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    name: str = "common_crawl"
    vocab: int = 50_000
    dup_rate: float = 0.40          # Table 2: CC 40.66%, RealNews 7.2%, ...
    mean_len: int = 120             # tokens (scaled from paper's word counts)
    max_len: int = 256
    min_len: int = 24
    edit_rate_lo: float = 0.00      # near-dup edit intensity range
    edit_rate_hi: float = 0.08      # ~J in [0.55, 1.0] for 5-gram shingles
    window: int = 4096              # how far back a dup can reference
    seed: int = 0


DATASET_PRESETS = {
    # scaled-down analogues of Table 2 (p99w in paper: 64-6683 words)
    "lm1b": CorpusConfig(name="lm1b", dup_rate=0.0198, mean_len=32,
                         max_len=64, min_len=8),
    "c4": CorpusConfig(name="c4", dup_rate=0.0202, mean_len=128, max_len=256),
    "realnews": CorpusConfig(name="realnews", dup_rate=0.072, mean_len=160,
                             max_len=320),
    "common_crawl": CorpusConfig(name="common_crawl", dup_rate=0.4066,
                                 mean_len=192, max_len=384),
}


class SyntheticCorpus:
    """Streaming batch source. `next_batch(B)` -> (tokens, lengths, dup_of)."""

    def __init__(self, cfg: CorpusConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self._history_tokens: list[np.ndarray] = []  # ring of recent docs
        self._emitted = 0

    def _fresh_doc(self) -> np.ndarray:
        cfg = self.cfg
        ln = int(np.clip(self.rng.lognormal(np.log(cfg.mean_len), 0.5),
                         cfg.min_len, cfg.max_len))
        return self.rng.integers(0, cfg.vocab, ln).astype(np.uint32)

    def _edit(self, doc: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        rate = self.rng.uniform(cfg.edit_rate_lo, cfg.edit_rate_hi)
        out = doc.copy()
        n_sub = self.rng.binomial(len(out), rate)
        if n_sub:
            pos = self.rng.choice(len(out), n_sub, replace=False)
            out[pos] = self.rng.integers(0, cfg.vocab, n_sub)
        # occasional head/tail truncation (formatting-change analogue)
        if self.rng.random() < 0.2 and len(out) > cfg.min_len + 8:
            cut = self.rng.integers(1, 8)
            out = out[cut:] if self.rng.random() < 0.5 else out[:-cut]
        return out

    def next_batch(self, batch_size: int):
        cfg = self.cfg
        docs, dup_of = [], []
        for _ in range(batch_size):
            if self._history_tokens and self.rng.random() < cfg.dup_rate:
                lo = self._emitted - len(self._history_tokens)
                j = int(self.rng.integers(lo, self._emitted))
                src = self._history_tokens[j - lo]
                docs.append(self._edit(src))
                dup_of.append(j)
            else:
                docs.append(self._fresh_doc())
                dup_of.append(-1)
            self._history_tokens.append(docs[-1])
            if len(self._history_tokens) > cfg.window:
                self._history_tokens.pop(0)
            self._emitted += 1
        max_len = max(len(d) for d in docs)
        tokens = np.zeros((batch_size, max_len), np.uint32)
        lengths = np.zeros(batch_size, np.int32)
        for i, d in enumerate(docs):
            tokens[i, :len(d)] = d
            lengths[i] = len(d)
        return tokens, lengths, np.asarray(dup_of, np.int64)
