"""The one traffic generator: a mix file's parameters and a seed in, a
stream of work units out.

A mix (`traffic/<mix>.json`) names a corpus preset and how its documents
reach the system:

  preset         a key of `corpus.DATASET_PRESETS` (lengths, dup rate,
                 edit range, history window)
  loop           "closed": units are batches of `batch_docs` documents, the
                 next sent when the last completes; "open": units are
                 requests with a scheduled arrival
  recrawl_share  share of documents that are light edits of prefill
                 documents drawn uniformly: max(1, int(recrawl_sub_rate *
                 length)) tokens at distinct positions replaced by tokens
                 drawn from [1, vocab); the rest continue the preset's
                 stream
  rate_docs_per_s, request_docs, shape_seed
                 (open loop) the offered load, the request-size law
                 (lognormal by median and sigma, clipped to [min, max], or
                 fixed), and the seed of the request sizes and gaps
  warmup_docs    documents of the warm-up unit, sent before the window
  source         where the parameters come from

Every seed gets the same work: the prefill comes from the configuration's
own seed, and in an open loop the set of request sizes and of gaps between
arrivals comes from `shape_seed`; `--seed` draws the documents and the
order of those sizes and gaps. Arrivals of a Poisson process over a window
are uniform order statistics, which is how the gaps are drawn.

`produce` runs in its own process, on a core of its own at a lower
priority, and keeps a bounded queue filled ahead of the caller, so that
making documents never counts against the system and the documents depend
on the seed alone, not on timing.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np

from foldbench.traffic.corpus import DATASET_PRESETS, SyntheticCorpus

__all__ = ["load_mix", "prefill_batches", "Stream", "request_pool",
           "produce", "pad", "unpad"]

HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    """The parameters of a traffic mix, by name."""
    with open(HERE / f"{name}.json") as f:
        return json.load(f)


def _seq(seed: int, *tags: int) -> np.random.SeedSequence:
    """A seed sequence for any whole number (negative or past 64 bits
    too) and a stream tag."""
    return np.random.SeedSequence([int(seed) % (1 << 64), *tags])


def pad(docs: list) -> tuple[np.ndarray, np.ndarray]:
    """Documents (1-D uint32 arrays) as a zero-padded (B, L) matrix and
    their lengths, L at least 5 (the shingle width)."""
    L = max(5, max((len(d) for d in docs), default=1))
    tokens = np.zeros((len(docs), L), np.uint32)
    lengths = np.zeros(len(docs), np.int32)
    for i, d in enumerate(docs):
        tokens[i, :len(d)] = d
        lengths[i] = len(d)
    return tokens, lengths


def unpad(tokens: np.ndarray, lengths: np.ndarray) -> list:
    """The rows of a padded matrix as 1-D documents (copies)."""
    return [tokens[i, :int(lengths[i])].copy() for i in range(len(lengths))]


def _corpus(mix: dict, prefill: dict) -> SyntheticCorpus:
    preset = DATASET_PRESETS[mix["preset"]]
    return SyntheticCorpus(dataclasses.replace(preset, seed=prefill["seed"]))


def prefill_batches(mix: dict, prefill: dict) -> list:
    """The prefill: `prefill["docs"]` documents of the mix's preset in
    batches of `prefill["batch_docs"]`, from the prefill's own seed."""
    corpus = _corpus(mix, prefill)
    n, b = prefill["docs"], prefill["batch_docs"]
    return [corpus.next_batch(min(b, n - s))[:2] for s in range(0, n, b)]


class Stream:
    """The documents after the prefill: the preset's stream continued under
    `seed`, with the recrawl share mixed in."""

    def __init__(self, mix: dict, prefill: dict, seed: int):
        self.mix = mix
        self.corpus = _corpus(mix, prefill)
        self.share = float(mix.get("recrawl_share", 0.0))
        self.old: list = []
        for s in range(0, prefill["docs"], prefill["batch_docs"]):
            tokens, lengths, _ = self.corpus.next_batch(
                min(prefill["batch_docs"], prefill["docs"] - s))
            if self.share:
                self.old.extend(unpad(tokens, lengths))
        self.corpus.rng = np.random.default_rng(_seq(seed, 0))
        self.rng = np.random.default_rng(_seq(seed, 1))

    def _recrawl(self, doc: np.ndarray) -> np.ndarray:
        """A light edit: max(1, int(rate * length)) tokens at distinct
        positions replaced by tokens drawn from [1, vocab)."""
        rng, n = self.rng, len(doc)
        m = min(n, max(1, int(self.mix["recrawl_sub_rate"] * n)))
        out = doc.copy()
        pos = rng.choice(n, m, replace=False)
        out[pos] = rng.integers(1, self.corpus.cfg.vocab, m)
        return out

    def docs(self, n: int) -> list:
        """The next n documents, as 1-D uint32 arrays."""
        old = (self.rng.random(n) < self.share if self.share
               else np.zeros(n, bool))
        fresh = iter(unpad(*self.corpus.next_batch(int((~old).sum()))[:2])
                     if (~old).any() else [])
        return [self._recrawl(self.old[int(self.rng.integers(len(self.old)))])
                if o else next(fresh) for o in old]


def request_pool(mix: dict, seconds: float, seed: int, tag: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(arrival offsets in s, request sizes) of an open loop over `seconds`:
    the same sizes and gaps for every seed (from the mix's shape seed and
    `tag`), in the order `seed` draws."""
    shape = np.random.default_rng(_seq(mix["shape_seed"], tag))
    law = mix["request_docs"]
    draws = 65536
    if law["dist"] == "fixed":
        sizes = np.full(draws, int(law["docs"]), np.int64)
    elif law["dist"] == "lognormal":
        sizes = np.clip(np.rint(shape.lognormal(np.log(law["median"]),
                                                law["sigma"], draws)),
                        law["min"], law["max"]).astype(np.int64)
    else:
        raise ValueError(f"unknown request-size law {law['dist']!r}")
    n = max(1, int(round(mix["rate_docs_per_s"] * seconds / sizes.mean())))
    sizes = sizes[:n]
    arrivals = np.sort(shape.uniform(0.0, seconds, n))
    gaps = np.diff(arrivals, prepend=0.0)
    order = np.random.default_rng(_seq(seed, 2, tag))
    gaps = gaps[order.permutation(n)]
    sizes = sizes[order.permutation(n)]
    return np.cumsum(gaps), sizes


def units(mix: dict, prefill: dict, seed: int, seconds: float,
          trace_seconds: float):
    """Every unit of a run, in order: the warm-up unit, then the window's
    (a closed loop's never end), then, with `trace_seconds`, the traced
    segment's. A closed loop's unit is ("batch", tokens, lengths); an open
    loop's is ("request", arrival s, tokens, lengths), arrivals counted
    from the window's start."""
    stream = Stream(mix, prefill, seed)
    yield ("warmup", *pad(stream.docs(mix["warmup_docs"])))
    if mix["loop"] == "closed":
        while True:
            yield ("batch", *pad(stream.docs(mix["batch_docs"])))
    elif mix["loop"] == "open":
        segments = [(0.0, seconds, 0)]
        if trace_seconds:
            segments.append((seconds, trace_seconds, 1))
        for start, length, tag in segments:
            arrivals, sizes = request_pool(mix, length, seed, tag)
            for t, k in zip(arrivals, sizes):
                yield ("request", start + float(t), *pad(stream.docs(int(k))))
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")


def produce(mix: dict, prefill: dict, seed: int, seconds: float,
            trace_seconds: float, queue, stop, core: int | None = None
            ) -> None:
    """Fill `queue` with `units(...)` until they end (then put None) or
    `stop` is set. Runs in its own process: on `core` alone, where given,
    at a lower priority."""
    import queue as queue_mod
    if core is not None:
        os.sched_setaffinity(0, {core})
        os.nice(10)
    for unit in units(mix, prefill, seed, seconds, trace_seconds):
        while True:
            if stop.is_set():
                return
            try:
                queue.put(unit, timeout=0.1)
                break
            except queue_mod.Full:
                continue
    queue.put(None)
