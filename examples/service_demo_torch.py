"""Online dedup serving demo on the PyTorch/CUDA port: the full
repro_torch.service stack end to end (port of examples/service_demo.py).

    PYTHONPATH=src python examples/service_demo_torch.py [--device cpu]

Streams synthetic Common-Crawl-like traffic (40% near-duplicates) into a
DedupService in ragged request-sized chunks. The micro-batcher coalesces
them onto a bounded menu of batch shapes, the executor runs signature prep
and index search/insert, and the index manager grows the HNSW index past
its deliberately tiny initial capacity and rotates snapshots. Prints the
reference example's per-wave serving report and final metrics, then the
same service over the `dpk` backend. With no `--device` it runs on the
card and raises without one; `--device cpu` runs the plain PyTorch path.
The size flags default to the reference example's values.
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import tempfile

import numpy as np

from repro_torch.core.dedup import FoldConfig
from repro_torch.data import DATASET_PRESETS, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.service import DedupService, ServiceConfig


def main(argv=None):
    ap = argparse.ArgumentParser(prog="examples/service_demo_torch.py")
    ap.add_argument("--waves", type=int, default=6)
    ap.add_argument("--docs-per-wave", type=int, default=512)
    ap.add_argument("--capacity", type=int, default=2048)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    src = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    snap_dir = os.path.join(tempfile.mkdtemp(prefix="fold_service_"), "snaps")

    svc = DedupService(ServiceConfig(
        fold=FoldConfig(capacity=args.capacity, ef_construction=48,
                        ef_search=48, threshold_space="minhash"),
        max_batch=128, max_wait_ms=2.0, max_len=512,
        grow_watermark=0.85, growth_factor=2.0,
        snapshot_dir=snap_dir, snapshot_every=8, max_snapshots=2,
        device=device))  # foldlint: disable=F141 (the port's ServiceConfig adds device)

    waves, docs_per_wave = args.waves, args.docs_per_wave
    print(f"serving {waves} waves x {docs_per_wave} docs "
          f"(initial capacity {svc.backend.capacity})")
    for w in range(waves):
        tickets = []
        sent = 0
        while sent < docs_per_wave:                 # ragged request sizes
            n = int(rng.integers(1, 48))
            n = min(n, docs_per_wave - sent)
            toks, lens, _ = src.next_batch(n)
            tickets.append(svc.submit(toks, lens))
            sent += n
        verdicts = [v for t in tickets for v in svc.results(t)]
        s = svc.stats()
        admitted = sum(v.admitted for v in verdicts)
        print(f"wave {w}: admitted {admitted:4d}/{docs_per_wave}"
              f"  qps={s['qps_interval']:7.1f}"
              f"  p99_batch={s['latency_ms']['batch_ms']['p99']:6.1f}ms"
              f"  index {s['index']['count']}/{s['index']['capacity']}"
              f"  (grown {s['index']['grow_events']}x,"
              f" {s['index']['snapshots']} snaps)")

    s = svc.stats()
    c = s["counters"]
    print(f"\ntotals: in={c['docs_in']} out={c['docs_out']} "
          f"admitted={c.get('admitted', 0)} "
          f"batch_dup={c.get('batch_dup', 0)} "
          f"index_dup={c.get('index_dup', 0)}")
    print(f"compiled shapes (bounded by bucketing): "
          f"{s['batching']['compiled_shapes']}")
    print(f"snapshot dir keeps newest {svc.cfg.max_snapshots}: "
          f"{sorted(os.listdir(snap_dir))}")
    assert s["index"]["grow_events"] >= 1, \
        f"demo should outgrow {args.capacity} slots"

    # --- the same serving stack over a different index organization -------
    # ServiceConfig.backend takes any repro_torch.index registry key; the
    # DPK baseline below gets the identical micro-batching, pipelining, and
    # growth watermark machinery — no code changes, one config string.
    svc2 = DedupService(ServiceConfig(
        fold=FoldConfig(capacity=2048), backend="dpk",
        max_batch=128, max_wait_ms=2.0, max_len=512,
        device=device))  # foldlint: disable=F141 (the port's ServiceConfig adds device)
    src2 = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    t = svc2.submit(*src2.next_batch(512)[:2])
    admitted = sum(v.admitted for v in svc2.results(t))
    s2 = svc2.stats()
    print(f"\nsame service, backend='dpk': admitted {admitted}/512, index "
          f"{s2['index']['count']}/{s2['index']['capacity']} "
          f"({s2['index']['backend_stats']['buckets']} LSH buckets)")


if __name__ == "__main__":
    main()
