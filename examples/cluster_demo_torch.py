"""Replicated dedup serving demo on the PyTorch/CUDA port: the
repro_torch.cluster stack end to end (port of examples/cluster_demo.py).

    PYTHONPATH=src python examples/cluster_demo_torch.py [--device cpu]

One ClusterWriter (a full DedupService: micro-batching, pipelined
execution, growth, snapshot rotation) admits synthetic traffic from three
tenants — a well-behaved bulk producer, a rate-capped "greedy" tenant that
keeps slamming into its QPS bucket, and a budgeted tenant whose oldest
docs get evicted once it exceeds its live-doc allowance. Two ReadReplicas
poll the published manifest, restore new epochs, and serve the read-side
"would this be a dup?" queries through the staleness-gated router.
Byte-identical resubmits short-circuit at the exact-dup front end without
ever reaching the index. The writer and both replicas run on one device:
with no `--device` the card (raises without one), or `--device cpu`. The
size and quota flags default to the reference example's values.
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import dataclasses
import tempfile

from repro_torch.cluster import (Backpressure, ClusterConfig, DedupCluster,
                                 TenantSpec)
from repro_torch.core.dedup import FoldConfig
from repro_torch.data import DATASET_PRESETS, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.service import ServiceConfig


def main(argv=None):
    ap = argparse.ArgumentParser(prog="examples/cluster_demo_torch.py")
    ap.add_argument("--waves", type=int, default=5)
    ap.add_argument("--per-wave", type=int, default=192)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--burst", type=int, default=64,
                    help="the greedy tenant's QPS bucket size")
    ap.add_argument("--max-live-docs", type=int, default=128,
                    help="the budgeted tenant's live-doc allowance")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    src = SyntheticCorpus(dataclasses.replace(
        DATASET_PRESETS["common_crawl"], seed=0))
    snap_dir = os.path.join(tempfile.mkdtemp(prefix="fold_cluster_"), "snaps")

    cl = DedupCluster(ClusterConfig(
        service=ServiceConfig(
            fold=FoldConfig(capacity=args.capacity, ef_construction=32,
                            ef_search=32, threshold_space="minhash",
                            exact_filter=True),
            max_batch=64, max_wait_ms=1.0, max_len=256,
            max_pending_docs=512, retry_after_s=0.02,
            snapshot_dir=snap_dir,
            device=device),  # foldlint: disable=F141 (the port's ServiceConfig adds device)
        n_replicas=2,
        publish_every=4,                 # new epoch every 4 batches
        max_staleness_epochs=2,
        tenants=(TenantSpec("bulk"),
                 TenantSpec("greedy", qps=40.0, burst=args.burst),
                 TenantSpec("budgeted", max_live_docs=args.max_live_docs))))

    waves, per_wave = args.waves, args.per_wave
    rejected = 0
    print(f"cluster: 1 writer + {len(cl.replicas)} replicas, "
          f"publish_every={cl.cfg.publish_every}")
    toks = lens = None
    for w in range(waves):
        toks, lens, _ = src.next_batch(per_wave)
        cut1, cut2 = per_wave // 2, 3 * per_wave // 4
        for tenant, sl in (("bulk", slice(0, cut1)),
                           ("greedy", slice(cut1, cut2)),
                           ("budgeted", slice(cut2, per_wave))):
            try:
                cl.results(cl.submit(toks[sl], lens[sl], tenant=tenant))
            except Backpressure as bp:
                rejected += sl.stop - sl.start
                print(f"  wave {w}: {bp.tenant!r} rejected "
                      f"({bp.reason}, retry in {bp.retry_after_s:.2f}s)")
        cl.poll()                        # replicas poll the manifest
        ten = cl.writer.stats()["cluster"]["tenants"]
        eps = [r.epoch for r in cl.replicas]
        print(f"wave {w}: epoch={cl.writer.epoch} replicas={eps} "
              f"live(budgeted)={ten['budgeted']['live_docs']} "
              f"evicted={ten['budgeted']['evicted']}")

    # read path: fresh docs (mostly not dups) vs a byte-identical replay of
    # the last wave's submissions (admitted ones hit the exact front end)
    cl.publish()
    cl.refresh_replicas()
    fresh, flens, _ = src.next_batch(32)
    out = cl.query(fresh, flens)
    print(f"\nfresh probe: {int(out.is_dup.sum())}/32 flagged dup")
    replay = cl.query(toks[:16], lens[:16])  # exact hits never search
    print(f"exact replay: {int(replay.exact_hit.sum())}/16 short-circuited, "
          f"{int(replay.is_dup.sum())}/16 dup")

    st = cl.stats()
    w = st["writer"]
    print(f"\nwriter: epoch={w['cluster']['epoch']} "
          f"publishes={w['cluster']['publishes']} "
          f"exact_hits={w['index'].get('exact_hits', 0)}")
    for r in st["replicas"]:
        c = r["cluster"]
        print(f"replica {c['replica_id']}: epoch={c['epoch']} "
              f"behind={c['epochs_behind']} refreshes={c['refreshes']} "
              f"queries={r['counters'].get('queries', 0)}")
    for name, t in w["cluster"]["tenants"].items():
        print(f"tenant {name!r}: submitted={t['submitted']} "
              f"admitted={t['admitted']} rej_qps={t['rejected_qps']} "
              f"rej_queue={t['rejected_queue']} evicted={t['evicted']}")
    assert rejected > 0 or w["cluster"]["tenants"]["greedy"]["rejected_qps"]


if __name__ == "__main__":
    main()
