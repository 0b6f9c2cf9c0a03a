"""Quickstart on the PyTorch/CUDA port: online fuzzy dedup of an evolving
corpus with FOLD (port of examples/quickstart.py).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Streams synthetic Common-Crawl-like batches (40% near-duplicates) through
the port's FOLD pipeline and prints per-cycle throughput + the
recall/false-positive rate vs an exact brute-force reference, in the
reference example's format. Both pipelines come from the repro_torch.index
registry. With no `--device` it runs on the card (MinHash and the in-batch
Jaccard on their CUDA kernels) and raises without one; `--device cpu` runs
the plain PyTorch path. The size flags default to the reference example's
values.
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np

from repro_torch.core.dedup import FoldConfig
from repro_torch.data import DATASET_PRESETS, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.index import make_pipeline


def main(argv=None):
    ap = argparse.ArgumentParser(prog="examples/quickstart_torch.py")
    ap.add_argument("--cycles", type=int, default=4)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--capacity", type=int, default=1 << 14)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cycles, batch = args.cycles, args.batch
    cfg = FoldConfig(capacity=args.capacity, ef_construction=48,
                     ef_search=48, threshold_space="minhash")

    def pipeline(key):            # any repro_torch.index registry key
        return make_pipeline(key, cfg=cfg, device=device)

    fold, brute = pipeline("hnsw"), pipeline("brute")

    def stream():
        return SyntheticCorpus(DATASET_PRESETS["common_crawl"])

    src_f, src_b = stream(), stream()
    keeps_f, keeps_b = [], []
    for c in range(cycles):
        toks, lens, _ = src_f.next_batch(batch)
        keep, stats = fold.process_batch(toks, lens)
        keeps_f.append(keep)
        print(f"cycle {c}: {batch/ (stats['t_signature']+stats['t_in_batch']+stats['t_search']+stats['t_insert']):7.0f} docs/s  "
              f"in-batch drop {stats['n_batch_drop']:3d}  index drop "
              f"{stats['n_index_drop']:3d}  admitted {stats['n_insert']:3d}  "
              f"corpus {stats['count']}")
        toks, lens, _ = src_b.next_batch(batch)
        kb, _ = brute.process_batch(toks, lens)
        keeps_b.append(kb)
    kf, kb = np.concatenate(keeps_f), np.concatenate(keeps_b)
    ref_dup = ~kb
    recall = ((~kf) & ref_dup).sum() / ref_dup.sum()
    fp = ((~kf) & kb).sum() / kb.sum()
    print(f"\nFOLD vs brute force: recall={recall:.3f} false-positive={fp:.4f}")


if __name__ == "__main__":
    main()
