"""Distributed FOLD on the PyTorch/CUDA port: index-sharded dedup over 4
HNSW sub-graphs (port of examples/distributed_dedup.py).

    PYTHONPATH=src python examples/distributed_dedup_torch.py [--device cpu]

Each shard owns an HNSW sub-graph over 1/4 of the corpus (the reference
mesh's "data" axis): every shard searches all queries, the best similarity
over the shards filters them, and admitted rows go to the shards round
robin — the step of core/sharded.py. The reference lays the 4 shards on a
(4, 2) mesh of 8 virtual devices; here all 4 live on one device (the card
with no `--device`, raising without one; `--device cpu` for the plain
path), and the mesh's "model" axis, over which the reference only
replicates, has no counterpart.
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import time

import torch

from repro_torch.core.bitmap import pack_bitmaps, popcount
from repro_torch.core.hashing import hash_seeds
from repro_torch.core.hnsw import HNSWConfig, sample_levels
from repro_torch.core.sharded import make_sharded_dedup_step, sharded_init
from repro_torch.core.shingle import shingle_hashes, token_tensors
from repro_torch.data import DATASET_PRESETS, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser(prog="examples/distributed_dedup_torch.py")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    shards = 4
    cfg = HNSWConfig(capacity=4096, words=128, M=12, M0=24,
                     ef_construction=32, ef_search=32, max_level=3)
    states = sharded_init(cfg, shards, device)
    step = make_sharded_dedup_step(cfg, shards, tau=0.538, k=4)
    seeds = hash_seeds(112, device=device)
    src = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    total = kept = 0
    for c in range(4):
        toks, lens, _ = src.next_batch(256)
        toks, lens = (t.to(device) for t in token_tensors(toks, lens))
        sh = shingle_hashes(toks, lens, 5)
        sigs = ops.minhash(sh, seeds)
        bm = pack_bitmaps(sigs, T=4096)
        t0 = time.time()
        levels = torch.from_numpy(sample_levels(256, cfg, seed=c)).to(device)
        states, keep = step(states, bm, popcount(bm), levels)
        n_keep = int(keep.sum())              # waits for the step
        total += 256
        kept += n_keep
        print(f"cycle {c}: admitted {n_keep:3d}/256 "
              f"({256/(time.time()-t0):6.0f} docs/s) "
              f"shard counts {[int(st.count) for st in states]}")
    print(f"total admitted {kept}/{total}")


if __name__ == "__main__":
    main()
