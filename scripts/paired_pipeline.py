"""Phase 3 of chip_smoke.py (the main path at 2**20 slots over 32 batches
of 512 Common Crawl preset docs, plus one profiled batch) from several
checkouts, in turns, on one GPU: the paired comparison of two commits.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/paired_pipeline.py build/parent . . build/parent

Each argument is the root of a checkout; each run is its own process,
which builds that checkout's kernels and imports its `chip_smoke.py`.
Prints each run's `pipeline` and `profile` lines, tagged with its root.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

_RUN = r'''
import os, sys
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import torch
import chip_smoke as cs
from repro_torch.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro_torch.kernels import _lib
if not torch.cuda.is_available():
    cs.fail("torch.cuda.is_available() is false: this script needs a GPU")
_lib.build_all()
corpus = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
batches = [corpus.next_batch(512)[:2] for _ in range(cs.PIPE_BATCHES)]
cs.phase_pipeline(batches, cs.gpu_name_power(), torch.device("cuda"))
'''


def main(roots: list[str]) -> int:
    if not roots:
        print(__doc__)
        return 2
    for root in roots:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", _RUN, root],
                             capture_output=True, text=True, timeout=900)
        for line in out.stdout.splitlines():
            if line.startswith(("pipeline {", "profile {")):
                print(root, line, flush=True)
        if out.returncode:
            print(root, "FAILED", out.stderr[-3000:], flush=True)
            return 1
        print(root, "wall", round(time.perf_counter() - t0, 1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
