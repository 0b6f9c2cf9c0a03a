"""The port's `examples/distributed_dedup_torch.py` against the reference
`examples/distributed_dedup.py`, both at the reference's own size (4
shards of 4,096 slots, 4 cycles of 256 Common Crawl preset docs).

The reference sets XLA_FLAGS for 8 virtual devices before it imports jax,
so it runs in a subprocess of its own; the port runs in this process with
`--device cpu`, all 4 shards on the CPU. Every count they print must be
equal: each cycle's admitted docs and per-shard counts, and the total
(the docs/s field is masked).
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_examples_util import (ROOT, mask_clock, reference_path,  # noqa: E402
                                  run_example)


def test_distributed_dedup_matches_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable,
                          str(reference_path("distributed_dedup"))],
                         env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    got = run_example("distributed_dedup", ["--device", "cpu"])["text"]
    assert mask_clock(got).splitlines() == mask_clock(ref.stdout).splitlines()
    cycles = re.findall(r"admitted (\d+)/256 .* shard counts \[([\d, ]+)\]",
                        got)
    assert len(cycles) == 4
    last = [int(x) for x in cycles[-1][1].split(",")]
    assert sum(last) == sum(int(n) for n, _ in cycles)
    assert got.splitlines()[-1] == f"total admitted {sum(last)}/1024"
