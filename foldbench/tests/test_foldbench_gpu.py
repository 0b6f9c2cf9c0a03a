"""A whole run of each cell on the card at a test's size: the kernels, the
profiler's trace and the reference on the device. Marked `gpu`; skips
without a card (decided in a fixture, never at import)."""
from __future__ import annotations

import pytest
import torch

from foldbench import bench
from foldbench.tests._tiny import tiny

CELLS = [c["name"] for c in bench.load_spec()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_card(cell, card, tmp_path):
    spec, config, mix = tiny(cell)
    r = bench.run(cell, 2**31 + 5, 1.0, True, device=card, spec=spec,
                  config=config, mix=mix, cache=tmp_path, control=True,
                  log=lambda msg: None)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] < r["device"]["window_s"]
    want = {m["name"] for m in bench.cell_metrics(spec, cell, True)}
    assert set(r["metrics"]) == want, set(r["metrics"]) ^ want
    for name in ("k1_minhash_roofline", "k2_jaccard_roofline"):
        if name in r["metrics"]:
            assert 0 < r["metrics"][name]["value"] <= 105
