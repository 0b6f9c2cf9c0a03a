"""The port stands alone: `repro_torch` and chip_smoke.py import neither
jax, the JAX package `repro` nor msgpack, at run time or anywhere in their
source, and the port saves and restores its checkpoints (every ported
backend, `hnsw_sharded` at 4 shards and its scale-out restore, the
baselines through `repro_torch.baselines`), and serves a service with
snapshots, sharded too, where none of the three can be imported."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.core.dedup, "
            "repro_torch.index, repro_torch.kernels.ops, repro_torch.data, "
            "repro_torch.core.oracle, repro_torch.index.exact, "
            "repro_torch.lifecycle, repro_torch.train.checkpoint, "
            "repro_torch.service, repro_torch.cluster, "
            "repro_torch.data.ingest, repro_torch.baselines, "
            "repro_torch.index.backends.lsh, "
            "repro_torch.index.backends.prefix, repro_torch.core.minhash, "
            "repro_torch.core.sharded, repro_torch.index.backends.sharded; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "msgpack"), \
                (path, node.lineno, name)


_BLOCKED_RUN = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
from repro_torch.core.dedup import FoldConfig
from repro_torch.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro_torch.index import make_pipeline
tokens, lengths, _ = SyntheticCorpus(DATASET_PRESETS["lm1b"]).next_batch(32)
nxt = SyntheticCorpus(DATASET_PRESETS["common_crawl"]).next_batch(32)[:2]
for key in ("hnsw", "brute"):
    cfg = FoldConfig(capacity=128, M=8, M0=16, ef_construction=32,
                     ef_search=32, verify_minhash=key == "hnsw",
                     exact_filter=True)
    pipe = make_pipeline(key, cfg, device="cpu")
    pipe.process_batch(tokens, lengths)
    pipe.delete(np.arange(0, 32, 4))
    pipe.save(sys.argv[1] + "/" + key, 1)
    back = make_pipeline(key, cfg, device="cpu")
    assert back.restore(sys.argv[1] + "/" + key) == 1
    assert back.inserted == pipe.inserted
    assert (back.process_batch(*nxt)[0] == pipe.process_batch(*nxt)[0]).all()
cfg = FoldConfig(capacity=64, M=8, M0=16, ef_construction=32, ef_search=32)
pipe = make_pipeline("hnsw_sharded", cfg, shards=4, device="cpu")
pipe.process_batch(tokens, lengths)
pipe.delete(np.arange(0, 32, 4))
pipe.save(sys.argv[1] + "/hnsw_sharded", 1)
for shards in (8, 4):
    back = make_pipeline("hnsw_sharded", cfg, shards=shards, device="cpu")
    assert back.restore(sys.argv[1] + "/hnsw_sharded") == 1
    assert back.inserted == pipe.inserted
assert (back.process_batch(*nxt)[0] == pipe.process_batch(*nxt)[0]).all()
import repro_torch.baselines as tb
for key, make_pipe in (
        ("hnsw_raw", lambda: tb.RawHNSWPipeline(
            metric="hamming", capacity=128, M=8, M0=16, ef_construction=32,
            ef_search=32, device="cpu")),
        ("dpk", lambda: tb.DPKPipeline(capacity=128, device="cpu")),
        ("flat_lsh", lambda: tb.FlatLSHPipeline(capacity=128, device="cpu")),
        ("prefix_filter", lambda: tb.PrefixFilterPipeline(device="cpu"))):
    pipe = make_pipe()
    pipe.process_batch(tokens, lengths)
    pipe.save(sys.argv[1] + "/" + key, 1)
    back = make_pipe()
    assert back.restore(sys.argv[1] + "/" + key) == 1
    assert back.inserted == pipe.inserted > 0
    assert (back.process_batch(*nxt)[0] == pipe.process_batch(*nxt)[0]).all()
from repro_torch.service import DedupService, ServiceConfig
svc = DedupService(ServiceConfig(
    fold=FoldConfig(capacity=128, M=8, M0=16, ef_construction=32,
                    ef_search=32), max_batch=16, max_wait_ms=0.0,
    snapshot_dir=sys.argv[1] + "/service", snapshot_every=1,
    device="cpu"))
ticket = svc.submit(tokens[:20], lengths[:20])
svc.flush()
assert len(svc.results(ticket)) == 20
assert svc.index_manager.committed_steps() == (1, 2)
svc = DedupService(ServiceConfig(
    fold=FoldConfig(capacity=64, M=8, M0=16, ef_construction=32,
                    ef_search=32), shards=2, max_batch=16, max_wait_ms=0.0,
    snapshot_dir=sys.argv[1] + "/sharded_service", snapshot_every=1,
    device="cpu"))
ticket = svc.submit(tokens[:20], lengths[:20])
svc.flush()
assert len(svc.results(ticket)) == 20
assert svc.pipeline.backend.name == "hnsw_sharded"
assert svc.index_manager.committed_steps() == (1, 2)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_checkpoints_round_trip_without_jax_or_msgpack(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert (tmp_path / "hnsw" / "step_00000001" / "arrays.msgpack").exists()
    assert (tmp_path / "service" / "step_00000002" / "MANIFEST.json").exists()
    assert (tmp_path / "hnsw_sharded" / "step_00000001"
            / "arrays.msgpack").exists()
