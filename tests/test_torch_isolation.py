"""The port stands alone: `repro_torch` and chip_smoke.py import neither
jax, the JAX package `repro` nor msgpack, at run time or anywhere in their
source, and the port saves and restores its checkpoints (every ported
backend, `hnsw_sharded` at 4 shards and its scale-out restore, the
baselines through `repro_torch.baselines`), serves a service with
snapshots, sharded too, lists its program specs (`python -m
repro_torch.analysis list`), serves every REDUCED LM arch
(`repro_torch.launch.serve.generate`), and trains, checkpoints and
resumes through `python -m repro_torch.launch.train` where none of the
three can be imported; the port's examples (`examples/*_torch.py`) import
none of them either, and the quickstart runs as a script where they are
blocked. Torch's fake process group (a test-only torch API)
appears in the port's dry run alone."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.core.dedup, "
            "repro_torch.index, repro_torch.kernels.ops, repro_torch.data, "
            "repro_torch.core.oracle, repro_torch.index.exact, "
            "repro_torch.lifecycle, repro_torch.train.checkpoint, "
            "repro_torch.service, repro_torch.cluster, "
            "repro_torch.data.ingest, repro_torch.baselines, "
            "repro_torch.index.backends.lsh, "
            "repro_torch.index.backends.prefix, repro_torch.core.minhash, "
            "repro_torch.core.sharded, repro_torch.index.backends.sharded, "
            "repro_torch.analysis, repro_torch.analysis.gate, "
            "repro_torch.analysis.inputs, repro_torch.analysis.__main__, "
            "repro_torch.service.programs, repro_torch.models, "
            "repro_torch.models.config, repro_torch.models.common, "
            "repro_torch.models.layers, repro_torch.models.transformer, "
            "repro_torch.models.whisper, repro_torch.configs, "
            "repro_torch.configs.shapes, repro_torch.train.step, "
            "repro_torch.launch.serve, repro_torch.train, "
            "repro_torch.train.optimizer, repro_torch.train.ft, "
            "repro_torch.launch.train, repro_torch.dist, "
            "repro_torch.dist.act, repro_torch.dist.sharding, "
            "repro_torch.launch.mesh, repro_torch.launch.hlocost, "
            "repro_torch.launch.dryrun; "
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


# torch's fake process group is a private, test-only torch API: the port
# uses it in its dry run alone
FAKE_GROUP_OK = {ROOT / "src" / "repro_torch" / "launch" / "dryrun.py"}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_fake_process_group_only_in_the_dry_run(path):
    text = path.read_text()
    uses = "fake_pg" in text or "FakeStore" in text
    assert uses == (path in FAKE_GROUP_OK), path


_BLOCKED_RUN = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import torch
# one intra-op thread: the parallel test workers share the cores, and
# oversubscribed threads slow this run past its timeout
torch.set_num_threads(1)
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
import contextlib, io, runpy
out_dir = sys.argv[1]
sys.argv = ["repro_torch.analysis", "list"]
listed = io.StringIO()
with contextlib.redirect_stdout(listed):
    try:
        runpy.run_module("repro_torch.analysis", run_name="__main__")
    except SystemExit as stop:
        assert stop.code == 0, stop.code
assert len(listed.getvalue().splitlines()) == 11, listed.getvalue()
from repro_torch.configs import list_archs, reduced_config
from repro_torch.launch.serve import generate, init_model
for arch in list_archs():
    cfg = reduced_config(arch)
    rng = np.random.default_rng(0)
    params, caches = init_model(cfg, 2, 6, "cpu", rng)
    out = generate(cfg, params, caches, rng.integers(1, cfg.vocab, (2, 3)), 4)
    assert out.tokens.shape == (2, 4), arch
from repro_torch.launch.train import main as train_main
run_dir = out_dir + "/train"
run = train_main(["--device", "cpu", "--steps", "2", "--batch", "2",
                  "--seq", "16", "--ckpt-every", "1", "--dataset", "lm1b",
                  "--ckpt-dir", run_dir])
assert len(run.log) == 2
again = train_main(["--device", "cpu", "--steps", "3", "--batch", "2",
                    "--seq", "16", "--dataset", "lm1b",
                    "--ckpt-dir", run_dir])
assert again.resumed_from == 2 and int(again.trainer.opt_state.step) == 3
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
    assert (tmp_path / "train" / "step_00000002" / "arrays.msgpack").exists()


def test_examples_exist_and_quickstart_runs_without_jax(tmp_path):
    names = {p.name for p in PORT_FILES if p.parent.name == "examples"}
    assert names == {f"{n}_torch.py" for n in (
        "quickstart", "service_demo", "cluster_demo", "distributed_dedup",
        "serve_demo", "train_dedup_lm")}
    example = ROOT / "examples" / "quickstart_torch.py"
    code = _BLOCKED_RUN.split("import numpy as np")[0] + (
        "import runpy, torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.argv = [{str(example)!r}, '--device', 'cpu', '--cycles', '1',"
        " '--batch', '32', '--capacity', '256']\n"
        f"runpy.run_path({str(example)!r}, run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'msgpack'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "FOLD vs brute force: recall=" in out.stdout
    assert out.stdout.splitlines()[-1] == "[]"
