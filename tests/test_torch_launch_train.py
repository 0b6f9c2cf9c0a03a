"""The port's training entry point (`python -m repro_torch.launch.train`) on
the CPU at REDUCED width: two steps fed by each dedup mode (direct FOLD
ingest, the service, no dedup, the `dpk` backend), gradient
accumulation, resume from its own checkpoints (which does not replay the
batches of the run it resumes), `--mesh 1,1` on a one-rank gloo group
against the unmeshed run, the card as the default device, and the admitted stream against the reference
launcher's data stage on the same seed."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.data import DATASET_PRESETS as JAX_PRESETS
from repro.data import DedupIngest as JaxDedupIngest
from repro.data import PackedBatches as JaxPackedBatches
from repro.data import SyntheticCorpus as JaxSyntheticCorpus
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import main

torch.set_num_threads(2)

ARGS = ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "32"]


def _run(tmp_path, *extra):
    return main(ARGS + ["--ckpt-dir", str(tmp_path / "ckpt"), *extra])


def _reference_batches(n_steps: int, *, batch=2, seq=32, arch="qwen1.5-4b",
                       dataset="common_crawl"):
    """The reference launcher's data stage (`repro/launch/train.py`: its
    corpus, FoldConfig, DedupIngest, PackedBatches and fill loop) for
    `n_steps` steps: ([(tokens, mask)], ingest)."""
    from repro.core.dedup import FoldConfig
    cfg = jax_reduced_config(arch)
    src = JaxSyntheticCorpus(dataclasses.replace(JAX_PRESETS[dataset],
                                                 vocab=cfg.vocab))
    packer = JaxPackedBatches(batch=batch, seq_len=seq + 1)
    ingest = JaxDedupIngest(src, FoldConfig(capacity=1 << 15,
                                            ef_construction=48,
                                            ef_search=48,
                                            threshold_space="minhash"))
    out = []
    for _ in range(n_steps):
        while True:
            toks, lens, _ = ingest.next_clean_batch(256)
            packer.add_docs(toks, lens)
            b = packer.pop_batch()
            if b is not None:
                out.append(b)
                break
    return out, ingest


def _batches_equal(run, ref) -> None:
    assert sorted(run.batches) == list(range(len(ref)))
    for step, (tokens, mask) in enumerate(ref):
        got = run.batches[step]
        np.testing.assert_array_equal(got["tokens"].numpy(), tokens[:, :-1])
        np.testing.assert_array_equal(got["labels"].numpy(), tokens[:, 1:])
        np.testing.assert_array_equal(got["loss_mask"].numpy(), mask[:, 1:])


def test_dedup_fed_training_matches_the_reference_stream(tmp_path, capsys):
    run = _run(tmp_path)
    out = capsys.readouterr().out
    assert "arch=qwen1.5-4b family=dense reduced=True device=cpu" in out
    assert len(run.log) == 2 and all(np.isfinite(r["loss"]) for r in run.log)
    assert [r["step"] for r in run.log] == [1, 2]
    assert set(run.log[0]) >= {"loss", "lr", "grad_norm", "dt", "batch_s"}
    assert int(run.trainer.opt_state.step) == 2
    ref, ingest = _reference_batches(2)
    _batches_equal(run, ref)
    assert (run.ingest.total_in, run.ingest.total_admitted) == (
        ingest.total_in, ingest.total_admitted)
    assert (f"dedup: admitted {ingest.total_admitted}/{ingest.total_in} docs"
            in out)
    assert "loss first->last:" in out and "tok/s" in out


def test_service_ingest_admits_the_direct_stream(tmp_path):
    direct = _run(tmp_path / "direct")
    svc = _run(tmp_path / "svc", "--service")
    assert svc.ingest.service is not None
    assert (svc.ingest.total_in, svc.ingest.total_admitted) == (
        direct.ingest.total_in, direct.ingest.total_admitted)
    for step in (0, 1):
        for k in ("tokens", "labels", "loss_mask"):
            assert torch.equal(svc.batches[step][k], direct.batches[step][k])
    assert [r["loss"] for r in svc.log] == [r["loss"] for r in direct.log]


@pytest.mark.parametrize("extra", [["--no-dedup"], ["--dedup-backend", "dpk"],
                                   ["--grad-accum", "2"]],
                         ids=["no_dedup", "dpk", "grad_accum"])
def test_cli_modes_train(tmp_path, capsys, extra):
    run = _run(tmp_path, *extra)
    out = capsys.readouterr().out
    assert len(run.log) == 2 and all(np.isfinite(r["loss"]) for r in run.log)
    if extra == ["--no-dedup"]:
        assert run.ingest is None and "dedup:" not in out
    else:
        assert run.ingest.total_admitted > 0 and "dedup: admitted" in out
    if extra[0] == "--dedup-backend":
        assert run.ingest.pipe.backend.name == "dpk"


def test_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    first = _run(tmp_path, "--ckpt-every", "1")
    capsys.readouterr()
    again = main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
                  "32", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert "resumed from step 2" in capsys.readouterr().out
    assert again.resumed_from == 2 and [r["step"] for r in again.log] == [3]
    assert int(again.trainer.opt_state.step) == 3
    assert first.log[-1]["step"] == 2


def test_cli_resume_does_not_replay_the_batches(tmp_path):
    """A resumed `main` (as in a new process) starts a new corpus, dedup
    index and batch cache, as the reference's `launch/train.py` does:
    its step 2 trains on the stream's first batch, not on the batch an
    uninterrupted run trains step 2 on (a hazard in ROADMAP.md section
    3)."""
    three = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "32"]
    whole = main(three + ["--ckpt-dir", str(tmp_path / "whole")])
    _run(tmp_path, "--ckpt-every", "2")
    resumed = main(three + ["--ckpt-dir", str(tmp_path / "ckpt")])
    assert resumed.resumed_from == 2 and sorted(resumed.batches) == [2]
    got = resumed.batches[2]["tokens"]
    assert torch.equal(got, whole.batches[0]["tokens"])
    assert not torch.equal(got, whole.batches[2]["tokens"])


def test_mesh_one_rank_trains_as_the_unmeshed_cli(tmp_path):
    """`--mesh 1,1` starts its own one-rank gloo group, trains on DTensor
    params and moments, and takes it down again; its losses and batches
    are the unmeshed run's, and its checkpoint resumes one device."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.models.common import tree_leaves
    plain = _run(tmp_path / "plain")
    meshed = main(ARGS + ["--mesh", "1,1", "--ckpt-every", "2",
                          "--ckpt-dir", str(tmp_path / "mesh")])
    assert not dist.is_initialized()
    assert meshed.mesh is not None and meshed.mesh.mesh_dim_names == (
        "data", "model")
    assert all(isinstance(t, DTensor)
               for t in tree_leaves(meshed.trainer.params))
    for a, b in zip(plain.log, meshed.log):
        assert abs(a["loss"] - b["loss"]) < 1e-3
    for k in plain.batches:
        assert torch.equal(plain.batches[k]["tokens"],
                           meshed.batches[k]["tokens"].full_tensor())
    resumed = main(ARGS[:3] + ["3"] + ARGS[4:] + [
        "--ckpt-dir", str(tmp_path / "mesh")])
    assert resumed.resumed_from == 2 and resumed.mesh is None


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="found no GPU"):
        main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="found no GPU"):
        launch_train.make_ingest(launch_train.reduced_config("qwen1.5-4b"),
                                 "common_crawl")
