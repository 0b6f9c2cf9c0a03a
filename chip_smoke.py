"""Drive the PyTorch/CUDA port of FOLD on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  0. build  — compile every CUDA kernel from src/repro_torch/kernels/csrc
  1. kernels — each kernel at the main path's shapes (and ragged ones)
     against its plain PyTorch version on the card, and K3 (which recounts
     the popcounts) against K2 fed them; a kernel's time is its device time
     in a torch.profiler trace, the plain version's from CUDA events around
     back-to-back calls
  2. parity — FoldPipeline on cuda and on cpu over the same batches must
     give identical keep masks and index states (default config, and the
     Fig. 8 NO CACHE arm, which is the path that runs kernel K3)
  3. pipeline — FoldConfig() defaults at capacity 2**20 over 32 Common Crawl
     preset batches of 512 docs: docs/s and per-stage medians (the main path: K1, K2)
  4. hamming — ops.hamming, the only entry point of kernel K4
  5. reference — the exact `brute` backend on the card over phase 3's
     batches: its docs/s, and the recall and false-positive rate of phase
     3's hnsw keep masks against it; brute on cuda equals brute on cpu
     (keep masks and sims) over 4 batches of 256
  6. options — FoldPipeline on cuda equals it on cpu (keep masks and full
     state) with select_heuristic, batched_insert=False, verify_minhash,
     and exact_filter (fed repeated documents so the front door hits)
  7. lifecycle — on phase 3's index: delete every third admitted slot,
     compact (wall and device time), 4 more batches reuse the freed slots,
     save to build/ and restore into a fresh card pipeline (identical
     state and verdicts); and cuda-vs-cpu parity of delete and compact
  8. service — DedupService(ServiceConfig(fold=FoldConfig(capacity=2**20)))
     at its defaults on the card, fed 8,192 Common Crawl preset docs as
     ragged requests of 1-300 docs: docs/s, its batch_ms p50/p99 and
     sampled stage medians; its verdicts and index equal a process_batch
     loop over the same micro-batches on a second card pipeline; one
     profiled micro-batch (device idle share); pipeline depth 0 against 2
     in alternating turns on fresh services; and growth from 512 slots
     with snapshot rotation on cuda and on cpu (equal verdicts, grow
     events, committed steps, snapshot bytes)
  9. cluster — a ClusterWriter at 2**20 slots publishing every 16 batches,
     two card replicas and two tenants (a QPS quota on an injected clock,
     a live-doc budget), 4,096 docs: after every publish each refreshed
     replica answers a probe batch as the writer does; publish and
     refresh times; the budget's evictions ran through delete on the card
 10. baselines — Table 1's configurations (dpk, prefix_filter, flat_lsh
     with topk 4 and 160, hnsw_raw under minhash_jaccard and hamming) at
     2**20 slots over a prefix of phase 3's batches (BASELINES): docs/s,
     stage medians, recall and FP against phase 5's brute masks at tau
     0.7, K1's launches (none on prefix_filter, which runs no MinHash);
     each on cuda equals it on cpu over phase 2's batches (hnsw_raw's full
     state too; flat_lsh through deletes and two more batches)
 11. sharded — hnsw_sharded at FoldConfig() widths, 4 shards of 2**18
     slots (phase 3's 2**20 in all), over phase 3's first SHARDED_BATCHES
     batches: docs/s, the median t_fused_step, a profiled batch, recall
     and FP against phase 5's brute masks at the matched MinHash tau beside
     phase 3's hnsw over the same prefix, agreement with phase 3, K1 once
     per batch and K2-K4 never; shards=1 at 2**20 equals phase 3's masks;
     4 shards on cuda equal cpu (keep masks, every per-shard state);
     delete a third, compact, reuse, save, restore at 4 (equal), at 8
     (scale-out) and at 2 (refused); DedupService(shards=4) equals a
     process_batch loop over its micro-batches
 12. programs — repro_torch.analysis: (a) every registered program spec
     run once on the card and once on the CPU in this process: equal
     interface, argument/output bytes, aliasing, float64 outputs,
     data-dependent op counts and outputs, and no budget violation on the
     card; per spec the card's syncs (sync-debug mode), kernel launches,
     temp bytes and wall ms; K1-K4 never launched. (b) the main path's own
     programs at production geometry: on a copy of phase 3's 2**20-slot
     state, hnsw_search and hnsw_insert_batch of phase 3's last batch again
     (what its profiled batch ran; nothing admitted) and of a fresh 512-doc
     batch, then hnsw_search at each service batch bucket: syncs, launches,
     device operations and temp bytes per program; the replay's device
     operations beside phase 3's profiled batch
 13. lm_serve — the LM stack (repro_torch.models, configs, train.step,
     launch.serve). (a) every REDUCED arch, weights drawn from a CPU
     generator: make_prefill_step's logits, one decode step (logits and
     every cache leaf) and generate at batch 2, prompt 8, gen 8, on cuda
     against cpu, at bf16 and at f32 compute (equal tokens at f32).
     (b) qwen1.5-4b at full width (3,950,369,280 parameters, drawn on the
     card): generate at batch 16, prompt 128, gen 64 against a 4,096-
     position cache (prefill ms, decode tokens/s, median step ms, peak
     memory, one profiled decode step), and make_prefill_step's logits at
     the prompt's last position against the decode loop's; the same for
     falcon-mamba-7b at full width (7,006,326,784 parameters). (c) one
     qwen1.5-4b decode step at batch 1 on the card against the CPU, from
     the same weights and cache. K1-K4 are never launched.
 14. lm_train — LM training fed by FOLD dedup (repro_torch.train,
     launch.train). (a) every REDUCED arch at f32 compute, weights drawn
     from a CPU generator: the loss and every gradient of make_grad_fn,
     then one make_train_step (loss, grad_norm, params, m, v), on cuda
     against cpu, and the card's remat=True against remat=False bit for
     bit, under deterministic algorithms. (b) qwen1.5-4b at full width
     through launch.train's main path (ingest on the card -> PackedBatches
     -> make_train_step -> ElasticTrainer) at batch 2 x seq 512, one
     warm-up step then 8: launch.train's tokens/s (ingest included), median
     step ms, the model-FLOP share (6 N tokens per step over the H100
     SXM's dense bf16 peak; N without the embedding table), peak memory,
     one profiled step, loss first -> last, dedup admitted/in, and K1 and
     K2 launched by its ingest; the same at launch.train's default batch 8 x
     seq 256 for 4 steps, unprofiled; then --service for two steps (K1
     and K2 launched, its batches and admitted counts equal the direct
     ingest's). (c) the elastic resume of REDUCED qwen1.5-4b on the card
     (fail at step 6, checkpoints every 4, resume at 4) equals an
     uninterrupted 10-step run bit for bit, under deterministic
     algorithms (CUBLAS_WORKSPACE_CONFIG is set before CUDA starts).
 15. lm_train_mesh — meshed training through repro_torch.dist on a
     one-rank NCCL group and a (1, 1) ("data", "model") cuda mesh, so
     params and moments are DTensors. (a) qwen1.5-4b at full width through
     `launch.train --mesh 1,1` at phase 14 (b)'s batch 2 x seq 512 and 9
     steps (its lr schedule; one warm-up): each step's loss and grad norm
     against phase 14 (b)'s on the same batches (loss within 1e-3, grad
     norm within 1e-3 of its value), the median step, tokens/s, peak
     memory, one profiled step (device operations, idle share, NCCL
     kernels in it) beside phase 14 (b)'s, and K1 and K2 launched by its
     ingest. (b) REDUCED qwen1.5-4b and grok-1-314b, one train step each
     on the (1, 1) mesh and unmeshed on the card, from the same weights
     and batch: loss within 1e-3, params within 2e-3.
 16. examples — the six port examples (examples/*_torch.py) through their
     `main` in this process on the card, their printed lines captured.
     (a) quickstart, (b) service_demo, (c) cluster_demo and (d)
     distributed_dedup at their defaults, with the service batcher's and
     the cluster's tenant clocks frozen at 0: docs/s, recall, FP, p99
     batch ms; K1 and K2 launched in (a)-(c), K1 4 times and no other
     kernel in (d). (e) train_dedup_lm at demo-124m, batch 64 x seq 256,
     5 steps (the example's 300 cut by the run's time limit): loss first
     -> last, each step timed on the card, tokens/s, peak memory, dedup
     admitted/in; K1 and K2 once per ingest pull. (f) serve_demo at
     zamba2-7b full width (6,751,078,992 parameters) at batch 4, prompt
     32, gen 64: prefill s, decode tokens/s, median step, peak memory, one
     profiled decode step, finite logits; the decode loop's
     last-prompt-position logits no further from an f32-compute prefill's
     than make_prefill_step's bf16 logits are, within 25% (mean and
     largest error; the tests' rule for zamba2 at bf16), and at f32
     compute the decode loop within 10 times what one ulp on the input
     embeddings moves the prefill; K1-K4 never launched. Then, in parallel CPU processes, (a)-(d)
     again with `--device cpu` (equal output once the wall-clock fields
     are masked) and a DedupIngest over (e)'s pulls (equal admitted count
     in every pull).
Launch counts are reset just before each path is driven and read just
after; the comparison launches of phase 1 are not counted.

Prints one JSON line of per-kernel results, the card's name and power
limit, and last `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# phase 14 (a) and (c) run under torch.use_deterministic_algorithms, which
# needs cuBLAS's workspace fixed before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
PROFILE_DIR = os.path.join(ROOT, "build", "profile")

# phase 3: batches of 512 docs fed at capacity 2**20
PIPE_BATCHES = 32
# phases 8 and 9: docs sent as ragged requests of 1-300 docs
SERVICE_DOCS = 8192      # the service at capacity 2**20
DEPTH_DOCS = 2048        # each turn of pipeline depth 0 against 2
ROTATION_DOCS = 1024     # growth from 512 slots with snapshot rotation
CLUSTER_DOCS = 4096      # the cluster writer and its two replicas
SERVING_CAPACITY = 1 << 20   # index slots of phases 8 and 9
# phase 10: Table 1's configurations (benchmarks/table1_recall.py:13-24)
# at 2**20 slots, each fed a prefix of phase 3's batches: (tag, registry
# key, options, batches). hnsw_raw is cut to 16 batches (it pays phase 3's
# per-batch launches) and the pure-Python prefix_filter to 8, to keep the
# phase within about 3 minutes.
BASELINES = [
    ("dpk", "dpk", {}, 32),
    ("prefix_filter", "prefix_filter", {}, 8),
    ("flat_topk4", "flat_lsh", {"topk": 4}, 32),
    ("flat_topk160", "flat_lsh", {"topk": 160}, 32),
    ("faiss_jaccard", "hnsw_raw", {"metric": "minhash_jaccard"}, 16),
    ("faiss_hamming", "hnsw_raw", {"metric": "hamming"}, 16),
]

# phase 11: hnsw_sharded at FoldConfig() widths. The main run is cut to
# phase 3's first 16 batches (8,192 docs) by the run's time limit: every
# shard searches every query, so a batch costs about 4 of phase 3's
# searches. The shards=1 run takes phase 3's first 8 batches.
SHARDS = 4
SHARD_CAPACITY = 1 << 18         # per shard: 2**20 slots in all
SHARDED_BATCHES = 16
SHARDED_ONE_BATCHES = 8
SHARDED_PARITY_CAPACITY = 4096   # per shard, cuda against cpu
SHARDED_SERVICE_DOCS = 2048
# phase 12 (b): a batch of phase 3's width on a copy of its final state
PROGRAM_BATCH = 512
# phase 13: LM serving. (a) every REDUCED arch at the widths of
# repro_torch/configs; (b) and (c) qwen1.5-4b at full width
LM_SMALL = (2, 8, 8)                  # batch, prompt, gen
LM_FULL_ARCH = "qwen1_5_4b"
LM_FULL_PARAMS = 3_950_369_280
LM_FULL = (16, 128, 64, 4096)         # batch, prompt, gen, cache positions
LM_CPU_CACHE = 256                    # (c): cache positions copied to host
LM_FULL_SSM = ("falcon_mamba_7b", 7_006_326_784)   # (b) for the ssm family
# tolerances of tests/test_torch_models.py: f32 compute 1e-4 (the SSM
# families 2e-3); bf16 the reference's atol=0.15, rtol=0.05, and zamba2
# (ill-conditioned at bf16) no further from the CPU's f32 result than the
# CPU's own bf16 result, within 25%
LM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.15, 0.05)}
LM_SSM_TOL = 2e-3

# phase 14: LM training. (a) every REDUCED arch, batch x seq; (b)
# qwen1.5-4b at full width through launch.train: batch, seq, steps (one
# warm-up, then 8 timed), launch.train's default 8 x 256 for one warm-up
# and 3 timed steps, then two steps with --service; the tolerances of
# tests/test_torch_train_grads.py and tests/test_torch_train.py (a
# gradient's and m's largest error as a share of the leaf's largest
# |value| 1e-5, the SSM families 1e-3; v, quadratic in the gradient,
# twice that; params within it where the gradient is at least 1e-3 of
# its leaf's largest, and within one AdamW step elsewhere)
LM_TRAIN_SMALL = (2, 32)
LM_TRAIN_FULL = (2, 512, 9)
LM_TRAIN_DEFAULT = (8, 256, 4)        # launch.train's default batch x seq
LM_TRAIN_SERVICE_STEPS = 2
LM_TRAIN_SHARE = {"float32": 1e-5, "ssm": 1e-3}
# phase 16: the port's examples (examples/*_torch.py), each at its own
# defaults on the card and (a)-(d) on the CPU; (e) demo-124m at the batch
# the example's docstring gives for an accelerator, its 300 steps cut to
# 5 by the run's time limit (c4's short docs take 2 ingest pulls of 256 a
# step, and the CPU replays every pull at 5-10 s each); (f) zamba2-7b at
# full width at the serving CLI's defaults (batch 4, prompt 32, gen 64).
# The CPU runs go in parallel processes, each given EX_CPU_THREADS
# intra-op threads (the two longest two each) on the host's 8 cores.
EXAMPLES = os.path.join(ROOT, "examples")
EX_DEDUP = ("quickstart", "service_demo", "cluster_demo",
            "distributed_dedup")
EX_TRAIN = (64, 256, 5)               # batch, seq, steps
EX_TRAIN_PULL = 256                   # docs per ingest pull in the example
EX_VOCAB = 32_000                     # the example's model vocab
EX_CPU_THREADS = {"quickstart": 2, "service_demo": 2}   # others 1
EX_SERVE = ["--arch", "zamba2-7b", "--full"]
EX_SERVE_PARAMS = 6_751_078_992
# (f): zamba2 at bf16 is held as the tests hold it (LM_TOL's hybrid rule):
# the decode loop's last-prompt-position logits no further from an
# f32-compute prefill's than the bf16 prefill's are, within 25% (mean and
# largest error)
EX_SERVE_SLACK = 1.25
# At f32 compute the decode loop and the prefill round differently at
# every op, and 81 layers of random weights amplify rounding: the two must
# differ by no more than EX_SERVE_ULP_FACTOR times what flipping the input
# embeddings by one f32 ulp moves the prefill's logits (a wrong cache
# position or state moves them by the logits' own scale)
EX_SERVE_ULP_FACTOR = 10.0
# published H100 SXM peaks (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer ALU ops: a quarter of the 67 TFLOP/s float32 figure
# (64 INT32 lanes per SM per clock instead of 128 FP32 lanes, no FMA pair)
INT32_OPS_PER_S = 67e12 / 4
# population count issues at 16 per SM per clock (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0)
POPC_PER_SM_CLOCK = 16
# dense bf16 tensor-core peak, for phase 14's model-FLOP share
BF16_FLOPS_PER_S = 989.4e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def gpu_name_power() -> str:
    return nvidia_smi("name,power.limit")


def popc_floor_ms(n_popc: float) -> float:
    """Least time for n_popc population counts at the card's SM count and
    maximum SM clock: the floor of any design that counts bits on the
    integer units."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return n_popc / (sms * POPC_PER_SM_CLOCK * mhz * 1e6) * 1e3


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trace_ms(fn, reps: int, kernel: str) -> float:
    """Mean device time of `kernel` per call of `fn`, from the kernel
    events of a torch.profiler trace of `reps` calls: the kernel body
    alone, not the host's cost of issuing it. Fails unless the wrappers
    launched exactly one kernel per call; a trace that recorded fewer
    kernel events than that (the profiler drops events now and then) is
    taken again, and after three incomplete traces the script fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _lib
    for _ in range(3):
        fn()
    os.makedirs(PROFILE_DIR, exist_ok=True)
    tag = kernel.replace("<", "_").replace(">", "")
    path = os.path.join(PROFILE_DIR, f"kernel_{tag}.json")
    attempts = 3
    for attempt in range(attempts):
        torch.cuda.synchronize()
        before = sum(_lib.LAUNCHES.values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launched = sum(_lib.LAUNCHES.values()) - before
        if launched != reps:
            fail(f"{kernel}: {launched} launches for {reps} calls")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        durs = [e["dur"] for e in kernels if kernel in e.get("name", "")]
        if len(durs) == reps:
            return sum(durs) / reps / 1e3
        seen = sorted({e.get("name", "")[:60] for e in kernels})
        log(f"trace {attempt + 1} of {kernel} recorded {len(durs)} kernel "
            f"events for {reps} launches; kernels seen: {seen}")
    fail(f"no complete trace of {kernel} in {attempts} attempts")


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def u32_max_err(a, b) -> int:
    from repro_torch.core.hashing import u32
    return int((u32(a) - u32(b)).abs().max()) if a.numel() else 0


def phase_kernels(dev, corpus_batch) -> tuple[list, dict]:
    """Each kernel vs its plain version; returns per-kernel records."""
    import torch

    from repro_torch.core import bitmap as bm
    from repro_torch.core.hashing import hash_seeds
    from repro_torch.core.shingle import shingle_hashes
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitmap_jaccard import (bitmap_jaccard_matrix,
                                                    hamming_matrix)
    from repro_torch.kernels.minhash import minhash_kernel_signatures

    tokens, lengths = corpus_batch                    # 512 docs, L = 384
    g = torch.Generator(device="cpu").manual_seed(0)

    def rand_words(*shape):
        return torch.randint(-2**31, 2**31, shape, generator=g,
                             dtype=torch.int64).to(torch.int32).to(dev)

    sh = shingle_hashes(torch.from_numpy(tokens.view(np.int32)).to(dev),
                        torch.from_numpy(lengths).to(dev), 5)
    seeds = hash_seeds(112, device=dev)
    B, L = sh.shape
    H = seeds.shape[0]
    recs = []

    # K1 at the main path's shape (B=512, L=384, H=112), and ragged: B off
    # the block count, L over one staged tile, H off the lane layout,
    # padding inside rows, rows with no and with one valid shingle
    out = minhash_kernel_signatures(sh, seeds)
    torch.cuda.synchronize()
    err = u32_max_err(out, ref.minhash_ref(sh, seeds))
    rag = rand_words(7, 1500)
    rag[:, ::3] = -1
    rag[1] = -1
    rag[2] = -1
    rag[2, 700] = 12345
    for r_sh, r_h in ((rag, 31), (rag, 112), (sh[:, 100:300].contiguous(), 1)):
        r_seeds = hash_seeds(r_h, device=dev)
        got = minhash_kernel_signatures(r_sh, r_seeds)
        torch.cuda.synchronize()
        err = max(err, u32_max_err(got, ref.minhash_ref(r_sh, r_seeds)))
    n_valid = int((sh != -1).sum())
    b_ms, b_by = bound(B * L * 4 + H * 4 + B * H * 4, 12 * n_valid * H)
    recs.append(dict(
        name="minhash", route="cuda",
        source="src/repro_torch/kernels/csrc/minhash.cu",
        replaces="src/repro/kernels/minhash.py:47",
        shape=f"B={B} L={L} H={H} (+7x1500 H=31,112; {B}x200 H=1)",
        max_abs_err=err,
        ms=trace_ms(lambda: minhash_kernel_signatures(sh, seeds), 50,
                    "minhash_kernel"),
        call_ms=cuda_ms(lambda: minhash_kernel_signatures(sh, seeds), 50),
        plain_ms=cuda_ms(lambda: ref.minhash_ref(sh, seeds), 5, 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    sigs = out

    bitmaps = bm.pack_bitmaps(sigs, T=4096)
    pcs = bm.popcount(bitmaps)
    Q = N = bitmaps.shape[0]
    W = bitmaps.shape[1]
    # ragged: Q, N off the tile; W off the vector width and over one staged
    # pass; a row view whose base is not 16-byte aligned (big[1:], W = 5)
    ragged = [(rand_words(13, W), rand_words(201, W)),
              (rand_words(33, 129), rand_words(65, 129)),
              (rand_words(31, 5), rand_words(71, 5)[1:])]

    def f32_err(a, b) -> float:
        if a.shape != b.shape:
            return float("inf")
        if torch.equal(a, b) or a.numel() == 0:
            return 0.0
        diff = (a - b).abs()
        return float(torch.nan_to_num(diff, nan=float("inf")).max())

    # K2-K4 are one tiled kernel, bitmap_tile<EPI>, one instantiation each.
    # K3's least work recounts each row's popcount once: (Q + N) W more
    # popcounts and adds beside the cached arm's Q N W.
    cases = [
        ("jaccard_cached", "bitmap_tile<0>",
         "src/repro/kernels/bitmap_jaccard.py:33",
         lambda q, d: bitmap_jaccard_matrix(q, d, ref.popcount(q),
                                            ref.popcount(d), cached=True),
         lambda q, d: ref.bitmap_jaccard_ref(q, d, ref.popcount(q),
                                             ref.popcount(d)),
         lambda: bitmap_jaccard_matrix(bitmaps, bitmaps, pcs, pcs, cached=True),
         lambda: ref.bitmap_jaccard_ref(bitmaps, bitmaps, pcs, pcs),
         (2 * Q * W * 4 + 2 * Q * 4 + Q * N * 4, 3 * Q * N * W + 6 * Q * N),
         Q * N * W),
        ("jaccard_nocache", "bitmap_tile<1>",
         "src/repro/kernels/bitmap_jaccard.py:46",
         lambda q, d: bitmap_jaccard_matrix(q, d, cached=False),
         lambda q, d: ref.bitmap_jaccard_ref(q, d),
         lambda: bitmap_jaccard_matrix(bitmaps, bitmaps, cached=False),
         lambda: ref.bitmap_jaccard_ref(bitmaps, bitmaps),
         (2 * Q * W * 4 + Q * N * 4,
          3 * Q * N * W + 2 * (Q + N) * W + 6 * Q * N),
         Q * N * W + (Q + N) * W),
        ("hamming", "bitmap_tile<2>",
         "src/repro/kernels/bitmap_jaccard.py:60",
         hamming_matrix, ref.hamming_ref,
         lambda: hamming_matrix(bitmaps, bitmaps),
         lambda: ref.hamming_ref(bitmaps, bitmaps),
         (2 * Q * W * 4 + Q * N * 4, 3 * Q * N * W + 2 * Q * N),
         Q * N * W),
    ]
    for (name, symbol, replaces, kern, plain, run_k, run_p, (nbytes, ops),
         n_popc) in cases:
        err = 0.0
        for q, d in [(bitmaps, bitmaps)] + ragged:
            got = kern(q, d)
            torch.cuda.synchronize()
            err = max(err, f32_err(got, plain(q, d)))
            if name == "jaccard_nocache":
                err = max(err, f32_err(got, bitmap_jaccard_matrix(
                    q, d, ref.popcount(q), ref.popcount(d), cached=True)))
        b_ms, b_by = bound(nbytes, ops)
        recs.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/bitmap_jaccard.cu",
            replaces=replaces,
            shape=f"Q={Q} N={N} W={W} (+13x201x{W}, 33x65x129, 31x70x5 view)",
            max_abs_err=err, ms=trace_ms(run_k, 200, symbol),
            call_ms=cuda_ms(run_k, 200), plain_ms=cuda_ms(run_p, 10, 2),
            bound_ms=b_ms, bound_by=b_by, popc_floor_ms=popc_floor_ms(n_popc),
            library_ms=None))
    bad = [r["name"] for r in recs if r["max_abs_err"] != 0]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad} {recs}")
    return recs, {"bitmaps": bitmaps}


def states_equal(a, b) -> list:
    from repro_torch.core.hnsw import state_to_numpy
    na, nb = state_to_numpy(a), state_to_numpy(b)
    return [k for k in na if not np.array_equal(na[k], nb[k])]


def parity_run(tag: str, gpu, cpu, batches) -> dict:
    """The same batches through a card and a cpu pipeline: identical keep
    masks, HNSW states and sig stores. Returns both sides' wall times, the
    card's per-batch t_insert and the admitted count."""
    t_gpu = t_cpu = 0.0
    kept, t_insert = 0, []
    for i, (tok, ln) in enumerate(batches):
        t0 = time.perf_counter()
        kg, st = gpu.process_batch(tok, ln)
        t1 = time.perf_counter()
        kc, _ = cpu.process_batch(tok, ln)
        t2 = time.perf_counter()
        t_gpu += t1 - t0
        t_cpu += t2 - t1
        t_insert.append(st["t_insert"])
        if not np.array_equal(kg, kc):
            fail(f"parity ({tag}): keep masks differ at batch {i}")
        bad = states_equal(gpu.backend.state, cpu.backend.state)
        store = getattr(gpu.backend, "_sig_store", None)
        if store is not None and not np.array_equal(
                store.cpu().numpy(), cpu.backend._sig_store.numpy()):
            bad.append("sig_store")
        if bad:
            fail(f"parity ({tag}): states differ at batch {i}: {bad}")
        kept += int(kg.sum())
    return {"cuda_s": t_gpu, "cpu_s": t_cpu, "t_insert": t_insert,
            "admitted": kept}


def phase_parity(batches, cached: bool, dev):
    """FoldPipeline on the card vs cpu: identical keep masks and states.
    Returns the launches and both pipelines (phase 7 goes on with them)."""
    from repro_torch.core.dedup import FoldConfig, FoldPipeline
    from repro_torch.kernels import _lib
    cfg = FoldConfig(capacity=16384, cached=cached)
    gpu = FoldPipeline(cfg, device=dev)
    cpu = FoldPipeline(cfg, device="cpu")
    _lib.reset_launches()
    r = parity_run(f"cached={cached}", gpu, cpu, batches)
    launches = dict(_lib.LAUNCHES)
    log(f"parity cached={cached}: {len(batches)} batches x "
        f"{len(batches[0][0])} docs at capacity {cfg.capacity}: keep masks "
        f"and states identical on cuda and cpu; admitted {r['admitted']}; "
        f"cuda {r['cuda_s']:.3f} s, cpu {r['cpu_s']:.3f} s; t_insert "
        f"{json.dumps(r['t_insert'])}; launches {launches}")
    return launches, (gpu, cpu)


def phase_pipeline(batches, card: str, dev):
    import torch

    from repro_torch.core.dedup import FoldConfig, FoldPipeline
    from repro_torch.kernels import _lib
    cfg = FoldConfig(capacity=1 << 20)
    torch.cuda.reset_peak_memory_stats()
    pipe = FoldPipeline(cfg, device=dev)
    stats, keeps = [], []
    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tok, ln in batches:
        keep, st = pipe.process_batch(tok, ln)
        if keep.shape != (len(tok),) or st["n_overflow"] != 0:
            fail(f"bad batch result: shape {keep.shape}, stats {st}")
        stats.append(st)
        keeps.append(keep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    if launches["minhash"] == 0 or launches["jaccard_cached"] == 0:
        fail(f"main path did not launch K1 and K2: {launches}")
    n_docs = sum(len(t) for t, _ in batches)
    admitted = stats[-1]["count"]
    if admitted != sum(s["n_insert"] for s in stats):
        fail("index count disagrees with the admitted rows")
    steady = stats[1:]
    med = {k: statistics.median(s[k] for s in steady)
           for k in ("t_signature", "t_in_batch", "t_search", "t_insert")}
    res = dict(batches=len(batches), batch_docs=len(batches[0][0]),
               capacity=cfg.capacity, docs=n_docs, wall_s=wall,
               docs_per_s=n_docs / wall,
               steady_docs_per_s=sum(len(t) for t, _ in batches[1:])
               / sum(sum(s[k] for k in med) for s in steady),
               median_stage_s=med, admitted=admitted,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               card=card)
    log("pipeline " + json.dumps(res))
    log(f"pipeline: admitted {admitted} of {n_docs} docs into a "
        f"{cfg.capacity}-slot index (the doc count is cut by the run's "
        f"time limit, not by the index)")
    # one more batch under torch.profiler, after the timed run
    prof, _ = device_profile(lambda: pipe.process_batch(*batches[-1]),
                             "batch_trace")
    log("profile " + json.dumps(prof))
    res["profile"] = prof
    return res, launches, pipe, np.concatenate(keeps)


def device_profile(fn, name: str) -> tuple[dict, object]:
    """Run fn() once under torch.profiler: its wall time (the profiler's
    own cost included), the device busy time from the trace's kernel,
    memcpy and memset events, the device ops the host enqueued
    (`repro_torch.analysis.analyze.device_op_calls`, the count phase 12
    uses), and the costliest kernels and runtime calls. The trace goes to
    build/profile/<name>.json and is read back. Returns (that record, fn's
    result)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis.analyze import (device_events, device_op_calls,
                                              trace_events)
    os.makedirs(PROFILE_DIR, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = trace_events(prof, os.path.join(PROFILE_DIR, f"{name}.json"))
    dev, runtime = {}, {}
    for e in device_events(events):
        n, t = dev.get(e.get("name", ""), (0, 0.0))
        dev[e.get("name", "")] = (n + 1, t + e.get("dur", 0))
    for e in events:
        if e.get("cat") == "cuda_runtime":
            n, t = runtime.get(e.get("name", ""), (0, 0.0))
            runtime[e.get("name", "")] = (n + 1, t + e.get("dur", 0))
    busy_ms = sum(t for _, t in dev.values()) / 1e3

    def top(d, n):
        rows = sorted(d.items(), key=lambda kv: -kv[1][1])[:n]
        return [{"name": k[:80], "count": c, "ms": t / 1e3} for k, (c, t) in rows]

    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_ops": device_op_calls(events)[1],
            "device_events": sum(c for c, _ in dev.values()),
            "nccl_kernels": sum(c for k, (c, _) in dev.items()
                                if "nccl" in k.lower()),
            "top_device": top(dev, 6), "top_runtime": top(runtime, 4)}, out


def recall_fp(ref_keep: np.ndarray, keep: np.ndarray) -> tuple[float, float]:
    """Recall of the duplicates `ref_keep` drops, and the share of its
    kept docs that `keep` drops (as benchmarks/common.py computes them)."""
    ref_dup = ~ref_keep
    dup = ~keep
    recall = float((dup & ref_dup).sum() / max(ref_dup.sum(), 1))
    fp = float((dup & ~ref_dup).sum() / max((~ref_dup).sum(), 1))
    return recall, fp


def require_launched(tag: str, launches: dict, names) -> None:
    missing = [n for n in names if launches.get(n, 0) <= 0]
    if missing:
        fail(f"{tag}: kernels {missing} were not launched: {launches}")


def phase_reference(pipe_batches, hnsw_keep, par_batches, dev
                    ) -> tuple[dict, np.ndarray]:
    """brute on the card over phase 3's batches: docs/s, and phase 3's
    hnsw keep masks against it; then brute on cuda vs cpu. Returns the
    record and brute's keep masks by tag: at tau 0.7 (phase 10's ground
    truth) and at the matched MinHash tau (phase 11's)."""
    import torch

    from repro_torch.core.dedup import FoldConfig, bitmap_tau
    from repro_torch.index import make_pipeline
    from repro_torch.kernels import _lib
    t_phase = time.perf_counter()
    out, masks = {}, {}
    hnsw_cfg = FoldConfig(capacity=1 << 20)
    # brute at the default tau (0.7, MinHash space: the benchmark
    # protocol) and at the MinHash tau phase 3's bitmap tau stands for
    # (b = m / (2 - m), so m = 2b / (1 + b))
    b = bitmap_tau(hnsw_cfg)
    for tag, tau in (("tau_0.7", 0.7), ("tau_matched", 2 * b / (1 + b))):
        pipe = make_pipeline("brute", FoldConfig(capacity=1 << 20, tau=tau),
                             device=dev)
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keeps = [pipe.process_batch(tok, ln)[0] for tok, ln in pipe_batches]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_lib.LAUNCHES)
        require_launched(f"brute {tag}", launches, ["minhash"])
        keep = np.concatenate(keeps)
        masks[tag] = keep
        rec, fp = recall_fp(keep, hnsw_keep)
        n_docs = len(keep)
        out[tag] = {"tau": tau, "docs": n_docs, "wall_s": wall,
                    "docs_per_s": n_docs / wall, "admitted": int(keep.sum()),
                    "hnsw_admitted": int(hnsw_keep.sum()),
                    "hnsw_recall": rec, "hnsw_fp": fp,
                    "store_mib": pipe.backend.store.numel() * 4 / 2**20,
                    "launches": launches}
        log("reference " + json.dumps(out[tag]))
        del pipe
    # brute on cuda vs cpu: keep masks, neighbor ids and sims bit for bit
    cfg = FoldConfig(capacity=16384)
    gpu = make_pipeline("brute", cfg, device=dev)
    cpu = make_pipeline("brute", cfg, device="cpu")
    for i, (tok, ln) in enumerate(par_batches):
        qg, qc = gpu.query(tok, ln), cpu.query(tok, ln)
        if not (np.array_equal(qg.ids, qc.ids)
                and np.array_equal(qg.sims.view(np.uint32),
                                   qc.sims.view(np.uint32))):
            fail(f"brute cuda vs cpu: ids or sims differ at batch {i}")
        if not np.array_equal(gpu.process_batch(tok, ln)[0],
                              cpu.process_batch(tok, ln)[0]):
            fail(f"brute cuda vs cpu: keep masks differ at batch {i}")
    out["parity_batches"] = len(par_batches)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"reference: brute on cuda equals brute on cpu over "
        f"{len(par_batches)} batches of {len(par_batches[0][0])} (keep "
        f"masks, ids, sims); phase wall {out['phase_s']:.1f} s")
    return out, masks


def phase_options(par_batches, dev) -> dict:
    """FoldPipeline on cuda vs cpu with each option on."""
    from repro_torch.core.dedup import FoldConfig, FoldPipeline
    from repro_torch.kernels import _lib
    t_phase = time.perf_counter()
    (t0, l0), (t1, l1) = par_batches[0], par_batches[1]
    h = len(t0) // 2
    width = max(t0.shape[1], t1.shape[1])

    def pad(t):
        return np.pad(t, ((0, 0), (0, width - t.shape[1])))

    repeat = (np.concatenate([pad(t0)[:h], pad(t1)[h:]]),
              np.concatenate([l0[:h], l1[h:]]))
    arms = [("select_heuristic", {"select_heuristic": True}, par_batches[:3]),
            ("per_doc", {"batched_insert": False}, par_batches[:3]),
            ("verify_minhash", {"verify_minhash": True}, par_batches),
            ("exact_filter", {"exact_filter": True},
             par_batches[:3] + [repeat])]
    out = {}
    for tag, opts, batches in arms:
        cfg = FoldConfig(capacity=16384, **opts)
        gpu = FoldPipeline(cfg, device=dev)
        cpu = FoldPipeline(cfg, device="cpu")
        _lib.reset_launches()
        r = parity_run(tag, gpu, cpu, batches)
        r["launches"] = dict(_lib.LAUNCHES)
        require_launched(tag, r["launches"], ["minhash", "jaccard_cached"])
        if tag == "exact_filter":
            r["exact_hits"] = gpu.exact.hits
            if gpu.exact.hits <= 0 or gpu.exact.hits != cpu.exact.hits:
                fail(f"exact_filter: front door hits {gpu.exact.hits} "
                     f"(cpu {cpu.exact.hits})")
        r["batches"] = len(batches)
        out[tag] = r
        log(f"options {tag}: " + json.dumps(r))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"options: cuda equals cpu for all four arms; phase wall "
        f"{out['phase_s']:.1f} s")
    return out


def phase_lifecycle(pipe, more_batches, parity_pipes, parity_more, dev
                    ) -> dict:
    """Delete, compact, reuse, save and restore on phase 3's index; then
    cuda-vs-cpu parity of delete and compact on phase 2's pipelines."""
    import shutil

    import torch

    from repro_torch.core.dedup import FoldPipeline
    from repro_torch.core.hnsw import needs_repair
    from repro_torch.kernels import _lib
    t_phase = time.perf_counter()
    out = {}
    st = pipe.backend.state
    admitted = np.flatnonzero(st.node_level.cpu().numpy() >= 0)
    kill = admitted[::3]
    count0 = int(st.count)
    n_del = pipe.delete(kill)
    if n_del != len(kill):
        fail(f"lifecycle: deleted {n_del} of {len(kill)}")
    st = pipe.backend.state
    live = (st.node_level >= 0) & ~st.dead
    scored = [int(needs_repair(st, live, lev).numel())
              for lev in range(pipe.hnsw_cfg.max_level + 1)]
    prof, info = device_profile(pipe.compact, "compact_trace")
    out["compact"] = {"tombstones": n_del, "rows_scored_per_level": scored,
                      "reclaimed": info["reclaimed"], "free": info["free"],
                      "capacity": pipe.capacity, "count": count0, **prof}
    log("lifecycle compact " + json.dumps(out["compact"]))
    if info["reclaimed"] != n_del or pipe.dead_fraction != 0.0:
        fail(f"lifecycle: compact reclaimed {info}")
    count_c = int(pipe.backend.state.count)
    freed = np.asarray(pipe.backend._free, np.int64)
    _lib.reset_launches()
    kept = [pipe.process_batch(tok, ln)[1]["n_insert"]
            for tok, ln in more_batches[:4]]
    launches = dict(_lib.LAUNCHES)
    require_launched("lifecycle batches", launches, ["minhash",
                                                     "jaccard_cached"])
    # each insert offers up to B free slots and consumes one per kept row
    # (the rest wait for the next compact); only the overflow takes fresh
    n_free, fresh, expect = len(freed), 0, 0
    for k, (tok, _) in zip(kept, more_batches):
        offered = min(len(tok), n_free)
        fresh += max(0, k - offered)
        expect += min(k, offered)
        n_free -= offered
    st = pipe.backend.state
    reused = int((st.node_level.cpu().numpy()[freed] >= 0).sum())
    if reused == 0 or reused != expect or int(st.count) != count_c + fresh:
        fail(f"lifecycle: freed slots not reused below count (reused "
             f"{reused} of {expect}, count {int(st.count)}, after compact "
             f"{count_c}, fresh {fresh})")
    out["reuse"] = {"freed": len(freed), "admitted": int(sum(kept)),
                    "reused": reused, "count": int(st.count),
                    "count_after_compact": count_c, "launches": launches}
    log("lifecycle reuse " + json.dumps(out["reuse"]))
    ckpt_dir = os.path.join(ROOT, "build", "ckpt_lifecycle")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.save(ckpt_dir, 1)
    t_save = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(ckpt_dir, "step_00000001",
                                          "arrays.msgpack"))
    fresh = FoldPipeline(pipe.cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.restore(ckpt_dir)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    bad = states_equal(fresh.state, pipe.state)
    if bad:
        fail(f"lifecycle: restored state differs: {bad}")
    tok, ln = more_batches[4]
    if not np.array_equal(fresh.process_batch(tok, ln)[0],
                          pipe.process_batch(tok, ln)[0]):
        fail("lifecycle: restored pipeline gives other verdicts")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    out["checkpoint"] = {"bytes": nbytes, "save_ms": t_save * 1e3,
                         "restore_ms": t_restore * 1e3}
    log("lifecycle checkpoint " + json.dumps(out["checkpoint"]))
    del fresh
    # cuda vs cpu: delete, compact, and inserts into the freed slots
    gpu, cpu = parity_pipes
    live_ids = np.flatnonzero(cpu.state.node_level.numpy() >= 0)[::3]
    if gpu.delete(live_ids) != cpu.delete(live_ids):
        fail("lifecycle parity: delete counts differ")
    cg, cc = gpu.compact(), cpu.compact()
    if cg["reclaimed"] != cc["reclaimed"] or cg["free"] != cc["free"]:
        fail(f"lifecycle parity: compact differs: {cg} {cc}")
    bad = states_equal(gpu.state, cpu.state)
    if bad:
        fail(f"lifecycle parity: states differ after compact: {bad}")
    r = parity_run("lifecycle", gpu, cpu, parity_more)
    out["parity"] = {"deleted": len(live_ids), "reclaimed": cg["reclaimed"],
                     "batches_after": len(parity_more), **r}
    out["phase_s"] = time.perf_counter() - t_phase
    log("lifecycle parity " + json.dumps(out["parity"]))
    log(f"lifecycle: phase wall {out['phase_s']:.1f} s")
    return out

def ragged_chunks(corpus, n_docs: int, seed: int, hi: int = 300) -> list:
    """n_docs corpus docs as submit-sized chunks of 1-hi docs (seeded
    sizes): the traffic of clients sending ragged requests."""
    rng = np.random.default_rng(seed)
    out, left = [], n_docs
    while left:
        n = min(left, int(rng.integers(1, hi + 1)))
        out.append(corpus.next_batch(n)[:2])
        left -= n
    return out


def verdict_tuples(verdicts) -> list:
    return [(v.doc_id, v.admitted, v.reason, v.neighbor_id,
             int(np.float32(v.similarity).view(np.uint32))) for v in verdicts]


def replay_micro_batches(ref, emitted, verdicts) -> tuple:
    """The valid rows of a service's emitted micro-batches through
    ref.process_batch, in emission order. Returns (the loop's keep mask,
    the service's verdicts in the same doc order); padding rows trail
    every micro-batch and are never admitted, so the two must be equal."""
    keep_ref = np.concatenate([
        ref.process_batch(mb.tokens[:mb.n_docs], mb.lengths[:mb.n_docs])[0]
        for mb in emitted])
    order = np.concatenate([mb.doc_ids[:mb.n_docs] for mb in emitted])
    return keep_ref, np.asarray([v.admitted for v in verdicts])[order]


def run_service(svc, chunks) -> tuple[list, float]:
    """Submit every chunk, flush, and collect the verdicts; returns them
    and the wall seconds of submit + flush (the card synchronised)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets = [svc.submit(tok, ln) for tok, ln in chunks]
    svc.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [v for t in tickets for v in svc.results(t)], wall


def phase_service(chunks, fresh, depth_chunks, rot_chunks, card: str,
                  dev) -> dict:
    """DedupService at its defaults on the card: docs/s, its own latency
    histograms, verdicts against a process_batch loop over the emitted
    micro-batches, one profiled micro-batch (`fresh`: the stream's next
    max_batch docs), depth 0 against depth 2, and a growth + rotation arm
    on cuda and on cpu."""
    import shutil

    import torch

    from repro_torch.core.dedup import FoldConfig, FoldPipeline
    from repro_torch.kernels import _lib
    from repro_torch.service import DedupService, ServiceConfig
    t_phase = time.perf_counter()
    out = {"card": card}
    cfg = ServiceConfig(fold=FoldConfig(capacity=SERVING_CAPACITY))
    svc = DedupService(cfg)
    if svc.pipeline.device.type != torch.device(dev).type:
        fail(f"service: DedupService() built on {svc.pipeline.device}")
    emitted = []
    svc.outcome_hooks.append(lambda o: emitted.append(o.batch))
    _lib.reset_launches()
    verdicts, wall = run_service(svc, chunks)
    launches = dict(_lib.LAUNCHES)
    require_launched("service", launches, ["minhash", "jaccard_cached"])
    n_docs = sum(len(t) for t, _ in chunks)
    if [v.doc_id for v in verdicts] != list(range(n_docs)):
        fail("service: verdicts do not cover the submitted doc ids")
    st = svc.stats()
    lat = st["latency_ms"]
    out["main"] = {
        "docs": n_docs, "submits": len(chunks), "wall_s": wall,
        "docs_per_s": n_docs / wall, "micro_batches": len(emitted),
        "shapes": st["batching"]["compiled_shapes"],
        "admitted": st["counters"]["admitted"],
        "batch_dup": st["counters"].get("batch_dup", 0),
        "index_dup": st["counters"].get("index_dup", 0),
        "batch_ms": {k: lat["batch_ms"][k] for k in ("n", "p50", "p99",
                                                     "max")},
        "stage_ms_p50": {k: (lat[k]["p50"], lat[k]["n"]) for k in (
            "t_in_batch_ms", "t_search_ms", "t_insert_ms") if k in lat},
        "launches": launches}
    log("service " + json.dumps(out["main"]))
    # the same micro-batches, valid rows only, through process_batch on a
    # second card pipeline: the verdicts and the index must be equal
    ref = FoldPipeline(FoldConfig(capacity=SERVING_CAPACITY), device=dev)
    keep_ref, keep_svc = replay_micro_batches(ref, emitted, verdicts)
    if not np.array_equal(keep_ref, keep_svc):
        fail(f"service: verdicts differ from the process_batch loop at "
             f"{int((keep_ref != keep_svc).sum())} docs")
    bad = states_equal(ref.backend.state, svc.pipeline.backend.state)
    if bad:
        fail(f"service: index differs from the process_batch loop: {bad}")
    log(f"service: {n_docs} verdicts equal a process_batch loop over the "
        f"same {len(emitted)} micro-batches (index state equal too); {card}")
    del ref
    prof, _ = device_profile(lambda: (svc.submit(*fresh), svc.flush()),
                             "service_batch_trace")
    prof["admitted"] = svc.stats()["counters"]["admitted"] - \
        out["main"]["admitted"]
    out["profile"] = prof
    log("service profile " + json.dumps(prof))
    del svc
    # pipeline depth 0 against 2: fresh services, alternating turns
    turns = []
    for depth in (0, 2, 0, 2):
        s = DedupService(dataclasses.replace(cfg, pipeline_depth=depth))
        _, w = run_service(s, depth_chunks)
        turns.append({"depth": depth, "wall_s": w,
                      "docs_per_s": sum(len(t) for t, _ in depth_chunks) / w})
        del s
    out["depth"] = turns
    log("service depth " + json.dumps(turns) + f"; {card}")
    # growth + snapshot rotation on cuda and on cpu: the same verdicts,
    # grow events and committed steps (and snapshot bytes)
    arms = {}
    for d in (dev, "cpu"):
        snap = os.path.join(ROOT, "build", f"service_rotation_{d}")
        shutil.rmtree(snap, ignore_errors=True)
        s = DedupService(ServiceConfig(fold=FoldConfig(capacity=512),
                                       snapshot_dir=snap, snapshot_every=4,
                                       device=str(d)))
        v, w = run_service(s, rot_chunks)
        arms[str(d)] = {"verdicts": verdict_tuples(v), "wall_s": w,
                        "grow_events": s.index_manager.grow_events,
                        "capacity": s.pipeline.capacity,
                        "steps": s.index_manager.committed_steps(),
                        "snapshots": s.index_manager.snapshots_taken,
                        "dir": snap}
    a, b = arms[str(dev)], arms["cpu"]
    for key in ("verdicts", "grow_events", "capacity", "steps", "snapshots"):
        if a[key] != b[key]:
            fail(f"service rotation: {key} differs on cuda and cpu")
    if a["grow_events"] < 1 or not a["steps"]:
        fail(f"service rotation: no growth or no snapshot ({a['grow_events']}, "
             f"{a['steps']})")
    for step in a["steps"]:
        name = os.path.join(f"step_{step:08d}", "arrays.msgpack")
        with open(os.path.join(a["dir"], name), "rb") as f1, \
                open(os.path.join(b["dir"], name), "rb") as f2:
            if f1.read() != f2.read():
                fail(f"service rotation: snapshot {step} bytes differ")
    for arm in arms.values():
        shutil.rmtree(arm["dir"], ignore_errors=True)
    out["rotation"] = {"docs": len(a["verdicts"]), "admitted": sum(
        v[1] for v in a["verdicts"]), "grow_events": a["grow_events"],
        "capacity": a["capacity"], "steps": a["steps"],
        "cuda_wall_s": a["wall_s"], "cpu_wall_s": b["wall_s"]}
    log("service rotation " + json.dumps(out["rotation"]) + "; cuda equals "
        "cpu (verdicts, grow events, committed steps, snapshot bytes)")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"service: phase wall {out['phase_s']:.1f} s")
    return out


class StepClock:
    """The tenants' clock: moves only when the request loop advances it
    (no sleeping for a retry-after, and the same rejections in every
    run)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def phase_cluster(chunks, probe, card: str, dev) -> dict:
    """One ClusterWriter at 2**20 with two card replicas and two tenants:
    after every publish each refreshed replica answers a probe batch as the
    writer's own pipeline does at that step; publish and refresh times."""
    import shutil

    import torch

    from repro_torch.cluster import (Backpressure, ClusterConfig,
                                     ClusterWriter, ReadReplica, TenantSpec)
    from repro_torch.core.dedup import FoldConfig
    from repro_torch.kernels import _lib
    from repro_torch.service import ServiceConfig
    t_phase = time.perf_counter()
    snap = os.path.join(ROOT, "build", "cluster_snapshots")
    shutil.rmtree(snap, ignore_errors=True)
    scfg = ServiceConfig(fold=FoldConfig(capacity=SERVING_CAPACITY),
                         snapshot_dir=snap)
    clock = StepClock()
    tenants = (TenantSpec("quota", qps=500.0, burst=300),
               TenantSpec("budget", max_live_docs=500))
    w = ClusterWriter(ClusterConfig(service=scfg, publish_every=16,
                                    tenants=tenants), clock=clock)
    replicas = [ReadReplica(scfg, replica_id=i) for i in range(2)]
    publish_ms, refresh_ms, checks = [], [], []
    publish = w.publish

    def timed_publish(flush: bool = True) -> int:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch = publish(flush=flush)
        publish_ms.append((time.perf_counter() - t0) * 1e3)
        return epoch

    def check_epoch(_out) -> None:
        # runs after the writer's own hook: a publish just happened iff the
        # epoch moved; the writer's state is then exactly the snapshot's
        if w.epoch == (checks[-1]["epoch"] if checks else 0):
            return
        lag = [w.epoch - r.epoch for r in replicas]
        for r in replicas:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if not r.refresh():
                fail(f"cluster: replica {r.replica_id} did not take epoch "
                     f"{w.epoch}")
            torch.cuda.synchronize()
            refresh_ms.append((time.perf_counter() - t0) * 1e3)
        want = w.query(*probe)
        for r in replicas:
            got = r.query(*probe)
            if not (np.array_equal(got.is_dup, want.is_dup)
                    and np.array_equal(got.ids, want.ids)
                    and np.array_equal(got.sims.view(np.uint32),
                                       want.sims.view(np.uint32))):
                fail(f"cluster: replica {r.replica_id} differs from the "
                     f"writer at epoch {w.epoch}")
        checks.append({"epoch": w.epoch, "count": w.service.pipeline.inserted,
                       "probe_dups": int(want.is_dup.sum()),
                       "epochs_behind_before": lag,
                       "epochs_behind_after": [r.epochs_behind
                                               for r in replicas]})

    w.publish = timed_publish
    w.service.outcome_hooks.append(check_epoch)
    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    retries = 0
    for i, (tok, ln) in enumerate(chunks):
        tenant = ("quota", "budget")[i % 2]
        clock.t += 0.1
        while True:
            try:
                w.submit(tok, ln, tenant=tenant)
                break
            except Backpressure as e:
                if e.reason != "qps_quota":
                    raise
                retries += 1
                # a client waits the hint, and at least a millisecond: a
                # hint below the clock's resolution would not move it
                clock.t += max(e.retry_after_s, 1e-3)
    w.flush()
    w.publish()                 # the tail after the last auto-publish
    check_epoch(None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    require_launched("cluster", launches, ["minhash", "jaccard_cached"])
    ten = w.stats()["cluster"]["tenants"]
    pipe = w.service.pipeline
    if ten["quota"]["rejected_qps"] <= 0 or retries <= 0:
        fail(f"cluster: the QPS quota never bit: {ten['quota']}")
    evicted = ten["budget"]["evicted"]
    if (evicted <= 0 or pipe.deleted != evicted
            or pipe.device.type != torch.device(dev).type
            or ten["budget"]["live_docs"] > 500):
        fail(f"cluster: budget evictions did not go through delete on the "
             f"card: {ten['budget']}, deleted {pipe.deleted} on "
             f"{pipe.device}")
    if len(checks) != w.epoch or w.epoch < 2:
        fail(f"cluster: {len(checks)} checked epochs of {w.epoch}")
    n_docs = sum(len(t) for t, _ in chunks)
    step_dir = os.path.join(snap, f"step_{w.service.index_manager.last_step:08d}")
    out = {"docs": n_docs, "wall_s": wall, "docs_per_s": n_docs / wall,
           "epochs": w.epoch, "publish_ms": publish_ms,
           "refresh_ms": refresh_ms,
           "snapshot_bytes": os.path.getsize(os.path.join(step_dir,
                                                          "arrays.msgpack")),
           "checks": checks, "tenants": ten, "qps_retries": retries,
           "launches": launches, "card": card}
    shutil.rmtree(snap, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log("cluster " + json.dumps(out))
    log(f"cluster: {len(replicas)} replicas equal the writer at each of "
        f"{w.epoch} epochs; phase wall {out['phase_s']:.1f} s; {card}")
    return out


def baseline_parity(tag, key, opts, par_batches, par_more, dev) -> dict:
    """One phase-10 configuration on cuda and on cpu over phase 2's
    batches at 16,384 slots: keep masks, step-② survivors, search ids and
    sims bit for bit, and the full HNSWState for hnsw_raw; flat_lsh then
    deletes every third admitted row on both sides and runs two more
    batches."""
    from repro_torch.core.dedup import FoldConfig
    from repro_torch.index import make_pipeline
    from repro_torch.index.pipeline import host
    cfg = FoldConfig(capacity=16384)
    gpu = make_pipeline(key, cfg, device=dev, **opts)
    cpu = make_pipeline(key, cfg, device="cpu", **opts)
    gpu.backend.track_slots = cpu.backend.track_slots = True
    wall = {"cuda_s": 0.0, "cpu_s": 0.0}

    def run(batches, label):
        for i, (tok, ln) in enumerate(batches):
            res = []
            for side, pipe in (("cuda_s", gpu), ("cpu_s", cpu)):
                t0 = time.perf_counter()
                r = pipe.dedup_step(pipe.signatures(tok, ln))
                res.append([host(x) for x in r])
                wall[side] += time.perf_counter() - t0
            (kg, bg, ig, sg), (kc, bc, ic, sc) = res
            if not (np.array_equal(kg, kc) and np.array_equal(bg, bc)
                    and np.array_equal(ig, ic)
                    and np.array_equal(sg.view(np.uint32),
                                       sc.view(np.uint32))):
                fail(f"baselines parity ({tag}): cuda and cpu differ at "
                     f"{label} batch {i}")
            if key == "hnsw_raw":
                bad = states_equal(gpu.backend.state, cpu.backend.state)
                if bad:
                    fail(f"baselines parity ({tag}): states differ at "
                         f"{label} batch {i}: {bad}")

    run(par_batches, "first")
    out = {"batches": len(par_batches), "deleted": 0}
    if key == "flat_lsh":
        slots = [np.concatenate(p.backend.pop_slot_log()) for p in (gpu, cpu)]
        kill = slots[0][::3]
        n_del = [gpu.delete(kill), cpu.delete(kill)]
        if not np.array_equal(*slots) or n_del != [len(kill)] * 2:
            fail(f"baselines parity ({tag}): slots or deletes differ")
        run(par_more, "after delete")
        out.update(deleted=len(kill), batches_after=len(par_more))
    out.update(wall, admitted=gpu.inserted)
    if gpu.inserted != cpu.inserted:
        fail(f"baselines parity ({tag}): admitted counts differ")
    return out


def phase_baselines(pipe_batches, brute_keep, par_batches, par_more, card,
                    dev) -> dict:
    """Table 1 on the card: each configuration of BASELINES over its prefix
    of phase 3's batches at 2**20 slots (docs/s, stage medians, recall and
    FP against brute's tau-0.7 masks, whose prefix is brute's verdict on
    that prefix since brute is online), its launches (K1 on every path but
    prefix_filter, which must launch none), then cuda against cpu."""
    import torch

    from repro_torch.core.dedup import FoldConfig
    from repro_torch.index import make_pipeline
    from repro_torch.kernels import _lib
    t_phase = time.perf_counter()
    out = {"runs": {}, "parity": {}, "card": card}
    for tag, key, opts, n_batches in BASELINES:
        batches = pipe_batches[:n_batches]
        torch.cuda.reset_peak_memory_stats()
        pipe = make_pipeline(key, FoldConfig(capacity=1 << 20, tau=0.7),
                             device=dev, **opts)
        stats, keeps = [], []
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for tok, ln in batches:
            keep, st = pipe.process_batch(tok, ln)
            if keep.shape != (len(tok),) or st["n_overflow"] != 0:
                fail(f"baselines {tag}: bad batch result {keep.shape} {st}")
            stats.append(st)
            keeps.append(keep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_lib.LAUNCHES)
        if key == "prefix_filter":
            if launches["minhash"] != 0:
                fail(f"baselines {tag}: the shingles-only path launched "
                     f"K1: {launches}")
        else:
            require_launched(f"baselines {tag}", launches, ["minhash"])
        keep = np.concatenate(keeps)
        n_docs = len(keep)
        if stats[-1]["count"] != int(keep.sum()):
            fail(f"baselines {tag}: index count disagrees with the verdicts")
        rec, fp = recall_fp(brute_keep[:n_docs], keep)
        steady = stats[1:] or stats      # the first batch pays set-up
        med = {k: statistics.median(s[k] for s in steady)
               for k in ("t_signature", "t_in_batch", "t_search",
                         "t_insert")}
        out["runs"][tag] = dict(
            key=key, opts=opts, batches=n_batches,
            cut=f"first {n_batches} of phase 3's {len(pipe_batches)} batches",
            docs=n_docs, wall_s=wall, docs_per_s=n_docs / wall,
            median_stage_s=med, admitted=int(keep.sum()),
            brute_admitted=int(brute_keep[:n_docs].sum()), recall=rec, fp=fp,
            launches=launches,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"baselines {tag} " + json.dumps(out["runs"][tag]))
        del pipe
        out["parity"][tag] = baseline_parity(tag, key, opts, par_batches,
                                             par_more, dev)
        log(f"baselines {tag} parity: cuda equals cpu " +
            json.dumps(out["parity"][tag]))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"baselines: {len(BASELINES)} configurations, recall and FP against "
        f"brute, cuda equals cpu for each; phase wall {out['phase_s']:.1f} s; "
        f"{card}")
    return out


def sharded_states_equal(a, b) -> list:
    """(shard, field) pairs where two lists of per-shard states differ,
    compared where the tensors live (no host copy of a 2**18-slot
    shard)."""
    import torch
    bad = []
    for s, (x, y) in enumerate(zip(a, b)):
        for f in x._fields:
            u, v = getattr(x, f), getattr(y, f)
            if not torch.equal(u, v.to(u.device)):
                bad.append((s, f))
    return bad


def _leaves_equal(a, b) -> bool:
    import torch

    from repro_torch.analysis.analyze import tensor_leaves
    x, y = tensor_leaves(a), tensor_leaves(b)
    return len(x) == len(y) and all(
        u.shape == v.shape and u.dtype == v.dtype
        and torch.equal(u.cpu(), v.cpu()) for u, v in zip(x, y))


def phase_programs(main_state, replay_batch, fresh_batch, batch_profile,
                   card: str, dev) -> dict:
    """(a) every program spec on the card and on the CPU; (b) the main
    path's programs at production geometry on `main_state`, a copy of
    phase 3's final state (see the module docstring)."""
    import torch

    from repro_torch.analysis import (analyze_family, analyze_program,
                                      default_specs, measure_run,
                                      spec_families)
    from repro_torch.core.dedup import (FoldConfig, FoldPipeline, bitmap_tau,
                                        in_batch_dedup)
    from repro_torch.core.hnsw import (hnsw_insert_batch, hnsw_search,
                                       sample_levels)
    from repro_torch.kernels import _lib
    from repro_torch.service.batcher import default_batch_buckets
    t_phase = time.perf_counter()
    out = {"card": card, "specs": {}, "main": {}}

    # (a) every spec, cuda and cpu in one process
    specs = default_specs()
    reports = {}
    _lib.reset_launches()
    for spec in specs:
        cpu = analyze_program(spec, "cpu")
        gpu = analyze_program(spec, dev)
        if gpu.measure.launches is None:
            # the trace held no launch call (see analyze.py's docstring):
            # once more on fresh inputs, and a second loss fails the phase
            log(f"programs {spec.name}: the trace held no launch call; "
                f"running it again")
            gpu = analyze_program(spec, dev)
            if gpu.measure.launches is None:
                fail(f"programs: {spec.name}'s launches not measured twice")
        reports[spec.name] = gpu
        fc, fg = cpu.fingerprint, gpu.fingerprint
        for key in ("in_avals", "out_avals", "aliased", "f64",
                    "data_dependent_ops"):
            if fc[key] != fg[key]:
                fail(f"programs: {spec.name} {key} differs, cuda "
                     f"{fg[key]} vs cpu {fc[key]}")
        for key in ("argument_bytes", "output_bytes"):
            if fc["memory"][key] != fg["memory"][key]:
                fail(f"programs: {spec.name} {key} differs, cuda "
                     f"{fg['memory'][key]} vs cpu {fc['memory'][key]}")
        if not _leaves_equal(gpu.measure.outputs, cpu.measure.outputs):
            fail(f"programs: {spec.name} outputs differ between cuda and cpu")
        if gpu.violations:
            fail("programs: violations on the card: " + "; ".join(
                v.render() for v in gpu.violations))
        m = gpu.measure
        if not m.temp_bytes:
            # every spec allocates on the card: a peak that did not move
            # is a lost reading, not a program without temporaries
            fail(f"programs: {spec.name}'s temp bytes read 0")
        row = dict(card_syncs=m.syncs,
                   data_dependent_ops=m.data_dependent,
                   budget_card_syncs=spec.budget.card_syncs,
                   budget_host_syncs=spec.budget.host_syncs,
                   launches=m.launches, device_ops=m.device_ops,
                   temp_bytes=m.temp_bytes,
                   budget_temp_bytes=spec.budget.temp_bytes,
                   gather=fg["gather"], scatter=fg["scatter"],
                   aliased=fg["aliased"], alias_expect=spec.alias_expect,
                   argument_bytes=fg["memory"]["argument_bytes"],
                   output_bytes=fg["memory"]["output_bytes"],
                   ops_cuda=sum(fg["ops"].values()),
                   ops_cpu=sum(fc["ops"].values()),
                   wall_ms=m.wall_ms, cpu_wall_ms=cpu.measure.wall_ms)
        out["specs"][spec.name] = row
        log(f"programs {spec.name} " + json.dumps(row))
    for fam, fspecs in spec_families(specs).items():
        bad = analyze_family(fam, fspecs, reports)
        if bad:
            fail("programs: " + "; ".join(v.render() for v in bad))
    out["launches"] = dict(_lib.LAUNCHES)
    if any(out["launches"].values()):
        fail(f"programs: the analyzed programs launched a kernel: "
             f"{out['launches']}")
    log(f"programs: {len(specs)} specs equal on cuda and cpu (interface, "
        f"bytes, aliasing, f64, data-dependent ops, outputs), no violation "
        f"on the card, K1-K4 not launched")

    # (b) production geometry: phase 3's state. First phase 3's last batch
    # again (what its profiled batch ran: every doc is in the index, so
    # nothing is admitted), then a fresh batch, each through steps ③ and ⑤
    # as the pipeline calls them, then the service buckets
    cfg = FoldConfig(capacity=1 << 20)
    hcfg = cfg.hnsw()
    tau = bitmap_tau(cfg)
    sigs = FoldPipeline(FoldConfig(capacity=PROGRAM_BATCH), device=dev)

    def record(tag, fn, *args, **kwargs):
        m = measure_run(fn, *args, device=dev, **kwargs)
        if m.launches is None or not m.temp_bytes:
            fail(f"programs: {tag} not measured: launches {m.launches}, "
                 f"temp bytes {m.temp_bytes}")
        row = dict(card_syncs=m.syncs, data_dependent_ops=m.data_dependent,
                   launches=m.launches, device_ops=m.device_ops,
                   temp_bytes=m.temp_bytes, wall_ms=m.wall_ms,
                   gather=m.count(("gather", "index", "index_select",
                                   "take")))
        out["main"][tag] = row
        log(f"programs main {tag} " + json.dumps(row))
        return m.outputs

    for i, (tag, batch) in enumerate((("replay", replay_batch),
                                      ("fresh", fresh_batch))):
        sig = sigs.signatures(*batch)
        ids, sims = record(f"{tag}/search", hnsw_search, hcfg, main_state,
                           sig.bitmaps, k=cfg.k)
        keep = in_batch_dedup(sig.bitmaps, sig.pcs, tau) & \
            ~(sims >= tau).any(-1)
        levels = torch.from_numpy(sample_levels(
            PROGRAM_BATCH, hcfg, seed=PIPE_BATCHES + i + cfg.seed + 1))
        main_state, n = record(f"{tag}/insert", hnsw_insert_batch, hcfg,
                               main_state, sig.bitmaps, sig.pcs,
                               levels.to(dev), keep,
                               seed_ids=ids.to(torch.int32), free_slots=None)
        out[f"{tag}_admitted"] = int(n)
    for B in default_batch_buckets(128):
        record(f"service/search_b{B:03d}", hnsw_search, hcfg, main_state,
               sig.bitmaps[:B], k=cfg.k)
    both = sum(out["main"][k]["device_ops"]
               for k in ("replay/search", "replay/insert"))
    out["replay_vs_batch"] = dict(
        search_insert_device_ops=both,
        batch_device_ops=batch_profile["device_ops"],
        rest=batch_profile["device_ops"] - both)
    log("programs replay_vs_batch " + json.dumps(out["replay_vs_batch"]))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"programs: phase wall {out['phase_s']:.1f} s; {card}")
    return out


def phase_sharded(pipe_batches, hnsw_keep, brute_matched, par_batches,
                  svc_chunks, card, dev) -> dict:
    """hnsw_sharded on the card: the main run at 4 x 2**18 slots over
    phase 3's first SHARDED_BATCHES batches (docs/s, t_fused_step, a
    profiled batch, recall and FP against brute at the matched tau beside
    phase 3's hnsw, K1 once per batch and K2-K4 never), shards=1 against
    phase 3's masks, cuda against cpu, the lifecycle and shard-layout
    rules on the main run's index, and the service at shards=4."""
    import shutil

    import torch

    from repro_torch.core.dedup import FoldConfig
    from repro_torch.index import make_pipeline
    from repro_torch.kernels import _lib
    from repro_torch.service import DedupService, ServiceConfig
    t_phase = time.perf_counter()
    out = {"card": card}
    batches = pipe_batches[:SHARDED_BATCHES]
    cfg = FoldConfig(capacity=SHARD_CAPACITY)
    torch.cuda.reset_peak_memory_stats()
    pipe = make_pipeline("hnsw_sharded", cfg, shards=SHARDS, device=dev)
    stats, keeps = [], []
    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tok, ln in batches:
        keep, st = pipe.process_batch(tok, ln)
        if keep.shape != (len(tok),) or st["n_overflow"] != 0:
            fail(f"sharded: bad batch result {keep.shape} {st}")
        stats.append(st)
        keeps.append(keep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    if launches.get("minhash", 0) != len(batches):
        fail(f"sharded: K1 launched {launches.get('minhash', 0)} times in "
             f"{len(batches)} batches: {launches}")
    if any(launches.get(k, 0) for k in ("jaccard_cached", "jaccard_nocache",
                                        "hamming")):
        fail(f"sharded: a bitmap kernel ran on the fused step: {launches}")
    keep = np.concatenate(keeps)
    n_docs = len(keep)
    counts = [int(st.count) for st in pipe.backend.states]
    if sum(counts) != int(keep.sum()) or stats[-1]["count"] != sum(counts):
        fail(f"sharded: shard counts {counts} disagree with {int(keep.sum())} "
             f"admitted")
    rec, fp = recall_fp(brute_matched[:n_docs], keep)
    h_rec, h_fp = recall_fp(brute_matched[:n_docs], hnsw_keep[:n_docs])
    steady = stats[1:]
    out["main"] = dict(
        shards=SHARDS, shard_capacity=SHARD_CAPACITY,
        capacity=pipe.capacity, batches=len(batches),
        batch_docs=len(batches[0][0]),
        cut=f"first {len(batches)} of phase 3's {len(pipe_batches)} batches",
        docs=n_docs, wall_s=wall, docs_per_s=n_docs / wall,
        median_t_fused_step_s=statistics.median(s["t_fused_step"]
                                                for s in steady),
        median_t_signature_s=statistics.median(s["t_signature"]
                                               for s in steady),
        admitted=int(keep.sum()), shard_counts=counts,
        brute_matched_admitted=int(brute_matched[:n_docs].sum()),
        recall=rec, fp=fp, hnsw_recall=h_rec, hnsw_fp=h_fp,
        agree_with_hnsw=float((keep == hnsw_keep[:n_docs]).mean()),
        launches=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("sharded " + json.dumps(out["main"]))
    nxt = pipe_batches[SHARDED_BATCHES]
    prof, _ = device_profile(lambda: pipe.process_batch(*nxt),
                             "sharded_batch_trace")
    out["profile"] = prof
    log("sharded profile " + json.dumps(prof))

    # shards=1 at 2**20: the fused step is the single-graph algorithm
    one = make_pipeline("hnsw_sharded", FoldConfig(capacity=1 << 20),
                        shards=1, device=dev)
    n1 = SHARDED_ONE_BATCHES
    keep1 = np.concatenate([one.process_batch(tok, ln)[0]
                            for tok, ln in pipe_batches[:n1]])
    if not np.array_equal(keep1, hnsw_keep[:len(keep1)]):
        fail(f"sharded: shards=1 differs from phase 3 at "
             f"{int((keep1 != hnsw_keep[:len(keep1)]).sum())} docs")
    out["one_shard"] = {"batches": n1, "docs": len(keep1),
                        "equal_to_phase3": True}
    log(f"sharded: shards=1 at 2**20 equals phase 3's masks over its first "
        f"{n1} batches ({len(keep1)} docs)")
    del one

    # cuda against cpu at 4 x SHARDED_PARITY_CAPACITY
    pcfg = FoldConfig(capacity=SHARDED_PARITY_CAPACITY)
    sides = [make_pipeline("hnsw_sharded", pcfg, shards=SHARDS, device=d)
             for d in (dev, "cpu")]
    t_side = [0.0, 0.0]
    for i, (tok, ln) in enumerate(par_batches):
        ks = []
        for j, p in enumerate(sides):
            t0 = time.perf_counter()
            ks.append(p.process_batch(tok, ln)[0])
            t_side[j] += time.perf_counter() - t0
        if not np.array_equal(*ks):
            fail(f"sharded parity: keep masks differ at batch {i}")
        bad = sharded_states_equal(sides[0].backend.states,
                                   sides[1].backend.states)
        if bad:
            fail(f"sharded parity: states differ at batch {i}: {bad}")
    out["parity"] = {"batches": len(par_batches),
                     "batch_docs": len(par_batches[0][0]),
                     "shard_capacity": SHARDED_PARITY_CAPACITY,
                     "admitted": sides[1].inserted, "cuda_s": t_side[0],
                     "cpu_s": t_side[1]}
    log("sharded parity: cuda equals cpu (keep masks, every per-shard "
        "state) " + json.dumps(out["parity"]))
    del sides

    # lifecycle on the main run's index: delete a third of the admitted
    # global ids, compact, reuse, save, restore at 4, 8 and 2 shards
    be = pipe.backend
    live = np.concatenate([
        np.flatnonzero(st.node_level.cpu().numpy() >= 0) * SHARDS + s
        for s, st in enumerate(be.states)])
    kill = np.sort(live)[::3]
    n_del = pipe.delete(kill)
    if n_del != len(kill):
        fail(f"sharded lifecycle: deleted {n_del} of {len(kill)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = pipe.compact()
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t0
    if info["reclaimed"] != n_del or pipe.dead_fraction != 0.0:
        fail(f"sharded lifecycle: compact gave {info} for {n_del} deletes")
    freed = [list(f) for f in be._free]
    count_c = sum(int(st.count) for st in be.states)
    more = pipe_batches[SHARDED_BATCHES + 1:SHARDED_BATCHES + 3]
    kept = sum(int(pipe.process_batch(tok, ln)[0].sum()) for tok, ln in more)
    reused = sum(int((st.node_level[torch.tensor(f, dtype=torch.long,
                                                 device=st.count.device)]
                      >= 0).sum()) if f else 0
                 for st, f in zip(be.states, freed))
    count_r = sum(int(st.count) for st in be.states)
    if reused == 0 or count_r - count_c != kept - reused:
        fail(f"sharded lifecycle: freed slots not reused (reused {reused}, "
             f"admitted {kept}, count {count_c} -> {count_r})")
    ckpt_dir = os.path.join(ROOT, "build", "ckpt_sharded")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.save(ckpt_dir, 1)
    t_save = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(ckpt_dir, "step_00000001",
                                          "arrays.msgpack"))
    back = make_pipeline("hnsw_sharded", cfg, shards=SHARDS, device=dev)
    t0 = time.perf_counter()
    back.restore(ckpt_dir)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    bad = sharded_states_equal(back.backend.states, be.states)
    if bad:
        fail(f"sharded lifecycle: restore at {SHARDS} differs: {bad}")
    del back
    wide = make_pipeline("hnsw_sharded", cfg, shards=2 * SHARDS, device=dev)
    wide.restore(ckpt_dir)
    bad = sharded_states_equal(wide.backend.states[:SHARDS], be.states)
    empty = all(int(st.count) == 0 and int((st.node_level >= 0).sum()) == 0
                for st in wide.backend.states[SHARDS:])
    if bad or not empty:
        fail(f"sharded lifecycle: scale-out restore: {bad}, empty {empty}")
    n0 = wide.inserted
    wkeep = wide.process_batch(*pipe_batches[SHARDED_BATCHES + 3])[0]
    grown = [int(st.count) for st in wide.backend.states[SHARDS:]]
    if wkeep.sum() == 0 or wide.inserted != n0 + int(wkeep.sum()) \
            or min(grown) == 0:
        fail(f"sharded lifecycle: admission after scale-out: kept "
             f"{int(wkeep.sum())}, new shards {grown}")
    del wide
    try:
        make_pipeline("hnsw_sharded", cfg, shards=SHARDS // 2,
                      device=dev).restore(ckpt_dir)
        fail("sharded lifecycle: a restore onto fewer shards was not refused")
    except ValueError as e:
        if "cannot be merged" not in str(e):
            raise
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    out["lifecycle"] = {"deleted": n_del, "reclaimed": info["reclaimed"],
                        "free": info["free"], "compact_ms": t_compact * 1e3,
                        "admitted_after": kept, "reused": reused,
                        "checkpoint_bytes": nbytes, "save_ms": t_save * 1e3,
                        "restore_ms": t_restore * 1e3,
                        "scale_out_admitted": int(wkeep.sum()),
                        "scale_out_new_shard_counts": grown,
                        "scale_in": "refused"}
    log("sharded lifecycle " + json.dumps(out["lifecycle"]))
    del pipe, be
    torch.cuda.empty_cache()

    # the service at shards=4: its verdicts equal a process_batch loop
    # over the valid rows of its own micro-batches
    svc = DedupService(ServiceConfig(fold=cfg, shards=SHARDS))
    if svc.pipeline.backend.name != "hnsw_sharded" or \
            svc.pipeline.device.type != torch.device(dev).type:
        fail(f"sharded service: built {svc.pipeline.backend.name} on "
             f"{svc.pipeline.device}")
    emitted = []
    svc.outcome_hooks.append(lambda o: emitted.append(o.batch))
    _lib.reset_launches()
    verdicts, wall = run_service(svc, svc_chunks)
    s_launches = dict(_lib.LAUNCHES)
    require_launched("sharded service", s_launches, ["minhash"])
    ref = make_pipeline("hnsw_sharded", cfg, shards=SHARDS, device=dev)
    keep_ref, keep_svc = replay_micro_batches(ref, emitted, verdicts)
    if not np.array_equal(keep_ref, keep_svc):
        fail(f"sharded service: verdicts differ from the process_batch loop "
             f"at {int((keep_ref != keep_svc).sum())} docs")
    bad = sharded_states_equal(ref.backend.states, svc.pipeline.backend.states)
    if bad:
        fail(f"sharded service: index differs from the loop: {bad}")
    n_svc = sum(len(t) for t, _ in svc_chunks)
    out["service"] = {"docs": n_svc, "submits": len(svc_chunks),
                      "micro_batches": len(emitted), "wall_s": wall,
                      "docs_per_s": n_svc / wall,
                      "admitted": int(keep_svc.sum()),
                      "launches": s_launches}
    log("sharded service " + json.dumps(out["service"]) + "; verdicts and "
        "index equal a process_batch loop over the same micro-batches")
    del svc, ref
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"sharded: phase wall {out['phase_s']:.1f} s; {card}")
    return out


def lm_run(cfg, dev) -> dict:
    """One REDUCED arch on `dev`, weights drawn from a CPU generator seeded
    0 (the same on every device): make_prefill_step's logits, one decode
    step at pos 3 from fresh caches, and generate at LM_SMALL. Returns the
    outputs on the host: [prefill, decode logits, generate's last prompt
    logits, every decode cache leaf], and the generated tokens."""
    import torch

    from repro_torch.launch.serve import generate, init_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train.step import make_decode_step, make_prefill_step
    B, P, G = LM_SMALL
    rng = np.random.default_rng(0)
    params, caches = init_model(cfg, B, P + G, dev, rng,
                                generator=torch.Generator().manual_seed(0))
    prompts = rng.integers(1, cfg.vocab, (B, P))
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.as_tensor(
            rng.normal(size=(B, cfg.prefix_len, cfg.d_model)),
            dtype=torch.float32, device=dev)
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(
            rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)),
            dtype=torch.float32, device=dev)
    prefill = make_prefill_step(cfg)(params, batch)
    step_caches = tree_map(torch.clone, caches)
    logits, step_caches = make_decode_step(cfg)(
        params, step_caches, batch["tokens"][:, 0],
        torch.full((B,), 3, dtype=torch.int64, device=dev))
    out = generate(cfg, params, caches, prompts, G)
    outs = [prefill, logits, out.prompt_logits] + tree_leaves(step_caches)
    return {"outs": [o.float().cpu().numpy() for o in outs],
            "tokens": out.tokens}


def lm_compare(tag: str, cfg, card: dict, cpu: dict, cpu_f32: dict) -> float:
    """Card against CPU with LM_TOL; returns the largest abs difference."""
    cdt = cfg.compute_dtype
    atol, rtol = LM_TOL[cdt]
    if cdt == "float32" and cfg.family in ("ssm", "hybrid"):
        atol = rtol = LM_SSM_TOL
    worst = 0.0
    for i, (g, w) in enumerate(zip(card["outs"], cpu["outs"])):
        if g.shape != w.shape or not np.isfinite(g).all():
            fail(f"lm_serve {tag}: output {i} has shape {g.shape} against "
                 f"{w.shape}, or is not finite")
        worst = max(worst, float(np.abs(g - w).max()))
        if cdt == "bfloat16" and cfg.family == "hybrid":
            truth = cpu_f32["outs"][i]
            e_card, e_cpu = np.abs(g - truth), np.abs(w - truth)
            if (e_card.mean() > 1.25 * e_cpu.mean()
                    or e_card.max() > 1.25 * e_cpu.max()):
                fail(f"lm_serve {tag}: output {i} is {e_card.mean()}/"
                     f"{e_card.max()} (mean/max) from the CPU's f32 result, "
                     f"the CPU's own bf16 {e_cpu.mean()}/{e_cpu.max()}")
        elif not np.allclose(g, w, atol=atol, rtol=rtol):
            fail(f"lm_serve {tag}: output {i} differs by "
                 f"{np.abs(g - w).max()} (atol {atol}, rtol {rtol})")
    if cdt == "float32" and (card["tokens"] != cpu["tokens"]).any():
        fail(f"lm_serve {tag}: generated tokens differ: {card['tokens']} "
             f"against {cpu['tokens']}")
    return worst


def lm_full_width(arch: str, n_expected: int, card: str, dev):
    """`arch` at full width, weights drawn on the card: generate at LM_FULL
    (prefill and decode times, tokens/s, median step, peak memory),
    make_prefill_step's last-position logits against the decode loop's,
    and one profiled decode step at the next position. Returns (the
    record, params, caches, that step's logits)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params, tree_leaves, tree_size
    from repro_torch.train.step import make_decode_step, make_prefill_step
    cfg = get_config(arch)
    B, P, G, C = LM_FULL
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(T.param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    n_params = tree_size(params)
    if n_params != n_expected:
        fail(f"lm_serve: {arch} has {n_params} parameters, expected "
             f"{n_expected}")
    caches = T.init_caches(cfg, B, C, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (B, P))
    # warm-up (cuBLAS handles, the allocator's pools), then fresh caches
    generate(cfg, params, caches, prompts[:, :2], 2)
    for t in tree_leaves(caches):
        t.zero_()
    torch.cuda.reset_peak_memory_stats()
    gen = generate(cfg, params, caches, prompts, G)
    peak = torch.cuda.max_memory_allocated()
    full = make_prefill_step(cfg)(
        params, {"tokens": torch.as_tensor(prompts, device=dev)})[:, -1]
    if not (bool(torch.isfinite(full).all())
            and bool(torch.isfinite(gen.prompt_logits).all())):
        fail(f"lm_serve: non-finite logits at full width ({arch})")
    prefill_vs_decode = float((full - gen.prompt_logits).abs().max())
    argmax_agree = float((full.argmax(-1) == gen.prompt_logits.argmax(-1))
                         .float().mean())
    del full
    decode = make_decode_step(cfg)
    tok = torch.as_tensor(gen.tokens[:, -1], device=dev)
    pos = torch.full((B,), P + G - 1, dtype=torch.int64, device=dev)
    prof, (last, _) = device_profile(
        lambda: decode(params, caches, tok, pos), f"lm_decode_step_{arch}")
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(caches))
    res = {"arch": cfg.name, "params": n_params, "batch": B, "prompt": P,
           "gen": G, "cache_positions": C, "cache_bytes": cache_bytes,
           "init_s": init_s, "prefill_ms": gen.prefill_s * 1e3,
           "prefill_ms_per_step": gen.prefill_s * 1e3 / P,
           "decode_s": gen.decode_s, "decode_tokens_per_s": gen.tokens_per_s,
           "median_step_ms": gen.median_step_ms,
           "resident_gib": resident / 2**30,
           "max_memory_allocated_gib": peak / 2**30,
           "prefill_vs_decode_max_abs": prefill_vs_decode,
           "prefill_vs_decode_argmax_agree": argmax_agree,
           "profile": prof, "card": card}
    log("lm_serve (b) " + json.dumps(res))
    log(f"lm_serve (b): {cfg.name} at full width ({n_params:,} parameters), "
        f"batch {B}, prompt {P}, gen {G}, caches {cache_bytes / 1e9:.1f} GB: "
        f"prefill {gen.prefill_s * 1e3:.1f} ms, {gen.tokens_per_s:.1f} "
        f"tokens/s, median step {gen.median_step_ms:.2f} ms, peak "
        f"{peak / 2**30:.2f} GiB; a profiled step: "
        f"{prof['device_busy_ms']:.1f} ms busy, idle "
        f"{prof['device_idle_share']:.4f}, {prof['device_ops']} launches; "
        f"{card}")
    return res, params, caches, last


def phase_lm_serve(card: str, dev) -> dict:
    """The LM serving path: (a) every REDUCED arch, cuda against cpu; (b)
    qwen1.5-4b and falcon-mamba-7b at full width on the card; (c) one
    full-width decode step at batch 1, card against CPU (see the module
    docstring)."""
    import torch

    from repro_torch.configs import get_config, list_archs, reduced_config
    from repro_torch.kernels import _lib
    from repro_torch.models.common import tree_map
    from repro_torch.train.step import make_decode_step
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    _lib.reset_launches()

    # (a) every REDUCED arch, cuda against cpu, f32 compute first (the
    # hybrid's bf16 check reads the CPU's f32 outputs)
    small = {}
    t0 = time.perf_counter()
    for arch in list_archs():
        runs = {}
        for cdt in ("float32", "bfloat16"):
            cfg = dataclasses.replace(reduced_config(arch), compute_dtype=cdt)
            runs[cdt] = lm_run(cfg, cpu)
            small[f"{arch}/{cdt}"] = lm_compare(
                f"{arch}/{cdt}", cfg, lm_run(cfg, dev), runs[cdt],
                runs["float32"])
    log("lm_serve (a) " + json.dumps({"max_abs_err": small, "card": card}))
    log(f"lm_serve (a): all {len(list_archs())} REDUCED archs, prefill "
        f"logits, a decode step and generate at batch {LM_SMALL[0]}, prompt "
        f"{LM_SMALL[1]}, gen {LM_SMALL[2]} on cuda equal cpu within the "
        f"tests' tolerances at bf16 and f32 (tokens equal at f32); "
        f"{time.perf_counter() - t0:.1f} s; {card}")

    # (b) qwen1.5-4b at full width, drawn on the card
    res, params, caches, last = lm_full_width(LM_FULL_ARCH, LM_FULL_PARAMS,
                                              card, dev)
    decode = make_decode_step(get_config(LM_FULL_ARCH))
    _, P, G, _ = LM_FULL

    # (c) one decode step at batch 1 and the cache's first LM_CPU_CACHE
    # positions, card against CPU, from the same weights and cache
    t0 = time.perf_counter()
    host_params = tree_map(lambda t: t.cpu(), params)
    card_cache = tree_map(lambda t: t[:, :1, :LM_CPU_CACHE].clone(), caches)
    host_cache = tree_map(lambda t: t.cpu(), card_cache)
    del caches
    copy_s = time.perf_counter() - t0
    tok1 = last.argmax(-1)[:1]
    pos1 = torch.full((1,), P + G, dtype=torch.int64, device=dev)
    decode(params, card_cache, tok1, pos1)          # warm-up at batch 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_logits, _ = decode(params, card_cache, tok1, pos1)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    host_logits, _ = decode(host_params, host_cache, tok1.cpu(), pos1.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    diff = (card_logits.cpu() - host_logits).abs()
    atol, rtol = LM_TOL["bfloat16"]
    if not torch.allclose(card_logits.cpu(), host_logits, atol=atol,
                          rtol=rtol):
        fail(f"lm_serve (c): card and CPU logits differ by {diff.max()}")
    step = {"batch": 1, "cache_positions": LM_CPU_CACHE, "pos": P + G,
            "max_abs_err": float(diff.max()), "mean_abs_err": float(diff.mean()),
            "argmax_equal": bool(card_logits.argmax(-1).cpu()
                                 == host_logits.argmax(-1)),
            "card_ms": card_ms, "cpu_ms": cpu_ms, "host_copy_s": copy_s,
            "tolerance": [atol, rtol], "card": card}
    log("lm_serve (c) " + json.dumps(step))
    del host_params, host_cache, params, card_cache, last
    torch.cuda.empty_cache()

    # (b) again for the state-space family: falcon-mamba-7b at full width
    ssm_res, params, caches, last = lm_full_width(*LM_FULL_SSM, card, dev)
    del params, caches, last
    torch.cuda.empty_cache()
    launches = dict(_lib.LAUNCHES)
    if any(launches.values()):
        fail(f"lm_serve: the LM path launched FOLD kernels: {launches}")
    out = {"small": small, "full": res, "full_ssm": ssm_res, "step": step,
           "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    log(f"lm_serve: K1-K4 launched 0 times on the LM path; phase wall "
        f"{out['phase_s']:.1f} s; {card}")
    return out


def train_batch(vocab: int, B: int, S: int, seed: int, dev, cfg=None) -> dict:
    """A seeded LM batch (tokens, labels, loss_mask; the VLM's patch
    embeds and the encdec's frames when `cfg` needs them) on `dev`."""
    import torch
    rng = np.random.default_rng(seed)
    t = rng.integers(0, vocab, (B, S + 1))
    batch = {"tokens": torch.as_tensor(t[:, :-1], device=dev),
             "labels": torch.as_tensor(t[:, 1:], device=dev),
             "loss_mask": torch.ones((B, S), device=dev)}
    if cfg is not None and cfg.family == "vlm":
        batch["patch_embeds"] = torch.as_tensor(
            rng.normal(size=(B, cfg.prefix_len, cfg.d_model)),
            dtype=torch.float32, device=dev)
    if cfg is not None and cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(
            rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)),
            dtype=torch.float32, device=dev)
    return batch


def share(got, want) -> float:
    """Largest |got - want| as a share of want's largest |value|."""
    want = want.float().cpu()
    err = (got.float().cpu() - want).abs().max()
    return float(err / want.abs().max().clamp_min(1e-30))


def lm_train_small(arch: str, dev) -> dict:
    """(a) for one REDUCED arch at f32 compute: gradients, then one train
    step, on `dev` against the CPU from the same weights and batch, and
    `dev`'s remat=True gradients against its remat=False ones."""
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.models import whisper as W
    from repro_torch.models.common import init_params, tree_leaves, tree_map
    from repro_torch.train import OptConfig, make_train_step, opt_init
    from repro_torch.train.step import make_grad_fn
    cpu = torch.device("cpu")
    cfg = dataclasses.replace(reduced_config(arch), compute_dtype="float32")
    specs = (W.whisper_param_specs(cfg) if cfg.family == "encdec"
             else T.param_specs(cfg))
    host = init_params(specs, torch.Generator().manual_seed(0), cpu)
    card = tree_map(lambda t: t.to(dev, copy=True), host)
    B, S = LM_TRAIN_SMALL
    bound = LM_TRAIN_SHARE["ssm" if cfg.family in ("ssm", "hybrid")
                           else "float32"]
    loss_c, g_c = make_grad_fn(cfg)(card, train_batch(cfg.vocab, B, S, 0,
                                                      dev, cfg))
    loss_h, g_h = make_grad_fn(cfg)(host, train_batch(cfg.vocab, B, S, 0,
                                                      cpu, cfg))
    _, g_n = make_grad_fn(cfg, remat=False)(
        card, train_batch(cfg.vocab, B, S, 0, dev, cfg))
    g_c, g_h, g_n = (tree_leaves(g) for g in (g_c, g_h, g_n))
    if not all(torch.equal(a, b) for a, b in zip(g_c, g_n)):
        fail(f"lm_train (a) {arch}: remat=True and remat=False gradients "
             f"differ on the card")
    rec = {"loss_rel": abs(float(loss_c) - float(loss_h)) / abs(float(loss_h)),
           "grad_share": max(share(a, b) for a, b in zip(g_c, g_h))}

    oc = OptConfig(lr=1e-3, warmup_steps=1, decay_steps=100)
    p0 = tree_map(torch.clone, host)
    out = {}
    for tag, d, params in (("card", dev, card), ("host", cpu, host)):
        out[tag] = make_train_step(cfg, oc)(
            params, opt_init(params, oc), train_batch(cfg.vocab, B, S, 0, d,
                                                      cfg))
    (pc, sc, mc), (ph, sh, mh) = out["card"], out["host"]
    lr = float(mh["lr"])
    p_share = 0.0
    for a, b, g, p in zip(tree_leaves(pc), tree_leaves(ph), g_h,
                          tree_leaves(p0)):
        err = (a.cpu() - b).abs()
        held = g.abs() >= 1e-3 * g.abs().max()
        p_share = max(p_share, float(err[held].max() / b.abs().max())
                      if bool(held.any()) else 0.0)
        if not bool((err <= 2 * lr * (1 + 0.1 * p.abs()) + 1e-7).all()):
            fail(f"lm_train (a) {arch}: a parameter moved more than one "
                 f"AdamW step from the CPU's")
    rec.update(
        step_loss_rel=abs(float(mc["loss"]) - float(mh["loss"]))
        / abs(float(mh["loss"])),
        grad_norm_rel=abs(float(mc["grad_norm"]) - float(mh["grad_norm"]))
        / abs(float(mh["grad_norm"])),
        param_share=p_share,
        m_share=max(share(a, b) for a, b in zip(tree_leaves(sc.m),
                                                 tree_leaves(sh.m))),
        v_share=max(share(a, b) for a, b in zip(tree_leaves(sc.v),
                                                 tree_leaves(sh.v))))
    # the global norm sums every leaf's squares: its bound is the leaves'
    checks = {"loss_rel": 1e-5, "grad_share": bound, "step_loss_rel": 1e-5,
              "grad_norm_rel": bound, "param_share": bound, "m_share": bound,
              "v_share": 2 * bound}
    log(f"lm_train (a) {arch} " + json.dumps(rec))
    for k, lim in checks.items():
        if not rec[k] <= lim:
            fail(f"lm_train (a) {arch}: {k} {rec[k]} above {lim}")
    return rec


def lm_train_resume(dev, ckpt_root: str) -> dict:
    """(c) REDUCED qwen1.5-4b on `dev`: fail at step 6 with checkpoints
    every 4, resume at 4 and run to 10; equal to an uninterrupted 10-step
    run bit for bit (the caller holds deterministic algorithms on)."""
    import shutil

    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params, tree_leaves, tree_map
    from repro_torch.train import (ElasticTrainer, OptConfig, make_train_step,
                                   opt_init)
    cfg = reduced_config(LM_FULL_ARCH)
    host = init_params(T.param_specs(cfg), torch.Generator().manual_seed(0),
                       "cpu")
    oc = OptConfig(lr=1e-3, warmup_steps=1, decay_steps=100)
    step = make_train_step(cfg, oc)
    shutil.rmtree(ckpt_root, ignore_errors=True)

    def trainer(name: str, every: int) -> ElasticTrainer:
        params = tree_map(lambda t: t.to(dev, copy=True), host)
        return ElasticTrainer(
            step, params, opt_init(params, oc),
            lambda i: train_batch(cfg.vocab, 4, 64, 5000 + i, dev),
            os.path.join(ckpt_root, name), ckpt_every=every, async_save=False)

    t0 = time.perf_counter()
    tr = trainer("run", 4)
    try:
        tr.run(10, fail_at=6)
        fail("lm_train (c): the injected failure did not raise")
    except RuntimeError as err:
        if "injected failure at step 6" not in str(err):
            raise
    tr2 = trainer("run", 4)
    if not (tr2.maybe_resume() and tr2.step == 4):
        fail(f"lm_train (c): resumed at step {tr2.step}, expected 4")
    tr2.run(10)
    ref = trainer("ref", 100)
    ref.run(10)
    for a, b in zip(tree_leaves(tr2.params) + tree_leaves(tr2.opt_state.m)
                    + tree_leaves(tr2.opt_state.v),
                    tree_leaves(ref.params) + tree_leaves(ref.opt_state.m)
                    + tree_leaves(ref.opt_state.v)):
        if not torch.equal(a, b):
            fail("lm_train (c): the resumed run differs from the "
                 "uninterrupted one")
    return {"resumed_at": 4, "steps": 10, "bit_exact": True,
            "losses": [r["loss"] for r in ref.metrics_log],
            "s": time.perf_counter() - t0}


def lm_train_full(B: int, S: int, steps: int, ckpt_dir: str, dev,
                  profile: bool, extra: tuple = ()) -> tuple[dict, object]:
    """(b) qwen1.5-4b at full width through launch.train's main path at
    batch B x seq S for `steps` steps (the first a warm-up), with an
    optional profiled step more on the last batch; `extra` arguments go
    to launch.train (phase 15's --mesh). Returns (its record,
    launch.train's TrainRun)."""
    import shutil

    import torch

    from repro_torch.kernels import _lib
    from repro_torch.launch import train as launch_train
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    run = launch_train.main(
        ["--arch", "qwen1.5-4b", "--full", "--steps", str(steps), "--batch",
         str(B), "--seq", str(S), "--ckpt-every", "1000", "--device",
         dev.type, "--ckpt-dir", ckpt_dir, *extra])
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require_launched(f"lm_train (b) {B} x {S}", launches,
                     ["minhash", "jaccard_cached"])
    if run.n_params != LM_FULL_PARAMS:
        fail(f"lm_train (b): {run.n_params} parameters, expected "
             f"{LM_FULL_PARAMS}")
    losses = [r["loss"] for r in run.log]
    if len(losses) != steps or not np.isfinite(losses).all():
        fail(f"lm_train (b) {B} x {S}: losses {losses}")
    timed = run.log[1:]
    step_ms = [(r["dt"] - r["batch_s"]) * 1e3 for r in timed]
    med_s = statistics.median(step_ms) / 1e3
    tokens = B * S
    # the embedding table is gathered, not multiplied: N counts the rest
    n_matmul = run.n_params - run.trainer.params["embed"].numel()
    prof = None
    if profile:
        tr = run.trainer
        prof, (_, tr.opt_state, _) = device_profile(
            lambda: tr.train_step(tr.params, tr.opt_state,
                                  run.batches[steps - 1]),
            f"lm_train_step_{B}x{S}")
    res = {"arch": run.cfg.name, "params": run.n_params,
           "matmul_params": n_matmul, "batch": B, "seq": S, "steps": steps,
           "run_tokens_per_s": run.tokens_per_s, "run_s": run.seconds,
           "step_ms": step_ms, "median_step_ms": med_s * 1e3,
           "step_tokens_per_s": tokens / med_s,
           "median_wall_ms": statistics.median(r["dt"] for r in timed) * 1e3,
           "warmup_ms": run.log[0]["dt"] * 1e3,
           "warmup_batch_s": run.log[0]["batch_s"],
           "model_flop_share": 6 * n_matmul * tokens / med_s
           / BF16_FLOPS_PER_S,
           "max_memory_allocated_gib": peak / 2**30,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "grad_norms": [r["grad_norm"] for r in run.log],
           "admitted": run.ingest.total_admitted,
           "docs_in": run.ingest.total_in, "launches": launches,
           "profile": prof}
    return res, run


def phase_lm_train(card: str, dev) -> dict:
    """The LM training path (see the module docstring): (a) every REDUCED
    arch cuda against cpu, (b) qwen1.5-4b at full width through
    launch.train, at batch 2 x seq 512 and at its default 8 x
    256, (c) the elastic resume."""
    import gc

    import torch

    from repro_torch.configs import list_archs
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as launch_train
    t_phase = time.perf_counter()
    ckpt_root = os.path.join(ROOT, "build", "lm_train")
    gc.collect()
    torch.cuda.empty_cache()
    resident_before = torch.cuda.memory_allocated()

    # (a) and (c) under deterministic algorithms: the backward of an index
    # or a gather adds with atomics on the card
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        small = {arch: lm_train_small(arch, dev) for arch in list_archs()}
        small_s = time.perf_counter() - t0
        resume = lm_train_resume(dev, os.path.join(ckpt_root, "resume"))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    log("lm_train (a) " + json.dumps({"archs": small, "s": small_s,
                                      "card": card}))
    log(f"lm_train (a): all {len(small)} REDUCED archs, gradients and one "
        f"train step at f32 on {dev.type} equal cpu (largest gradient share "
        f"{max(r['grad_share'] for r in small.values()):.3g}), remat=True "
        f"equals remat=False bit for bit; {small_s:.1f} s; {card}")
    log("lm_train (c) " + json.dumps({**resume, "card": card}))

    # (b) qwen1.5-4b at full width through launch.train's main path
    B, S, steps = LM_TRAIN_FULL
    res, run = lm_train_full(B, S, steps, os.path.join(ckpt_root, "full"),
                             dev, profile=True)
    res.update(resident_before_gib=resident_before / 2**30, card=card)
    launches = res["launches"]
    log("lm_train (b) " + json.dumps(res))
    first = {k: {n: t.cpu() for n, t in run.batches[k].items()}
             for k in range(LM_TRAIN_SERVICE_STEPS)}
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # (b) at launch.train's default batch shape
    Bd, Sd, steps_d = LM_TRAIN_DEFAULT
    dflt, run = lm_train_full(Bd, Sd, steps_d,
                              os.path.join(ckpt_root, "default"), dev,
                              profile=False)
    dflt["card"] = card
    log("lm_train (b) default shape " + json.dumps(dflt))
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # (b) again with --service, two steps
    _lib.reset_launches()
    svc = launch_train.main(
        ["--arch", "qwen1.5-4b", "--full", "--steps",
         str(LM_TRAIN_SERVICE_STEPS), "--batch", str(B), "--seq", str(S),
         "--device", dev.type, "--service", "--ckpt-every", "1000",
         "--ckpt-dir", os.path.join(ckpt_root, "service")])
    svc_launches = dict(_lib.LAUNCHES)
    require_launched("lm_train (b) --service", svc_launches,
                     ["minhash", "jaccard_cached"])
    for k, b in first.items():
        for n, t in b.items():
            if not torch.equal(svc.batches[k][n].cpu(), t):
                fail(f"lm_train (b) --service: batch {k} {n} differs from "
                     f"the direct ingest's")
    _, direct = launch_train.make_ingest(svc.cfg, "common_crawl", device=dev)
    while direct.total_in < svc.ingest.total_in:
        direct.next_clean_batch(256)
    if (direct.total_in, direct.total_admitted) != (
            svc.ingest.total_in, svc.ingest.total_admitted):
        fail(f"lm_train (b) --service: admitted {svc.ingest.total_admitted}/"
             f"{svc.ingest.total_in}, the direct ingest "
             f"{direct.total_admitted}/{direct.total_in}")
    svc_res = {"steps": LM_TRAIN_SERVICE_STEPS,
               "losses": [r["loss"] for r in svc.log],
               "admitted": svc.ingest.total_admitted,
               "docs_in": svc.ingest.total_in, "launches": svc_launches}
    log("lm_train (b) --service " + json.dumps(svc_res))
    del svc, direct
    gc.collect()
    torch.cuda.empty_cache()
    prof = res["profile"]
    for r in (res, dflt):
        log(f"lm_train (b): {r['arch']} at full width ({r['params']:,} "
            f"parameters), batch {r['batch']} x seq {r['seq']}: the "
            f"trainer's {r['run_tokens_per_s']:.0f} tokens/s over "
            f"{r['steps']} steps, ingest included; median step "
            f"{r['median_step_ms']:.1f} ms ({r['step_tokens_per_s']:.0f} "
            f"tokens/s), model-FLOP share {r['model_flop_share']:.4f} (N "
            f"{r['matmul_params']:,}, the embedding table left out), peak "
            f"{r['max_memory_allocated_gib']:.2f} GiB; loss "
            f"{r['loss_first']:.3f} -> {r['loss_last']:.3f}; dedup admitted "
            f"{r['admitted']}/{r['docs_in']}; K1 "
            f"{r['launches']['minhash']}, K2 "
            f"{r['launches']['jaccard_cached']} launches; {card}")
    log(f"lm_train (b): a profiled {B} x {S} step: "
        f"{prof['device_busy_ms']:.1f} ms busy, idle "
        f"{prof['device_idle_share']:.4f}, {prof['device_ops']} device "
        f"operations; {card}")
    out = {"small": small, "full": res, "default": dflt, "service": svc_res,
           "resume": resume, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    log(f"lm_train: phase wall {out['phase_s']:.1f} s; {card}")
    return out


def lm_mesh_small(arch: str, mesh, dev) -> dict:
    """(b) of phase 15 for one REDUCED arch: one train step on the (1, 1)
    mesh and one unmeshed on `dev`, from the same weights and batch."""
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.dist import act
    from repro_torch.dist.sharding import batch_pspecs, distribute, make_plan
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params, tree_leaves, tree_map
    from repro_torch.train import OptConfig, make_train_step, opt_init
    B, S = LM_TRAIN_SMALL
    cfg = reduced_config(arch)
    specs = T.param_specs(cfg)
    params = init_params(specs, torch.Generator().manual_seed(0), dev)
    batch = train_batch(cfg.vocab, B, S, seed=15, dev=dev)
    oc = OptConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    step = make_train_step(cfg, oc)
    plain = tree_map(torch.clone, params)
    p1, _, m1 = step(plain, opt_init(plain, oc), batch)
    meshed = distribute(params, make_plan(cfg, mesh).params(specs), mesh,
                        src_data_rank=None)
    mbatch = distribute(batch, batch_pspecs(cfg, mesh, "train", B), mesh,
                        src_data_rank=None)
    act.set_mesh(mesh)
    t0 = time.perf_counter()
    try:
        p2, o2, m2 = step(meshed, opt_init(meshed, oc), mbatch)
        float(m2["loss"])                   # the sync
    finally:
        act.clear()
    step_s = time.perf_counter() - t0
    if not all(type(t).__name__ == "DTensor"
               for t in tree_leaves(p2) + tree_leaves(o2.m)):
        fail(f"lm_train_mesh (b) {arch}: params or moments left the mesh")
    loss_diff = abs(float(m1["loss"]) - float(m2["loss"]))
    p_diff = max(float((a.full_tensor() - b).abs().max())
                 for a, b in zip(tree_leaves(p2), tree_leaves(p1)))
    if not (loss_diff < 1e-3 and p_diff < 2e-3):
        fail(f"lm_train_mesh (b) {arch}: meshed against unmeshed loss "
             f"{loss_diff}, params {p_diff}")
    return {"loss": float(m2["loss"]), "loss_diff": loss_diff,
            "param_diff": p_diff, "first_meshed_step_s": step_s}


def phase_lm_train_mesh(card: str, dev, full14: dict) -> dict:
    """Meshed training on the card (see the module docstring): (a)
    qwen1.5-4b at full width through `launch.train --mesh 1,1` against
    phase 14 (b)'s run `full14`, (b) REDUCED qwen1.5-4b and grok-1-314b
    meshed against unmeshed."""
    import gc
    import socket

    import torch
    import torch.distributed as dist

    from repro_torch.dist import act
    from repro_torch.models.common import tree_leaves
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    # the group outlives launch.train's main, for the profiled step and (b)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        B, S, steps = LM_TRAIN_FULL
        res, run = lm_train_full(
            B, S, steps, os.path.join(ROOT, "build", "lm_train", "mesh"),
            dev, profile=False, extra=("--mesh", "1,1"))
        tr = run.trainer
        if run.mesh is None or tuple(run.mesh.shape) != (1, 1) or not all(
                type(t).__name__ == "DTensor" for t in
                tree_leaves(tr.params) + tree_leaves(tr.opt_state.m)):
            fail("lm_train_mesh (a): params and moments are not DTensors "
                 "on a (1, 1) mesh")
        loss_diff = max(abs(a - b) for a, b in
                        zip(res["losses"], full14["losses"]))
        gn_diff = max(abs(a - b) / b for a, b in
                      zip(res["grad_norms"], full14["grad_norms"]))
        if not (loss_diff < 1e-3 and gn_diff < 1e-3):
            fail(f"lm_train_mesh (a): losses {res['losses']} and grad norms "
                 f"{res['grad_norms']} against phase 14 (b)'s "
                 f"{full14['losses']}, {full14['grad_norms']}")
        act.set_mesh(run.mesh)
        try:
            prof, (_, tr.opt_state, _) = device_profile(
                lambda: tr.train_step(tr.params, tr.opt_state,
                                      run.batches[steps - 1]),
                f"lm_train_mesh_step_{B}x{S}")
        finally:
            act.clear()
        res.update(profile=prof, largest_loss_diff=loss_diff,
                   largest_grad_norm_rel_diff=gn_diff, card=card)
        log("lm_train_mesh (a) " + json.dumps(res))
        launches = res["launches"]
        mesh = run.mesh
        del run, tr
        gc.collect()
        torch.cuda.empty_cache()
        small = {arch: lm_mesh_small(arch, mesh, dev)
                 for arch in ("qwen1.5-4b", "grok-1-314b")}
        log("lm_train_mesh (b) " + json.dumps({"archs": small,
                                               "card": card}))
    finally:
        dist.destroy_process_group()
    p14 = full14["profile"]
    log(f"lm_train_mesh (a): {res['arch']} at full width through "
        f"launch.train --mesh 1,1 (DTensor params and moments), batch {B} x "
        f"seq {S}: median step {res['median_step_ms']:.1f} ms "
        f"({res['step_tokens_per_s']:.0f} tokens/s; phase 14 (b) "
        f"{full14['median_step_ms']:.1f} ms, "
        f"{full14['step_tokens_per_s']:.0f} tokens/s), the trainer's "
        f"{res['run_tokens_per_s']:.0f} tokens/s with ingest (phase 14 (b) "
        f"{full14['run_tokens_per_s']:.0f}), peak "
        f"{res['max_memory_allocated_gib']:.2f} GiB (phase 14 (b) "
        f"{full14['max_memory_allocated_gib']:.2f}); profiled step: "
        f"{prof['device_ops']} device operations, idle "
        f"{prof['device_idle_share']:.4f} (phase 14 (b) {p14['device_ops']}, "
        f"{p14['device_idle_share']:.4f}), {prof['nccl_kernels']} NCCL "
        f"kernels" + (" (a one-rank mesh reduces nothing)"
                      if prof["nccl_kernels"] == 0 else "")
        + f"; largest loss difference from phase 14 (b) {loss_diff:.3g}, "
        f"grad norm {gn_diff:.3g} relative; K1 {launches['minhash']}, K2 "
        f"{launches['jaccard_cached']} launches; {card}")
    log("lm_train_mesh (b): " + "; ".join(
        f"{a} meshed against unmeshed: loss {r['loss_diff']:.3g}, params "
        f"{r['param_diff']:.3g}" for a, r in small.items()) + f"; {card}")
    out = {"full": res, "small": small, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    log(f"lm_train_mesh: phase wall {out['phase_s']:.1f} s; {card}")
    return out


def load_example(name: str):
    """examples/<name>_torch.py as a fresh module (its `main(argv)`)."""
    import importlib.util
    path = os.path.join(EXAMPLES, f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class FrozenClocks:
    """Freeze the service batcher's clock and the cluster writer's tenant
    clock at 0 (the `MicroBatcher` name in repro_torch.service.service,
    the `ClusterWriter` name in repro_torch.cluster.router): a partial
    micro-batch leaves only when its results are asked for, and a QPS
    bucket serves its burst and nothing after it, on every device."""

    def __enter__(self):
        import functools

        import repro_torch.cluster.router as router
        import repro_torch.service.service as service
        frozen = lambda: 0.0  # noqa: E731
        self.saved = [(service, "MicroBatcher", service.MicroBatcher),
                      (router, "ClusterWriter", router.ClusterWriter)]
        for mod, name, cls in self.saved:
            setattr(mod, name, functools.partial(cls, clock=frozen))
        return self

    def __exit__(self, *exc):
        for mod, name, cls in self.saved:
            setattr(mod, name, cls)


def run_example(name: str, argv: list, setup=None) -> dict:
    """One example's `main(argv)` in this process: what it printed, its
    wall time and the kernel launches counted from just before it to just
    after it. `setup(module)` may wrap names of the module first."""
    import contextlib
    import io

    import torch

    from repro_torch.kernels import _lib
    on_card = "cuda" in argv
    mod = load_example(name)
    if setup is not None:
        setup(mod)
    out = io.StringIO()
    if on_card:
        torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        mod.main(argv)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    text = out.getvalue()
    if on_card:
        for line in text.splitlines():
            log(f"  [{name}] {line}")
    return {"text": text, "wall_s": wall, "launches": launches}


_CLOCK_FIELDS = [(r"\s*[-\d.e+inf]+ docs/s", " <t> docs/s"),
                 (r"qps=\s*[-\d.e+inf]+", "qps=<t>"),
                 (r"p99_batch=\s*[-\d.e+inf]+ms", "p99_batch=<t>ms")]


def mask_clock(text: str) -> str:
    """An example's output with its wall-clock fields masked."""
    import re
    for pat, rep in _CLOCK_FIELDS:
        text = re.sub(pat, rep, text)
    return text


def cpu_job(kind: str, arg, threads: int) -> None:
    """One CPU run of phase 16, in a process of its own (see cpu_jobs)
    with `threads` intra-op threads: an example at its defaults with
    `--device cpu` and frozen clocks ("example", name), or a DedupIngest
    over (e)'s corpus ("ingest", the number of pulls). Prints one JSON
    line: the example's output and its launches, or each pull's admitted
    count."""
    import torch
    torch.set_num_threads(threads)
    if kind == "example":
        with FrozenClocks():
            run = run_example(arg, ["--device", "cpu"])
        print(json.dumps(run), flush=True)
        return
    from repro_torch.core.dedup import FoldConfig
    from repro_torch.data import DATASET_PRESETS, DedupIngest, SyntheticCorpus
    t0 = time.perf_counter()
    ing = DedupIngest(
        SyntheticCorpus(dataclasses.replace(DATASET_PRESETS["c4"],
                                            vocab=EX_VOCAB)),
        FoldConfig(capacity=1 << 15, ef_construction=48, ef_search=48,
                   threshold_space="minhash"), device="cpu")
    pulls = [len(ing.next_clean_batch(EX_TRAIN_PULL)[1]) for _ in range(arg)]
    print(json.dumps({"pulls": pulls, "wall_s": time.perf_counter() - t0}),
          flush=True)


def cpu_jobs(jobs: dict) -> dict:
    """Run every (kind, arg) of `jobs` through cpu_job, each in its own
    process (EX_CPU_THREADS intra-op threads, else one), all at once; wait
    for all of them and return tag -> the job's JSON record. A job that
    fails fails the script; none outlives this call."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = {}
    for tag, (kind, arg) in jobs.items():
        threads = EX_CPU_THREADS.get(tag, 1)
        code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
                f"import chip_smoke; "
                f"chip_smoke.cpu_job({kind!r}, {arg!r}, {threads})")
        procs[tag] = subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out, errors = {}, []
    for tag, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            fail(f"examples: the CPU run {tag} took over 600 s")
        if p.returncode != 0:
            errors.append(f"{tag}: exit {p.returncode}\n{stderr[-3000:]}")
            continue
        out[tag] = json.loads(stdout.strip().splitlines()[-1])
    if errors:
        fail("examples: CPU runs failed:\n" + "\n".join(errors))
    return out


def example_train(dev, card: str) -> dict:
    """(e) train_dedup_lm at demo-124m, EX_TRAIN: each step timed on the
    card (synchronized), its loss, and every ingest pull's admitted count
    (held against a CPU DedupIngest by phase_examples)."""
    import re

    import torch
    rec = {"step_ms": [], "losses": [], "pulls": []}

    def setup(mod):
        make_step, ingest_cls = mod.make_train_step, mod.DedupIngest

        def timed(*a, **k):
            step = make_step(*a, **k)

            def run(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*args)
                loss = float(out[2]["loss"])         # waits for the step
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["losses"].append(loss)
                return out
            return run

        def ingest(*a, **k):
            ing = ingest_cls(*a, **k)
            pull = ing.next_clean_batch

            def counted(n):
                before = ing.total_admitted
                out = pull(n)
                rec["pulls"].append(ing.total_admitted - before)
                return out
            ing.next_clean_batch = counted
            rec["ingest"] = ing
            return ing
        mod.make_train_step, mod.DedupIngest = timed, ingest

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B, S, steps = EX_TRAIN
    run = run_example("train_dedup_lm",
                      ["--batch", str(B), "--seq", str(S), "--steps",
                       str(steps), "--device", dev.type], setup)
    peak = torch.cuda.max_memory_allocated()
    ing = rec.pop("ingest")
    n_pulls = len(rec["pulls"])
    if (len(rec["losses"]) != steps or not np.isfinite(rec["losses"]).all()
            or ing.total_in != n_pulls * EX_TRAIN_PULL):
        fail(f"examples train_dedup_lm: losses {rec['losses']}, "
             f"{ing.total_in} docs in over {n_pulls} pulls")
    for k in ("minhash", "jaccard_cached"):
        if run["launches"][k] != n_pulls:
            fail(f"examples train_dedup_lm: {k} launched "
                 f"{run['launches'][k]} times in {n_pulls} ingest pulls")
    med = statistics.median(rec["step_ms"][1:])
    return {"config": "demo-124m",
            "params": re.search(r"model: (\S+) params", run["text"])[1],
            "batch": B, "seq": S, "steps": steps,
            "loss_first": rec["losses"][0], "loss_last": rec["losses"][-1],
            "losses": rec["losses"], "step_ms": rec["step_ms"],
            "median_step_ms": med, "step_tokens_per_s": B * S / med * 1e3,
            "printed_tokens_per_s": [float(x) for x in re.findall(
                r"\((\d+) tok/s\)", run["text"])],
            "run_tokens_per_s": B * S * steps / run["wall_s"],
            "wall_s": run["wall_s"],
            "max_memory_allocated_gib": peak / 2**30,
            "admitted": ing.total_admitted, "docs_in": ing.total_in,
            "pulls": rec["pulls"], "launches": run["launches"], "card": card}


def example_serve(dev, card: str) -> dict:
    """(f) serve_demo at zamba2-7b full width (EX_SERVE), generate's
    arguments and result kept: one more decode step profiled; the decode
    loop's logits at the prompt's last position against
    make_prefill_step's, at bf16 both measured from an f32-compute prefill
    (EX_SERVE_SLACK), and the decode loop rerun over the prompt at f32
    compute against that prefill (EX_SERVE_ULP_FACTOR)."""
    import gc

    import torch

    import repro_torch.launch.serve as serve
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_size
    from repro_torch.train.step import make_decode_step, make_prefill_step
    gc.collect()
    torch.cuda.empty_cache()
    kept = {}
    generate = serve.generate

    def keep(cfg, params, caches, prompts, gen):
        out = generate(cfg, params, caches, prompts, gen)
        kept.update(cfg=cfg, params=params, caches=caches, prompts=prompts,
                    out=out)
        return out

    torch.cuda.reset_peak_memory_stats()
    serve.generate = keep
    try:
        run = run_example("serve_demo", EX_SERVE + ["--device", dev.type])
    finally:
        serve.generate = generate
    peak = torch.cuda.max_memory_allocated()
    cfg, params, out = kept["cfg"], kept["params"], kept["out"]
    n_params = tree_size(params)
    if n_params != EX_SERVE_PARAMS:
        fail(f"examples serve_demo: {n_params} parameters, expected "
             f"{EX_SERVE_PARAMS}")
    if any(run["launches"].values()):
        fail(f"examples serve_demo: the LM path launched FOLD kernels: "
             f"{run['launches']}")
    B, P = kept["prompts"].shape
    G = out.tokens.shape[1]
    # one more decode step, profiled, at the caches' last free position
    decode = make_decode_step(cfg)
    tok = torch.as_tensor(out.tokens[:, -1], device=dev)
    pos = torch.full((B,), P + G - 1, dtype=torch.int64, device=dev)
    prof, _ = device_profile(lambda: decode(params, kept["caches"], tok, pos),
                             "examples_zamba2_decode")
    del kept["caches"]
    tokens = torch.as_tensor(kept["prompts"], device=dev)
    f32_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.no_grad():
        bf16 = make_prefill_step(cfg)(params, {"tokens": tokens})[:, -1]
        f32 = make_prefill_step(f32_cfg)(params, {"tokens": tokens})[:, -1]
        # the prefill's sensitivity: every input embedding moved one ulp
        embed = params["embed"]
        flip = torch.rand(embed.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(1)) < 0.5
        params["embed"] = embed * (1 + torch.finfo(torch.float32).eps * (
            2 * flip.float() - 1))
        del flip
        f32_ulp = make_prefill_step(f32_cfg)(
            params, {"tokens": tokens})[:, -1].float()
        params["embed"] = embed
    f32_loop = generate(f32_cfg, params, T.init_caches(f32_cfg, B, P, dev),
                        kept["prompts"], 1).prompt_logits.float()
    decode_bf16, bf16, f32 = out.prompt_logits.float(), bf16.float(), f32.float()
    if not all(bool(torch.isfinite(t).all())
               for t in (decode_bf16, bf16, f32, f32_loop)):
        fail("examples serve_demo: non-finite logits at full width")
    scale = float(f32.abs().max())
    e_dec, e_pre = (decode_bf16 - f32).abs(), (bf16 - f32).abs()
    if (float(e_dec.mean()) > EX_SERVE_SLACK * float(e_pre.mean())
            or float(e_dec.max()) > EX_SERVE_SLACK * float(e_pre.max())):
        fail(f"examples serve_demo: the decode loop's logits are "
             f"{float(e_dec.mean())}/{float(e_dec.max())} (mean/max) from "
             f"the f32 prefill's, the bf16 prefill's "
             f"{float(e_pre.mean())}/{float(e_pre.max())}")
    f32_gap = float((f32_loop - f32).abs().max())
    ulp_gap = float((f32_ulp - f32).abs().max())
    if f32_gap > EX_SERVE_ULP_FACTOR * ulp_gap:
        fail(f"examples serve_demo: at f32 compute the decode loop's "
             f"last-position logits differ from the prefill's by {f32_gap}, "
             f"over {EX_SERVE_ULP_FACTOR} times the {ulp_gap} that one ulp "
             f"on the input embeddings moves the prefill (largest |logit| "
             f"{scale})")
    res = {"arch": cfg.name, "params": n_params, "batch": B, "prompt": P,
           "gen": G, "prefill_s": out.prefill_s, "decode_s": out.decode_s,
           "decode_tokens_per_s": out.tokens_per_s,
           "median_step_ms": out.median_step_ms,
           "max_memory_allocated_gib": peak / 2**30,
           "bf16_prefill_vs_decode_max_abs": float(
               (bf16 - decode_bf16).abs().max()),
           "bf16_argmax_agree": float(
               (bf16.argmax(-1) == decode_bf16.argmax(-1)).float().mean()),
           "decode_vs_f32_mean_max": [float(e_dec.mean()),
                                      float(e_dec.max())],
           "prefill_vs_f32_mean_max": [float(e_pre.mean()),
                                       float(e_pre.max())],
           "f32_prefill_vs_decode_max_abs": f32_gap,
           "f32_prefill_one_ulp_max_abs": ulp_gap,
           "f32_max_abs_logit": scale, "profile": prof,
           "wall_s": run["wall_s"], "launches": run["launches"],
           "card": card}
    del kept, params, out, bf16, f32, decode_bf16, f32_loop, f32_ulp
    del e_dec, e_pre
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_examples(card: str, dev) -> dict:
    """The six port examples through their `main` (see the module
    docstring): each on the card first, then (a)-(d) and (e)'s ingest on
    the CPU, in parallel processes, whose output must equal the card's."""
    import re

    import torch
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    runs = {}
    # (a) quickstart, (b) service_demo, (c) cluster_demo, (d)
    # distributed_dedup at their defaults, clocks frozen
    with FrozenClocks():
        for name in EX_DEDUP:
            runs[name] = run_example(name, ["--device", dev.type])
    for name in ("quickstart", "service_demo", "cluster_demo"):
        require_launched(f"examples {name}", runs[name]["launches"],
                         ["minhash", "jaccard_cached"])
    want = {"minhash": 4, "jaccard_cached": 0, "jaccard_nocache": 0,
            "hamming": 0}
    if runs["distributed_dedup"]["launches"] != want:
        fail(f"examples distributed_dedup: launches "
             f"{runs['distributed_dedup']['launches']}, expected {want}")
    # (e) and (f)
    train = example_train(dev, card)
    srv = example_serve(dev, card)
    runs["train_dedup_lm"] = {"launches": train["launches"]}
    runs["serve_demo"] = {"launches": srv["launches"]}
    # the CPU side, in parallel processes: equal output, equal pulls
    t0 = time.perf_counter()
    jobs = {name: ("example", name) for name in EX_DEDUP}
    jobs["ingest"] = ("ingest", len(train["pulls"]))
    cpu = cpu_jobs(jobs)
    cpu_s = time.perf_counter() - t0
    for name in EX_DEDUP:
        got, ref = runs[name], cpu[name]
        if mask_clock(got["text"]) != mask_clock(ref["text"]):
            fail(f"examples {name}: the card's output differs from the "
                 f"CPU's:\n{got['text']}\n---\n{ref['text']}")
        if any(ref["launches"].values()):
            fail(f"examples {name}: the CPU run launched kernels: "
                 f"{ref['launches']}")
        got["cpu_wall_s"] = ref["wall_s"]
    if cpu["ingest"]["pulls"] != train["pulls"]:
        fail(f"examples train_dedup_lm: the card admitted {train['pulls']} "
             f"per pull, a CPU DedupIngest {cpu['ingest']['pulls']}")
    train["cpu_ingest_s"] = cpu["ingest"]["wall_s"]
    qs, sv, cl, dd = (runs[n] for n in EX_DEDUP)
    qs["docs_per_s"] = [float(x) for x in
                        re.findall(r"cycle \d+:\s+([\d.]+) docs/s", qs["text"])]
    qs["recall"], qs["fp"] = (float(x) for x in re.search(
        r"recall=([\d.]+) false-positive=([\d.]+)", qs["text"]).groups())
    sv["p99_batch_ms"] = [float(x) for x in
                          re.findall(r"p99_batch=\s*([\d.]+)ms", sv["text"])]
    dd["docs_per_s"] = [float(x) for x in
                        re.findall(r"\(\s*([\d.]+) docs/s\)", dd["text"])]
    dd["admitted"] = [int(x) for x in
                      re.findall(r"admitted\s+(\d+)/256", dd["text"])]
    for name in EX_DEDUP:
        r = {k: v for k, v in runs[name].items() if k != "text"}
        log(f"examples ({name}) " + json.dumps(dict(r, card=card)))
    log("examples (e) " + json.dumps(train))
    log("examples (f) " + json.dumps(srv))
    launch = lambda r: (f"K1 {r['launches']['minhash']}, K2 "  # noqa: E731
                        f"{r['launches']['jaccard_cached']}")
    log(f"examples (a) quickstart: docs/s {qs['docs_per_s']}, recall "
        f"{qs['recall']}, FP {qs['fp']}; {launch(qs)}; cuda = cpu; {card}")
    log(f"examples (b) service_demo: p99 batch ms after each wave "
        f"{sv['p99_batch_ms']}; {launch(sv)}; cuda = cpu; {card}")
    log(f"examples (c) cluster_demo: {launch(cl)}; cuda = cpu; {card}")
    log(f"examples (d) distributed_dedup: admitted {dd['admitted']}, docs/s "
        f"{dd['docs_per_s']}; {launch(dd)}; cuda = cpu; {card}")
    log(f"examples (e) train_dedup_lm: {train['config']} "
        f"({train['params']} params) at {train['batch']} x {train['seq']}, "
        f"{train['steps']} steps: loss {train['loss_first']:.3f} -> "
        f"{train['loss_last']:.3f}, median step "
        f"{train['median_step_ms']:.2f} ms "
        f"({train['step_tokens_per_s']:.0f} tokens/s; "
        f"{train['run_tokens_per_s']:.0f} with ingest), peak "
        f"{train['max_memory_allocated_gib']:.2f} GiB, dedup "
        f"{train['admitted']}/{train['docs_in']} (= a CPU DedupIngest, pull "
        f"by pull); {launch(train)} in {len(train['pulls'])} pulls; {card}")
    prof = srv["profile"]
    log(f"examples (f) serve_demo: {srv['arch']} at full width "
        f"({srv['params']:,} parameters), batch {srv['batch']}, prompt "
        f"{srv['prompt']}, gen {srv['gen']}: prefill {srv['prefill_s']:.2f} "
        f"s, {srv['decode_tokens_per_s']:.1f} tokens/s, median step "
        f"{srv['median_step_ms']:.2f} ms, peak "
        f"{srv['max_memory_allocated_gib']:.2f} GiB; a profiled step: "
        f"{prof['device_busy_ms']:.1f} ms busy, idle "
        f"{prof['device_idle_share']:.4f}, {prof['device_ops']} launches; "
        f"from an f32 prefill (mean/max): decode loop "
        f"{srv['decode_vs_f32_mean_max']}, bf16 prefill "
        f"{srv['prefill_vs_f32_mean_max']}; at f32 the decode loop is "
        f"{srv['f32_prefill_vs_decode_max_abs']:.3g} from the prefill, one "
        f"ulp on the embeddings moves it {srv['f32_prefill_one_ulp_max_abs']:.3g} "
        f"(largest |logit| {srv['f32_max_abs_logit']:.3g}); {card}")
    out = {"runs": runs, "train": train, "serve": srv, "cpu_s": cpu_s,
           "phase_s": time.perf_counter() - t_phase}
    log(f"examples: phase wall {out['phase_s']:.1f} s (the parallel CPU "
        f"runs {cpu_s:.1f} s); {card}")
    return out

def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")

    from repro_torch.data.corpus import DATASET_PRESETS, SyntheticCorpus
    from repro_torch.kernels import _lib
    dev = torch.device("cuda")
    card = gpu_name_power()
    log(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _lib.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for src, text in _lib.BUILD_LOG.items():
        for line in text.splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")

    # data: made in bulk before anything is timed
    corpus = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    pipe_batches = [corpus.next_batch(512)[:2] for _ in range(PIPE_BATCHES)]
    more_batches = [corpus.next_batch(512)[:2] for _ in range(5)]
    par_corpus = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    par_batches = [par_corpus.next_batch(256)[:2] for _ in range(4)]
    par_more = [par_corpus.next_batch(256)[:2] for _ in range(2)]
    svc_corpus = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    svc_chunks = ragged_chunks(svc_corpus, SERVICE_DOCS, seed=8)
    svc_fresh = svc_corpus.next_batch(128)[:2]
    depth_chunks = ragged_chunks(SyntheticCorpus(dataclasses.replace(
        DATASET_PRESETS["common_crawl"], seed=1)), DEPTH_DOCS, seed=9)
    rot_chunks = ragged_chunks(SyntheticCorpus(dataclasses.replace(
        DATASET_PRESETS["common_crawl"], seed=2)), ROTATION_DOCS, seed=10)
    cl_corpus = SyntheticCorpus(dataclasses.replace(
        DATASET_PRESETS["common_crawl"], seed=3))
    cl_chunks = ragged_chunks(cl_corpus, CLUSTER_DOCS, seed=11)
    probe = cl_corpus.next_batch(64)[:2]
    svc_shard_chunks = ragged_chunks(SyntheticCorpus(dataclasses.replace(
        DATASET_PRESETS["common_crawl"], seed=4)), SHARDED_SERVICE_DOCS,
        seed=12)

    tok, ln = pipe_batches[0]
    padded = np.zeros((tok.shape[0], 384), np.uint32)
    padded[:, :tok.shape[1]] = tok
    t0 = time.perf_counter()
    recs, extra = phase_kernels(dev, (padded, ln))
    log(f"kernel checks: all four equal their plain versions (max error 0); "
        f"phase wall {time.perf_counter() - t0:.1f} s")

    launches = {}
    t0 = time.perf_counter()
    launches["jaccard_nocache"], _ = phase_parity(par_batches, False, dev)
    _, parity_pipes = phase_parity(par_batches, True, dev)
    log(f"parity: phase wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res, main_launches, pipe, hnsw_keep = phase_pipeline(pipe_batches, card,
                                                         dev)
    launches["minhash"] = launches["jaccard_cached"] = main_launches
    log(f"pipeline: phase wall {time.perf_counter() - t0:.1f} s")

    from repro_torch.kernels import ops
    bitmaps = extra["bitmaps"]
    _lib.reset_launches()
    sim = ops.hamming(bitmaps, bitmaps)
    torch.cuda.synchronize()
    launches["hamming"] = dict(_lib.LAUNCHES)
    if sim.shape != (bitmaps.shape[0],) * 2 or not torch.isfinite(sim).all():
        fail("ops.hamming gave a bad matrix")

    # phase 12 (b) runs on a copy of phase 3's final state
    from repro_torch.core.hnsw import HNSWState
    main_state = HNSWState(*(t.clone() for t in pipe.state))

    _, brute = phase_reference(pipe_batches, hnsw_keep, par_batches, dev)
    phase_options(par_batches, dev)
    phase_lifecycle(pipe, more_batches, parity_pipes, par_more, dev)
    del pipe, parity_pipes
    svc = phase_service(svc_chunks, svc_fresh, depth_chunks, rot_chunks,
                        card, dev)
    clu = phase_cluster(cl_chunks, probe, card, dev)
    base = phase_baselines(pipe_batches, brute["tau_0.7"], par_batches,
                           par_more, card, dev)
    shard = phase_sharded(pipe_batches, hnsw_keep, brute["tau_matched"],
                          par_batches, svc_shard_chunks, card, dev)
    prog = phase_programs(main_state, pipe_batches[-1], more_batches[-1],
                          res["profile"], card, dev)
    del main_state
    lm = phase_lm_serve(card, dev)
    train = phase_lm_train(card, dev)
    mesh = phase_lm_train_mesh(card, dev, train["full"])
    examples = phase_examples(card, dev)

    paths = {"minhash": "FoldPipeline(FoldConfig(capacity=2**20)).process_batch",
             "jaccard_cached": "FoldPipeline(FoldConfig(capacity=2**20)).process_batch",
             "jaccard_nocache": "FoldPipeline(FoldConfig(cached=False)).process_batch",
             "hamming": "ops.hamming"}
    for r in recs:
        r["launches"] = launches[r["name"]][r["name"]]
        r["path"] = paths[r["name"]]
        if r["launches"] <= 0:
            fail(f"kernel {r['name']} was not launched on its path")
        if r["name"] in ("minhash", "jaccard_cached"):
            r["path_launches"] = {
                "pipeline": r["launches"],
                "service": svc["main"]["launches"][r["name"]],
                "cluster": clu["launches"][r["name"]]}
        if r["name"] == "minhash":
            r["path_launches"].update({
                f"baselines/{tag}": run["launches"]["minhash"]
                for tag, run in base["runs"].items()
                if run["key"] != "prefix_filter"})
        # hnsw_sharded: K1 once per batch; its in-batch matrix is the plain
        # pairwise product, as in the reference, so K2-K4 never run there
        r.setdefault("path_launches", {})["sharded"] = \
            shard["main"]["launches"].get(r["name"], 0)
        # the analyzed hot-path programs (phase 12) reach no kernel
        r["path_launches"]["programs"] = prog["launches"].get(r["name"], 0)
        # the LM serving path (phase 13) reaches no kernel
        r["path_launches"]["lm_serve"] = lm["launches"].get(r["name"], 0)
        # the LM training path (phase 14): K1 and K2 in its ingest
        r["path_launches"]["lm_train"] = train["launches"].get(r["name"], 0)
        # meshed training (phase 15): K1 and K2 in its ingest
        r["path_launches"]["lm_train_mesh"] = mesh["launches"].get(
            r["name"], 0)
        # the six examples (phase 16): K1 and K2 where they dedup on the
        # main path, K1 alone in the sharded step, none in LM serving
        for tag, run in examples["runs"].items():
            r["path_launches"][f"examples/{tag}"] = run["launches"].get(
                r["name"], 0)
    log(json.dumps({"kernels": recs, "card": card}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
