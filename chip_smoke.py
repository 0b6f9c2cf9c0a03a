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

# published H100 SXM peaks (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer ALU ops: a quarter of the 67 TFLOP/s float32 figure
# (64 INT32 lanes per SM per clock instead of 128 FP32 lanes, no FMA pair)
INT32_OPS_PER_S = 67e12 / 4
# population count issues at 16 per SM per clock (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0)
POPC_PER_SM_CLOCK = 16


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
    return res, launches, pipe, np.concatenate(keeps)


def device_profile(fn, name: str) -> tuple[dict, object]:
    """Run fn() once under torch.profiler: its wall time (the profiler's
    own cost included), the device busy time from the trace's kernel,
    memcpy and memset events, their count, and the costliest kernels and
    runtime calls. The trace goes to build/profile/<name>.json and is read
    back. Returns (that record, fn's result)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(PROFILE_DIR, exist_ok=True)
    path = os.path.join(PROFILE_DIR, f"{name}.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, runtime = {}, {}
    for e in events:
        cat, ev, dur = e.get("cat"), e.get("name", ""), e.get("dur", 0)
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            n, t = dev.get(ev, (0, 0.0))
            dev[ev] = (n + 1, t + dur)
        elif cat == "cuda_runtime":
            n, t = runtime.get(ev, (0, 0.0))
            runtime[ev] = (n + 1, t + dur)
    busy_ms = sum(t for _, t in dev.values()) / 1e3

    def top(d, n):
        rows = sorted(d.items(), key=lambda kv: -kv[1][1])[:n]
        return [{"name": k[:80], "count": c, "ms": t / 1e3} for k, (c, t) in rows]

    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_ops": sum(c for c, _ in dev.values()),
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
    log(json.dumps({"kernels": recs, "card": card}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
