"""End-to-end driver on the PyTorch/CUDA port: FOLD-cleaned corpus ->
~100M-param LM training (port of examples/train_dedup_lm.py).

On a card:  python examples/train_dedup_lm_torch.py --steps 300 --batch 64
On the CPU (smoke): python examples/train_dedup_lm_torch.py --tiny --device cpu

The model is a 124M GPT-class decoder (12L x 768d, vocab 32k); documents
flow through the FOLD dedup stage (MinHash and the in-batch Jaccard on
their CUDA kernels on the card) before packing — the paper's system in its
intended role as the corpus-construction layer of a training run. The
train step runs eagerly: the reference's `jax.jit` has no counterpart
here. With no `--device` it runs on the card and raises without one.
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import dataclasses
import time

import torch

from repro_torch.core.dedup import FoldConfig
from repro_torch.data import DATASET_PRESETS, DedupIngest, PackedBatches, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params, tree_size
from repro_torch.models.config import ModelConfig
from repro_torch.train import OptConfig, make_train_step, opt_init


def main(argv=None):
    ap = argparse.ArgumentParser(prog="examples/train_dedup_lm_torch.py")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true",
                    help="2L/128d smoke config for CPU")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.tiny:
        cfg = ModelConfig(name="demo-2m", family="dense", n_layers=2,
                          d_model=128, n_heads=4, n_kv_heads=4, d_ff=512,
                          vocab=32000, q_chunk=64, kv_chunk=64)
        args.steps = min(args.steps, 30)
    else:
        cfg = ModelConfig(name="demo-124m", family="dense", n_layers=12,
                          d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
                          vocab=32000)

    # corpus token ids must stay inside the model vocab
    corpus_cfg = dataclasses.replace(DATASET_PRESETS["c4"], vocab=cfg.vocab)
    src = SyntheticCorpus(corpus_cfg)
    ingest = DedupIngest(src, FoldConfig(capacity=1 << 15, ef_construction=48,
                                         ef_search=48,
                                         threshold_space="minhash"),
                         device=device)
    packer = PackedBatches(batch=args.batch, seq_len=args.seq + 1)

    params = init_params(T.param_specs(cfg),
                         torch.Generator(device).manual_seed(0), device)
    print(f"model: {tree_size(params)/1e6:.1f}M params")
    oc = OptConfig(lr=3e-4, warmup_steps=20, decay_steps=args.steps)
    opt = opt_init(params, oc)
    step = make_train_step(cfg, oc)

    def on_device(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    t0 = time.time()
    losses = []
    for i in range(args.steps):
        b = packer.pop_batch()
        while b is None:
            toks, lens, _ = ingest.next_clean_batch(256)
            packer.add_docs(toks, lens)
            b = packer.pop_batch()
        tokens, mask = b
        batch = {"tokens": on_device(tokens[:, :-1], torch.int64),
                 "labels": on_device(tokens[:, 1:], torch.int64),
                 "loss_mask": on_device(mask[:, 1:], torch.float32)}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        if i % 10 == 0:
            print(f"step {i:4d} loss {losses[-1]:.3f} "
                  f"({args.batch*args.seq*(i+1)/(time.time()-t0):.0f} tok/s)")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"dedup admitted {ingest.total_admitted}/{ingest.total_in}")


if __name__ == "__main__":
    main()
