"""Training CLI: synthetic-data LM training with checkpoint/restart —
the port of ``repro/launch/train.py``.

Fault tolerance: periodic atomic checkpoints + --resume; the data
pipeline is stateless in (seed, step, shard), so a restarted run
reproduces the exact batch sequence. Runs on the card unless --device
names another.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \
      --steps 100 --batch 8 --seq 128 --ckpt-dir DIR [--resume] \
      [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data.lm_data import (LMDataConfig, batch_generator, dedup_corpus,
                            lm_batches, synth_corpus)
from ..train import AdamWConfig, TrainConfig, init_train_state, make_train_step
from ..util import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--dedup", action="store_true",
                    help="run the ScalLoPS LSH dedup stage on a probe corpus "
                         "before training (the paper's technique in the "
                         "data plane)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    dc = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)

    if args.dedup:
        docs, lens = synth_corpus(dc, n_docs=256, dup_fraction=0.1)
        keep, n_dups = dedup_corpus(docs, lens, device=dev)
        print(f"[dedup] ScalLoPS SimHash stage: {n_dups} near-duplicates "
              f"dropped of {len(keep)} docs")

    tc = TrainConfig(
        n_microbatches=args.microbatches,
        opt=AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                        total_steps=args.steps))
    step_fn = make_train_step(cfg, tc)
    state = init_train_state(torch.Generator(device=dev).manual_seed(
        args.seed), cfg, dev)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if args.resume and mgr is not None and mgr.latest_step() is not None:
        tree, start = mgr.restore(state.tree())
        state.load_tree(tree)
        print(f"[resume] restored step {start}")

    t0 = time.time()
    for s in range(start, args.steps):
        x, y = lm_batches(dc, s, device=dev)
        if cfg.embedding_inputs:
            inputs = torch.randn(
                (x.shape[0], x.shape[1], cfg.d_model),
                generator=batch_generator(args.seed ^ 7, s)).to(dev)
        else:
            inputs = x
        state, metrics = step_fn(state, {"inputs": inputs, "targets": y})
        if s % 10 == 0 or s == args.steps - 1:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.time() - t0
            tok_s = (s - start + 1) * args.batch * args.seq / max(dt, 1e-9)
            print(f"step {s:5d} loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"tok/s={tok_s:.0f}")
        if mgr is not None and (s + 1) % args.ckpt_every == 0:
            mgr.save(s + 1, state.tree())
    if mgr is not None:
        mgr.save(args.steps, state.tree())
    print("done.")
    return state


if __name__ == "__main__":
    main()
