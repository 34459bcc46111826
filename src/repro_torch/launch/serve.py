"""LM serving driver: batched prefill + greedy decode with a KV/recurrent
cache — the port of ``repro/launch/serve.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
      --smoke --batch 2 --prompt-len 16 --gen 16 [--device cpu]

Everything runs on the CUDA card unless ``--device`` names another
device; without a card and without ``--device cpu`` it raises. Weights
and the prompt are drawn from ``--seed`` with a ``torch.Generator`` on
that device (torch's numbers, not the reference's). The decode loop is
eager; each timed phase ends in a device sync, so the printed times are
the device's.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, get_smoke_config, shape_applicable
from ..models import decode_step, init_cache, init_params, prefill
from ..util import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model, prompt, gen: int):
    """Prefill ``prompt`` (B, P), then ``gen - 1`` greedy decode steps.
    Returns (ids (B, gen) numpy, the last step's logits (B, V) fp32,
    prefill seconds, decode seconds)."""
    dev = prompt.device
    B, P = prompt.shape
    cache = init_cache(model.cfg, B, max_len=P + gen, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(model, prompt, cache)
    tok = torch.argmax(logits, -1)[:, None]
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode_step(model, cache, tok, P + i)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return torch.cat(out, dim=1).cpu().numpy(), logits, prefill_s, decode_s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    ok, why = shape_applicable(args.arch, "decode_32k")
    if not ok:
        raise SystemExit(f"{args.arch} has no decode step: {why}")
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = init_params(cfg, gen, dev)
    B, P, G = args.batch, args.prompt_len, args.gen
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)
    ids, _, prefill_s, decode_s = generate(model, prompt, G)
    print(f"[prefill] {B}x{P} in {prefill_s:.2f}s")
    print(f"[decode] {G-1} steps in {decode_s:.2f}s "
          f"({B*(G-1)/max(decode_s,1e-9):.1f} tok/s)")
    print("generated token ids:\n", ids)
    return ids


if __name__ == "__main__":
    main()
