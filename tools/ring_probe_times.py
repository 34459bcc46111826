"""Per-batch times of the sharded ring probe against ``topk_probe``.

Builds the serving smoke's Swiss-Prot-scale index on the card (454,401
synthetic refs of the paper's mean length, seed 0; ``LSHConfig(k=3,
T=13, f=32, d=1, scheme="splitmix")``) and its 256 queries, then times,
per 64-query batch, ``topk_probe`` and ``ShardedIndex.topk`` at 1, 2 and 4
shards on the one card, each at the cap grow-and-retry settles on. Every
ring result is checked equal to ``topk_probe``'s first. For each it also
gives the card's busy ms a batch from ``torch.profiler`` (the union of
the kernel and copy intervals over one pass). The timing and the
profile are ``chip_smoke.py``'s own, as its ``[shard]`` phase runs them.

    python tools/ring_probe_times.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so two trees can be compared in one session
on one card. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (SHARD_PASSES, _device_busy_ms,  # noqa: E402
                        _sharded_ms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    from repro_torch.configs.scallops import DATASETS
    from repro_torch.core.pipeline import LSHConfig
    from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                            make_protein_sets)
    from repro_torch.index import ShardedIndex, SignatureIndex, topk_probe

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    sp = DATASETS["swissprot"]
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=sp["n"], ref_len_mean=sp["avg_len"], ref_len_std=80,
        n_homolog_queries=128, n_decoy_queries=128, seed=0))
    cfg = LSHConfig(k=3, T=13, f=32, d=1, scheme="splitmix")
    index = SignatureIndex.build(cfg, data["ref_ids"], data["ref_lens"],
                                 device=dev)
    q = index._pipeline.signatures(data["query_ids"], data["query_lens"])
    batch, k = 64, 10
    cap = max(topk_probe(index, q[i:i + batch], k=k, cap=32)[2]
              for i in range(0, q.shape[0], batch))

    def probe(x):
        r = topk_probe(index, x, k=k, cap=cap)
        return r[0].cpu().numpy(), r[1].cpu().numpy(), r[2], r[3]

    runs = {"unsharded": probe}
    for n in (1, 2, 4):
        sh = ShardedIndex(index, [dev] * n)
        for i in range(0, q.shape[0], batch):
            got, want = sh.topk(q[i:i + batch], k=k, cap=cap), \
                probe(q[i:i + batch])
            if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"n_shards={n}: the ring differs from "
                                     f"topk_probe")
        runs[str(n)] = (lambda s: lambda x: s.topk(x, k=k, cap=cap))(sh)
    out = {"label": args.label, "cap": cap, "batch": batch,
           "device": torch.cuda.get_device_name(0)}
    for name, fn in runs.items():
        ms = _sharded_ms(torch, fn, q, batch, SHARD_PASSES)
        busy = _device_busy_ms(torch, fn, q, batch)
        out[name] = {"p50": float(np.percentile(ms, 50)),
                     "p95": float(np.percentile(ms, 95)),
                     "mean": float(ms.mean()), "busy_ms": busy,
                     "busy_share": None if busy is None
                     else busy / float(ms.mean())}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
