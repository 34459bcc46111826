"""The ``[train]`` phase alone, run after run in one process on the card.

Runs ``chip_smoke.phase_train`` (the training CLI's restart, the four
block families card == CPU, yi-9b at full width) ``--runs`` times and
prints the phase's lines, then one JSON line: for each run, the phase's
seconds, the CLI's seconds and each check's CPU step seconds.

    python tools/train_phase_times.py [--runs 2]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
from chip_smoke import phase_train  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    import torch

    from repro_torch.kernels import ops
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    runs = []
    for _ in range(args.runs):
        out = phase_train(torch, ops, torch.device("cuda"), smi,
                          lambda msg: print(msg, flush=True))
        runs.append({"phase_s": out["phase_s"], "cli_s": out["cli"]["s"],
                     "cpu_s": {a: r["cpu_s"]
                               for a, r in out["checks"].items()}})
    print(json.dumps({"device": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
