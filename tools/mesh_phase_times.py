"""The ``[mesh]`` and ``[dryrun]`` phases alone on the card, with what
they compare against.

Serves yi-9b unsharded as ``[lm]`` does (its weights, prompt and greedy
ids), trains yi-9b at full width as ``[train]`` does (its step times),
then runs ``chip_smoke.phase_mesh`` and, unless ``--no-dryrun``, the
``[dryrun]`` walks after it (``chip_smoke.phase_dryrun``), and prints
their lines and one JSON line: the phase's seconds and its serving (with
the bf16 class), decode-check, training-check, restore and training
numbers, and the dry run's.

    python tools/mesh_phase_times.py [--no-dryrun]
    python tools/mesh_phase_times.py --recurrent

``--recurrent`` runs only ``[mesh]``'s recurrent checks
(``chip_smoke._mesh_recurrent_checks``: recurrentgemma-2b and xlstm-1.3b
at full width, fp32, on (2, 2) and (1, 4) against the unsharded card)
and prints their lines and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-dryrun", action="store_true",
                    help="skip the [dryrun] walks (minutes of host time)")
    ap.add_argument("--recurrent", action="store_true",
                    help="only [mesh]'s recurrent checks")
    args = ap.parse_args()
    import torch

    from repro_torch.kernels import ops

    def log(msg):
        print(msg, flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    if args.recurrent:
        t0 = time.perf_counter()
        out = smoke._mesh_recurrent_checks(torch, dev, log)
        print(json.dumps({"device": smi, "s": time.perf_counter() - t0,
                          "recurrent": out}))
        return 0
    lm = {"serve": smoke._lm_serve(torch, dev, smi, log)}
    train = {"run": smoke._train_full_width(torch, dev, smi, log)}
    out = smoke.phase_mesh(torch, ops, dev, smi, lm, train, log)
    if not args.no_dryrun:      # the walks after the card's phases here
        out["dryrun"] = smoke.phase_dryrun(smoke._dryrun_start(), None,
                                           out["run"], smi, log)
    print(json.dumps({"device": smi, **{k: out[k] for k in (
        "phase_s", "serve", "decode", "checks", "recurrent", "restore", "run",
        "dryrun") if k in out}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
