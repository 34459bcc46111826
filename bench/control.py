"""Read a cell's compared numbers on several seeds in one process: the
program's (``--side program``) or the control's (``--side control``: the
reference put in the program's place with one stated guarantee broken,
which has to come out not correct). The benchmark's own runs never run
the control.

    python3 bench/control.py --workload <cell> --side control \\
        --seconds 3 --seeds 11 12 13

One JSON line a seed: the workload, the seed, ``correct`` and ``compared``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "control"), required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    from bench import harness
    for seed in args.seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             t_start=time.perf_counter(),
                             control=args.side == "control",
                             log=lambda m: print(m, file=sys.stderr))
        print(json.dumps({"workload": args.workload, "side": args.side,
                          "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"],
                          "compared": r["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
