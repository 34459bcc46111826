"""Render the dry run's tables from experiments/dryrun_torch/*.json: the
port of ``repro/launch/report.py``.

  PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..configs import ARCHS, SHAPES, shape_applicable

FIX_NOTES = {
    "compute": "raise arithmetic intensity: bigger per-device tiles / fewer"
               " remat recomputes; split the row's compute over 'model'",
    "memory": "fuse/bridge HBM round-trips: larger attention chunks, fused"
              " CE, fewer eager materializations",
    "collective": "cut gather volume: ZeRO-1 instead of per-microbatch FSDP"
                  " regather; overlap collectives with compute",
}


def load(dirpath: Path):
    cells = {}
    for p in sorted(dirpath.glob("*.json")):
        with open(p) as f:
            r = json.load(f)
        cells[(r["arch"], r["shape"], r["mesh"])] = r
    return cells


def fmt_table(cells, mesh="single"):
    hdr = ("| arch | shape | compute(ms) | memory(ms) | collective(ms) | "
           "bottleneck | useful | peak GiB/dev |")
    sep = "|" + "---|" * 8
    lines = [hdr, sep]
    for a in ARCHS:
        for s in SHAPES:
            ok, why = shape_applicable(a, s)
            if not ok:
                lines.append(f"| {a} | {s} | — | — | — | SKIP: {why} | — | — |")
                continue
            r = cells.get((a, s, mesh))
            if r is None:
                lines.append(f"| {a} | {s} | (missing) | | | | | |")
                continue
            lines.append(
                f"| {a} | {s} | {r['compute_s']*1e3:.1f} | "
                f"{r['memory_s']*1e3:.1f} | {r['collective_s']*1e3:.1f} | "
                f"{r['bottleneck']} | {r['useful_ratio']:.2f} | "
                f"{r['peak_memory_bytes']/2**30:.1f} |")
    return "\n".join(lines)


def fmt_details(cells, mesh="single"):
    out = []
    for a in ARCHS:
        for s in SHAPES:
            r = cells.get((a, s, mesh))
            if r is None:
                continue
            colls = {k: v for k, v in r["collectives"].items() if v}
            out.append(
                f"- **{a} × {s}**: bottleneck={r['bottleneck']}; "
                f"flops/dev={r['hlo_flops']:.2e}, bytes/dev="
                f"{r['hlo_bytes']:.2e}, coll/dev={r['collective_bytes']:.2e} "
                f"({colls}); MODEL_FLOPS/flops={r['useful_ratio']:.2f}; "
                f"walked: one entry of a row of "
                f"{r.get('row_entries', 1)} entries; "
                f"fix: {FIX_NOTES[r['bottleneck']]}.")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--details", action="store_true")
    args = ap.parse_args(argv)
    cells = load(Path(args.dir))
    print(fmt_table(cells, args.mesh))
    if args.details:
        print()
        print(fmt_details(cells, args.mesh))


if __name__ == "__main__":
    main()
