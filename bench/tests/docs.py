"""The benchmark documents the tests run: ``BENCHMARK.json``, and with it
the cells held out in ``bench/staged/``, whose files the tests keep
working so that a later change can put them back by their entries."""
from __future__ import annotations

from bench import harness

PARTS = ("configs", "workloads", "end_to_end", "per_layer")


def bench_doc() -> dict:
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def full_doc() -> dict:
    doc = bench_doc()
    for path in sorted((harness.BENCH / "staged").glob("*.json")):
        part = harness.load_json(path)
        for key in PARTS:
            doc[key] += part[key]
    return doc
