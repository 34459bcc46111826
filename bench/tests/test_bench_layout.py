"""The benchmark is driven by data: every cell resolves to its files by
name, new files are found without editing old ones, the harness keeps to
its contract's shape, and nothing under ``bench/`` loads JAX or the JAX
package."""
from __future__ import annotations

import ast
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness
from bench.tests.docs import bench_doc, full_doc

ROOT = harness.ROOT
BENCH = harness.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.mark.parametrize("cell",
                         [c["name"] for c in full_doc()["workloads"]])
def test_cell_resolves_to_its_files(cell):
    doc = full_doc()
    entry, config, traffic, e2e, layer = harness.resolve(doc, cell)
    harness.load_module("drivers", config["driver"])
    assert callable(harness.load_module("generators",
                                        traffic["generator"]).query_sets)
    assert callable(harness.load_module("loops", traffic["loop"]).run)
    for m in e2e + layer:
        assert callable(harness.load_module("metrics", m["name"]).read)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer, "every cell reports a per-layer metric"
    assert entry["chips"] == 1


@pytest.mark.parametrize("load", [bench_doc, full_doc],
                         ids=["benchmark", "with_staged"])
def test_contract_shape(load):
    doc = load()
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert doc["paths"] == ["bench"] and doc["command"][1] == "bench/run.py"
    assert 1 <= doc["run_seconds"] <= 51
    cfg_names = {c["name"] for c in doc["configs"]}
    used = {w["config"] for w in doc["workloads"]}
    assert used == cfg_names
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert NAME.match(c["name"]) and len(c["source"]) <= 200
    pairs = set()
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    for m in doc["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in doc["workloads"]}
    for m in doc["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads",
                                                    m["workloads"]))
    assert len(json.dumps(doc)) < 64 * 1024


def _digest(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


PACED_LOOP = """\
import time

from bench.harness import Record

CALLS = []


def run(drv, plan, seconds, *, start=0, min_calls=1, traced=False):
    records, i, t_begin = [], start, time.perf_counter()
    while True:
        spec = plan[i % len(plan)]
        i += 1
        time.sleep(0.001)               # the client's think time
        t0 = time.perf_counter()
        out = drv.call(spec)
        records.append(Record(spec, out, t0, time.perf_counter(),
                              drv.after_call() if traced else {}))
        CALLS.append(i)
        if records[-1].t1 - t_begin >= seconds and len(records) >= min_calls:
            return records, 0, i
"""

DECOY_GENERATOR = """\
from bench import gen
from bench.deploy import Queries


def query_sets(traffic, ref_ids, ref_lens, seed, device):
    spec = traffic["queries"]
    out = []
    for s in range(traffic["n_sets"]):
        g = gen.generator(seed, 1 + s, device)
        L = gen.lengths(spec["n"], spec["len_mean"], spec["len_sd"],
                        lo=spec["min_len"], hi=spec["max_len"],
                        length_seed=spec["length_seed"], order=g,
                        device=device)
        ids = gen.pad_past(gen.residues(spec["n"], int(L.max()), g, device), L)
        out.append(Queries(ids.cpu().numpy(), L.int().cpu().numpy()))
    return out
"""


def test_new_files_are_found_without_editing_old_ones(tmp_path):
    bench_dir = tmp_path / "bench"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(bench_dir)
    doc = bench_doc()
    # a new configuration, traffic mix (with a generator and a loop of its
    # own) and metric, each a file of its own
    cfg = harness.load_json(BENCH / "configs" / "swissprot-topk.json")
    cfg["name"] = "swissprot-topk-k5"
    cfg["serving"]["k"] = 5
    (bench_dir / "configs" / "swissprot-topk-k5.json").write_text(
        json.dumps(cfg))
    mix = harness.load_json(BENCH / "traffic" / "reads-b512.json")
    mix.update(batch=256, loop="paced", generator="decoys")
    mix["queries"]["homolog_share"] = 0.0
    (bench_dir / "traffic" / "decoys-paced.json").write_text(json.dumps(mix))
    (bench_dir / "loops" / "paced.py").write_text(PACED_LOOP)
    (bench_dir / "generators" / "decoys.py").write_text(DECOY_GENERATOR)
    (bench_dir / "metrics" / "topk_batch_p50_ms.py").write_text(
        "from bench.readers import latency_ms\n\n\n"
        "def read(ctx):\n    return latency_ms(ctx, 50)\n")
    cell = "swissprot-topk-k5.decoys-paced"
    doc["configs"].append({"name": "swissprot-topk-k5", "source": "x",
                           "file": "bench/configs/swissprot-topk-k5.json",
                           "reduced": [], "why": "x"})
    doc["workloads"].append({"name": cell, "config": "swissprot-topk-k5",
                             "traffic": "decoys-paced", "chips": 1,
                             "why": "x"})
    doc["end_to_end"].append({"name": "topk_batch_p50_ms", "unit": "ms",
                              "better": "lower", "bound": 0.05,
                              "source": "host_clock", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    entry, config, traffic, e2e, _ = harness.resolve(doc, cell, bench_dir)
    assert config["serving"]["k"] == 5 and traffic["batch"] == 256
    assert "topk_batch_p50_ms" in {m["name"] for m in e2e}
    # a tiny run on the CPU goes through the new loop and generator
    r = harness.run_cell(
        cell, 2**31 + 3, 0.2, False, t_start=0.0, device="cpu",
        bench_dir=bench_dir, log=lambda m: None,
        scale={"config.refs.n": 3000, "traffic.queries.n": 300,
               "traffic.n_sets": 1, "traffic.warmup_calls": 1})
    assert sys.modules["_bench_loops_paced"].CALLS
    assert r["correct"] is True and "topk_batch_p50_ms" in r["metrics"]
    after = _digest(bench_dir)
    assert {k: after[k] for k in before} == before


def test_a_loop_without_its_file_is_refused(tmp_path):
    bench_dir = tmp_path / "bench"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = harness.load_json(bench_dir / "traffic" / "reads-d1.json")
    mix["loop"] = "open"
    (bench_dir / "traffic" / "reads-d1.json").write_text(json.dumps(mix))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    with pytest.raises(FileNotFoundError, match="loops"):
        harness.run_cell("swissprot-pairdump.reads-d1", 5, 0.1, False,
                         t_start=0.0, device="cpu", bench_dir=bench_dir,
                         log=lambda m: None)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_under_bench_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for path in files:
        assert not _imports(path) & set(harness.FORBIDDEN), path
        if "tests" not in path.parts:
            assert "benchmarks" not in path.read_text(), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro", sys)
    assert harness.forbidden_modules() == ["repro"]


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "swissprot-pairdump.reads-d1", "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "swissprot-pairdump.reads-d1", "--seed", "3", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
