"""The benchmark's harness: finds a cell's files by name, runs its window,
reads its metrics, judges its answers and builds the result line.

Everything that belongs to one configuration, traffic mix or metric lives
in files of its own, found from the names in ``BENCHMARK.json``:

* ``bench/configs/<config>.json``: a deployment; its ``driver`` key names
  ``bench/drivers/<driver>.py``, the code that sets the deployment up,
  makes one timed call and judges the answers against ``bench/reference``;
* ``bench/traffic/<traffic>.json``: the parameters of a traffic mix; its
  ``generator`` key names ``bench/generators/<generator>.py``, which makes
  the mix's query sets from them, and its ``loop`` key names
  ``bench/loops/<loop>.py``, which sends the calls in the window;
* ``bench/metrics/<metric>.py``: one metric's reader, ``read(ctx)``, which
  returns a number or None when it finds nothing to read.

A later change adds a cell by adding such files and entries, and edits
none of these.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level names
PROFILE_SECONDS = 1.0   # the profiled stretch after a traced window
PROFILE_MIN_CALLS = 3
BREAKDOWN_ROWS = 10
ANNOTATION = "bench.call"   # the profiler's range around each call


class NoDevice(RuntimeError):
    """The cell asks for cards this machine does not have."""


@dataclass
class Record:
    spec: object
    out: object
    t0: float
    t1: float
    info: dict = field(default_factory=dict)


def load_json(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str, bench_dir: Path = BENCH):
    """``bench/<kind>/<name>.py`` as a module of its own."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"_bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, cell_name: str, bench_dir: Path = BENCH):
    """The cell's entry, its configuration document, its traffic document
    and its metrics (end to end, per layer), all by name."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = load_json(bench_dir.parent / cfgs[cell["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")

    def mine(metric):
        return cell_name in metric.get("workloads", [cell_name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    layer = [m for m in bench["per_layer"] if mine(m)]
    return cell, config, traffic, e2e, layer


def override(doc: dict, changes: dict | None, prefix: str) -> dict:
    """A copy of ``doc`` with ``{"<prefix>.a.b": value}`` entries set (the
    small sizes of the CPU tests)."""
    doc = json.loads(json.dumps(doc))
    for key, value in (changes or {}).items():
        head, *path = key.split(".")
        if head != prefix:
            continue
        node = doc
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = value
    return doc


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device) -> None:
    import torch
    if getattr(device, "type", str(device)).startswith("cuda"):
        torch.cuda.synchronize(device)


def profile_stretch(drv, loop, plan, position: int, device):
    """The plan's next calls for PROFILE_SECONDS under torch.profiler, sent
    by the traffic's loop. Returns (records, device summary or None,
    failed)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    class Annotated:
        def call(self, spec):
            with record_function(ANNOTATION):
                return drv.call(spec)

    _sync(device)
    with profile(activities=acts) as prof:
        records, failed, _ = loop.run(Annotated(), plan, PROFILE_SECONDS,
                                      start=position,
                                      min_calls=PROFILE_MIN_CALLS)
        _sync(device)
    wall = records[-1].t1 - records[0].t0
    dev, cpu = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CPU:
            cpu.append(span)
        elif e.name != ANNOTATION:      # the call's own range is no op
            dev.append(span)
    return records, summarize(dev, cpu, wall), failed


def _merge(intervals):
    out = []
    for a, b in sorted((a, b) for _, a, b in intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_label(cpu_sorted, starts, m) -> str:
    """The innermost host operation running at time ``m`` (us)."""
    j = int(np.searchsorted(starts, m, side="right")) - 1
    for _ in range(4096):
        if j < 0:
            break
        name, a, b = cpu_sorted[j]
        if b >= m:
            return "python between operations" if name == ANNOTATION \
                else name
        j -= 1
    return "outside any call"


def summarize(dev, cpu, wall_s):
    """Device busy seconds (the union of kernels and copies), the traced
    window, the device operations by time and the idle gaps by what the
    host was doing; None when the trace holds no device operation."""
    if not dev:
        return None
    merged = _merge(dev)
    busy = sum(b - a for a, b in merged) / 1e6
    by_op: dict[str, float] = {}
    for name, a, b in dev:
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
    cpu_sorted = sorted(cpu, key=lambda e: e[1])
    starts = np.asarray([e[1] for e in cpu_sorted], dtype=np.float64)
    by_gap: dict[str, float] = {}
    for (_, b0), (a1, _) in zip(merged, merged[1:]):
        label = _host_label(cpu_sorted, starts, (b0 + a1) / 2)
        by_gap[label] = by_gap.get(label, 0.0) + (a1 - b0) / 1e6

    def top(d):
        return [[k[:160], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ROWS]]

    return SimpleNamespace(busy_s=busy, window_s=wall_s, ops=dev,
                           device_ops=top(by_op), idle_gaps=top(by_gap))


def window_quarters(records, t_window: float, window_s: float) -> list:
    """Calls finished in each quarter of the window: a slow stretch shows
    as one low quarter, a slow process as four."""
    q = [0, 0, 0, 0]
    for r in records:
        q[min(3, int(4 * (r.t1 - t_window) / window_s))] += 1
    return q


def device_info(device, count: int) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device=None, scale: dict | None = None,
             control: bool = False, min_calls: int = 1, bench_dir=BENCH,
             doc: dict | None = None, log=print):
    """One run of one cell of ``doc`` (by default ``BENCHMARK.json``).
    Returns the result dict (its keys in the order the result line prints
    them, ``compared`` last)."""
    import torch

    bench = doc or load_json(bench_dir.parent / "BENCHMARK.json")
    cell, config, traffic, e2e, layer = resolve(bench, cell_name, bench_dir)
    config = override(config, scale, "config")
    traffic = override(traffic, scale, "traffic")
    if device is None:
        if not torch.cuda.is_available():
            raise NoDevice("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"{torch.cuda.device_count()} cards, the cell "
                           f"asks for {cell['chips']}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    t_imports = time.perf_counter()
    drivers = load_module("drivers", config["driver"], bench_dir)
    generator = load_module("generators", traffic["generator"], bench_dir)
    loop = load_module("loops", traffic["loop"], bench_dir)
    drv = drivers.Driver(config, traffic, generator, seed, device,
                         control=control)
    plan = drv.plan()
    _sync(device)
    t_built = time.perf_counter()
    drv.warmup(plan)
    _sync(device)
    # what set-up made lives on: no collection in the window walks it again
    gc.collect()
    gc.freeze()
    log(f"set-up: start to the card {t_imports - t_start:.3f} s, the "
        f"deployment and its traffic {t_built - t_imports:.3f} s, the warm-up "
        f"{time.perf_counter() - t_built:.3f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        drv.trace_on()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    records, failed, pos = loop.run(drv, plan, seconds, min_calls=min_calls,
                                    traced=trace)
    window_s = records[-1].t1 - t_window
    log(f"calls a quarter of the window: "
        f"{window_quarters(records, t_window, window_s)}")
    spans = drv.trace_off() if trace else []
    profiled, dev_summary = [], None
    if trace:
        profiled, dev_summary, more = profile_stretch(drv, loop, plan, pos,
                                                      device)
        failed += more
    log(f"{cell_name}: {drv.describe()}")
    found = forbidden_modules()
    if found:
        raise ImportError(f"the run loaded {', '.join(found)}")
    info = device_info(device, cell["chips"])
    ctx = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, records=records, spans=spans,
        profiled=profiled, device=dev_summary, driver=drv)
    metrics = {}
    for m in (layer if trace else e2e):
        value = load_module("metrics", m["name"], bench_dir).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    drv.release()
    gc.unfreeze()
    rng = np.random.default_rng([int(seed) % 2**64, 7])
    t_check = time.perf_counter()
    compared = drv.check(records + profiled, rng)
    check_s = time.perf_counter() - t_check
    log(f"window: {len(records)} calls in {window_s:.3f} s; set-up "
        f"{setup_s:.3f} s; the reference's check {check_s:.3f} s")
    attempted = len(records) + len(profiled)
    correct = failed == 0 and all(v <= lim for _, v, lim in compared)
    result = {"workload": cell_name, "seed": int(seed), "correct": correct,
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": info}
    if trace and dev_summary is not None:
        info["busy_s"] = dev_summary.busy_s
        info["window_s"] = dev_summary.window_s
        result["breakdown"] = {"device_ops": dev_summary.device_ops,
                               "idle_gaps": dev_summary.idle_gaps}
    if device.type == "cuda":
        log(f"card: {power_limit()}")
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in compared}
    return result


