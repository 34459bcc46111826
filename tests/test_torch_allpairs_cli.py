"""The port's all-pairs CLI (``python -m repro_torch.launch.allpairs``)
against the reference's (``python -m repro.launch.allpairs``) at the same
arguments, two shards: the same printed lines with the timings taken
out, and the same ``--out`` arrays, for an incremental run and a batch
run. The reference runs in subprocesses (its ``--shards`` sets XLA's
host device count before jax starts), both started at once; the port
runs in process on the CPU. Then the metrics carrier: the port merges a
worker's JSON snapshot and renders it."""
import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import allpairs

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--n-families", "16", "--family-size", "4", "--n-singletons", "64",
        "--shards", "2", "--prefilter"]
RUNS = {"incremental": ARGS + ["--incremental", "16"], "batch": ARGS}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the twins run thousands of small
    torch ops, and with the suite's workers sharing the cores a full
    thread pool each makes them fight for the cores (the K4 twin's
    column loop ran 100x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _lines(out: str) -> list[str]:
    """The printed lines without their timings and file paths."""
    return [re.sub(r"\d+\.\d+s", "<t>", ln.split(" wrote ")[0])
            for ln in out.splitlines() if ln.startswith("[")]


def _port(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        allpairs.main(argv)
    return out.getvalue()


def test_port_cli_matches_reference_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro.launch.allpairs", *argv, "--out",
         str(tmp_path / f"ref_{name}.npz")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, argv in RUNS.items()}
    try:
        port = {name: _port(argv + ["--device", "cpu", "--out",
                                    str(tmp_path / f"port_{name}.npz")])
                for name, argv in RUNS.items()}
        ref = {}
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, err[-3000:]
            ref[name] = out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    for name in RUNS:
        assert _lines(port[name]) == _lines(ref[name]), name
        a = np.load(tmp_path / f"ref_{name}.npz")
        b = np.load(tmp_path / f"port_{name}.npz")
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    tags = {ln.split()[0] for ln in _lines(port["batch"])}
    assert {"[join]", "[score]", "[graph]", "[truth]", "[out]"} <= tags
    assert "prefilter rejected" in port["batch"]


def test_port_cli_metrics_merge(tmp_path):
    """A worker's --metrics-out *.json folds into the parent's registry
    through --metrics-merge, and the parent renders Prometheus text."""
    import json

    from repro_torch.obs import REGISTRY
    REGISTRY.counter("cli_test_pairs", "pairs", ("shard",)).labels(
        shard="0").inc(5)
    worker = tmp_path / "w.json"
    out = _port(["--n-families", "4", "--family-size", "3",
                 "--n-singletons", "8", "--pallas", "--device", "cpu",
                 "--metrics-out", str(worker)])
    assert f"[metrics] wrote {worker}" in out
    snap = json.loads(worker.read_text())
    assert snap["families"]["cli_test_pairs"]["children"] == [[["0"], 5]]
    prom = tmp_path / "m.prom"
    out = _port(["--n-families", "4", "--family-size", "3",
                 "--n-singletons", "8", "--pallas", "--device", "cpu",
                 "--metrics-merge", str(worker), "--metrics-out", str(prom)])
    assert "[metrics] merged 1 worker snapshot(s)" in out
    assert 'cli_test_pairs{shard="0"} 10' in prom.read_text()


def test_port_cli_refuses_what_it_does_not_port():
    for flag in (["--host-gather"], ["--join-impl", "legacy"]):
        with pytest.raises(SystemExit, match="the port has no"):
            allpairs.main(["--device", "cpu", *flag])


def test_port_cli_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        allpairs.main(["--n-families", "2", "--n-singletons", "4"])
