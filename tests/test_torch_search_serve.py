"""The port's serving CLI (``python -m repro_torch.launch.search_serve``)
against the reference's (``python -m repro.launch.search_serve``) at the
same arguments: two shards, the Smith-Waterman re-rank and a compaction.
The reference runs in a subprocess (its ``--shards`` sets XLA's host
device count before jax starts); the port runs in process on the CPU.
The planted-homolog hit line must be the same text, and compaction must
leave the port's answers identical."""
import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import search_serve
from repro_torch.obs import TRACER

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--n-refs", "512", "--n-queries", "64", "--batch", "16",
        "--shards", "2", "--rerank", "--compact"]


def _line(out: str, tag: str) -> str:
    hits = [ln for ln in out.splitlines() if ln.startswith(tag)]
    assert len(hits) == 1, (tag, out)
    return hits[0]


def test_port_cli_matches_reference_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.search_serve", *ARGS,
         "--index", str(tmp_path / "ref_idx")], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=240)
    assert ref.returncode == 0, ref.stderr
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            search_serve.main(ARGS + [
                "--device", "cpu", "--index", str(tmp_path / "port_idx"),
                "--metrics-out", str(tmp_path / "m.prom"),
                "--trace-out", str(tmp_path / "t.json")])
    finally:                # --trace-out turned the process's tracer on
        TRACER.disable()
        TRACER.clear()
    port = out.getvalue()
    assert _line(port, "[quality]") == _line(ref.stdout, "[quality]")
    assert "identical" in _line(port, "[compact]")
    assert "identical" in _line(ref.stdout, "[compact]")
    assert _line(port, "[mode]") == _line(ref.stdout, "[mode]")
    assert (tmp_path / "m.prom").read_text().startswith("# HELP")
    assert (tmp_path / "t.json").stat().st_size > 0


def test_port_cli_needs_a_card_unless_told_otherwise():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        search_serve.main(["--n-refs", "8", "--n-queries", "4"])
