"""The port stands alone: it imports neither jax nor the JAX package, runs
on the card unless asked for the CPU, and ``chip_smoke.py`` refuses to
report anything without a card or without the port beside it."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_port_modules_import_without_jax():
    mods = _port_modules()
    assert "repro_torch.index.service" in mods and len(mods) >= 47
    assert {"repro_torch.index.shard", "repro_torch.serve.engine",
            "repro_torch.serve.fleet", "repro_torch.faults.supervisor",
            "repro_torch.launch.search_serve", "repro_torch.core.mapreduce",
            "repro_torch.obs.aggregate",
            "repro_torch.launch.allpairs"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + [str(p.relative_to(ROOT)) for p in (ROOT / "tools").glob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_neither_jax_nor_repro(path):
    roots = set(_imported_roots(ROOT / path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.core.pipeline import LSHConfig, ScalLoPS
    from repro_torch.index.store import SignatureIndex
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScalLoPS(LSHConfig())
    with pytest.raises(RuntimeError):
        SignatureIndex(LSHConfig(), np.zeros((0, 1), np.uint32),
                       np.zeros(0, bool))
    with pytest.raises(RuntimeError):
        SignatureIndex.build(LSHConfig(), np.zeros((1, 8), np.int8),
                             np.array([8]))
    assert ScalLoPS(LSHConfig(), device="cpu").device.type == "cpu"


def test_new_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.align import (SeedExtendBaseline,
                                   batch_percent_identity, percent_identity,
                                   sw_align_batch, sw_score, sw_scores_device,
                                   sw_wave_affine, sw_wave_linear)
    from repro_torch.core.pipeline import LSHConfig
    from repro_torch.index.store import SignatureIndex
    q = np.zeros((1, 8), np.int8)
    for fn in (sw_align_batch, sw_scores_device, sw_score, percent_identity,
               sw_wave_linear, sw_wave_affine):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(q, q)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_percent_identity(np.zeros((1, 3), np.int32), q, [8], q, [8])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SeedExtendBaseline().build_index(q, np.array([8]))
    path = tmp_path / "idx.npz"
    SignatureIndex(LSHConfig(), np.zeros((0, 1), np.uint32),
                   np.zeros(0, bool), device="cpu").save(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SignatureIndex.load(path)
    assert SignatureIndex.load(path, device="cpu").device.type == "cpu"


def test_serving_tier_defaults_to_the_card():
    """ShardedIndex places its shards on the card unless told otherwise,
    and so the fleet."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.core.pipeline import LSHConfig
    from repro_torch.index import ServingConfig, ShardedIndex, SignatureIndex
    from repro_torch.serve import ReplicaFleet
    idx = SignatureIndex(LSHConfig(), np.zeros((0, 1), np.uint32),
                         np.zeros(0, bool), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedIndex(idx, ["cuda"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaFleet(idx, ServingConfig(), n_replicas=1, devices=["cuda"],
                     start_ingest=False)
    fleet = ReplicaFleet(idx, ServingConfig(), n_replicas=1,
                         start_ingest=False)
    assert fleet._replicas[0].sharded.devices == (torch.device("cpu"),)


def test_chip_smoke_alone_fails_and_reports_nothing(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
