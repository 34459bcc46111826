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
    assert "repro_torch.index.service" in mods and len(mods) >= 80
    assert {"repro_torch.index.shard", "repro_torch.serve.engine",
            "repro_torch.serve.fleet", "repro_torch.faults.supervisor",
            "repro_torch.launch.search_serve", "repro_torch.core.mapreduce",
            "repro_torch.obs.aggregate",
            "repro_torch.launch.allpairs", "repro_torch.obs.jit",
            "repro_torch.models.config", "repro_torch.models.layers",
            "repro_torch.models.recurrent", "repro_torch.models.model",
            "repro_torch.launch.serve", "repro_torch.configs.yi_9b",
            "repro_torch.configs.olmoe_1b_7b",
            "repro_torch.configs.qwen3_moe_30b_a3b",
            "repro_torch.configs.hubert_xlarge",
            "repro_torch.configs.recurrentgemma_2b",
            "repro_torch.configs.qwen2_vl_7b",
            "repro_torch.configs.nemotron_4_15b",
            "repro_torch.configs.granite_3_8b",
            "repro_torch.configs.granite_34b",
            "repro_torch.configs.xlstm_1_3b",
            "repro_torch.train", "repro_torch.train.optimizer",
            "repro_torch.train.train_lib", "repro_torch.train.compression",
            "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
            "repro_torch.data.lm_data", "repro_torch.launch.train",
            "repro_torch.models.sharding", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun", "repro_torch.launch.report",
            "repro_torch.launch.roofline",
            "repro_torch.launch.hlo_walk"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'repro' or m.startswith('repro.')\n"
            "             or m == 'ml_dtypes')\n"
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
    assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}, (path, roots)


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


def test_training_entry_points_default_to_the_card():
    """The training slice's entry points raise without a card unless given
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.lm_data import (LMDataConfig, dedup_corpus,
                                          lm_batches, token_signatures)
    from repro_torch.train import init_train_state
    cfg = get_smoke_config("yi-9b")
    toks, lens = np.zeros((2, 8), np.int32), np.array([8, 8])
    for call in (lambda: init_train_state(torch.Generator(), cfg),
                 lambda: lm_batches(LMDataConfig(256, 8, 2), 0),
                 lambda: token_signatures(toks, lens),
                 lambda: dedup_corpus(toks, lens)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert init_train_state(torch.Generator(), cfg,
                            "cpu").model.device.type == "cpu"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_port_imports_no_torch_distributed():
    """The meshes are one process over a list of devices: no process
    group, so no ``torch.distributed`` (DeviceMesh, DTensor, FSDP) in the
    port, its tools or the smoke."""
    paths = sorted(PORT.rglob("*.py")) + sorted(
        (ROOT / "tools").glob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = {str(p.relative_to(ROOT)): m for p in paths
           for m in _imported_modules(p)
           if m == "torch.distributed" or m.startswith("torch.distributed.")}
    assert not bad, bad


def test_mesh_entry_points_default_to_the_card():
    """A Mesh built without devices and init_train_state(mesh=) on it run
    on the card, and raise without one; the production mesh's ``meta``
    entries are the one documented exception (the dry run allocates
    nothing)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.sharding import Mesh
    from repro_torch.train import init_train_state
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Mesh((2, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Mesh((2, 2), ("data", "model"), ["cuda:0"] * 4)
    cfg = get_smoke_config("yi-9b")
    cpu = Mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(torch.Generator(), cfg, "cuda", mesh=cpu)
    state = init_train_state(torch.Generator(), cfg, mesh=cpu)
    assert state.model.mesh is cpu and state.step.device.type == "cpu"
    assert {d.type for d in make_production_mesh().devices} == {"meta"}
