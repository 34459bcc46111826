"""Launch-layer units of the port (``repro_torch.launch.{mesh, dryrun,
report, roofline}``), mirroring ``tests/test_launch.py``, with the
H100's data-sheet constants; ``input_specs`` held against the
reference's on both production meshes (a subprocess over 512 forced
host devices, nothing compiled); the dry run on a smoke-sized cell of a
(2, 2) ``meta`` mesh and its CLI on one real cell.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.configs import (ARCHS, SHAPES, cells, get_config,
                                 get_smoke_config, shape_applicable)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (dp_size, input_specs,
                                     make_production_mesh)
from repro_torch.launch.report import FIX_NOTES, fmt_details, fmt_table, load
from repro_torch.launch.roofline import (HBM_BW, NVLINK_BW, PEAK_FLOPS,
                                         Roofline, model_flops_for)
from repro_torch.models.config import active_param_count
from repro_torch.models.sharding import Mesh

ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = textwrap.dedent("""
    import json
    import jax
    from repro.configs import ARCHS, SHAPES, shape_applicable, get_config
    from repro.launch.mesh import make_production_mesh, input_specs
    assert jax.device_count() == 512
    out = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for a in ARCHS:
            cfg = get_config(a)
            for s in SHAPES:
                if not shape_applicable(a, s)[0]:
                    continue
                io = input_specs(cfg, s, mesh)
                out[f"{a}/{s}/{multi}"] = {k: [
                    list(v.shape), str(v.dtype),
                    None if v.sharding is None else [
                        list(i) if isinstance(i, tuple) else i
                        for i in v.sharding.spec]] for k, v in io.items()}
    print(json.dumps(out))
""")


def test_cell_matrix_counts():
    all_cells = cells()
    assert len(all_cells) == 40  # 10 archs x 4 shapes
    runnable = [c for c in all_cells if c[2]]
    skipped = [c for c in all_cells if not c[2]]
    assert len(runnable) == 31
    assert len(skipped) == 9
    hub = [c for c in skipped if c[0] == "hubert-xlarge"]
    assert len(hub) == 2
    longs = [c for c in skipped if c[1] == "long_500k"]
    assert len(longs) == 8
    for _, _, ok, why in skipped:
        assert why  # every skip carries a reason


def test_subquadratic_archs_run_long_500k():
    assert shape_applicable("recurrentgemma-2b", "long_500k")[0]
    assert shape_applicable("xlstm-1.3b", "long_500k")[0]
    assert not shape_applicable("yi-9b", "long_500k")[0]


def test_model_flops_accounting():
    cfg = get_config("yi-9b")
    n = active_param_count(cfg)
    t = model_flops_for(cfg, "train_4k", n, 4096, 256, "train")
    p = model_flops_for(cfg, "prefill_32k", n, 32768, 32, "prefill")
    d = model_flops_for(cfg, "decode_32k", n, 32768, 128, "decode")
    assert t == 6.0 * n * 4096 * 256
    assert p == 2.0 * n * 32768 * 32
    assert d == 2.0 * n * 128          # one token per sequence


def test_moe_active_flops_smaller_than_total():
    cfg = get_config("qwen3-moe-30b-a3b")
    from repro_torch.models.config import param_count
    assert active_param_count(cfg) < 0.2 * param_count(cfg)


def test_hardware_constants_match_brief():
    """H100 SXM5 80GB at 700 W, NVIDIA's data sheet: bf16 dense (half the
    2:4-sparse 1,979 TFLOP/s), HBM3, and one direction of NVLink 4."""
    assert PEAK_FLOPS == 989.5e12 and HBM_BW == 3.35e12
    assert NVLINK_BW == 450e9


def test_report_renders_skips_and_cells(tmp_path):
    r = Roofline(arch=ARCHS[0], shape="train_4k", mesh="single", chips=256,
                 hlo_flops=1e12, hlo_bytes=1e12, collective_bytes=1e10,
                 collectives={}, model_flops=1e15,
                 peak_memory_bytes=2**30).finalize()
    cells_map = {(ARCHS[0], "train_4k", "single"): json.loads(
        json.dumps(r.__dict__))}
    table = fmt_table(cells_map, "single")
    assert "SKIP" in table               # skipped cells rendered with reason
    assert ARCHS[0] in table
    assert "(missing)" in table          # un-run cells flagged, not hidden
    assert "row of 1 entries" in fmt_details(cells_map, "single")
    for note in FIX_NOTES.values():
        assert isinstance(note, str) and note


def test_roofline_bottleneck_note_exists_for_every_term():
    assert set(FIX_NOTES) == {"compute", "memory", "collective"}


def test_production_mesh_is_meta_and_shaped():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert {d.type for d in single.devices + multi.devices} == {"meta"}
    assert dp_size(single) == 16 and dp_size(multi) == 32


def test_input_specs_match_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    n = 0
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for a in ARCHS:
            for s in SHAPES:
                if not shape_applicable(a, s)[0]:
                    continue
                got = input_specs(get_config(a), s, mesh)
                w = want[f"{a}/{s}/{multi}"]
                assert list(got) == list(w), (a, s)
                for k, (t, spec) in got.items():
                    shape, dtype, wspec = w[k]
                    assert t.device.type == "meta"
                    assert list(t.shape) == shape, (a, s, k)
                    assert str(t.dtype).removeprefix("torch.") == dtype
                    assert (None if spec is None else [
                        list(i) if isinstance(i, tuple) else i
                        for i in spec]) == wspec, (a, s, k, multi)
                    n += 1
    # a mesh: train (inputs, targets) and prefill of the ten archs,
    # decode_32k (tokens, pos) of nine, long_500k of two
    assert n == 2 * (10 * 2 + 10 + 9 * 2 + 2 * 2)


@pytest.mark.parametrize("arch,kind", [
    ("yi-9b", "train"), ("olmoe-1b-7b", "train"), ("yi-9b", "decode"),
    ("recurrentgemma-2b", "prefill"), ("xlstm-1.3b", "decode")])
def test_lower_cell_smoke_cell_on_a_meta_mesh(arch, kind):
    """A smoke-sized cell on a (2, 2) ``meta`` mesh: finite terms, the
    FSDP gathers seen as all-gather (and, training, the gradients as
    reduce-scatter), useful_ratio <= 1 for training, and the argument
    bytes a quarter-ish of the state. yi-9b's and olmoe's training step:
    one entry walks a quarter of the FLOPs of the same cell on a (1, 1)
    mesh (tensor-parallel over "model", data-parallel over "data")."""
    mesh = Mesh((2, 2), ("data", "model"), "meta")
    shape = dict(name=kind, kind=kind, seq_len=32 if kind != "decode" else 64,
                 global_batch=8)
    mem, r = dryrun.lower_cell(arch, shape, mesh, "2x2",
                               cfg=get_smoke_config(arch))
    for v in (r.hlo_flops, r.hlo_bytes, r.collective_bytes, r.compute_s,
              r.memory_s, r.collective_s, r.useful_ratio):
        assert math.isfinite(v) and v > 0
    assert r.collectives["all-gather"] > 0 and r.row_entries == 2
    assert mem["argument"] > 0 and mem["temp"] > 0
    if kind == "train":
        assert r.useful_ratio <= 1.0
        assert r.collectives["reduce-scatter"] > 0
    if arch in ("yi-9b", "olmoe-1b-7b") and kind == "train":
        # one entry walks a quarter of the (1, 1) mesh's whole step
        one = Mesh((1, 1), ("data", "model"), "meta")
        _, whole = dryrun.lower_cell(arch, shape, one, "1x1",
                                     cfg=get_smoke_config(arch))
        assert r.hlo_flops * 4 == whole.hlo_flops


def test_dryrun_cli_one_cell(tmp_path, capsys):
    """``main`` on a real cell of the production mesh (recurrentgemma-2b
    x long_500k: batch 1, so nothing splits over "data"), then [CACHED]
    and the report over its JSON."""
    argv = ["--arch", "recurrentgemma-2b", "--shape", "long_500k",
            "--out", str(tmp_path)]
    dryrun.main(argv)
    out = capsys.readouterr().out
    assert "[OK] recurrentgemma-2b x long_500k x single" in out
    assert "ALL CELLS PASSED" in out
    r = json.loads((tmp_path / "recurrentgemma-2b__long_500k__single.json")
                   .read_text())
    assert r["chips"] == 256 and r["row_entries"] == 16
    assert set(r["collectives"]) == {"all-gather", "all-reduce",
                                     "reduce-scatter", "all-to-all",
                                     "collective-permute"}
    dryrun.main(argv)
    assert "[CACHED] recurrentgemma-2b x long_500k x single" in \
        capsys.readouterr().out
    cells_map = load(tmp_path)
    assert "long_500k" in fmt_table(cells_map)
    dryrun.main(["--arch", "yi-9b", "--shape", "long_500k", "--out",
                 str(tmp_path)])
    assert "[SKIP] yi-9b x long_500k" in capsys.readouterr().out
