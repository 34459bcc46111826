"""The port's roofline machinery (``repro_torch.launch.{hlo_walk,
roofline}``), mirroring ``tests/test_roofline.py``: the walker counts
what the port dispatches, so a Python loop of products counts every
product (no trip count to find), a plain product's bytes cover its
operands and result, and a gather over a mesh reports the bytes that
moved between entries. ``test_parse_computations_finds_entry`` has no
mirror: the port has no HLO to parse.
"""
import torch

from repro_torch.launch.hlo_walk import walk
from repro_torch.launch.roofline import (HBM_BW, NVLINK_BW, PEAK_FLOPS,
                                         Roofline, analyze)
from repro_torch.models import sharding as shd


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def test_walker_counts_every_step_of_a_python_loop():
    def looped(x, ws):
        for w in ws:
            x = x @ w
        return x

    x, ws = _meta(128, 256), [_meta(256, 256) for _ in range(16)]
    r = walk(looped, x, ws)
    assert r.flops == 16 * 2 * 128 * 256 * 256
    assert r.unknown_loops == 0


def test_walker_nested_loops():
    def nested(x, ws):
        for _ in range(3):
            for w in ws:
                x = x @ w
        return x

    r = walk(nested, _meta(64, 64), [_meta(64, 64) for _ in range(5)])
    assert r.flops == 3 * 5 * 2 * 64 * 64 * 64


def test_walker_plain_dot_and_bytes():
    a, b = torch.randn(32, 48), torch.randn(48, 16)
    r = walk(lambda a, b: a @ b, a, b)
    assert r.flops == 2 * 32 * 48 * 16
    assert r.hbm_bytes >= (32 * 48 + 48 * 16 + 32 * 16) * 4
    # einsum and a batched product lower to the same matmul class
    q, k = _meta(2, 8, 4, 16), _meta(2, 8, 4, 16)
    r = walk(lambda q, k: torch.einsum("bqhd,bkhd->bhqk", q, k), q, k)
    assert r.flops == 2 * (2 * 4) * 8 * 8 * 16


def test_walker_views_cost_no_bytes_and_temps_are_tracked():
    x = _meta(1024, 1024)
    r = walk(lambda x: x.view(-1).reshape(1024, 1024).T, x)
    assert r.hbm_bytes == 0 and r.peak_temp_bytes == 0

    def chain(x):
        y = x * 2          # 4 MiB alive
        z = y + 1          # 8 MiB alive
        del y
        return z * 3       # y freed: 8 MiB at most

    r = walk(chain, x)
    assert r.peak_temp_bytes == 2 * 1024 * 1024 * 4
    r = walk(lambda x: x.mul_(2), x)     # in place: no new storage
    assert r.peak_temp_bytes == 0


def test_walker_collective_bytes_of_a_gather_on_a_mesh():
    """A (8, 16) fp32 tensor split over ("data", "model") on a (2, 2)
    mesh of one device: gathering it onto entry 0 moves the other three
    blocks, and the walker reports exactly those bytes as all-gather."""
    mesh = shd.Mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    s = shd.Sharded.place(torch.randn(8, 16), mesh, ("data", "model"))
    r = walk(lambda: s.read(0))
    assert r.collectives["all-gather"] == 3 * 4 * 8 * 4
    assert r.collective_bytes == 3 * 4 * 8 * 4
    assert set(r.collectives) == set(shd.COLLECTIVES)
    assert walk(lambda: s.read(0, ((0, 4), (0, 8)))).collective_bytes == 0


def test_roofline_terms_and_bottleneck():
    r = Roofline(arch="x", shape="y", mesh="single", chips=256,
                 hlo_flops=PEAK_FLOPS, hlo_bytes=HBM_BW * 2,
                 collective_bytes=NVLINK_BW * 0.5, collectives={},
                 model_flops=PEAK_FLOPS * 256 * 0.5,
                 peak_memory_bytes=0).finalize()
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 2.0) < 1e-9
    assert abs(r.collective_s - 0.5) < 1e-9
    assert r.bottleneck == "memory"
    assert abs(r.useful_ratio - 0.5) < 1e-9


def test_analyze_takes_the_walk_and_the_placed_bytes():
    w = walk(lambda a, b: a @ b, _meta(64, 64), _meta(64, 64))
    r = analyze(w, {"argument": 10, "temp": 5}, arch="a", shape="s",
                mesh_name="m", chips=4, model_flops=w.flops * 2,
                row_entries=2)
    assert r.hlo_flops == 2 * 64 ** 3 and r.peak_memory_bytes == 15
    assert r.useful_ratio == 0.5 and r.row_entries == 2
    assert r.bottleneck in ("compute", "memory", "collective")
