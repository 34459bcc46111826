"""The port's recompile sentinel (``repro_torch/obs/jit.py``) on its cached
builders — a kernel library load, the per-word tables and K1's operands
uploaded to a device, the SW kernels' BLOSUM62 table: each build is
counted once per key, a warmed serving engine builds nothing, and two
spellings of one device build once (mirrors tests/test_obs.py's
sentinel tests)."""
import numpy as np
import pytest
import torch

from repro_torch.core import simhash
from repro_torch.core.pipeline import LSHConfig
from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                        make_protein_sets)
from repro_torch.index import QueryEngine, ServingConfig, SignatureIndex
from repro_torch.kernels import build, sw
from repro_torch.obs import REGISTRY, SENTINEL, TRACER, trace_sentinel
from repro_torch.util import canonical_device

BUILDERS = (simhash._build_table, simhash._build_siggen_operands,
            sw._build_table)


@pytest.fixture
def fresh():
    """Empty builder caches and a reset sentinel (it is process-wide)."""
    for b in BUILDERS:
        b.cache_clear()
    SENTINEL.reset()
    yield
    for b in BUILDERS:
        b.cache_clear()
    SENTINEL.reset()


def test_sentinel_counts_builds_not_calls(fresh):
    sw._table("cpu")
    sw._table("cpu")                 # same key: cached, no rebuild
    assert SENTINEL.total("sw_table") == 1
    sw._table("cpu", False)          # new key: one fresh build
    assert SENTINEL.total("sw_table") == 2
    assert SENTINEL.recompiled() == {}
    assert SENTINEL.by_site()["sw_table"] == 2
    with pytest.raises(AssertionError, match="zero-compile"):
        with SENTINEL.expect_no_compiles("device_table",
                                         message="steady state"):
            simhash._device_table("count", 3, 13, 0, "java", "cpu")
    with SENTINEL.expect_no_compiles("device_table"):
        simhash._device_table("count", 3, 13, 0, "java", "cpu")  # warm


def test_same_key_built_twice_is_reported(fresh):
    """An evicted (here: cleared) cache entry built again is the
    reference's "same key twice": ``recompiled`` names it, and the
    ``jit_compiles`` counter and the ``compile`` trace instant record
    every build."""
    counter = REGISTRY.counter("jit_compiles", labelnames=("site",)).labels(
        site="sw_table")
    before = counter.value
    was = TRACER.enabled
    TRACER.enable()
    try:
        sw._table("cpu")
        sw._build_table.cache_clear()
        sw._table("cpu")
        events = [e for e in TRACER.spans() if e["name"] == "compile"
                  and e["args"]["site"] == "sw_table"]
    finally:
        TRACER.enabled = was
    (key, n), = SENTINEL.recompiled().items()
    assert key[0] == "sw_table" and n == 2
    assert [e["args"]["n_for_key"] for e in events][-2:] == [1, 2]
    assert counter.value == before + 2


def test_device_spellings_build_once(fresh):
    """``"cpu"``, ``torch.device("cpu")`` and ``"cpu:1"`` are one device:
    one table, one set of K1 operands, one BLOSUM62 table each."""
    for dev in ("cpu", torch.device("cpu"), "cpu:1"):
        t = simhash._device_table("contrib", 3, 13, 32, "java", dev)
        ops = simhash._device_siggen_operands(3, 32, "java", dev)
        blosum = sw._table(dev)
    assert SENTINEL.by_site() == {"device_table": 1, "siggen_operands": 1,
                                  "sw_table": 1}
    assert SENTINEL.recompiled() == {}
    assert t is simhash._device_table("contrib", 3, 13, 32, "java",
                                      torch.device("cpu"))
    assert ops[0].dtype == torch.int8 and blosum.dtype == torch.int32
    assert canonical_device("cpu:0") == torch.device("cpu")


def test_cuda_spellings_share_one_key():
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            canonical_device("cuda")
        return
    assert canonical_device("cuda") == canonical_device(
        f"cuda:{torch.cuda.current_device()}")


def test_kernel_library_loads_once_per_source(fresh, monkeypatch):
    """``kernels/build.py::library`` loads each source's library once,
    beneath its cache (no nvcc here: the build and the load are stubbed)."""
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "build_all", lambda: 0.0)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    a = build.library("sw")
    assert build.library("sw") is a
    build.library("hamming")
    assert SENTINEL.by_site() == {"kernel_library": 2}
    assert SENTINEL.recompiled() == {}


def test_trace_sentinel_static_key_separates_builds(fresh):
    calls = []

    @trace_sentinel("jit_test_site", static_key=("cap", 64))
    def body(x):
        calls.append(x)
        return x

    body(np.zeros(4, np.float32))
    body(np.ones(4, np.float32))     # same abstract key: a rebuild
    assert SENTINEL.recompiled() == {
        ("jit_test_site", ((("arr", (4,), "float32"),), ())
         + (("static", ("cap", 64)),)): 2}
    assert len(calls) == 2


def test_warmup_then_serving_is_compile_free(fresh):
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=96, n_homolog_queries=8, n_decoy_queries=8, ref_len_mean=80,
        ref_len_std=10, sub_rates=(0.04,), seed=5))
    index = SignatureIndex.build(LSHConfig(k=3, T=13, f=32, d=1),
                                 data["ref_ids"], data["ref_lens"],
                                 device="cpu")
    eng = QueryEngine(index, ServingConfig(k=5, max_batch=8, mode="probe",
                                           rerank=True),
                      ref_seqs=(data["ref_ids"], data["ref_lens"]))
    assert eng.warmup(data["query_ids"], data["query_lens"]) > 0
    # the index's contribution and feature-count tables, built once each
    assert SENTINEL.by_site() == {"device_table": 2}
    with SENTINEL.expect_no_compiles(message="warmed sync engine"):
        for j in range(0, 12, 4):
            eng.query_batch(data["query_ids"][j:j + 4],
                            data["query_lens"][j:j + 4])
    assert SENTINEL.recompiled() == {}
