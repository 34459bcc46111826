"""The port's cross-process metric carrier (``repro_torch.obs.aggregate``)
against the reference's (``repro.obs.aggregate``): the cases of
``tests/test_obs.py`` on the port's registry, and the JSON snapshot
exchanged between the packages both ways — a snapshot either one writes
merges into the other's registry, and both render the same Prometheus
text."""
import json

import pytest

from repro.obs import merge_registry_state as j_merge
from repro.obs import registry_state as j_state
from repro.obs.registry import Registry as JRegistry

from repro_torch.obs import merge_registry_state, registry_state
from repro_torch.obs.registry import Registry


def _fill(reg):
    """The same traffic into either package's registry."""
    reg.counter("pairs_total", "emitted pairs",
                ("impl",)).labels(impl="spgemm").inc(7)
    reg.gauge("resident_rows", "rows").labels().set(128.0)
    h = reg.histogram("join_ms", "join latency", ("shard",),
                      bounds=(1.0, 10.0))
    for v, s in ((0.5, "0"), (3.0, "1"), (30.0, "0")):
        h.labels(shard=s).observe(v)
    d = reg.histogram("wave_s", "wave seconds")
    for v in (1e-5, 2e-3, 0.4):
        d.labels().observe(v)
    return reg


def test_registry_state_json_roundtrip_merges_exactly():
    """A worker snapshot survives json encode/decode and folds into a
    parent exactly: counters add, gauges take the incoming value,
    histogram bucket counts add bucket for bucket."""
    worker = Registry()
    worker.counter("pairs_total", "emitted pairs",
                   ("impl",)).labels(impl="spgemm").inc(7)
    worker.gauge("resident_rows", "rows").labels().set(128.0)
    h = worker.histogram("join_ms", "join latency", bounds=(1.0, 10.0))
    for v in (0.5, 3.0, 30.0):
        h.labels().observe(v)

    snap = json.loads(json.dumps(registry_state(worker)))
    parent = Registry()
    parent.counter("pairs_total", "emitted pairs",
                   ("impl",)).labels(impl="spgemm").inc(3)
    ph = parent.histogram("join_ms", "join latency", bounds=(1.0, 10.0))
    ph.labels().observe(5.0)
    merge_registry_state(snap, parent)
    merge_registry_state(snap, parent)       # associative: fold twice

    fams = parent.families()
    assert fams["pairs_total"].labels(impl="spgemm").value == 3 + 2 * 7
    assert fams["resident_rows"].labels().value == 128.0
    merged = ph.labels().state()
    assert merged["counts"] == [2, 3, 2]
    assert merged["count"] == 7


def test_merge_declares_missing_families():
    worker = Registry()
    worker.histogram("only_in_worker_ms", "h", ("shard",),
                     bounds=(2.0,)).labels(shard="3").observe(1.0)
    parent = merge_registry_state(registry_state(worker), Registry())
    fam = parent.families()["only_in_worker_ms"]
    assert fam.bounds == (2.0,)
    assert fam.labels(shard="3").state()["count"] == 1


def test_merge_identity_drift_raises():
    worker = Registry()
    worker.counter("m", "as counter").labels().inc(1)
    parent = Registry()
    parent.gauge("m", "as gauge").labels().set(1.0)
    with pytest.raises(ValueError, match="redeclaration"):
        merge_registry_state(registry_state(worker), parent)

    worker2 = Registry()
    worker2.counter("n", "c", ("a",)).labels(a="x").inc(1)
    parent2 = Registry()
    parent2.counter("n", "c", ("b",)).labels(b="y").inc(1)
    with pytest.raises(ValueError, match="redeclaration"):
        merge_registry_state(registry_state(worker2), parent2)


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown metric kind"):
        merge_registry_state({"families": {"x": {"kind": "summary"}}},
                             Registry())


def test_snapshot_json_equals_the_reference():
    """Key for key, the same JSON from the same traffic."""
    assert (json.dumps(registry_state(_fill(Registry())), sort_keys=True)
            == json.dumps(j_state(_fill(JRegistry())), sort_keys=True))


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_snapshots_merge_across_packages(direction):
    """A snapshot written by one package merges into the other's
    registry (already holding the same traffic once), and the merged
    registries render the same Prometheus text either way."""
    port, ref = _fill(Registry()), _fill(JRegistry())
    if direction == "reference_to_port":
        snap = json.loads(json.dumps(j_state(_fill(JRegistry()))))
    else:
        snap = json.loads(json.dumps(registry_state(_fill(Registry()))))
    merge_registry_state(snap, port)
    j_merge(snap, ref)
    assert port.prometheus() == ref.prometheus()
    fams = port.families()
    assert fams["pairs_total"].labels(impl="spgemm").value == 14
    assert fams["join_ms"].labels(shard="0").state()["counts"] == [2, 0, 2]
    assert fams["wave_s"].labels().state()["count"] == 6
