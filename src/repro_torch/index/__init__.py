"""The persistent bucket index and batched query serving.

* ``store``     — :class:`SignatureIndex`: packed signatures + per-band
  sorted bucket keys with CSR offsets, persistence keyed by a config
  fingerprint (segment directory or legacy monolithic npz, in the
  reference's formats), append-only ``add()`` and ``compact()``.
* ``segments``  — :class:`Segment`: the unit of incremental growth, its
  stable merge into the full bucket table, manifest + per-segment files.
* ``partition`` — :class:`BucketPartition`: shard-owned stacked CSR slabs.
* ``shard``     — :class:`ShardedIndex`: the buckets laid out over shards
  (one per device entry, repeats allowed), probed by a two-phase ring,
  grown by delta refresh, folded back by ``compact()``.
* ``service``   — :class:`QueryEngine`: micro-batched serving, bucket
  probe, exact Hamming top-k, Smith-Waterman re-rank.
* ``stats``     — bucket-occupancy and entropy diagnostics.
"""
from .store import IndexConfigMismatch, SignatureIndex, config_fingerprint
from .segments import Segment, merge_band_csrs
from .partition import BucketPartition, bucket_owners
from .service import QueryEngine, ServingConfig, topk_dense, topk_probe
from .shard import ShardedIndex
from .stats import BandStats, band_stats, compare_schemes, occupancy_report

__all__ = [
    "SignatureIndex", "IndexConfigMismatch", "config_fingerprint",
    "Segment", "merge_band_csrs",
    "BucketPartition", "bucket_owners",
    "QueryEngine", "ServingConfig", "topk_dense", "topk_probe",
    "ShardedIndex",
    "BandStats", "band_stats", "compare_schemes", "occupancy_report",
]
