"""Signature index over a reference database — built once, grown forever.

The port of ``repro/index/store.py``:

* packed signatures ``sigs`` (N, f//32) uint32 on the host, mirrored on the
  device as int32 bit patterns — job 1's output;
* ``valid`` (N,) bool — the paper's non-zero-signature rule (§5.2);
* sorted buckets in CSR form, in one of two layouts:

  - ``layout="band"`` (default): one table per band of band keys with
    ``bands >= d+1`` (the pigeonhole guarantee: a probe of all bands has no
    false negatives within Hamming d);
  - ``layout="flip"``: the paper's expansion — every reference emits all
    C(f, <=d) bit-flips (``core/join.py::flip_masks``) as keys and queries
    probe with their raw signature; one table, exact, no duplicate
    candidates. f <= 32.

Growth is append-only: ``add()`` seals a new segment, the merged bucket
table is a stable linear merge materialized lazily, ``compact()`` folds
the segments into one.

Persistence is fingerprint-versioned, in the reference's two containers
and formats, so an index saved by either package loads in the other: a
**segment directory** (manifest + per-segment npz, appends cost O(delta),
``recover=True`` serves the longest valid prefix) or the legacy
monolithic ``.npz`` (paths ending in ``.npz``). Loading against a
different :class:`~repro_torch.core.pipeline.LSHConfig` raises
:class:`IndexConfigMismatch`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zipfile

import numpy as np
import torch

from ..core.join import band_keys
from ..core.pipeline import LSHConfig, ScalLoPS
from ..faults import atomic_write
from ..obs import span
from ..util import as_unsigned, i32_to_u32, resolve_device, u32_to_i32
from . import segments as seglib
from .segments import CorruptSegment, Segment

FORMAT_VERSION = 1

# Fields of LSHConfig that determine signature/bucket semantics; serving
# knobs (max_pairs, join_method) do not invalidate an index.
_FINGERPRINT_FIELDS = ("k", "T", "f", "d", "scheme", "siggen_method")


class IndexConfigMismatch(RuntimeError):
    """A persisted index was loaded against an incompatible LSHConfig."""


def config_fingerprint(cfg: LSHConfig, *, layout: str, bands: int,
                       interleave: bool = True,
                       key_hash: str = "none",
                       n_shards: int = 1) -> str:
    """Stable 16-hex-digit fingerprint of the index-relevant config —
    the same digest the reference computes for the same config."""
    payload = {
        "cfg": {f: getattr(cfg, f) for f in _FINGERPRINT_FIELDS},
        "layout": layout, "bands": bands, "interleave": interleave,
        "format": FORMAT_VERSION,
    }
    if key_hash != "none":
        payload["key_hash"] = key_hash
    if n_shards != 1:
        payload["n_shards"] = n_shards
    blob = json.dumps(payload, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _job1(sl: ScalLoPS, ref_ids, ref_lens):
    """Signatures (uint32 numpy) and validity (bool numpy) of new rows,
    computed on the pipeline's device."""
    sigs = i32_to_u32(sl.signatures(ref_ids, ref_lens))
    valid = (sl.feature_counts(ref_ids, ref_lens) > 0).cpu().numpy()
    return sigs, valid


class SignatureIndex:
    """Segmented reference index over packed LSH signatures.

    Use :meth:`build` (from sequences) or :meth:`load` (from disk);
    query via :meth:`probe` or the serving layer
    (:mod:`repro_torch.index.service`); grow via :meth:`add`.
    """

    def __init__(self, cfg: LSHConfig, sigs: np.ndarray, valid: np.ndarray,
                 *, layout: str = "band", bands: int | None = None,
                 interleave: bool = True, key_hash: str = "splitmix",
                 n_shards: int = 1, device=None):
        if layout not in ("band", "flip"):
            raise ValueError(f"unknown index layout {layout!r}")
        if layout == "flip" and cfg.f > 32:
            raise ValueError("flip layout needs f <= 32 (paper used f=32)")
        if key_hash not in ("splitmix", "none"):
            raise ValueError(f"unknown key_hash {key_hash!r}")
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.cfg = cfg
        self.layout = layout
        self.device = resolve_device(device)
        self.n_shards = int(n_shards)
        self.interleave = bool(interleave)
        # flip keys are the raw signature words: no key hash
        self.key_hash = key_hash if layout == "band" else "none"
        self.bands = int(bands if bands is not None else max(cfg.d + 1, 1))
        if layout == "band" and self.bands < cfg.d + 1:
            raise ValueError("bands must be >= d+1 for an exact probe")
        self.sigs = np.ascontiguousarray(np.asarray(sigs, np.uint32))
        self.valid = np.asarray(valid, bool).reshape(-1).copy()
        if self.sigs.shape != (self.valid.shape[0], cfg.f // 32):
            raise ValueError(f"sigs {self.sigs.shape} and valid "
                             f"{self.valid.shape} do not match f={cfg.f}")
        self.segments: list[Segment] = []   # sealed (CSR built)
        self._pending: list[tuple] = []     # (sigs, valid, base) to seal
        if self.size:
            self._pending.append((self.sigs, self.valid, 0))
        self.generation = 0
        self._merged_stale = True
        self._csr_np = None
        self.recovery = None    # load(recover=True)'s report of a dropped tail
        self._partitions = {}
        self._dev_sigs = None
        self._dev_valid = None
        self._dev_band_keys = None
        self._pipeline = None

    # ------------------------------------------------------------ properties
    @property
    def size(self) -> int:
        return self.sigs.shape[0]

    @property
    def n_bands(self) -> int:
        return 1 if self.layout == "flip" else self.bands

    @property
    def epoch(self) -> int:
        """Segment count (sealed + pending)."""
        return len(self.segments) + len(self._pending)

    @property
    def lifecycle(self) -> tuple[int, int]:
        """(generation, epoch) — changes iff a delta refresh or a full
        re-place is due."""
        return (self.generation, self.epoch)

    @property
    def fingerprint(self) -> str:
        return config_fingerprint(self.cfg, layout=self.layout,
                                   bands=self.bands,
                                   interleave=self.interleave,
                                   key_hash=self.key_hash,
                                   n_shards=self.n_shards)

    @property
    def device_sigs(self) -> torch.Tensor:
        """(N, f//32) int32 bit patterns on the device (uploaded once)."""
        if self._dev_sigs is None or self._dev_sigs.shape[0] != self.size:
            self._dev_sigs = u32_to_i32(self.sigs).to(self.device)
            self._dev_valid = torch.from_numpy(self.valid).to(self.device)
        return self._dev_sigs

    @property
    def device_valid(self) -> torch.Tensor:
        self.device_sigs
        return self._dev_valid

    @property
    def device_band_keys(self) -> torch.Tensor:
        """(N, n_bands) int64 holding every sequence's uint32 bucket key in
        every band, on the device. A sequence occupies exactly one bucket
        per band, so a self-join candidate pair is a cross-band duplicate
        iff its two rows agree in an earlier band
        (``index/spgemm.py::spgemm_join_self_keys``). Band layout only."""
        if self.layout != "band":
            raise ValueError("band keys are only defined for layout='band'")
        if (self._dev_band_keys is None
                or self._dev_band_keys.shape[0] != self.size):
            self._dev_band_keys = band_keys(
                self.device_sigs, self.cfg.f, self.bands,
                interleave=self.interleave, key_hash=self.key_hash)
        return self._dev_band_keys

    # ------------------------------------------------------------ build
    @classmethod
    def build(cls, cfg: LSHConfig, ref_ids, ref_lens, *,
              layout: str = "band", bands: int | None = None,
              interleave: bool = True, key_hash: str = "splitmix",
              n_shards: int = 1, device=None) -> "SignatureIndex":
        """Run job 1 (signature generation + validity) over the reference
        set on the device and index the result."""
        dev = resolve_device(device)
        sl = ScalLoPS(cfg, device=dev)
        sigs, valid = _job1(sl, ref_ids, ref_lens)
        idx = cls(cfg, sigs, valid, layout=layout, bands=bands,
                  interleave=interleave, key_hash=key_hash,
                  n_shards=n_shards, device=dev)
        idx._pipeline = sl
        return idx

    def add(self, ref_ids, ref_lens) -> None:
        """Incremental growth: signatures for the NEW rows only, appended as
        a pending segment and sealed lazily on the next probe."""
        if self._pipeline is None:
            self._pipeline = ScalLoPS(self.cfg, device=self.device)
        new_sigs, new_valid = _job1(self._pipeline, ref_ids, ref_lens)
        if new_sigs.shape[0] == 0:
            return
        base = self.size
        self.sigs = np.concatenate([self.sigs, new_sigs], axis=0)
        self.valid = np.concatenate([self.valid, new_valid], axis=0)
        self._pending.append((new_sigs, new_valid, base))
        self._merged_stale = True
        self._partitions = {}

    def seal(self) -> None:
        """Seal pending rows into segments (bucket the new rows)."""
        if not self._pending:
            return
        with span("seal", cat="lifecycle", pending=len(self._pending),
                  epoch=len(self.segments)):
            while self._pending:
                sigs, valid, base = self._pending.pop(0)
                self.segments.append(seglib.build_segment(
                    sigs, valid, base, layout=self.layout, f=self.cfg.f,
                    d=self.cfg.d, bands=self.bands,
                    interleave=self.interleave, key_hash=self.key_hash,
                    device=self.device))

    def _ensure_built(self) -> None:
        """Seal pending segments and materialize the merged bucket table."""
        self.seal()
        if not self._merged_stale and self._csr_np is not None:
            return
        if self.segments:
            self._csr_np = seglib.merge_band_csrs(
                [s.csr for s in self.segments])
        else:
            self._csr_np = [seglib._empty_csr() for _ in range(self.n_bands)]
        self._partitions = {}
        self._merged_stale = False

    def compact(self) -> None:
        """Fold every segment into one (the explicit reduce step). Probe
        results are identical before and after."""
        self.seal()
        if len(self.segments) == 1:
            return
        with span("compact_index", cat="lifecycle",
                  segments=len(self.segments), size=self.size):
            self._ensure_built()
            self.segments = [Segment(0, self.sigs, self.valid, self._csr_np)]
            self._pending = []
            self.generation += 1

    def partition(self, n_shards: int | None = None):
        """Shard-owned stacked CSR slabs, cached per shard count."""
        from .partition import BucketPartition
        self._ensure_built()
        n = int(n_shards if n_shards is not None else self.n_shards)
        part = self._partitions.get(n)
        if part is None:
            part = BucketPartition(self._csr_np, n, sigs=self.sigs,
                                   device=self.device)
            self._partitions[n] = part
        return part

    def delta_partition(self, n_shards: int, from_epoch: int):
        """Partition of just the segments sealed at or after
        ``from_epoch``; never touches the merged table."""
        from .partition import BucketPartition
        self.seal()
        segs = self.segments[from_epoch:]
        if segs:
            csr = seglib.merge_band_csrs([s.csr for s in segs])
        else:
            csr = [seglib._empty_csr() for _ in range(self.n_bands)]
        return BucketPartition(csr, n_shards, sigs=self.sigs,
                               device=self.device)

    # ------------------------------------------------------------ probing
    def query_keys(self, q_sigs: torch.Tensor) -> torch.Tensor:
        """Per-band probe keys for a query batch: (n_bands, B) int64
        holding uint32 values (the raw first word under the flip layout)."""
        if self.layout == "flip":
            return as_unsigned(q_sigs.to(self.device)[:, 0])[None, :]
        return band_keys(q_sigs.to(self.device), self.cfg.f, self.bands,
                         interleave=self.interleave,
                         key_hash=self.key_hash).T.contiguous()

    def probe(self, q_sigs: torch.Tensor, *, cap: int):
        """Candidate generation: for each query, up to ``cap`` reference ids
        per band whose bucket key matches.

        Returns (cand (B, n_bands*cap) int32 with -1 padding — duplicates
        across bands allowed, overflowed 0-d bool tensor — True iff some
        matched bucket held more than ``cap`` entries).
        """
        from .service import _probe_csr_fused
        self._ensure_built()
        qk = self.query_keys(q_sigs)
        keys_s, offs_s, ids_s = self.partition(1).probe_arrays(0)
        if keys_s.shape[1] == 0:           # no buckets at all (empty index)
            B = qk.shape[1]
            return (torch.full((B, self.n_bands * cap), -1, dtype=torch.int32,
                               device=self.device),
                    torch.zeros((), dtype=torch.bool, device=self.device))
        cand, sizes = _probe_csr_fused(qk, keys_s, offs_s, ids_s, cap=cap)
        return cand, torch.amax(sizes) > cap

    # ------------------------------------------------------------ persistence
    def _meta(self) -> dict:
        return {
            "format": FORMAT_VERSION,
            "fingerprint": self.fingerprint,
            "cfg": dataclasses.asdict(self.cfg),
            "layout": self.layout,
            "bands": self.bands,
            "interleave": self.interleave,
            "key_hash": self.key_hash,
            "n_shards": self.n_shards,
            "n_refs": self.size,
        }

    def save(self, path: str | os.PathLike) -> int:
        """Persist the index; returns the number of segment files written.

        Paths ending in ``.npz`` write the legacy monolithic container
        (merged table, one file). Any other path is a segment directory:
        manifest + per-segment files, and repeated saves append only the
        segments not on disk yet (O(delta)).
        """
        if not seglib.is_segmented(path):
            self._ensure_built()
            payload = {
                "meta_json": np.frombuffer(
                    json.dumps(self._meta(), sort_keys=True).encode(),
                    dtype=np.uint8),
                **seglib.stored_arrays(self.sigs, self.valid, self._csr_np),
            }
            atomic_write(os.fspath(path),
                         lambda fh: np.savez_compressed(fh, **payload))
            return 1
        self.seal()                 # segments only — no merge needed
        return seglib.save_segmented(path, self._meta(), self.segments,
                                     self.n_bands)

    @classmethod
    def _check_meta(cls, meta: dict, expected_cfg: LSHConfig | None):
        """Fingerprint verification shared by both containers; returns the
        config and the constructor's keyword arguments."""
        cfg = LSHConfig(**meta["cfg"])
        layout, bands = meta["layout"], int(meta["bands"])
        interleave = bool(meta.get("interleave", True))
        # indexes saved before band keys were hashed bucket on raw keys
        key_hash = meta.get("key_hash", "none")
        # indexes saved before sharding are 1-way partitions
        n_shards = int(meta.get("n_shards", 1))
        stored = meta["fingerprint"]
        recomputed = config_fingerprint(cfg, layout=layout, bands=bands,
                                        interleave=interleave,
                                        key_hash=key_hash,
                                        n_shards=n_shards)
        if stored != recomputed:
            raise IndexConfigMismatch(
                f"fingerprint {stored} does not match stored config "
                f"(expected {recomputed}) — corrupt or stale index")
        if expected_cfg is not None:
            want = config_fingerprint(expected_cfg, layout=layout,
                                      bands=bands, interleave=interleave,
                                      key_hash=key_hash,
                                      n_shards=n_shards)
            if want != stored:
                raise IndexConfigMismatch(
                    f"index fingerprint {stored} != {want} for the "
                    f"requested config; rebuild the index")
        return cfg, dict(layout=layout, bands=bands, interleave=interleave,
                         key_hash=key_hash, n_shards=n_shards)

    @classmethod
    def load(cls, path: str | os.PathLike,
             expected_cfg: LSHConfig | None = None, *,
             recover: bool = False, device=None) -> "SignatureIndex":
        """Load a persisted index (either package's, either container) onto
        ``device`` — the card unless another is named; fails loudly on a
        config mismatch.

        Segment directories load their manifest + segment files; ``.npz``
        paths load the monolithic container as one sealed segment (indexes
        saved before key hashing or sharding load with those defaults).
        With ``expected_cfg``, its fingerprint must match the stored one,
        else :class:`IndexConfigMismatch`. A damaged segment file raises
        :class:`~repro_torch.index.segments.CorruptSegment` naming the
        file; with ``recover=True`` the damaged tail is quarantined and
        the longest valid prefix served, the drop report on
        ``idx.recovery``.
        """
        dev = resolve_device(device)
        if seglib.is_segmented(path) and os.path.exists(
                seglib.manifest_path(path)):
            meta, segments, recovery = seglib.load_segmented(
                path, recover=recover)
            if meta.get("format") != FORMAT_VERSION:
                raise IndexConfigMismatch(
                    f"index format {meta.get('format')} != {FORMAT_VERSION}")
            cfg, kw = cls._check_meta(meta, expected_cfg)
            if segments:
                sigs = np.concatenate([s.sigs for s in segments], axis=0)
                valid = np.concatenate([s.valid for s in segments], axis=0)
            else:
                sigs = np.zeros((0, cfg.f // 32), np.uint32)
                valid = np.zeros((0,), bool)
            idx = cls(cfg, sigs, valid, device=dev, **kw)
            idx._pending = []
            idx.segments = segments
            idx.recovery = recovery
            return idx
        try:
            z = np.load(path)
        except (OSError, EOFError, ValueError,
                zipfile.BadZipFile) as err:
            # the monolithic container has no prefix to fall back to
            raise CorruptSegment(
                os.fspath(path),
                f"legacy index {path} is unreadable (truncated or torn "
                f"write): {type(err).__name__}: {err}") from err
        with z:
            meta = json.loads(bytes(z["meta_json"].tobytes()).decode())
            if meta.get("format") != FORMAT_VERSION:
                raise IndexConfigMismatch(
                    f"index format {meta.get('format')} != {FORMAT_VERSION}")
            cfg, kw = cls._check_meta(meta, expected_cfg)
            idx = cls(cfg, z["sigs"], z["valid"], device=dev, **kw)
            csr = [(z[f"band{b}_keys"], z[f"band{b}_offsets"],
                    z[f"band{b}_ids"]) for b in range(idx.n_bands)]
        # the monolithic table is one sealed segment (global ids, base 0)
        idx._pending = []
        idx.segments = [Segment(0, idx.sigs, idx.valid, csr)]
        idx._csr_np = csr
        idx._merged_stale = False
        return idx
