"""Append-only index segments — the unit of incremental growth.

Every ingest seals a **segment**: its own packed signature rows plus its
own per-band CSR buckets over *global* ids. The merged bucket table of the
whole index is a stable linear merge of the segment CSRs
(:func:`merge_band_csrs`), bit-exact with a from-scratch build.

As in the reference (``repro/index/segments.py``), the CSR arrays are host
numpy: keys uint32, offsets int32, ids int32. Only the keys of a new
segment (band keys, or flip keys) are computed with torch, on the index's
device.

Persistence is a **manifest + per-segment files** in the reference's
format (the same arrays and dtypes, checksums and manifest keys), so each
package loads the other's directories:
``save_segmented`` appends only the segment files that are not on disk
yet (O(delta)); a rewrite goes under a new write generation. Every file
goes through :func:`repro_torch.faults.atomic_write`, segments before the
manifest that names them. Damage that arrives anyway raises a typed
:class:`CorruptSegment` naming the file; ``load_segmented(recover=True)``
moves the damaged segment *and everything after it* into ``quarantine/``
(later segments' global ids assume every earlier row exists), rewrites
the manifest to the longest valid prefix, and serves that.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import zipfile

import numpy as np
import torch

from ..core.join import band_keys, flip_masks
from ..faults import atomic_write
from ..obs import REGISTRY
from ..util import as_unsigned, u32_to_i32

_M_QUARANTINED = REGISTRY.counter(
    "segments_quarantined", "damaged segment files moved to quarantine/ "
    "during recovery loads")


class CorruptSegment(ValueError):
    """A persisted segment file (or the manifest entry describing it) is
    damaged: truncated, checksum-mismatched, missing, or inconsistent
    with its neighbours. ``file`` names the offending file."""

    def __init__(self, file: str, message: str):
        super().__init__(message)
        self.file = file


@dataclasses.dataclass
class Segment:
    """One sealed, immutable slice of the index. ``base`` is the global id
    of row 0; ``csr`` holds one ``(keys, offsets, ids)`` sorted bucket
    table per band with **global** ids."""
    base: int
    sigs: np.ndarray                    # (n, f//32) uint32
    valid: np.ndarray                   # (n,) bool
    csr: list                           # per band: (keys, offsets, ids)

    @property
    def n_rows(self) -> int:
        return int(self.sigs.shape[0])

    @property
    def n_entries(self) -> int:
        return sum(len(ids) for _, _, ids in self.csr)


def sort_bucket(keys: np.ndarray, ids: np.ndarray):
    """Group (key, id) entries into CSR: (unique keys, offsets, sorted ids).

    ``keys`` are unsigned 32-bit values (uint32, or int64 holding them), so
    numpy sorts them in uint32 order. The stable sort keeps every bucket's
    members in ascending id order — the bit-exactness anchor of the merge.
    """
    order = np.argsort(keys, kind="stable")
    ks, sids = keys[order], ids[order]
    uk, first = np.unique(ks, return_index=True)
    offsets = np.concatenate([first, [len(ks)]]).astype(np.int32)
    return uk.astype(np.uint32), offsets, sids.astype(np.int32)


def _empty_csr():
    return sort_bucket(np.zeros(0, np.uint32), np.zeros(0, np.int32))


def build_segment(sigs, valid, base: int, *, layout: str, f: int, d: int,
                  bands: int, interleave: bool, key_hash: str,
                  device=torch.device("cpu")) -> Segment:
    """Seal a segment: bucket its rows under the index's layout — per-band
    CSRs of band keys, or one CSR of every row's C(f, <=d) flip keys.
    Keys are computed on ``device``; the CSR is built on the host."""
    sigs = np.ascontiguousarray(np.asarray(sigs, np.uint32))
    valid = np.asarray(valid, bool).reshape(-1)
    local_ids = np.nonzero(valid)[0].astype(np.int64)
    gids = (local_ids + base).astype(np.int32)
    if layout == "flip":
        if len(gids) == 0:
            return Segment(base, sigs, valid, [_empty_csr()])
        masks = flip_masks(f, d)[:, 0].astype(np.int64)
        w0 = as_unsigned(u32_to_i32(sigs[local_ids, 0]).to(device))
        keys = (w0[:, None] ^ torch.from_numpy(masks).to(device)[None, :])
        ids = np.repeat(gids, masks.shape[0])
        return Segment(base, sigs, valid,
                       [sort_bucket(keys.reshape(-1).cpu().numpy(), ids)])
    if len(gids) == 0:
        return Segment(base, sigs, valid,
                       [_empty_csr() for _ in range(bands)])
    kb = band_keys(u32_to_i32(sigs[local_ids]).to(device), f, bands,
                   interleave=interleave, key_hash=key_hash).cpu().numpy()
    return Segment(base, sigs, valid,
                   [sort_bucket(kb[:, b], gids) for b in range(bands)])


def merge_band_csrs(csr_lists: list[list]) -> list:
    """Merge per-segment per-band CSRs into one bucket table per band.
    Segments arrive in base order with disjoint ascending id ranges, so the
    stable sort groups equal keys with ids ascending — exactly the table of
    a from-scratch build over the concatenated corpus."""
    if len(csr_lists) == 1:
        return csr_lists[0]
    out = []
    for b in range(len(csr_lists[0])):
        keys = np.concatenate(
            [np.repeat(c[b][0], np.diff(c[b][1])) for c in csr_lists])
        ids = np.concatenate([c[b][2] for c in csr_lists])
        out.append(sort_bucket(keys, ids))
    return out


# ---------------------------------------------------------------- manifest IO
MANIFEST_VERSION = 1
MANIFEST_NAME = "manifest.json"


def _segment_filename(gen: int, i: int) -> str:
    return f"seg-g{gen:03d}-{i:05d}.npz"


def manifest_path(path) -> str:
    p = os.fspath(path)
    return p if p.endswith(MANIFEST_NAME) else os.path.join(p, MANIFEST_NAME)


def is_segmented(path) -> bool:
    """True when ``path`` names a segment directory / manifest (the
    monolithic legacy ``.npz`` loads through the other branch)."""
    p = os.fspath(path)
    return (p.endswith(MANIFEST_NAME) or os.path.isdir(p)
            or not p.endswith(".npz"))


def stored_arrays(sigs, valid, csr) -> dict:
    """Signatures, validity and per-band CSR as the files hold them and the
    checksum hashes their bytes: sigs uint32, valid bool, per band keys
    uint32, offsets and ids int32, all C-contiguous. Any other dtype
    would give bytes the other package's loader rejects as swapped or
    corrupt."""
    out = {"sigs": np.ascontiguousarray(sigs, np.uint32),
           "valid": np.ascontiguousarray(valid, bool)}
    for b, (keys, offsets, ids) in enumerate(csr):
        out[f"band{b}_keys"] = np.ascontiguousarray(keys, np.uint32)
        out[f"band{b}_offsets"] = np.ascontiguousarray(offsets, np.int32)
        out[f"band{b}_ids"] = np.ascontiguousarray(ids, np.int32)
    return out


def segment_checksum(seg: Segment) -> str:
    """Content hash of a segment (signatures + validity + every band's
    CSR): what lets the append-only save prove the on-disk prefix really
    is this index's prefix, and the loader prove the files were not
    swapped or corrupted."""
    a = stored_arrays(seg.sigs, seg.valid, seg.csr)
    h = hashlib.sha256()
    h.update(a["sigs"].tobytes())
    h.update(a["valid"].tobytes())
    for b in range(len(seg.csr)):
        for part in ("keys", "offsets", "ids"):
            h.update(a[f"band{b}_{part}"].tobytes())
    return h.hexdigest()[:16]


def _segment_entry(gen: int, i: int, seg: Segment) -> dict:
    return {"file": _segment_filename(gen, i), "base": int(seg.base),
            "n_rows": seg.n_rows, "n_entries": seg.n_entries,
            "sha": segment_checksum(seg)}


def save_segmented(path, meta: dict, segments: list[Segment],
                   n_bands: int) -> int:
    """Write manifest + per-segment npz files; returns how many segment
    files were (re)written.

    Append-only: when the directory already holds a manifest with the
    same fingerprint whose segment list is a prefix of ours, only the NEW
    segments hit disk. Any mismatch (different fingerprint, diverged
    prefix, or a compaction that shrank the list) rewrites everything
    under a NEW write generation — filenames carry it, so a crash
    mid-rewrite leaves the old manifest and files loadable — and drops
    the stale generation's files only after the new manifest has landed.
    """
    mpath = manifest_path(path)
    root = os.path.dirname(mpath)
    os.makedirs(root, exist_ok=True)
    start = 0
    gen = 0
    old_files = []
    old = None
    if os.path.exists(mpath):
        try:
            with open(mpath) as fh:
                old = json.load(fh)
        except (OSError, json.JSONDecodeError):
            old = None
    if old is not None:
        old_entries = old.get("segments", [])
        old_files = [e["file"] for e in old_entries]
        gen = int(old.get("write_gen", 0))
        entries = [_segment_entry(gen, i, s)
                   for i, s in enumerate(segments)]
        same_cfg = old.get("fingerprint") == meta["fingerprint"]
        prefix = (len(old_entries) <= len(entries)
                  and all(o == n for o, n in zip(old_entries, entries)))
        if same_cfg and prefix:
            start = len(old_entries)    # append within the old generation
        else:
            gen += 1                    # full rewrite: fresh filenames
    entries = [_segment_entry(gen, i, s) for i, s in enumerate(segments)]
    written = 0
    for i in range(start, len(entries)):
        seg = segments[i]
        payload = {**stored_arrays(seg.sigs, seg.valid, seg.csr[:n_bands]),
                   "base": np.int64(seg.base)}
        # segments land before the manifest below
        atomic_write(os.path.join(root, entries[i]["file"]),
                     lambda fh, p=payload: np.savez_compressed(fh, **p))
        written += 1
    manifest = dict(meta)
    manifest["manifest_version"] = MANIFEST_VERSION
    manifest["write_gen"] = gen
    manifest["segments"] = entries
    blob = json.dumps(manifest, sort_keys=True, indent=1).encode()
    atomic_write(mpath, lambda fh: fh.write(blob))  # lands atomically, last
    keep = {e["file"] for e in entries}
    for f in old_files:                 # a rewrite dropped the old gen
        if f not in keep and os.path.exists(os.path.join(root, f)):
            os.unlink(os.path.join(root, f))
    return written


def _load_segment_file(root: str, e: dict, n_bands: int,
                       expect_base: int) -> Segment:
    """Load + verify ONE manifest entry's segment file; every failure
    mode is a :class:`CorruptSegment` naming the file."""
    f = e["file"]
    fpath = os.path.join(root, f)
    try:
        with np.load(fpath) as z:
            csr = [(z[f"band{b}_keys"], z[f"band{b}_offsets"],
                    z[f"band{b}_ids"]) for b in range(n_bands)]
            seg = Segment(int(z["base"]), z["sigs"],
                          np.asarray(z["valid"], bool), csr)
    except FileNotFoundError:
        raise CorruptSegment(f, f"segment {f} is missing from disk") \
            from None
    except (OSError, EOFError, KeyError, zipfile.BadZipFile,
            ValueError) as err:
        # a torn write truncates the npz zip container — np.load raises
        # BadZipFile/EOFError/OSError depending on where the tear landed
        raise CorruptSegment(
            f, f"segment {f} is unreadable (truncated or torn write): "
               f"{type(err).__name__}: {err}") from err
    if seg.n_rows != e["n_rows"]:
        raise CorruptSegment(f, f"segment {f} holds {seg.n_rows} rows, "
                                f"manifest says {e['n_rows']}")
    if "sha" in e and segment_checksum(seg) != e["sha"]:
        raise CorruptSegment(
            f, f"segment {f} content hash does not match the "
               f"manifest — swapped or corrupt segment file")
    if seg.base != expect_base or int(e["base"]) != expect_base:
        # segments concatenate in manifest order and their CSR ids embed
        # the stored base: any disagreement would map global ids to the
        # wrong signature rows
        raise CorruptSegment(
            f, f"segment {f} claims base {seg.base} "
               f"(manifest {e['base']}) but {expect_base} rows precede "
               f"it — manifest reordered or corrupt")
    return seg


def _quarantine(root: str, entries: list[dict]) -> list[str]:
    """Move the given manifest entries' files into ``quarantine/``
    (keeping the evidence — nothing is deleted) and count them."""
    qdir = os.path.join(root, "quarantine")
    os.makedirs(qdir, exist_ok=True)
    moved = []
    for e in entries:
        src = os.path.join(root, e["file"])
        if os.path.exists(src):
            shutil.move(src, os.path.join(qdir, e["file"]))
            moved.append(e["file"])
            _M_QUARANTINED.inc()
    return moved


def load_segmented(path, *, recover: bool = False
                   ) -> tuple[dict, list[Segment], dict | None]:
    """Read manifest + every segment file; returns
    ``(meta, segments, recovery)``.

    Default: any damaged segment raises :class:`CorruptSegment` naming
    the file — a load either serves exactly what was saved or refuses.
    With ``recover=True`` the longest valid segment *prefix* is served
    instead: the first damaged segment and every segment after it move to
    ``quarantine/``, the manifest is rewritten (atomically) to the
    surviving prefix, and ``recovery`` reports what was dropped.
    """
    mpath = manifest_path(path)
    root = os.path.dirname(mpath)
    with open(mpath) as fh:
        manifest = json.load(fh)
    if manifest.get("manifest_version") != MANIFEST_VERSION:
        raise ValueError(
            f"manifest version {manifest.get('manifest_version')} != "
            f"{MANIFEST_VERSION}")
    n_bands = 1 if manifest["layout"] == "flip" else int(manifest["bands"])
    segments = []
    recovery = None
    total = 0
    entries = manifest["segments"]
    for i, e in enumerate(entries):
        try:
            seg = _load_segment_file(root, e, n_bands, total)
        except CorruptSegment as err:
            if not recover:
                raise
            quarantined = _quarantine(root, entries[i:])
            manifest["segments"] = entries[:i]
            blob = json.dumps(manifest, sort_keys=True, indent=1).encode()
            atomic_write(mpath, lambda fh: fh.write(blob))
            recovery = dict(
                file=err.file, reason=str(err), quarantined=quarantined,
                n_segments_dropped=len(entries) - i,
                n_rows_dropped=sum(int(x["n_rows"]) for x in entries[i:]),
                n_rows_served=total)
            break
        total += seg.n_rows
        segments.append(seg)
    return manifest, segments, recovery
