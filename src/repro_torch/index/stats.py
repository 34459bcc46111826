"""Bucket-occupancy diagnostics for a :class:`SignatureIndex`.

The quality of every probe and self-join depends on how evenly the LSH keys
spread references over buckets: a degenerate band (one giant bucket) turns
the probe into a dense sweep and the self-join quadratic. These helpers make
that observable — per-band bucket-size histograms, occupancy entropy, and a
scheme comparison that answers the question of whether
``scheme="splitmix"`` recovers the key diversity the Java-hash signature
bits lose to position skew. The port of ``repro/index/stats.py``; the
histograms are host numpy over the index's CSR arrays.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .store import SignatureIndex


@dataclass(frozen=True)
class BandStats:
    band: int
    n_buckets: int               # unique keys
    n_entries: int               # references placed (valid only)
    max_bucket: int
    mean_bucket: float
    entropy_bits: float          # Shannon entropy of the occupancy dist.
    entropy_frac: float          # entropy / log2(n_entries) in [0, 1]
    expected_probe: float        # E[bucket size of a random member] =
                                 # sum m^2 / n — the probe/self-join cost
    hist: dict[int, int]         # bucket size -> count (log2-binned above 8)


def _hist(sizes: np.ndarray) -> dict[int, int]:
    out: dict[int, int] = {}
    for s in sizes:
        s = int(s)
        key = s if s <= 8 else 1 << int(np.ceil(np.log2(s)))
        out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))


def band_stats(index: SignatureIndex) -> list[BandStats]:
    """Per-band occupancy statistics of a built index."""
    index._ensure_built()
    out = []
    for b, (keys, offsets, ids) in enumerate(index._csr_np):
        sizes = np.diff(np.asarray(offsets)).astype(np.int64)
        n = int(sizes.sum())
        if n == 0:
            out.append(BandStats(b, 0, 0, 0, 0.0, 0.0, 0.0, 0.0, {}))
            continue
        p = sizes / n
        ent = float(-(p * np.log2(p, where=p > 0)).sum())
        out.append(BandStats(
            band=b, n_buckets=len(sizes), n_entries=n,
            max_bucket=int(sizes.max()), mean_bucket=float(sizes.mean()),
            entropy_bits=ent,
            entropy_frac=ent / max(np.log2(n), 1e-9),
            expected_probe=float((sizes.astype(float) ** 2).sum() / n),
            hist=_hist(sizes)))
    return out


def occupancy_report(index: SignatureIndex) -> str:
    """Human-readable per-band occupancy summary."""
    lines = [f"index: {index.size} refs, layout={index.layout}, "
             f"bands={index.n_bands}, scheme={index.cfg.scheme}"]
    for s in band_stats(index):
        lines.append(
            f"  band {s.band}: {s.n_buckets} buckets / {s.n_entries} refs, "
            f"max={s.max_bucket}, E[probe]={s.expected_probe:.1f}, "
            f"entropy={s.entropy_bits:.2f}b ({s.entropy_frac:.0%} of ideal)")
    return "\n".join(lines)


def compare_schemes(cfg, ids, lens, *, schemes=("java", "splitmix"),
                    bands: int | None = None,
                    device=None) -> dict[str, list[BandStats]]:
    """Build an index per hash scheme over the same corpus, on ``device``
    (the card unless another is named), and report occupancy side by
    side (the key-entropy experiment)."""
    import dataclasses as dc
    out = {}
    for scheme in schemes:
        c = dc.replace(cfg, scheme=scheme)
        idx = SignatureIndex.build(c, ids, lens, bands=bands, device=device)
        out[scheme] = band_stats(idx)
    return out
