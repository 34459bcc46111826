"""Carry an index built by the JAX package into the port.

The system has no weights; its state is the index. The reference index's
state is plain numpy (``idx.sigs``, ``idx.valid``, each segment's per-band
``(keys, offsets, ids)`` and ``dataclasses.asdict(idx.cfg)``), so the port
takes those arrays as they are and probes the same bucket table.
"""
from __future__ import annotations

import numpy as np

from ..core.pipeline import LSHConfig
from . import segments as seglib
from .segments import Segment
from .store import SignatureIndex


def index_from_arrays(cfg_dict: dict, sigs, valid, segments_csr, *,
                      layout: str = "band", bands: int, interleave: bool,
                      key_hash: str, device=None) -> SignatureIndex:
    """Build the port's :class:`SignatureIndex` from a reference index's
    numpy state. ``segments_csr`` lists, per segment in base order, the
    per-band ``(keys, offsets, ids)`` arrays; they are merged into one
    sealed segment — the merged table is what every probe reads, and the
    stable merge is bit-exact with the reference's."""
    cfg = LSHConfig(**cfg_dict)
    idx = SignatureIndex(cfg, sigs, valid, layout=layout, bands=bands,
                         interleave=interleave, key_hash=key_hash,
                         device=device)
    if not segments_csr:                    # an empty reference index
        segments_csr = [[seglib._empty_csr() for _ in range(idx.n_bands)]]
    csr = seglib.merge_band_csrs(
        [[(np.asarray(k, np.uint32), np.asarray(o, np.int32),
           np.asarray(i, np.int32)) for k, o, i in seg]
         for seg in segments_csr])
    if len(csr) != idx.n_bands:
        raise ValueError(f"{len(csr)} bands of CSR for an index of "
                         f"{idx.n_bands} bands")
    idx._pending = []
    idx.segments = [Segment(0, idx.sigs, idx.valid, csr)]
    return idx
