"""End-to-end ScalLoPS pipeline: the paper's two MapReduce jobs as one API.

    cfg = LSHConfig(k=3, T=13, f=32, d=1, scheme="splitmix")
    sl = ScalLoPS(cfg)                          # device defaults to the card
    ref_sigs = sl.signatures(ref_ids, ref_lens) # job 1: (N, f//32) int32
    qry_sigs = sl.signatures(qry_ids, qry_lens)
    pairs, count, overflowed = sl.search(qry_sigs, ref_sigs)   # job 2

``search`` returns a SearchResult: the fixed-capacity pair buffer, the true
match count, and ``overflowed`` — True when the buffer truncated rows, so
callers grow capacity and retry instead of silently losing pairs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..util import resolve_device, u32_to_i32
from . import simhash
from .hamming import threshold_pairs
from .join import band_join, flip_join

# Host-to-device chunking budget: job 1 runs over row chunks whose device
# bytes stay under this many (ScalLoPS._chunk_rows). Rows are independent,
# so chunking is bit-exact; the reference materializes the whole corpus at
# once, which at Swiss-Prot scale (454,401 refs x ~770 residues, f=32)
# would be ~45 GB.
_CHUNK_BYTES = 1 << 30


@dataclass(frozen=True)
class LSHConfig:
    """Paper parameters (§5): shingle length k, neighbour threshold T,
    signature bits f, Hamming threshold d."""
    k: int = 3
    T: int = 13
    f: int = 32
    d: int = 0
    scheme: str = "java"          # "java" (faithful) | "splitmix" (beyond-paper)
    siggen_method: str = "table"  # "table" (beyond-paper) | "matmul" (paper structure)
    join_method: str = "flip"     # "flip" (paper) | "band" | "dense"
    max_pairs: int = 1 << 16

    def __post_init__(self):
        if self.f % 32 or self.f < 32:
            raise ValueError(f"f must be a positive multiple of 32, got {self.f}")
        if self.scheme == "java" and self.f > 32:
            raise ValueError("java hashCode yields 32 bits (paper); use splitmix")


class SearchResult(NamedTuple):
    """Fixed-capacity join result. ``count`` is the true number of matches;
    ``overflowed`` is True iff the buffer truncated rows (grow + retry)."""
    pairs: torch.Tensor         # (capacity, 3) int32, -1 past the stored rows
    count: torch.Tensor         # () int32 — true match count
    overflowed: torch.Tensor    # () bool — buffer truncated


class ScalLoPS:
    def __init__(self, cfg: LSHConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # bytes taken from host arrays onto a card, never reset (a CPU
        # pipeline moves nothing and counts nothing)
        self.h2d_bytes = 0

    def _counted(self, x, convert) -> torch.Tensor:
        """``x`` as a tensor (numpy through ``convert``), its bytes added to
        ``h2d_bytes`` when it is a host array bound for a card."""
        if not isinstance(x, torch.Tensor):
            x = convert(x)
        if x.device.type == "cpu" and self.device.type != "cpu":
            self.h2d_bytes += x.numel() * x.element_size()
        return x

    def _chunk_rows(self, L: int, kind: str) -> int:
        """Rows of a job-1 chunk of width ``L`` (``kind`` "signatures" or
        "counts"): as many as keep what a row holds on the device at once
        under ``_CHUNK_BYTES``. On the card's table route (the
        ``table_sums`` kernel: the table signatures, and every count) that
        is the row's residues, its length and its output. Elsewhere it is
        the twin's (S, f) int32 gather, budgeted at 8 f bytes a residue (16
        for a count), or K1's (R, k * 21) operand and (R, f) output."""
        cfg = self.cfg
        if self.device.type == "cuda" and (
                kind == "counts" or cfg.siggen_method == "table"):
            row = L + 8 + (cfg.f // 8 if kind == "signatures" else 4)
        elif kind == "counts":
            row = 16 * L
        else:
            row = 8 * L * (cfg.f + (cfg.k * 21 if cfg.siggen_method
                                    == "matmul" else 0))
        return max(1, _CHUNK_BYTES // max(1, row))

    def _chunks(self, ids, lengths, kind: str):
        """Yield (ids, lengths) row chunks on the device."""
        ids = self._counted(ids, lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.int8)))
        lengths = self._counted(lengths, lambda a: torch.from_numpy(
            np.asarray(a, np.int32)))
        N, L = ids.shape
        step = self._chunk_rows(L, kind)
        for i in range(0, N, step):
            yield (ids[i:i + step].to(self.device, non_blocking=True),
                   lengths[i:i + step].to(self.device, non_blocking=True))

    # ---- job 1: Signature Generator (map-only) ----
    def signatures(self, ids, lengths) -> torch.Tensor:
        """Packed signatures (N, f//32) int32 on the device."""
        cfg = self.cfg
        parts = [simhash.signatures(i, l, k=cfg.k, T=cfg.T, f=cfg.f,
                                    scheme=cfg.scheme,
                                    method=cfg.siggen_method)
                 for i, l in self._chunks(ids, lengths, "signatures")]
        if not parts:
            return torch.zeros((0, cfg.f // 32), dtype=torch.int32,
                               device=self.device)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def feature_counts(self, ids, lengths) -> torch.Tensor:
        """Per-sequence neighbour-feature counts (N,) int32 on the device
        (0 => degenerate all-ones signature; the paper filters those)."""
        parts = [simhash.feature_counts(i, l, k=self.cfg.k, T=self.cfg.T)
                 for i, l in self._chunks(ids, lengths, "counts")]
        if not parts:
            return torch.zeros((0,), dtype=torch.int32, device=self.device)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    # ---- job 2: Signature Processor ----
    def _on_device(self, x, dtype=None) -> torch.Tensor:
        """A tensor on the pipeline's device; numpy signatures (uint32)
        become int32 bit patterns, numpy masks bool tensors."""
        x = self._counted(x, u32_to_i32 if dtype is None else
                          lambda a: torch.from_numpy(np.asarray(a, dtype)))
        return x.to(self.device).contiguous()

    def search(self, q_sigs, r_sigs, *, max_pairs: int | None = None,
               q_valid=None, r_valid=None) -> SearchResult:
        """Join the signature sets. q_valid/r_valid: optional bool masks —
        pairs touching invalid (zero-feature) sequences are dropped, per
        the paper's non-zero-signature rule. Check ``overflowed`` before
        trusting the pair buffer to be complete.

        Counts are int64 inside, so ``overflowed`` holds past 2^31 matches;
        ``count`` comes back int32, the reference's type."""
        cfg = self.cfg
        mp = max_pairs or cfg.max_pairs
        q = self._on_device(q_sigs)
        r = self._on_device(r_sigs)
        truncated = torch.zeros((), dtype=torch.bool, device=self.device)
        if cfg.join_method == "flip":
            pairs, count = flip_join(q, r, f=cfg.f, d=cfg.d, max_pairs=mp)
        elif cfg.join_method == "band":
            # band_join's count comes from capacity-bounded candidates, so
            # it can undercount once a band overran; truncated covers that
            pairs, count, truncated = band_join(q, r, f=cfg.f, d=cfg.d,
                                                max_pairs=mp)
        elif cfg.join_method == "dense":
            pairs, count = threshold_pairs(q, r, cfg.d, mp)
        else:
            raise ValueError(f"unknown join_method {cfg.join_method!r}")
        # overflow is judged on the raw join count: once the buffer
        # truncates, any downstream count (the masked one too) undercounts
        overflowed = (count > mp) | truncated
        if q_valid is not None or r_valid is not None:
            qv = (self._on_device(q_valid, bool) if q_valid is not None
                  else torch.ones(q.shape[0], dtype=torch.bool,
                                  device=self.device))
            rv = (self._on_device(r_valid, bool) if r_valid is not None
                  else torch.ones(r.shape[0], dtype=torch.bool,
                                  device=self.device))
            ok = ((pairs[:, 0] >= 0) & qv[pairs[:, 0].clamp_min(0).long()]
                  & rv[pairs[:, 1].clamp_min(0).long()])
            pairs = torch.where(ok[:, None], pairs, -1)
            count = ok.sum()
        return SearchResult(pairs, count.to(torch.int32), overflowed)
