"""The ScalLoPS pipeline's configuration and job 1 (signature generation).

    cfg = LSHConfig(k=3, T=13, f=32, d=1, scheme="splitmix")
    sl = ScalLoPS(cfg)                      # device defaults to the card
    sigs = sl.signatures(ids, lengths)      # (N, f//32) int32 on the card

Job 2 (``ScalLoPS.search``: the flip, band and dense joins) is not ported
yet; the bucket index (``repro_torch.index``) serves queries without it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..util import resolve_device
from . import simhash

# Host-to-device chunking budget: job 1 runs over row chunks whose
# intermediates (the (n, S, f) table gather, or the (R, D) K1 operand plus
# its (R, f) output) stay under this many bytes. Rows are independent, so
# chunking is bit-exact; the reference materializes the whole corpus at
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
    pairs: torch.Tensor
    count: torch.Tensor
    overflowed: torch.Tensor


class ScalLoPS:
    def __init__(self, cfg: LSHConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _chunks(self, ids, lengths, per_residue_bytes: int):
        """Yield (ids, lengths) row chunks on the device."""
        if not isinstance(ids, torch.Tensor):
            ids = torch.from_numpy(np.ascontiguousarray(ids, np.int8))
        if not isinstance(lengths, torch.Tensor):
            lengths = torch.from_numpy(np.asarray(lengths, np.int32))
        N, L = ids.shape
        step = max(1, _CHUNK_BYTES // max(1, L * per_residue_bytes))
        for i in range(0, N, step):
            yield (ids[i:i + step].to(self.device, non_blocking=True),
                   lengths[i:i + step].to(self.device, non_blocking=True))

    # ---- job 1: Signature Generator (map-only) ----
    def signatures(self, ids, lengths) -> torch.Tensor:
        """Packed signatures (N, f//32) int32 on the device."""
        cfg = self.cfg
        width = cfg.f + (cfg.k * 21 if cfg.siggen_method == "matmul" else 0)
        parts = [simhash.signatures(i, l, k=cfg.k, T=cfg.T, f=cfg.f,
                                    scheme=cfg.scheme,
                                    method=cfg.siggen_method)
                 for i, l in self._chunks(ids, lengths, 8 * width)]
        if not parts:
            return torch.zeros((0, cfg.f // 32), dtype=torch.int32,
                               device=self.device)
        return torch.cat(parts)

    def feature_counts(self, ids, lengths) -> torch.Tensor:
        """Per-sequence neighbour-feature counts (N,) int32 on the device
        (0 => degenerate all-ones signature; the paper filters those)."""
        parts = [simhash.feature_counts(i, l, k=self.cfg.k, T=self.cfg.T)
                 for i, l in self._chunks(ids, lengths, 16)]
        if not parts:
            return torch.zeros((0,), dtype=torch.int32, device=self.device)
        return torch.cat(parts)
