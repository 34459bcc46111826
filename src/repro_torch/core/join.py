"""Band keys for the pigeonhole banding of the bucket index.

Split the f signature bits into ``bands >= d+1`` disjoint groups: any pair
within Hamming distance d agrees exactly on at least one band, so equal
band keys are the candidate test (``repro/core/join.py``). The flip, band
and dense joins themselves are not ported yet.

Keys are int64 tensors holding uint32 values: torch's uint32 has no shifts
and no ``searchsorted``, and an int32 view would reorder keys >= 2^31.
"""
from __future__ import annotations

import numpy as np
import torch

from .simhash import unpack_bits

_M32 = 0xFFFFFFFF


def band_bit_groups(f: int, bands: int, *, interleave: bool = False):
    """Disjoint partition of bit positions into ``bands`` groups:
    contiguous, or interleaved (bit i -> band i % bands). Both keep the
    pigeonhole guarantee; interleaving spreads position-skewed bit entropy."""
    if interleave:
        return [np.arange(b, f, bands) for b in range(bands)]
    edges = np.linspace(0, f, bands + 1).astype(int)
    return [np.arange(edges[b], edges[b + 1]) for b in range(bands)]


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 ``h`` < 2^32 and a 32-bit constant ``c``,
    without overflowing int64: the high half-word's product only feeds
    bits 16..31, so it is masked to 16 bits before the shift."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def mix32(keys: torch.Tensor) -> torch.Tensor:
    """Murmur3 fmix32 over uint32 values held in int64; every product is
    reduced mod 2^32. A bijection on uint32, so bucket membership is
    exactly preserved."""
    h = keys.to(torch.int64) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def band_keys(sigs: torch.Tensor, f: int, bands: int, *,
              interleave: bool = False, key_hash: str = "none") -> torch.Tensor:
    """Per-band keys: (N, bands) int64 holding uint32 values.

    Bands up to 32 bits wide pack exactly into the key. Wider bands FOLD:
    the band's 32-bit words chain through :func:`mix32`
    (``acc = mix32(acc) ^ word``), so equal band bits always give equal
    keys. ``key_hash="splitmix"`` mixes each key once more (bijective).
    """
    if key_hash not in ("splitmix", "none"):
        raise ValueError(f"unknown key_hash {key_hash!r}")
    bits = unpack_bits(sigs, f).to(torch.int64)      # (N, f) in {0,1}
    keys = []
    for grp in band_bit_groups(f, bands, interleave=interleave):
        seg = bits[:, torch.as_tensor(grp, device=sigs.device)]
        acc = None
        for s0 in range(0, seg.shape[-1], 32):
            wordbits = seg[:, s0:s0 + 32]
            shifts = torch.arange(wordbits.shape[-1], device=sigs.device)
            word = torch.sum(wordbits << shifts, dim=-1)
            acc = word if acc is None else mix32(acc) ^ word
        keys.append(acc)
    out = torch.stack(keys, dim=-1)
    return mix32(out) if key_hash == "splitmix" else out
