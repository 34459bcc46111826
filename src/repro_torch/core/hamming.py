"""Hamming distance on packed signatures.

Signatures are (..., nwords) int32 tensors holding uint32 bit patterns
(f = nwords*32 bits). torch has no popcount operator, so the plain path
counts bits with the SWAR ladder; the CUDA kernel K2 uses ``__popc``.
"""
from __future__ import annotations

import torch

from ..util import as_unsigned


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each 32-bit word (SWAR). ``x`` is int64 holding an
    unsigned 32-bit value, so shifts are logical and nothing overflows."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance of packed signatures (broadcasting)."""
    x = as_unsigned(torch.bitwise_xor(a, b))
    return torch.sum(popcount32(x), dim=-1).to(torch.int32)
