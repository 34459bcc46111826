"""k-shingle extraction as strided views over int8 residue tensors.

A batch of padded sequences (N, L) becomes a dense shingle tensor
(N, S, k) with a validity mask — no string ops.
"""
from __future__ import annotations

import torch

from .alphabet import PAD


def num_shingles(seq_len: int, k: int) -> int:
    return max(seq_len - k + 1, 0)


def extract_shingles(ids: torch.Tensor, lengths: torch.Tensor, k: int):
    """Extract overlapping k-shingles from a padded batch.

    Args:
      ids: (N, L) int8 residue ids, padded with PAD.
      lengths: (N,) true sequence lengths, on the same device.
      k: shingle length.

    Returns:
      shingles: (N, S, k) int8 where S = L - k + 1; invalid positions are PAD.
      mask: (N, S) bool — True where the shingle is fully inside the sequence.
    """
    N, L = ids.shape
    S = num_shingles(L, k)
    if S == 0:
        return (ids.new_full((N, 0, k), PAD),
                torch.zeros((N, 0), dtype=torch.bool, device=ids.device))
    sh = ids.unfold(1, k, 1)                         # (N, S, k) view
    pos = torch.arange(S, device=ids.device)
    mask = (pos[None, :] + k) <= lengths.to(ids.device)[:, None]
    sh = torch.where(mask[..., None], sh, torch.full_like(sh, PAD))
    return sh, mask


def shingle_ids(shingles: torch.Tensor, alphabet_size: int = 20):
    """Flatten (…, k) shingles to int64 word ids in [0, alphabet_size**k).

    Invalid shingles (containing PAD) map to -1.
    """
    k = shingles.shape[-1]
    valid = torch.all(shingles < alphabet_size, dim=-1)
    powers = alphabet_size ** torch.arange(k - 1, -1, -1,
                                           device=shingles.device)
    wid = torch.sum(shingles.to(torch.int64) * powers, dim=-1)
    return torch.where(valid, wid, torch.full_like(wid, -1))
