"""Plain reference of job 1: SimHash signatures and validity from residues.

A shingle is k consecutive residues inside the sequence. Its features are
the codebook words w (all 20^k words of k residues) whose BLOSUM62 score
against it reaches T; each adds score * h(w) to the sequence's vector V,
where h(w) is the word's +1/-1 hyperplane row. Bit j of the signature is
V_j >= 0, packed 32 to a uint32 word, bit 0 first. A sequence is valid
when it has at least one feature. Everything is integer arithmetic, so
the reference and the program must agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .tables import BLOSUM62, PAD, hyperplane_signs

ROW_BYTES = 1 << 30         # temporaries of one block of sequences


class Job1:
    """Per-word contribution and feature-count tables of (k, T, f), built
    on ``device`` from the definitions above."""

    def __init__(self, k: int, T: int, f: int, device):
        self.k, self.T, self.f, self.device = k, T, f, device
        W = 20 ** k
        words = np.arange(W)
        digits = [(words // 20 ** (k - 1 - i)) % 20 for i in range(k)]
        B = torch.as_tensor(BLOSUM62, device=device)
        H = torch.as_tensor(hyperplane_signs(W, f), dtype=torch.float64,
                            device=device)
        dig = [torch.as_tensor(x, device=device) for x in digits]
        contrib = torch.empty((W, f), dtype=torch.int64, device=device)
        count = torch.empty((W,), dtype=torch.int64, device=device)
        step = 1024
        for a in range(0, W, step):
            b = min(a + step, W)
            score = sum(B[dig[i][a:b]][:, dig[i]] for i in range(k))
            weight = torch.where(score >= T, score, 0)
            # float64 holds these integer sums exactly (|V| < 2^31)
            contrib[a:b] = (weight.to(torch.float64) @ H).round().to(
                torch.int64)
            count[a:b] = (score >= T).sum(dim=1)
        # one zero row for shingles that cross the end of a sequence
        self.contrib = torch.cat([contrib, contrib.new_zeros((1, f))])
        self.count = torch.cat([count, count.new_zeros((1,))])

    def _word_ids(self, ids: torch.Tensor, lens: torch.Tensor):
        k = self.k
        x = ids.to(torch.int64)
        S = max(x.shape[1] - k + 1, 0)
        w = torch.zeros((x.shape[0], S), dtype=torch.int64, device=x.device)
        for i in range(k):
            w = w * 20 + x[:, i:i + S]
        pos = torch.arange(S, device=x.device)
        inside = pos[None, :] + k <= lens[:, None]
        return torch.where(inside, w, 20 ** k)

    def __call__(self, ids, lens):
        """(N, L) int8 residues (PAD-padded) and (N,) lengths, on any
        device -> (signatures (N, f // 32) uint32 numpy, valid (N,) bool
        numpy)."""
        ids = torch.as_tensor(ids).to(self.device)
        lens = torch.as_tensor(lens).to(self.device).to(torch.int64)
        N, L = ids.shape
        step = max(1, ROW_BYTES // max(1, L * self.f * 8))
        sigs, valid = [], []
        shifts = torch.arange(32, device=self.device, dtype=torch.int64)
        for a in range(0, N, step):
            wid = self._word_ids(ids[a:a + step], lens[a:a + step])
            V = self.contrib[wid].sum(dim=1)                    # (n, f)
            bits = (V >= 0).to(torch.int64).reshape(V.shape[0], -1, 32)
            sigs.append((bits << shifts).sum(dim=-1).cpu().numpy().astype(
                np.uint32))
            valid.append((self.count[wid].sum(dim=1) > 0).cpu().numpy())
        return np.concatenate(sigs), np.concatenate(valid)


def band_values(sigs: np.ndarray, f: int, bands: int) -> np.ndarray:
    """(N, bands) int64: band b holds bits b, b + bands, b + 2 * bands, ...
    of the signature, the first of them lowest. Two signatures share a
    bucket of band b exactly when these values are equal."""
    words = sigs.astype(np.uint64)
    bits = ((words[:, :, None] >> np.arange(32, dtype=np.uint64)) & 1)
    bits = bits.reshape(sigs.shape[0], -1)[:, :f].astype(np.int64)
    out = np.zeros((sigs.shape[0], bands), np.int64)
    for b in range(bands):
        grp = bits[:, b::bands]
        out[:, b] = (grp << np.arange(grp.shape[1], dtype=np.int64)).sum(1)
    return out


def signs(sigs: np.ndarray, f: int, device, dtype) -> torch.Tensor:
    """(N, f) +1/-1 of each signature bit, for distances by a product:
    hamming(a, b) = (f - a . b) / 2."""
    t = torch.as_tensor(sigs.astype(np.int64), device=device)
    sh = torch.arange(32, device=device, dtype=torch.int64)
    bits = ((t[:, :, None] >> sh) & 1).reshape(t.shape[0], -1)[:, :f]
    return (bits * 2 - 1).to(dtype)
