"""BLAST-like seed-and-extend baseline (paper §2.1, Algorithm 1).

The paper's quality methodology compares ScalLoPS' emitted pairs against
the pairs BLAST finds ("intersection pairs", §5.2). This is the port of
``repro/align/seed_extend.py``, the same algorithm with the same output,
list order included:

  1. tokenize queries into k-shingles;
  2. expand each shingle to its BLOSUM62 neighbourhood (score >= T) — the
     core's neighbour product, on the device;
  3. probe an inverted index word_id -> (ref, pos) for exact seed matches;
  4. ungapped extension: best-scoring segment through each seeded diagonal
     (Kadane on the diagonal's substitution scores — the maximal HSP);
  5. report pairs whose best HSP score >= S_min.

Steps 3-5 run on the host in numpy. Where the reference loops in Python,
the port takes the same values in the same order from arrays: the index
is a CSR over word ids whose entries keep the reference's (ref, pos) scan
order, seeded diagonals keep the order of their first seed, and Kadane's
recurrence runs over many diagonals at once (:func:`_kadane_diagonals`,
equal to :func:`_kadane` on each).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.alphabet import BLOSUM62_PADDED
from ..core.neighbors import neighbor_scores
from ..core.shingle import extract_shingles, shingle_ids
from ..util import resolve_device

def _kadane(x: np.ndarray) -> int:
    """Max-subarray sum (the maximal ungapped HSP score on a diagonal)."""
    best = cur = 0
    for v in x:
        cur = max(0, cur + int(v))
        best = max(best, cur)
    return best


def _kadane_diagonals(q: np.ndarray, refs: np.ndarray, r: np.ndarray,
                      i0: np.ndarray, j0: np.ndarray,
                      L: np.ndarray) -> np.ndarray:
    """:func:`_kadane` of many diagonals at once: diagonal n runs over
    q[i0[n] + t] against refs[r[n], j0[n] + t] for t < L[n]. The
    diagonals are taken longest first, so at step t the ones still
    running are a prefix, and each step extends every running diagonal
    by one cell: the work is the diagonals' cells and no more. Runs stay
    below 11 * L, far inside int32. Returns (n,) int64."""
    A = BLOSUM62_PADDED.shape[0]
    order = np.argsort(-L, kind="stable")
    steps = int(L[order[0]]) if len(order) else 0
    # running diagonals at step t: those with L > t
    running = np.searchsorted(-L[order], -np.arange(steps), side="left")
    profile = BLOSUM62_PADDED[q].astype(np.int32).ravel()   # (Lq * A,)
    qrow = i0[order] * A
    rpos = r[order] * refs.shape[1] + j0[order]
    flat = refs.ravel()
    cur = np.zeros(len(order), np.int32)
    best = np.zeros(len(order), np.int32)
    for t in range(steps):
        m = running[t]
        cell = flat[rpos[:m] + t]
        cell += qrow[:m]
        cell += A * t
        c = cur[:m]
        np.add(c, profile[cell], out=c)
        np.maximum(c, 0, out=c)
        np.maximum(best[:m], c, out=best[:m])
    out = np.zeros(len(order), np.int64)
    out[order] = best
    return out


@dataclass
class SeedExtendBaseline:
    k: int = 3
    T: int = 11       # BLAST's protein default neighbourhood threshold
    s_min: int = 25   # minimal HSP score to report a pair
    device: object = None   # where the shingles and neighbour scores are
    #                         computed: the card unless another is named

    def build_index(self, ref_ids: np.ndarray, ref_lens: np.ndarray):
        """Inverted index over reference shingle word ids, as a CSR: for
        each word (ascending), its (ref, pos) entries in scan order."""
        self._dev = resolve_device(self.device)
        ids = torch.as_tensor(np.asarray(ref_ids, np.int8), device=self._dev)
        lens = torch.as_tensor(np.asarray(ref_lens), device=self._dev)
        sh, _ = extract_shingles(ids, lens, self.k)
        wid = shingle_ids(sh).cpu().numpy()                  # (R, S)
        r, p = np.nonzero(wid >= 0)                          # scan order
        w = wid[r, p]
        order = np.argsort(w, kind="stable")
        self._words, first = np.unique(w[order], return_index=True)
        self._offsets = np.append(first, len(order)).astype(np.int64)
        self._entry_ref = r[order].astype(np.int64)
        self._entry_pos = p[order].astype(np.int64)
        self._refs = (np.asarray(ref_ids, np.int64),
                      np.asarray(ref_lens, np.int64))
        return self

    def _seeded_diagonals(self, pos: np.ndarray, word: np.ndarray):
        """The (ref, diagonal) of every seed of one query, each once, in
        the order of its first seed — seeds in (pos, word) order, each
        word's entries in scan order."""
        slot = np.searchsorted(self._words, word)
        slot = np.minimum(slot, max(len(self._words) - 1, 0))
        hit = (self._words[slot] == word) if len(self._words) else \
            np.zeros(len(word), bool)
        pos, slot = pos[hit], slot[hit]
        cnt = self._offsets[slot + 1] - self._offsets[slot]
        seed = np.repeat(np.arange(len(slot)), cnt)
        entry = (self._offsets[slot][seed] + np.arange(int(cnt.sum()))
                 - np.repeat(np.cumsum(cnt) - cnt, cnt))
        r = self._entry_ref[entry]
        dg = self._entry_pos[entry] - pos[seed]
        span = int(self._refs[0].shape[1]) + int(pos.max(initial=0)) + 1
        _, first = np.unique(r * (2 * span + 1) + (dg + span),
                             return_index=True)
        first.sort()
        return r[first], dg[first]

    def search(self, q_ids: np.ndarray, q_lens: np.ndarray):
        """Returns list of (query_idx, ref_idx, hsp_score)."""
        ref_ids, ref_lens = self._refs
        q_ids = np.asarray(q_ids, np.int8)
        sh, mask = extract_shingles(
            torch.as_tensor(q_ids, device=self._dev),
            torch.as_tensor(np.asarray(q_lens), device=self._dev), self.k)
        results = []
        for qi in range(q_ids.shape[0]):
            seeds = ((neighbor_scores(sh[qi], self.k) >= self.T)
                     & mask[qi][:, None])
            pos, word = np.nonzero(seeds.cpu().numpy())
            r, dg = self._seeded_diagonals(pos, word)
            # ungapped extension per seeded (ref, diagonal)
            q = q_ids[qi][: int(q_lens[qi])].astype(np.int64)
            i0 = np.maximum(0, -dg)
            j0 = i0 + dg
            L = np.minimum(len(q) - i0, ref_lens[r] - j0)
            ok = L >= self.k
            r, s = r[ok], _kadane_diagonals(q, ref_ids, r[ok], i0[ok],
                                            j0[ok], L[ok])
            # best HSP per ref, refs in the order of their first diagonal
            refs, first, inv = np.unique(r, return_index=True,
                                         return_inverse=True)
            best = np.zeros(len(refs), np.int64)
            np.maximum.at(best, inv, s)
            for n in np.argsort(first, kind="stable"):
                if best[n] >= self.s_min:
                    results.append((qi, int(refs[n]), int(best[n])))
        return results
