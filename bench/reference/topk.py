"""Plain reference of a served batch: the probe's top-k, then the re-rank.

A reference is a candidate of a query when the two share the value of at
least one band (bands interleave the signature bits, ``bands = d + 1``,
which no bucket key hashing changes: the hash is one to one). Among the
valid candidates the k nearest by Hamming distance are kept, ties to the
lower reference id, -1 past the last. Then each query's list is ordered
by Smith-Waterman score, highest first; equal scores keep their order.
A query without features gets an all -1 row.
"""
from __future__ import annotations

import numpy as np
import torch

from .align import pad_rows, sw_scores
from .simhash import band_values, signs

NONE = torch.iinfo(torch.int64).max


class Corpus:
    """The reference side, worked out from the residues: signatures,
    validity and band values of every reference, on ``device``."""

    def __init__(self, job1, ref_ids, ref_lens, *, bands: int, device):
        self.f, self.device = job1.f, device
        self.sigs, self.valid = job1(ref_ids, ref_lens)
        self.bands = torch.as_tensor(band_values(self.sigs, self.f, bands),
                                     device=device)
        dtype = torch.float16 if torch.device(device).type == "cuda" else \
            torch.float32
        self.signs = signs(self.sigs, self.f, device, dtype)
        self.valid_t = torch.as_tensor(self.valid, device=device)
        self.ids = torch.as_tensor(ref_ids, device=device)
        self.lens = torch.as_tensor(ref_lens, device=device).to(torch.int64)


def probe_topk(corpus: Corpus, q_sigs: np.ndarray, q_valid: np.ndarray, *,
               k: int, bands: int, ties: str = "low"):
    """(ids (B, k), dists (B, k)) int64 numpy of the probe's top-k.
    ``ties="high"`` breaks ties toward the higher id (the control)."""
    dev = corpus.device
    qb = torch.as_tensor(band_values(q_sigs, corpus.f, bands), device=dev)
    cand = torch.zeros((len(q_sigs), corpus.bands.shape[0]), dtype=torch.bool,
                       device=dev)
    for b in range(bands):
        cand |= qb[:, b, None] == corpus.bands[None, :, b]
    cand &= corpus.valid_t[None, :]
    dot = signs(q_sigs, corpus.f, dev, corpus.signs.dtype) @ corpus.signs.T
    dist = (corpus.f - dot.to(torch.int64)) // 2
    rid = torch.arange(corpus.bands.shape[0], device=dev, dtype=torch.int64)
    tie = rid if ties == "low" else (1 << 32) - 1 - rid
    key = torch.where(cand, (dist << 32) | tie[None, :], NONE)
    top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    found = top != NONE
    ids = top & 0xFFFFFFFF
    if ties != "low":
        ids = (1 << 32) - 1 - ids
    ids = torch.where(found, ids, -1).cpu().numpy()
    dists = torch.where(found, top >> 32, -1).cpu().numpy()
    ids[~q_valid] = -1
    dists[~q_valid] = -1
    return ids, dists


def rerank(corpus: Corpus, q_ids: torch.Tensor, q_lens: torch.Tensor,
           ids: np.ndarray, dists: np.ndarray):
    """Order each row of (ids, dists) by Smith-Waterman score of the query
    against each listed reference, highest first, stable."""
    dev = corpus.device
    qi, ki = np.nonzero(ids >= 0)
    score = np.full(ids.shape, -np.inf)
    if len(qi):
        q_ids = torch.as_tensor(q_ids, device=dev)
        q_lens = torch.as_tensor(q_lens, device=dev).to(torch.int64)
        qrows = torch.as_tensor(qi, device=dev)
        rrows = torch.as_tensor(ids[qi, ki], device=dev)
        Lq = int(q_lens[qrows].max())
        Lr = int(corpus.lens[rrows].max())
        qs = pad_rows(q_ids, q_lens, qrows, Lq)
        rs = pad_rows(corpus.ids, corpus.lens, rrows, Lr)
        score[qi, ki] = sw_scores(qs, rs).cpu().numpy()
    order = np.argsort(-score, axis=1, kind="stable")
    return (np.take_along_axis(ids, order, axis=1),
            np.take_along_axis(dists, order, axis=1))
