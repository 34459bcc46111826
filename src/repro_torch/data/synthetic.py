"""Synthetic protein datasets with *planted, known* homology.

The paper evaluates on E. coli / Ace Lake / GOS query sets against
myva/swissprot/nr (none of them redistributable).
We generate structurally matched stand-ins: a reference set of random
sequences (residues drawn from the empirical SwissProt amino-acid frequency)
plus query sets derived by a point-mutation/indel/truncation channel with a
*controlled* target identity — so every quality experiment has exact ground
truth (which reference each query descends from, and at what mutation rate),
strictly stronger than the paper's BLAST-intersection proxy. Benchmarks
also reproduce the paper's set-size ratios (queries >> references for the
metagenomic regime, §5.4).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.alphabet import ALPHABET_SIZE, AMINO_ACIDS

# Empirical amino-acid frequencies (SwissProt composition), AMINO_ACIDS order.
AA_FREQ = np.array([
    0.0826, 0.0553, 0.0406, 0.0546, 0.0137, 0.0393, 0.0674, 0.0708,
    0.0227, 0.0593, 0.0966, 0.0582, 0.0241, 0.0386, 0.0474, 0.0660,
    0.0535, 0.0110, 0.0292, 0.0687,
])
AA_FREQ = AA_FREQ / AA_FREQ.sum()


def random_protein(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.choice(ALPHABET_SIZE, size=length, p=AA_FREQ).astype(np.int8)


def mutate(rng: np.random.Generator, seq: np.ndarray, *,
           sub_rate: float, indel_rate: float = 0.0,
           truncate_to: int | None = None) -> np.ndarray:
    """Point-substitution + indel channel; expected identity ≈ 1 - sub_rate."""
    s = seq.copy()
    subs = rng.random(len(s)) < sub_rate
    s[subs] = rng.choice(ALPHABET_SIZE, size=int(subs.sum()), p=AA_FREQ)
    if indel_rate > 0:
        keep = rng.random(len(s)) >= indel_rate
        ins_mask = rng.random(len(s)) < indel_rate
        out = []
        for i, ch in enumerate(s):
            if keep[i]:
                out.append(ch)
            if ins_mask[i]:
                out.append(rng.choice(ALPHABET_SIZE, p=AA_FREQ))
        s = np.asarray(out, np.int8)
    if truncate_to is not None:
        s = s[:truncate_to]
    return s


@dataclass(frozen=True)
class SyntheticProteinConfig:
    n_refs: int = 256
    n_homolog_queries: int = 64     # queries descended from references
    n_decoy_queries: int = 64       # unrelated random queries
    ref_len_mean: int = 300         # paper: myva/swissprot avg ≈ 300-370
    ref_len_std: int = 80
    query_len_mean: int | None = None  # None -> same as parent (Fig 5.4 uses short)
    sub_rates: tuple[float, ...] = (0.05, 0.15, 0.30)  # planted identity tiers
    seed: int = 0


def make_protein_sets(cfg: SyntheticProteinConfig):
    """Returns dict with padded id arrays, lengths, and ground-truth labels.

    ground_truth[i] = (parent_ref_index, sub_rate) for homolog queries,
    (-1, nan) for decoys.
    """
    rng = np.random.default_rng(cfg.seed)
    refs = []
    for _ in range(cfg.n_refs):
        L = max(30, int(rng.normal(cfg.ref_len_mean, cfg.ref_len_std)))
        refs.append(random_protein(rng, L))
    queries, truth = [], []
    for i in range(cfg.n_homolog_queries):
        parent = int(rng.integers(cfg.n_refs))
        rate = cfg.sub_rates[i % len(cfg.sub_rates)]
        q = mutate(rng, refs[parent], sub_rate=rate,
                   truncate_to=cfg.query_len_mean)
        queries.append(q)
        truth.append((parent, rate))
    for _ in range(cfg.n_decoy_queries):
        L = cfg.query_len_mean or max(
            30, int(rng.normal(cfg.ref_len_mean, cfg.ref_len_std)))
        queries.append(random_protein(rng, L))
        truth.append((-1, float("nan")))

    def pad(seqs):
        if not seqs:
            return (np.zeros((0, 1), np.int8), np.zeros((0,), np.int32))
        L = max(len(s) for s in seqs)
        out = np.full((len(seqs), L), ALPHABET_SIZE, np.int8)  # PAD
        lens = np.zeros(len(seqs), np.int32)
        for i, s in enumerate(seqs):
            out[i, : len(s)] = s
            lens[i] = len(s)
        return out, lens

    r_ids, r_lens = pad(refs)
    q_ids, q_lens = pad(queries)
    return dict(ref_ids=r_ids, ref_lens=r_lens, query_ids=q_ids,
                query_lens=q_lens, truth=truth)


@dataclass(frozen=True)
class FamilyCorpusConfig:
    """A flat corpus with planted protein families (for all-vs-all search)."""
    n_families: int = 32
    family_size: int = 4            # members per family (>= 2)
    n_singletons: int = 64          # unrelated sequences (their own family)
    len_mean: int = 200
    len_std: int = 40
    sub_rate: float = 0.1           # within-family mutation channel
    indel_rate: float = 0.0
    seed: int = 0


def make_family_corpus(cfg: FamilyCorpusConfig):
    """Corpus with known family structure for many-against-many search.

    Each family is one random founder plus ``family_size - 1`` mutated
    copies; singletons are unrelated random sequences. Members are shuffled
    so family structure never aligns with corpus order.

    Returns dict(ids (N, L) int8 PAD-padded, lens (N,) int32,
    labels (N,) int32 — ground-truth family id, singletons get unique ids).
    """
    rng = np.random.default_rng(cfg.seed)
    seqs, labels = [], []
    for fam in range(cfg.n_families):
        L = max(30, int(rng.normal(cfg.len_mean, cfg.len_std)))
        founder = random_protein(rng, L)
        seqs.append(founder)
        labels.append(fam)
        for _ in range(cfg.family_size - 1):
            seqs.append(mutate(rng, founder, sub_rate=cfg.sub_rate,
                               indel_rate=cfg.indel_rate))
            labels.append(fam)
    for s in range(cfg.n_singletons):
        L = max(30, int(rng.normal(cfg.len_mean, cfg.len_std)))
        seqs.append(random_protein(rng, L))
        labels.append(cfg.n_families + s)
    perm = rng.permutation(len(seqs))
    seqs = [seqs[i] for i in perm]
    labels = np.asarray(labels, np.int32)[perm]

    L = max(len(s) for s in seqs)
    ids = np.full((len(seqs), L), ALPHABET_SIZE, np.int8)  # PAD
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s
        lens[i] = len(s)
    return dict(ids=ids, lens=lens, labels=labels)


def to_strings(ids, lens) -> list[str]:
    from ..core.alphabet import decode
    return [decode(ids[i][: int(lens[i])]) for i in range(len(lens))]
