"""repro_torch.allpairs — many-against-many all-pairs similarity search.

The port of ``repro/allpairs``: the corpus similarity graph on top of the
LSH index, on the card unless the caller asks for the CPU.

  corpus -> SignatureIndex.build -> LSH self-join (within-bucket pairs,
  deduped, upper-triangular CSR; K5) -> tiled pair scheduler (ungapped
  X-drop prefilter, K4; Smith-Waterman waves, K3 or K7; PID traceback)
  -> similarity graph -> union-find connected components = families

Growth is incremental: :func:`all_pairs_ingest` appends rows to the index,
delta-joins only the pairs touching them, scores those, and unions the
surviving edges into a :class:`~repro_torch.allpairs.graph.FamilyForest`;
the labels equal a from-scratch :func:`all_pairs_search` of the grown
corpus.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from ..core.pipeline import LSHConfig
from ..index.store import SignatureIndex
from .graph import (FamilyForest, FamilyResult, cluster_families,
                    families_from_labels, threshold_edges, union_find)
from .selfjoin import (JoinPrefilter, SelfJoinResult,
                       brute_force_collisions, lsh_delta_join, lsh_self_join)
from .tiles import PairScores, WaveConfig, score_pairs, wave_plan


@dataclass(frozen=True)
class AllPairsConfig:
    lsh: LSHConfig = field(default_factory=lambda: LSHConfig(k=3, T=13, f=32,
                                                             d=1))
    bands: int | None = None     # index bands (default: d+1)
    n_shards: int = 1            # > 1: sharding, not ported yet (raises)
    hamming_filter: bool = True  # exact-filter candidates at Hamming <= d
    wave: WaveConfig = field(default_factory=lambda: WaveConfig(with_pid=True))
    min_pid: float = 50.0        # family edge threshold (percent identity)
    min_score: int = 60          # edge threshold when waves skip PID
    max_pairs: int = 1 << 16     # the join's capacity floor
    fuse_prefilter: bool = False  # run the ungapped X-drop prefilter inside
                                  # the join (wave.prefilter_min/xdrop give
                                  # the threshold); the surviving pair set
                                  # equals the unfused wave prefilter's,
                                  # which is then skipped
    join_impl: str = "spgemm"    # "spgemm"; "legacy" is not ported (raises)


@dataclass(frozen=True)
class AllPairsResult:
    join: SelfJoinResult         # candidate pair set (CSR adjacency)
    scored: PairScores           # SW scores (+ PID) aligned with join.pairs
    families: FamilyResult       # thresholded components
    index: SignatureIndex        # the corpus index (reusable)

    @property
    def pairs(self) -> np.ndarray:
        return self.join.pairs

    @property
    def labels(self) -> np.ndarray:
        return self.families.labels


def _join_prefilter(cfg: AllPairsConfig, ids, lens):
    """The fused in-join prefilter and the prefilter-free wave to pair it
    with: thresholds come from the same WaveConfig knobs as the unfused
    wave prefilter, so fusing never changes which pairs survive."""
    if not cfg.fuse_prefilter:
        return None, cfg.wave
    pf = JoinPrefilter(ids=ids, lens=lens, min_score=cfg.wave.prefilter_min,
                       x=cfg.wave.xdrop, batch=cfg.wave.prefilter_batch,
                       len_quantum=cfg.wave.len_quantum)
    return pf, replace(cfg.wave, prefilter=False)


def _edge_mask(scored: PairScores, cfg: AllPairsConfig, pairs) -> np.ndarray:
    """The one edge-survival rule, shared by batch search and ingest."""
    if cfg.wave.with_pid:
        return threshold_edges(pairs, scored.pid, min_pid=cfg.min_pid)
    return threshold_edges(pairs, None, scores=scored.scores,
                           min_score=cfg.min_score)


def all_pairs_search(ids, lens, cfg: AllPairsConfig | None = None,
                     *, index: SignatureIndex | None = None,
                     device=None) -> AllPairsResult:
    """Corpus in, protein families out.

    Runs on ``device`` (the card unless the caller names another), or on
    the device of ``index=``, a prebuilt index over the same corpus.
    """
    cfg = cfg or AllPairsConfig()
    ids = np.asarray(ids, np.int8)
    lens = np.asarray(lens, np.int32)
    if index is None:
        index = SignatureIndex.build(cfg.lsh, ids, lens, bands=cfg.bands,
                                     n_shards=cfg.n_shards, device=device)
    elif index.size != len(lens):
        raise ValueError(f"index covers {index.size} sequences, corpus has "
                         f"{len(lens)}")
    pf, wave = _join_prefilter(cfg, ids, lens)
    join = lsh_self_join(index, d=cfg.lsh.d if cfg.hamming_filter else None,
                         max_pairs=cfg.max_pairs, n_shards=cfg.n_shards,
                         prefilter=pf, join_impl=cfg.join_impl)
    scored = score_pairs(ids, lens, join.pairs, wave, device=index.device)
    if cfg.wave.with_pid:
        families = cluster_families(index.size, join.pairs, scored.pid,
                                    min_pid=cfg.min_pid)
    else:       # score-only waves
        families = cluster_families(index.size, join.pairs, None,
                                    scores=scored.scores,
                                    min_score=cfg.min_score)
    return AllPairsResult(join=join, scored=scored, families=families,
                          index=index)


def forest_from_result(res: AllPairsResult) -> FamilyForest:
    """Seed a forest from a batch run's surviving edges — the handoff from
    :func:`all_pairs_search` to incremental ingest."""
    forest = FamilyForest(res.index.size)
    forest.union_edges(res.pairs[res.families.edge_mask])
    return forest


@dataclass(frozen=True)
class IngestResult:
    """One incremental ingest: the delta candidate pairs, their scores, and
    the grown corpus's family labels from the forest."""
    join: SelfJoinResult         # DELTA pairs only (>= 1 row is new)
    scored: PairScores           # aligned with join.pairs
    edge_mask: np.ndarray        # which delta pairs survived the threshold
    labels: np.ndarray           # (N,) labels over the GROWN corpus
    forest: FamilyForest         # the updated disjoint-set

    @property
    def families(self) -> list[np.ndarray]:
        return families_from_labels(self.labels)


def all_pairs_ingest(ids, lens, base_size: int,
                     cfg: AllPairsConfig | None = None, *,
                     index: SignatureIndex,
                     forest: FamilyForest) -> IngestResult:
    """Grow the corpus incrementally, on the index's device: rows
    ``[base_size:]`` of ``ids/lens`` are new; everything before is the
    resident corpus ``index`` and ``forest`` already cover.

    Appends the new rows to the index unless the caller already did,
    delta-joins only the pairs touching new rows, scores them through the
    standard wave pipeline, and unions the surviving edges into
    ``forest``. The labels are exactly those of a from-scratch
    :func:`all_pairs_search` over the grown corpus.
    """
    cfg = cfg or AllPairsConfig()
    ids = np.asarray(ids, np.int8)
    lens = np.asarray(lens, np.int32)
    # validate before mutating: a stale forest must not leave the index
    # grown on the error path
    if forest.n not in (base_size, len(lens)):
        raise ValueError(f"forest covers {forest.n} nodes; expected "
                         f"{base_size} or {len(lens)}")
    if index.size == base_size:
        index.add(ids[base_size:], lens[base_size:])
    elif index.size != len(lens):
        raise ValueError(
            f"index covers {index.size} sequences; expected the resident "
            f"{base_size} (add() pending) or the grown {len(lens)}")
    pf, wave = _join_prefilter(cfg, ids, lens)
    join = lsh_delta_join(index, base_size=base_size,
                          d=cfg.lsh.d if cfg.hamming_filter else None,
                          max_pairs=cfg.max_pairs, n_shards=cfg.n_shards,
                          prefilter=pf, join_impl=cfg.join_impl)
    scored = score_pairs(ids, lens, join.pairs, wave, device=index.device)
    mask = _edge_mask(scored, cfg, join.pairs)
    forest.grow(index.size)
    forest.union_edges(join.pairs[mask])
    return IngestResult(join=join, scored=scored, edge_mask=mask,
                        labels=forest.labels(), forest=forest)


__all__ = [
    "AllPairsConfig", "AllPairsResult", "all_pairs_search",
    "IngestResult", "all_pairs_ingest", "forest_from_result",
    "SelfJoinResult", "JoinPrefilter", "lsh_self_join", "lsh_delta_join",
    "brute_force_collisions",
    "WaveConfig", "PairScores", "score_pairs", "wave_plan",
    "FamilyResult", "FamilyForest", "cluster_families", "threshold_edges",
    "families_from_labels", "union_find",
]
