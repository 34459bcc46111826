"""Similarity graph -> protein families (union-find connected components).

Host numpy, as in the reference (``repro/allpairs/graph.py``); the
forest's persistence (``FamilyForest.save``/``load``, ``ForestMismatch``)
goes with the index lifecycle (ROADMAP Queue 1 item 9).

The scored edges of the all-pairs pipeline form a sparse similarity graph;
families are its connected components after thresholding (the classic
single-linkage clustering used by PASTIS-style many-to-many pipelines: an
edge survives if its alignment is strong enough, and transitive closure
groups distant relatives through intermediates).

The disjoint-set forest (:class:`FamilyForest`) grows with the corpus
(:meth:`FamilyForest.grow`), and unions each ingest's surviving delta
edges into the standing components — labels are canonicalized to the
component's smallest member id, so the incremental forest is EXACTLY the
from-scratch :func:`union_find` over the concatenated edge set (union
order never changes components, and the canonical label is order-free).

With the fused in-join prefilter (``AllPairsConfig.fuse_prefilter``) the
candidate edges entering this module are already X-drop survivors — the
fused and the wave prefilter share one threshold, so the surviving pair
set (and therefore every component) is identical under both routes. The
``min_score`` floor applies to whichever gap mode scored the edges:
BLOSUM62 thresholds calibrated under linear gaps carry over to affine
(-11/-1) wherever family alignments are gapless, since the two modes
score gapless alignments identically (Gotoh with no gap opened is the
plain match recurrence).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class FamilyForest:
    """Disjoint-set over a growing corpus.

    Path-halving + union by size, vectorized-ish host loop (edges are few
    after thresholding). ``labels()`` canonicalizes each component to its
    smallest member id — stable under edge order AND under the
    incremental-vs-batch split, which is what makes the grown forest
    interchangeable with a from-scratch recluster.
    """

    def __init__(self, n: int = 0):
        self.parent = np.arange(n, dtype=np.int64)
        self._size = np.ones(n, dtype=np.int64)

    @property
    def n(self) -> int:
        return len(self.parent)

    def grow(self, n: int) -> None:
        """Extend the forest to ``n`` nodes (new nodes start as singleton
        components — the ingest path calls this before unioning delta
        edges). Shrinking is refused: nodes never leave the corpus."""
        n0 = self.n
        if n < n0:
            raise ValueError(f"forest holds {n0} nodes; cannot shrink "
                             f"to {n}")
        if n == n0:
            return
        self.parent = np.concatenate(
            [self.parent, np.arange(n0, n, dtype=np.int64)])
        self._size = np.concatenate(
            [self._size, np.ones(n - n0, dtype=np.int64)])

    def find(self, x: int) -> int:
        parent = self.parent
        while parent[x] != x:
            parent[x] = parent[parent[x]]   # path halving
            x = parent[x]
        return int(x)

    def union_edges(self, edges: np.ndarray) -> None:
        """Union (m, 2) edges into the standing components."""
        for a, b in np.asarray(edges, np.int64).reshape(-1, 2):
            ra, rb = self.find(int(a)), self.find(int(b))
            if ra == rb:
                continue
            if self._size[ra] < self._size[rb]:
                ra, rb = rb, ra
            self.parent[rb] = ra
            self._size[ra] += self._size[rb]

    def labels(self) -> np.ndarray:
        """(n,) int32 component label per node — the component's smallest
        member id (order-free canonical form)."""
        n = self.n
        roots = np.fromiter((self.find(i) for i in range(n)), np.int64,
                            count=n)
        smallest = np.full(n, n, dtype=np.int64)
        np.minimum.at(smallest, roots, np.arange(n, dtype=np.int64))
        return smallest[roots].astype(np.int32)


def union_find(n: int, edges: np.ndarray) -> np.ndarray:
    """Connected-component labels of n nodes under (m, 2) edges.

    The from-scratch convenience wrapper over :class:`FamilyForest`;
    labels are the component's smallest member id, so they are stable
    under edge order (and equal to an incrementally grown forest fed the
    same edges in any split).
    """
    forest = FamilyForest(n)
    forest.union_edges(edges)
    return forest.labels()


@dataclass(frozen=True)
class FamilyResult:
    labels: np.ndarray            # (N,) int32 component label per sequence
    families: list[np.ndarray]    # members of each multi-member family
    edge_mask: np.ndarray         # (P,) bool — which input edges survived

    @property
    def n_families(self) -> int:
        return len(self.families)


def threshold_edges(pairs: np.ndarray, pid: np.ndarray | None = None,
                    *, min_pid: float = 50.0,
                    scores: np.ndarray | None = None,
                    min_score: int | None = None) -> np.ndarray:
    """(P,) bool mask of edges passing the PID and/or SW-score floors
    (NaN PID never passes) — shared by the batch clusterer and the
    incremental ingest, so an edge survives identically in both."""
    mask = np.ones(len(pairs), bool)
    if pid is not None:
        with np.errstate(invalid="ignore"):
            mask &= np.nan_to_num(np.asarray(pid), nan=-1.0) >= min_pid
    if min_score is not None:
        if scores is None:
            raise ValueError("min_score needs scores")
        mask &= np.asarray(scores) >= min_score
    return mask


def families_from_labels(labels: np.ndarray) -> list[np.ndarray]:
    """Multi-member components of a label vector, largest first."""
    uniq, counts = np.unique(labels, return_counts=True)
    fams = [np.flatnonzero(labels == u) for u in uniq[counts >= 2]]
    fams.sort(key=len, reverse=True)
    return fams


def cluster_families(n: int, pairs: np.ndarray, pid: np.ndarray | None = None,
                     *, min_pid: float = 50.0,
                     scores: np.ndarray | None = None,
                     min_score: int | None = None) -> FamilyResult:
    """Threshold edges (PID and/or SW score) and extract families.

    ``pairs`` (P, 2); ``pid`` (P,) percent identities (NaN never passes);
    ``scores``/``min_score`` adds an SW-score floor. Families are the
    connected components with >= 2 members, largest first.
    """
    pairs = np.asarray(pairs)
    mask = threshold_edges(pairs, pid, min_pid=min_pid, scores=scores,
                           min_score=min_score)
    labels = union_find(n, pairs[mask])
    return FamilyResult(labels=labels, families=families_from_labels(labels),
                        edge_mask=mask)
