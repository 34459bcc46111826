"""Similarity graph -> protein families (union-find connected components).

Host numpy, as in the reference (``repro/allpairs/graph.py``), and the
same forest file, so either package loads the other's.

The scored edges of the all-pairs pipeline form a sparse similarity graph;
families are its connected components after thresholding (the classic
single-linkage clustering used by PASTIS-style many-to-many pipelines: an
edge survives if its alignment is strong enough, and transitive closure
groups distant relatives through intermediates).

The disjoint-set forest is **persistent** (:class:`FamilyForest`): it
lives beside the index manifest, grows with the corpus
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

import os
import zipfile
from dataclasses import dataclass

import numpy as np

from ..faults import atomic_write


class ForestMismatch(ValueError):
    """A persisted family forest that does not belong to the index it was
    loaded for (stale generation, wrong corpus size) or whose own arrays
    are internally inconsistent. Carries the offending ``file``."""

    def __init__(self, file: str, message: str):
        super().__init__(message)
        self.file = file


class FamilyForest:
    """Persistent disjoint-set over a growing corpus.

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

    def save(self, path: str | os.PathLike,
             *, generation: int | None = None) -> None:
        """Persist the forest (conventionally ``families.npz`` beside the
        index manifest). ``generation``
        stamps the index generation the forest was built against, so a
        later load can refuse a forest that went stale (the index was
        compacted or recovered without re-clustering). The write is
        atomic: a crash mid-save leaves the previous forest intact."""
        gen = -1 if generation is None else int(generation)
        meta = np.array([self.n, gen], np.int64)
        atomic_write(path, lambda fh: np.savez_compressed(
            fh, parent=self.parent, size=self._size, meta=meta))

    @classmethod
    def load(cls, path: str | os.PathLike, *,
             expect_n: int | None = None,
             expect_generation: int | None = None) -> "FamilyForest":
        """Load a persisted forest, optionally pinned to the index it must
        belong to. ``expect_n`` is the index's row count and
        ``expect_generation`` its generation; either mismatch raises
        :class:`ForestMismatch` naming the file (a stale forest silently
        mislabeling families is the failure this guards against).
        Files without metadata skip the generation check."""
        spath = os.fspath(path)
        try:
            z = np.load(spath)
        except (OSError, EOFError, ValueError, KeyError,
                zipfile.BadZipFile) as err:
            raise ForestMismatch(
                spath, f"family forest {spath} is unreadable (truncated or "
                f"torn write): {type(err).__name__}: {err}") from err
        with z:
            forest = cls(0)
            forest.parent = np.asarray(z["parent"], np.int64).copy()
            forest._size = np.asarray(z["size"], np.int64).copy()
            stored_gen = None
            if "meta" in z.files:
                stored_n, stored_gen = (int(v) for v in z["meta"])
                if stored_n != forest.n:
                    raise ForestMismatch(
                        spath, f"family forest {spath} metadata says "
                        f"{stored_n} nodes but arrays hold {forest.n} — "
                        f"corrupt or hand-edited file")
                if stored_gen < 0:
                    stored_gen = None
        if expect_n is not None and forest.n != expect_n:
            raise ForestMismatch(
                spath, f"family forest {spath} covers {forest.n} nodes but "
                f"the index holds {expect_n} rows — stale forest (recluster "
                f"or re-run ingest)")
        if (expect_generation is not None and stored_gen is not None
                and stored_gen != expect_generation):
            raise ForestMismatch(
                spath, f"family forest {spath} was built at index "
                f"generation {stored_gen} but the index is at generation "
                f"{expect_generation} — stale forest (recluster)")
        return forest


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
