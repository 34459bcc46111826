"""Batched query serving over a :class:`~repro_torch.index.store.SignatureIndex`.

The serving path of ``repro/index/service.py`` on torch:

  submit -> micro-batch queue -> pad to a fixed shape ladder -> signature
  generation -> bucket probe (CSR searchsorted) -> exact Hamming filter ->
  fixed-capacity top-k -> optional Smith-Waterman re-rank of the top-k.

Two exact-filter paths:

* ``dense`` — kernel K2 (``kernels/csrc/hamming.cu``) sweeps the query
  batch against the whole index; right for small indexes.
* ``probe`` — CSR bucket probing generates candidates; only candidate
  signatures are gathered and popcount-filtered. Right at scale.

With ``sharded=`` (a :class:`~repro_torch.index.shard.ShardedIndex`) the
probe runs the shard ring instead, bit-exact with the ``probe`` path.

Ties: Hamming distances tie constantly, and the reference's
``jax.lax.top_k`` returns the lower index first among equal values.
``torch.topk`` promises no order among ties, so the top-k here runs on the
unique composite key ``dist * 2^32 + slot``, which orders ties by slot —
ids match the reference bit for bit. Capacity discipline: the probe
reports overflow when a bucket exceeds the candidate cap, and the engine
grows the cap and retries; the pair-dump path
(:meth:`QueryEngine.search_pairs`) grows on the ``overflowed`` flag of
:class:`~repro_torch.core.pipeline.SearchResult` the same way.

Both entries keep always-on per-engine stats (:meth:`QueryEngine.stats`,
:meth:`QueryEngine.pair_stats`) and record spans when the tracer is on.
"""
from __future__ import annotations

import itertools
import time
import warnings
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..core.alphabet import PAD, encode
from ..core.hamming import hamming_distance
from ..core.pipeline import ScalLoPS
from ..kernels import ops
from ..obs import REGISTRY, Histogram, span
from ..obs.trace import TRACER, new_trace_id, trace_context
from ..obs.trace import record as record_span
from .spgemm import row_product_positions
from .store import SignatureIndex

BIG = 1 << 30  # sentinel distance for masked slots (int32-safe)


# ---------------------------------------------------------------- primitives
def _probe_csr_fused(qkeys, csr_keys, csr_offsets, csr_ids, *, cap: int):
    """All bands' bucket probes in one batched call.

    qkeys (nb, B), csr_keys (nb, U) int64 holding uint32 values,
    csr_offsets (nb, U+1), csr_ids (nb, E) -> (cand (B, nb*cap) int32 with
    -1 padding, duplicates across bands allowed, bucket_size (nb, B) int32
    — the true matched-bucket sizes, which may exceed cap).
    """
    nb, B = qkeys.shape
    E = csr_ids.shape[-1]
    idx, ok, size = row_product_positions(qkeys, csr_keys, csr_offsets,
                                          cap=cap, E=E)
    ids = torch.gather(csr_ids, 1, idx.reshape(nb, B * cap)).reshape(
        nb, B, cap)
    cand = torch.where(ok, ids, -1)
    return cand.permute(1, 0, 2).reshape(B, nb * cap), size


def _dedup_candidates(cand, dist, ok):
    """Row-wise candidate dedup: sort slots by candidate id (invalid ids
    last) with a STABLE sort, as the reference's ``jnp.argsort`` is, then
    mask repeated ids (duplicates carry the same distance, so keeping the
    first is lossless). Returns (ids_sorted (B, C), dvals (B, C) with BIG
    in masked slots)."""
    sort_key = torch.where(ok, cand, 2**31 - 1)
    order = torch.sort(sort_key, dim=1, stable=True).indices
    cs = torch.gather(cand, 1, order)
    ds = torch.gather(dist, 1, order)
    oks = torch.gather(ok, 1, order)
    dup = torch.zeros_like(oks)
    dup[:, 1:] = cs[:, 1:] == cs[:, :-1]
    return cs, torch.where(oks & ~dup, ds, BIG)


def _topk_from_candidates(q_sigs, cand, ref_sigs, ref_valid, *, k: int):
    """Exact-filter candidates and keep the k nearest per query.
    cand (B, C) with -1 padding -> (ids (B, k), dists (B, k)) int32, -1
    padded."""
    safe = cand.clamp_min(0).long()
    dist = hamming_distance(q_sigs[:, None, :], ref_sigs[safe])   # (B, C)
    ok = (cand >= 0) & ref_valid[safe]
    cs, dvals = _dedup_candidates(cand, dist, ok)
    return _finalize_topk(dvals, cs, k)


def _finalize_topk(dvals, id_source, k: int):
    """Shared top-k tail: (B, C) distances (BIG = masked) + per-slot ids ->
    ((B, k) ids, (B, k) dists), -1-padded past the valid entries.
    ``id_source=None`` means slot index == reference id (dense path).

    The top-k runs on the unique key ``dist * 2^32 + slot``, so equal
    distances come out lowest slot first, as ``jax.lax.top_k`` gives them.
    """
    B, C = dvals.shape
    kk = min(k, C)
    slots = torch.arange(C, device=dvals.device)
    key = dvals.to(torch.int64) * (1 << 32) + slots
    top = torch.topk(key, kk, dim=1, largest=False, sorted=True).values
    nd = (top >> 32).to(torch.int32)
    idx = top & 0xFFFFFFFF
    nid = (idx.to(torch.int32) if id_source is None
           else torch.gather(id_source, 1, idx).to(torch.int32))
    nid = torch.where(nd < BIG, nid, -1)
    nd = torch.where(nd < BIG, nd, -1)
    if kk < k:
        pad = (0, k - kk)
        nid = torch.nn.functional.pad(nid, pad, value=-1)
        nd = torch.nn.functional.pad(nd, pad, value=-1)
    return nid, nd


def _topk_from_dists(dist, ref_valid, *, k: int):
    """(B, N) distances -> top-k (ids, dists) with invalid refs masked."""
    dvals = torch.where(ref_valid[None, :], dist, BIG)
    return _finalize_topk(dvals, None, k)


def topk_dense(index: SignatureIndex, q_sigs, *, k: int):
    """Exact top-k via kernel K2 over the whole index."""
    dist = ops.all_pairs_hamming(q_sigs.to(index.device).contiguous(),
                                 index.device_sigs)
    return _topk_from_dists(dist, index.device_valid, k=k)


def topk_probe(index: SignatureIndex, q_sigs, *, k: int, cap: int,
               max_cap: int = 1 << 14):
    """Top-k via bucket probing, growing the candidate cap on overflow.

    Returns (ids, dists, final_cap, truncated). Exact within the layout's
    guarantee (every reference within Hamming d shares a bucket) *unless*
    ``truncated`` is True: a bucket exceeded ``max_cap`` and candidates
    were dropped.
    """
    q_sigs = q_sigs.to(index.device)
    while True:
        cand, overflowed = index.probe(q_sigs, cap=cap)
        overflowed = bool(overflowed)
        if not overflowed or cap >= max_cap:
            break
        cap = min(cap * 2, max_cap)     # grow-and-retry
    ids, dists = _topk_from_candidates(
        q_sigs, cand, index.device_sigs, index.device_valid, k=k)
    return ids, dists, cap, overflowed


# ---------------------------------------------------------------- serving
@dataclass
class ServingConfig:
    k: int = 10
    max_batch: int = 64
    batch_ladder: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    len_quantum: int = 64           # pad query length to multiples of this
    probe_cap: int = 32             # initial candidates per band per query
    max_probe_cap: int = 1 << 14
    dense_threshold: int = 1024     # "auto": dense kernel below this size
    mode: str = "auto"              # "probe" | "dense" | "auto"
    rerank: bool = False            # Smith-Waterman re-rank of the top-k
    dp_kernel: str = "wavefront"    # "wavefront" (K3) | "rowwave" (K7)
    gap_mode: str = "linear"        # "linear" | "affine" (Gotoh)
    gap_open: int | None = None     # affine defaults: BLOSUM62 -11 / -1
    gap_extend: int | None = None


_STAGES = ("ladder", "sig", "probe", "rerank")

_M_BATCH = REGISTRY.histogram(
    "serve_batch_seconds", "query_batch wall-clock", labelnames=("engine",))
_M_STAGE = REGISTRY.histogram(
    "serve_stage_seconds", "per-batch serving-stage wall-clock "
    "(ladder/sig/probe/rerank)", labelnames=("engine", "stage"))
_M_QUERIES = REGISTRY.counter(
    "serve_queries", "queries served", labelnames=("engine",))
_M_TRUNC = REGISTRY.counter(
    "serve_truncations", "batches whose probe overflowed even at "
    "max_probe_cap", labelnames=("engine",))

_engine_ids = itertools.count()


class _Stats:
    """Bounded per-engine serving stats: fixed-log-bucket histograms,
    observed into the resettable ``stats()`` view and into the monotonic
    registry children."""

    def __init__(self, name: str):
        self._m_lat = _M_BATCH.labels(engine=name)
        self._m_stage = {s: _M_STAGE.labels(engine=name, stage=s)
                         for s in _STAGES}
        self._m_queries = _M_QUERIES.labels(engine=name)
        self._m_trunc = _M_TRUNC.labels(engine=name)
        self.reset()

    def reset(self) -> None:
        self.lat = Histogram(self._m_lat.bounds)
        self.stage = dict.fromkeys(_STAGES, 0.0)
        self.n_queries = 0
        self.truncations = 0

    def observe_batch(self, n_queries: int, seconds: float,
                      stage_seconds: dict) -> None:
        self.lat.observe(seconds)
        self._m_lat.observe(seconds)
        self.n_queries += n_queries
        self._m_queries.inc(n_queries)
        for s, v in stage_seconds.items():
            self.stage[s] += v
            self._m_stage[s].observe(v)

    def observe_truncation(self) -> None:
        self.truncations += 1
        self._m_trunc.inc()


#: jobs the pair dump's log keeps: well over a 10 s window's (d = 1 on
#: 547,169 reads runs ~150 jobs there on an H100)
PAIR_LOG_JOBS = 4096


class _DeviceClock:
    """A pool of timing events on the pipeline's card, recorded on its
    current stream at stage boundaries and read only after a host sync has
    passed them, so reading adds no sync. On a CPU pipeline it records
    nothing and every span is None."""

    def __init__(self, device: torch.device):
        self.device = device
        self.on = device.type == "cuda"
        self._pool: list = []

    def mark(self, i: int) -> None:
        """Record the job's ``i``-th event (``i`` counts up from 0)."""
        if not self.on:
            return
        if i == len(self._pool):
            self._pool.append(torch.cuda.Event(enable_timing=True))
        self._pool[i].record(torch.cuda.current_stream(self.device))

    def seconds(self, a: int, b: int) -> float | None:
        """Device seconds from event ``a`` to event ``b``."""
        if not self.on:
            return None
        return self._pool[a].elapsed_time(self._pool[b]) / 1e3


class _JoinStages:
    """The dense join's stages over one job's attempts, as
    :func:`~repro_torch.core.hamming.threshold_pairs` marks them: three
    marks an attempt (K6's count begins, the emission begins, the
    emission ends), each a host stamp and an event of ``clock``, and the
    emission tiles and query rows run so far. Reused job after job."""

    def __init__(self, device: torch.device):
        self.clock = _DeviceClock(device)
        self.reset()

    def reset(self) -> None:
        self.tiles = self.rows = 0
        self.stamps: list[tuple[float, int]] = []   # (host, tiles so far)

    def mark(self) -> None:
        self.clock.mark(len(self.stamps))
        self.stamps.append((time.perf_counter(), self.tiles))

    def tile(self, rows: int) -> None:
        self.tiles += 1
        self.rows += rows

    def device_s(self, stage: int, attempts: int):
        """Each attempt's device seconds of ``stage`` (0 the count, 1 the
        emission), or None without a card."""
        if not self.clock.on:
            return None
        return tuple(self.clock.seconds(3 * a + stage, 3 * a + stage + 1)
                     for a in range(attempts))


def _ms(seconds: float | None) -> float | None:
    return None if seconds is None else seconds * 1e3


class QueryEngine:
    """Micro-batched query serving over a built index, on the index's
    device.

    ``submit()`` enqueues raw sequences (strings or encoded int8 rows);
    ``flush()`` drains the queue in fixed-shape micro-batches;
    ``query_batch()`` is the synchronous batch entry. ``ref_seqs=(ids,
    lens)`` enables Smith-Waterman re-ranking; ``sharded=`` a
    :class:`~repro_torch.index.shard.ShardedIndex` over ``index`` serves
    the probe through its shard ring.
    """

    def __init__(self, index: SignatureIndex, cfg: ServingConfig | None = None,
                 *, ref_seqs=None, sharded=None, name: str | None = None):
        self.index = index
        self.device = index.device
        self.cfg = cfg or ServingConfig()
        self.sl = ScalLoPS(index.cfg, device=self.device)
        self.ref_seqs = ref_seqs
        self.sharded = sharded
        self.name = name or f"engine{next(_engine_ids)}"
        self._probe_cap = self.cfg.probe_cap
        self._queue: list[tuple[np.ndarray, int]] = []
        self._stats = _Stats(self.name)
        self._pair_log: deque = deque(maxlen=PAIR_LOG_JOBS)
        self._clock = _DeviceClock(self.device)
        self._stages = _JoinStages(self.device)
        self._ref_dev = None
        if self.cfg.rerank and ref_seqs is None:
            raise ValueError("rerank=True needs ref_seqs=(ref_ids, ref_lens)")
        self._ref_dev_src = None
        if self.cfg.rerank:       # upload once; skipped when never re-ranking
            self._upload_refs()

    def _upload_refs(self) -> None:
        """Mirror ``self.ref_seqs`` on the device for the re-rank gather.
        Rebind ``engine.ref_seqs`` to refresh (e.g. after ``index.add``)."""
        ids, lens = self.ref_seqs
        self._ref_dev = (
            torch.from_numpy(np.ascontiguousarray(ids, np.int8)).to(self.device),
            torch.from_numpy(np.asarray(lens, np.int64)).to(self.device))
        self._ref_dev_src = self.ref_seqs

    # ------------------------------------------------------------ queue
    def submit(self, seq) -> None:
        """Enqueue one query (amino-acid string or encoded int8 array)."""
        if isinstance(seq, str):
            row = np.asarray(encode(seq), np.int8)
        else:
            row = np.asarray(seq, np.int8).reshape(-1)
        self._queue.append((row, len(row)))

    def pending(self) -> int:
        return len(self._queue)

    def flush(self):
        """Serve every queued query; returns [(ids (k,), dists (k,)), ...]
        in submission order."""
        out = []
        queue, self._queue = self._queue, []
        for i in range(0, len(queue), self.cfg.max_batch):
            chunk = queue[i:i + self.cfg.max_batch]
            L = max(l for _, l in chunk)
            ids = np.full((len(chunk), max(L, 1)), PAD, np.int8)
            lens = np.zeros(len(chunk), np.int32)
            for j, (row, l) in enumerate(chunk):
                ids[j, :l] = row
                lens[j] = l
            nid, nd = self.query_batch(ids, lens)
            out.extend((nid[j], nd[j]) for j in range(len(chunk)))
        return out

    # ------------------------------------------------------------ shaping
    def _pad_shapes(self, ids, lens):
        """Pad batch and length to the fixed-shape ladder."""
        B0, L0 = ids.shape
        ladder = [b for b in self.cfg.batch_ladder if b >= B0]
        B = min(ladder) if ladder else self.cfg.max_batch
        q = self.cfg.len_quantum
        L = max(q, -(-L0 // q) * q)
        out = np.full((B, L), PAD, np.int8)
        out[:B0, :L0] = ids
        olens = np.zeros(B, np.int32)
        olens[:B0] = lens
        return out, olens

    # ------------------------------------------------------------ serving
    def query_batch(self, ids, lens):
        """Serve one batch: (B0, L) int8 + (B0,) lengths ->
        (neighbor_ids (B0, k), neighbor_dists (B0, k)) int32 numpy, -1 padded.
        Queries with zero neighbour features (paper §5.2) get all -1."""
        ids = np.asarray(ids, np.int8)
        lens = np.asarray(lens, np.int32)
        B0 = ids.shape[0]
        if B0 > self.cfg.max_batch:
            parts = [self.query_batch(ids[i:i + self.cfg.max_batch],
                                      lens[i:i + self.cfg.max_batch])
                     for i in range(0, B0, self.cfg.max_batch)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))

        t0 = time.perf_counter()
        pids, plens = self._pad_shapes(ids, lens)
        t_ladder = time.perf_counter()
        q_sigs = self.sl.signatures(pids, plens)
        q_valid = (self.sl.feature_counts(pids, plens) > 0).cpu().numpy()
        t_sig = time.perf_counter()

        k = self.cfg.k
        truncated = False
        if self.sharded is not None:     # numpy out of the ring's home pass
            nid, nd, self._probe_cap, truncated = self.sharded.topk(
                q_sigs, k=k, cap=self._probe_cap,
                max_cap=self.cfg.max_probe_cap)
        else:
            if self._mode() == "dense":
                nid, nd = topk_dense(self.index, q_sigs, k=k)
            else:
                nid, nd, self._probe_cap, truncated = topk_probe(
                    self.index, q_sigs, k=k, cap=self._probe_cap,
                    max_cap=self.cfg.max_probe_cap)
            nid = nid.cpu().numpy()
            nd = nd.cpu().numpy()
        if truncated:
            self._stats.observe_truncation()
            warnings.warn(
                f"probe candidates truncated at max_probe_cap="
                f"{self.cfg.max_probe_cap}; top-k may miss neighbors — "
                f"raise ServingConfig.max_probe_cap", RuntimeWarning,
                stacklevel=2)
        t_probe = time.perf_counter()
        nid[~q_valid] = -1
        nd[~q_valid] = -1
        nid, nd = nid[:B0], nd[:B0]
        if self.cfg.rerank:
            nid, nd = self._rerank(ids, lens, nid, nd)

        t_end = time.perf_counter()
        record_span("query_batch", t0, t_end, engine=self.name, B=B0)
        record_span("ladder", t0, t_ladder)
        record_span("sig", t_ladder, t_sig)
        record_span("probe", t_sig, t_probe, cap=self._probe_cap,
                    sharded=self.sharded is not None)
        if self.cfg.rerank:
            record_span("rerank", t_probe, t_end)
        self._stats.observe_batch(B0, t_end - t0, {
            "ladder": t_ladder - t0, "sig": t_sig - t_ladder,
            "probe": t_probe - t_sig, "rerank": t_end - t_probe})
        return nid, nd

    def _mode(self) -> str:
        if self.cfg.mode != "auto":
            return self.cfg.mode
        return "dense" if self.index.size <= self.cfg.dense_threshold \
            else "probe"

    # ------------------------------------------------------------ pair dump
    def search_pairs(self, q_ids, q_lens, *, max_pairs: int | None = None,
                     max_grow: int = 1 << 22):
        """Classic unordered pair dump (``ScalLoPS.search`` with the index
        config's ``join_method``) against the indexed references, honouring
        the result's ``overflowed`` flag: capacity doubles and the join
        retries until nothing is truncated or ``max_grow`` is reached.

        Every job adds an entry to :meth:`pair_stats`: its host stamps,
        attempts, bytes uploaded, and the device time of job 1 and of each
        attempt, from CUDA events read after the overflow check's sync (no
        sync of their own); a dense join adds each attempt's device time
        of K6's count and of the emission, and the emission's tiles and
        rows. With the tracer on, the job is a ``search_pairs`` span with a
        trace id of its own, around ``pairs.job1`` and one ``pairs.join``
        span an attempt, which in a dense join holds a
        ``pairs.join.count`` and a ``pairs.join.emit`` span; each span
        carries its device time as ``dev_ms`` (None on the CPU)."""
        sl, clock = self.sl, self._clock
        dense = self.index.cfg.join_method == "dense"
        stages = self._stages if dense else None
        if dense:
            stages.reset()
        h2d0 = sl.h2d_bytes
        t0 = time.perf_counter()
        clock.mark(0)
        q_sigs = sl.signatures(q_ids, q_lens)
        q_valid = sl.feature_counts(q_ids, q_lens) > 0
        clock.mark(1)
        t_job1 = time.perf_counter()
        mp = max_pairs or self.index.cfg.max_pairs
        attempts = []       # (host start, host end, capacity, overflowed)
        while True:
            ta = time.perf_counter()
            clock.mark(2 + 2 * len(attempts))
            res = sl.search(q_sigs, self.index.device_sigs,
                            max_pairs=mp, q_valid=q_valid,
                            r_valid=self.index.device_valid,
                            stages=stages)
            clock.mark(3 + 2 * len(attempts))
            overflowed = bool(res.overflowed)
            attempts.append((ta, time.perf_counter(), mp, overflowed))
            if not overflowed or mp >= max_grow:
                break
            mp = min(mp * 2, max_grow)  # grow-and-retry
        t1 = time.perf_counter()
        join_dev = (tuple(clock.seconds(2 + 2 * i, 3 + 2 * i)
                          for i in range(len(attempts)))
                    if clock.on else None)
        count_dev = stages.device_s(0, len(attempts)) if dense else None
        emit_dev = stages.device_s(1, len(attempts)) if dense else None
        self._pair_log.append(dict(
            t0=t0, t1=t1, attempts=len(attempts),
            h2d_bytes=sl.h2d_bytes - h2d0,
            job1_dev_s=clock.seconds(0, 1), join_dev_s=join_dev,
            count_dev_s=count_dev, emit_dev_s=emit_dev,
            emit_tiles=stages.tiles if dense else None,
            emit_rows=stages.rows if dense else None))
        if TRACER.enabled:
            with trace_context((new_trace_id(),)):
                record_span("search_pairs", t0, t1, cat="pairs",
                            engine=self.name, reads=len(q_lens),
                            d=self.index.cfg.d, attempts=len(attempts),
                            capacity=mp, dev_ms=_ms(clock.seconds(
                                0, 1 + 2 * len(attempts))))
                record_span("pairs.job1", t0, t_job1, cat="pairs",
                            dev_ms=_ms(clock.seconds(0, 1)))
                for i, (ta, tb, cap, ovf) in enumerate(attempts):
                    record_span("pairs.join", ta, tb, cat="pairs", attempt=i,
                                capacity=cap, overflowed=ovf,
                                dev_ms=_ms(join_dev[i] if join_dev else None))
                    if not dense:
                        continue
                    (c0, _), (e0, k0), (e1, k1) = \
                        stages.stamps[3 * i:3 * i + 3]
                    record_span("pairs.join.count", c0, e0, cat="pairs",
                                dev_ms=_ms(count_dev and count_dev[i]))
                    record_span("pairs.join.emit", e0, e1, cat="pairs",
                                tiles=k1 - k0,
                                dev_ms=_ms(emit_dev and emit_dev[i]))
        return res

    # ------------------------------------------------------------ rerank
    def _rerank(self, ids, lens, nid, nd):
        """Reorder each query's top-k by Smith-Waterman score (descending,
        stable). The reference corpus is on the device already; per call
        only the query batch and the (M,) pair-index vectors go up. The
        pair list is padded to a multiple of 64 (all-PAD rows score 0) and
        the query length is quantized to ``len_quantum``; the reference
        width is the whole padded corpus width."""
        from ..align.smith_waterman import sw_gather_scores
        if self.ref_seqs is not self._ref_dev_src:
            self._upload_refs()     # caller rebound ref_seqs (index.add etc.)
        ref_ids_dev, ref_lens_dev = self._ref_dev
        B, K = nid.shape
        qi, ki = np.nonzero(nid >= 0)
        if len(qi) == 0:
            return nid, nd
        rid = nid[qi, ki]
        if rid.max(initial=-1) >= ref_ids_dev.shape[0]:
            # the device gather would read past the corpus — fail loudly
            raise IndexError(
                f"re-rank hit reference id {int(rid.max())} outside "
                f"ref_seqs ({int(ref_ids_dev.shape[0])} rows); pass the "
                f"grown corpus as ref_seqs after index.add()")
        M = -(-len(qi) // 64) * 64
        qv = np.full(M, -1, np.int64)
        rv = np.full(M, -1, np.int64)
        qv[:len(qi)] = qi
        rv[:len(qi)] = rid
        q = self.cfg.len_quantum
        Lq = max(q, -(-ids.shape[1] // q) * q)
        ids_q = np.full((ids.shape[0], Lq), PAD, np.int8)
        ids_q[:, :ids.shape[1]] = ids
        dev = self.device
        scores = sw_gather_scores(
            torch.from_numpy(ids_q).to(dev),
            torch.from_numpy(np.asarray(lens, np.int64)).to(dev),
            ref_ids_dev, ref_lens_dev,
            torch.from_numpy(qv).to(dev), torch.from_numpy(rv).to(dev),
            Lq=Lq, Lr=int(ref_ids_dev.shape[1]),
            dp_kernel=self.cfg.dp_kernel, gap_mode=self.cfg.gap_mode,
            gap_open=self.cfg.gap_open,
            gap_extend=self.cfg.gap_extend).cpu().numpy()[:len(qi)]
        smat = np.full((B, K), -np.inf)
        smat[qi, ki] = scores
        order = np.argsort(-smat, axis=1, kind="stable")
        return (np.take_along_axis(nid, order, axis=1),
                np.take_along_axis(nd, order, axis=1))

    # ------------------------------------------------------------ warmup
    def warmup(self, q_ids=None, q_lens=None, *,
               max_len: int | None = None) -> int:
        """Run every (batch-rung, length-quantum) serving shape once before
        traffic arrives (first-touch allocations, kernel library load).

        With sample queries ``(q_ids, q_lens)``, first runs every sample
        through the engine to settle the grow-and-retry probe cap, then
        warms the length quanta the samples occupy. Without samples,
        synthesizes rows for every quantum up to ``max_len`` (default: one
        quantum). Returns shapes warmed. Runs through ``query_batch``, so
        call :meth:`reset_stats` afterwards."""
        quanta: dict[int, np.ndarray] = {}
        qm = self.cfg.len_quantum
        if q_ids is not None:
            lens = np.asarray(q_lens)
            for j, L in enumerate(lens):
                q = int(-(-int(L) // qm) * qm)
                if q not in quanta or int(L) > len(quanta[q]):
                    quanta[q] = np.asarray(q_ids[j][:int(L)], np.int8)
        else:
            top = max(int(max_len or qm), qm)
            for q in range(qm, (-(-top // qm) * qm) + 1, qm):
                quanta[q] = np.zeros(q, np.int8)
        rungs = [b for b in self.cfg.batch_ladder if b <= self.cfg.max_batch]
        if q_ids is not None:
            b = max(rungs)
            lens32 = np.asarray(q_lens, np.int32)
            with span("warmup", rung=b, engine=self.name, settle=True,
                      samples=len(lens32)):
                for i in range(0, len(lens32), b):
                    self.query_batch(q_ids[i:i + b], lens32[i:i + b])
        for b in rungs:
            for q, row in sorted(quanta.items()):
                with span("warmup", rung=b, quantum=q, engine=self.name):
                    self.query_batch(np.repeat(row[None, :], b, axis=0),
                                     np.full(b, len(row), np.int32))
        return len(rungs) * len(quanta)

    def reset_stats(self) -> None:
        """Zero the ``stats()`` and ``pair_stats()`` views; the registry
        children stay monotonic."""
        self._stats.reset()
        self._pair_log.clear()

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        """Latency/throughput summary over every batch served so far.
        Percentiles are bucket-interpolated estimates (<= one bucket's
        relative width off the sample percentile). ``stage_ms`` splits the
        accumulated wall-clock by serving stage; the device is synchronized
        where results come to the host (end of the probe stage and of the
        re-rank), so work issued earlier lands there."""
        st = self._stats
        lat = st.lat
        stage_ms = {s: v * 1e3 for s, v in st.stage.items()}
        if lat.count == 0:
            return dict(n_queries=0, n_batches=0, qps=0.0,
                        p50_ms=0.0, p95_ms=0.0, p99_ms=0.0, mean_ms=0.0,
                        stage_ms=stage_ms, truncations=0,
                        index_epoch=self.index.epoch)
        return dict(
            n_queries=st.n_queries,
            n_batches=lat.count,
            qps=st.n_queries / lat.sum,
            p50_ms=lat.quantile(0.50) * 1e3,
            p95_ms=lat.quantile(0.95) * 1e3,
            p99_ms=lat.quantile(0.99) * 1e3,
            mean_ms=lat.mean * 1e3,
            stage_ms=stage_ms,
            truncations=st.truncations,
            index_epoch=self.index.epoch,
        )

    def pair_stats(self) -> list[dict]:
        """The pair dump's counterpart of :meth:`stats`: the newest
        :data:`PAIR_LOG_JOBS` :meth:`search_pairs` jobs since the last
        reset, oldest first. A job holds its host ``perf_counter`` stamps
        ``t0`` and ``t1``, its join ``attempts``, ``h2d_bytes`` (0 on a CPU
        pipeline), job 1's device seconds ``job1_dev_s`` and each attempt's,
        ``join_dev_s`` (both None without a card). A dense join's job also
        holds each attempt's device seconds of K6's count, ``count_dev_s``,
        and of the emission, ``emit_dev_s`` (None without a card), and the
        emission tiles and query rows of all its attempts, ``emit_tiles``
        and ``emit_rows``; the four are None for the flip and band
        joins."""
        return list(self._pair_log)
