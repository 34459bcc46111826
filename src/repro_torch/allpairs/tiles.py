"""Tiled pair scheduler: candidate pairs -> batched Smith-Waterman waves on
the device.

The port of ``repro/allpairs/tiles.py``. The plan is the reference's:

1. **(tile_i, tile_j) blocks** — pairs are grouped by the corpus tile of
   each endpoint and the blocks walked in order;
2. **length buckets** — within a block, pairs are bucketed by their padded
   (Lq, Lr) on a quantized ladder, and each bucket is cut into waves of a
   fixed batch B (shrunk for long pairs by a cell budget), the last one
   padded with all-PAD rows;
3. **device gather** — the corpus goes to the device once; a wave sends
   only its (2, B) pair indices and gathers its (B, Lq) and (B, Lr)
   blocks there;
4. **ungapped X-drop prefilter** (``prefilter=True``, kernel K4 on CUDA) —
   only pairs whose ungapped score reaches ``prefilter_min`` proceed to
   the gapped wave (K3, or K7 with ``dp_kernel="rowwave"``); rejected
   pairs report their ungapped score, a lower bound (``kept`` marks the
   survivors);
5. **asynchronous drain** — torch launches return before the device
   finishes; a FIFO ring makes the host wait for a wave's scores only
   when more than ``inflight`` waves are outstanding.

The reference's ``use_pallas``/``pallas_interpret`` have no meaning here
(routing is by device), nor have its host-gather and per-wave-sync
profiling switches (the device gather is the only gather; the spans time
each wave's issue), and ``n_devices > 1`` comes with the sharded
all-pairs slice (ROADMAP Queue 1 item 1). Scores (and PID, through the
host traceback) come back aligned with the input pair order.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..align.smith_waterman import (dp_scores_block, sw_wave_pid,
                                    ungapped_xdrop_scores)
from ..core.alphabet import PAD
from ..obs import record as record_span
from ..util import resolve_device


@dataclass(frozen=True)
class WaveConfig:
    tile: int = 1024             # corpus rows per (tile_i, tile_j) block
    wave_batch: int = 64         # pairs per full-SW wave (upper bound)
    len_quantum: int = 64        # pad pair lengths to multiples of this
    max_wave_cells: int = 1 << 23  # B*Lq*Lr budget; shrinks B for long pairs
    inflight: int = 2            # waves in flight before the oldest
                                 # result is copied to the host
    n_devices: int = 1           # > 1: sharding, not ported yet (raises)
    dp_kernel: str = "wavefront"  # score-only DP: "wavefront" (K3) or
                                 # "rowwave" (K7, linear gaps). The PID
                                 # path always runs the row wave (its
                                 # traceback needs the DP matrix)
    gap_mode: str = "linear"     # "linear" (GAP = -4, both sweeps) or
                                 # "affine" (Gotoh open/extend, wavefront)
    gap_open: int | None = None  # None -> GAP (linear) / -11 (affine)
    gap_extend: int | None = None  # None -> -1; affine only
    prefilter: bool = False      # ungapped X-drop prefilter before full SW
    prefilter_min: int = 40      # skip full SW below this ungapped score
    xdrop: int | None = None     # X-drop margin; None is no drop (the
                                 # plain best ungapped segment)
    prefilter_batch: int = 256   # pairs per prefilter wave
    with_pid: bool = False       # also run the PID traceback


@dataclass(frozen=True)
class PairScores:
    scores: np.ndarray           # (P,) int32 SW best score per input pair
                                 # (prefilter-rejected pairs: ungapped score,
                                 # a lower bound — see ``kept``)
    pid: np.ndarray | None       # (P,) float64 percent identity (with_pid)
    aln_len: np.ndarray | None   # (P,) int64 alignment length (with_pid)
    n_waves: int                 # waves issued (incl. prefilter)
    n_shapes: int                # distinct wave shapes
    ungapped: np.ndarray | None = None  # (P,) int32 prefilter scores
    kept: np.ndarray | None = None      # (P,) bool — pair ran full SW
    timings: dict | None = None  # coarse phase seconds: dispatch,
                                 # drain, prefilter, pid_wave

    @property
    def n_prefiltered(self) -> int:
        return 0 if self.kept is None else int((~self.kept).sum())


def _quantize(lens: np.ndarray, quantum: int) -> np.ndarray:
    return np.maximum(quantum, -(-lens // quantum) * quantum)


def wave_plan(pairs: np.ndarray, lens: np.ndarray, cfg: WaveConfig):
    """Group pair indices into dispatch order: (tile_i, tile_j) block, then
    padded-length bucket. Yields (pair_idx (m,), Lq_pad, Lr_pad) with
    pair_idx referring to rows of ``pairs``."""
    if len(pairs) == 0:
        return
    ti = pairs[:, 0] // cfg.tile
    tj = pairs[:, 1] // cfg.tile
    lq = _quantize(lens[pairs[:, 0]], cfg.len_quantum)
    lr = _quantize(lens[pairs[:, 1]], cfg.len_quantum)
    # dispatch key: block-major, then shape; lexsort is stable so pairs stay
    # in input order within a wave
    order = np.lexsort((lr, lq, tj, ti))
    keys = np.stack([ti[order], tj[order], lq[order], lr[order]], axis=1)
    starts = np.flatnonzero(
        np.concatenate([[True], (np.diff(keys, axis=0) != 0).any(axis=1)]))
    bounds = np.concatenate([starts, [len(order)]])
    for s, e in zip(bounds[:-1], bounds[1:]):
        yield order[s:e], int(keys[s, 2]), int(keys[s, 3])


class _DeviceCorpus:
    """The corpus on the device, uploaded once, in the form that makes a
    wave's gather one index per side: every row PAD past its length, one
    all-PAD row at index N for the wave's padding slots (pair index -1),
    and the width padded to the widest wave. The blocks equal
    ``align.smith_waterman.gather_rows``'s; a wave sends only its (2, B)
    pair indices."""

    def __init__(self, ids: np.ndarray, lens: np.ndarray,
                 device: torch.device, quantum: int):
        N, L = ids.shape
        width = max(L, int(_quantize(lens, quantum).max(initial=quantum)))
        rows = np.full((N + 1, width), PAD, np.int8)
        rows[:N, :L] = np.where(np.arange(L)[None, :] < lens[:, None], ids,
                                PAD)
        self.n = N
        self.rows = torch.from_numpy(rows).to(device)

    def wave(self, pairs: np.ndarray, chunk: np.ndarray, B: int, Lq: int,
             Lr: int):
        """The (B, Lq) and (B, Lr) blocks of the pairs ``pairs[chunk]``,
        padded to B with the all-PAD row."""
        pinned = self.rows.is_cuda
        idx = torch.empty((2, B), dtype=torch.int64, pin_memory=pinned)
        host = idx.numpy()
        host.fill(self.n)
        host[:, :len(chunk)] = pairs[chunk].T
        if pinned:
            # a copy from pageable memory would wait for the whole stream;
            # from pinned memory it is queued behind the waves in flight
            idx = idx.to(self.rows.device, non_blocking=True)
        return self.rows[:, :Lq][idx[0]], self.rows[:, :Lr][idx[1]]


class _DrainRing:
    """FIFO of in-flight device results. Torch launches are asynchronous:
    a wave's scores are queued for the host (into pinned memory, behind
    the wave on its stream) as soon as it is issued, and the host waits
    for them only when the ring holds more than ``depth`` results — for
    that wave alone, not for the waves issued after it (a plain ``.cpu()``
    would wait for the whole stream)."""

    def __init__(self, depth: int, sink):
        self.depth = max(0, depth)
        self.sink = sink                # sink(slots, host_values)
        self._q: deque = deque()

    def push(self, slots, dev: torch.Tensor) -> None:
        done = None
        if dev.is_cuda:
            host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            host.copy_(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            dev = host
        self._q.append((slots, dev, done))
        while len(self._q) > self.depth:
            self._pop()

    def _pop(self) -> None:
        slots, host, done = self._q.popleft()
        if done is not None:
            done.synchronize()
        self.sink(slots, host.numpy())

    def drain(self) -> None:
        while self._q:
            self._pop()


class _WaveStats:
    def __init__(self):
        self.n_waves = 0
        self.shapes: set = set()
        self.t = {"dispatch": 0.0, "drain": 0.0, "prefilter": 0.0,
                  "pid_wave": 0.0}


def _iter_wave_chunks(sub, lens, cfg: WaveConfig, wave_batch: int):
    """Walk the dispatch plan, shrink the batch to the cell budget, and
    yield fixed-shape (chunk, B, Lq, Lr) work units (the last chunk of a
    bucket may be shorter than B; the dispatchers pad it). Shared by the
    score and PID paths, so their wave shapes cannot diverge."""
    for idx, Lq, Lr in wave_plan(sub, lens, cfg):
        B = max(1, min(wave_batch, cfg.max_wave_cells // (Lq * Lr)))
        for s in range(0, len(idx), B):
            yield idx[s:s + B], B, Lq, Lr


def _run_score_waves(lens, pairs, subset, cfg: WaveConfig, corpus, out,
                     stats: _WaveStats, *, kind: str,
                     wave_batch: int) -> None:
    """Dispatch score-only waves (``kind``: "sw" | "ungapped") over
    ``pairs[subset]``, writing results into ``out[subset[...]]`` through
    the drain ring."""
    sub = pairs[subset]

    def sink(slots, host):
        out[slots] = host[:len(slots)]

    ring = _DrainRing(cfg.inflight, sink)
    key = "prefilter" if kind == "ungapped" else "dispatch"
    for chunk, B, Lq, Lr in _iter_wave_chunks(sub, lens, cfg, wave_batch):
        t0 = time.perf_counter()
        qm, rm = corpus.wave(sub, chunk, B, Lq, Lr)
        if kind == "ungapped":
            res = ungapped_xdrop_scores(qm, rm, x=cfg.xdrop)
        else:
            res = dp_scores_block(qm, rm, dp_kernel=cfg.dp_kernel,
                                  gap_mode=cfg.gap_mode,
                                  gap_open=cfg.gap_open,
                                  gap_extend=cfg.gap_extend)
        t1 = time.perf_counter()
        stats.t[key] += t1 - t0
        # issue-side duration: device time hides in the drain
        record_span("wave", t0, t1, cat="allpairs", kind=kind, B=B,
                    Lq=Lq, Lr=Lr, n=len(chunk))
        t0 = time.perf_counter()
        ring.push(subset[chunk], res)
        stats.t["drain"] += time.perf_counter() - t0
        stats.n_waves += 1
        stats.shapes.add((kind, B, Lq, Lr))
    t0 = time.perf_counter()
    ring.drain()
    stats.t["drain"] += time.perf_counter() - t0


def _run_pid_waves(lens, pairs, subset, cfg: WaveConfig, corpus, scores,
                   pid, aln, stats: _WaveStats) -> None:
    """PID waves: the DP matrices on the device, then the host traceback
    (host-bound, so these waves drain synchronously)."""
    sub = pairs[subset]
    for chunk, B, Lq, Lr in _iter_wave_chunks(sub, lens, cfg,
                                              cfg.wave_batch):
        t0 = time.perf_counter()
        qm, rm = corpus.wave(sub, chunk, B, Lq, Lr)
        stats.t["dispatch"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        pw, lw, sw = sw_wave_pid(qm, rm, chunk=B)
        t1 = time.perf_counter()
        stats.t["pid_wave"] += t1 - t0
        record_span("wave", t0, t1, cat="allpairs", kind="pid", B=B,
                    Lq=Lq, Lr=Lr, n=len(chunk))
        slots = subset[chunk]
        pid[slots] = pw[:len(chunk)]
        aln[slots] = lw[:len(chunk)]
        scores[slots] = sw[:len(chunk)]
        stats.n_waves += 1
        stats.shapes.add(("pid", B, Lq, Lr))


def score_pairs(ids: np.ndarray, lens: np.ndarray, pairs: np.ndarray,
                cfg: WaveConfig | None = None, *,
                device=None) -> PairScores:
    """Score every (i, j) candidate pair with batched Smith-Waterman waves
    on ``device`` (the card unless the caller names another).

    ids (N, L) int8 PAD-padded corpus, lens (N,), pairs (P, 2) int32.
    Returns scores (and PID when ``cfg.with_pid``) aligned with ``pairs``.
    With ``cfg.prefilter`` the ungapped X-drop scan runs first and only
    survivors (``result.kept``) pay the full DP; rejected pairs report the
    ungapped lower bound (and PID 0).
    """
    cfg = cfg or WaveConfig()
    if cfg.dp_kernel not in ("wavefront", "rowwave"):
        raise ValueError(f"unknown dp_kernel {cfg.dp_kernel!r}")
    if cfg.gap_mode not in ("linear", "affine"):
        raise ValueError(f"unknown gap_mode {cfg.gap_mode!r}")
    if cfg.gap_mode == "affine":
        if cfg.dp_kernel == "rowwave":
            raise ValueError("affine gaps need dp_kernel='wavefront'")
        if cfg.with_pid:
            raise ValueError("with_pid needs gap_mode='linear' (the PID "
                             "traceback reads the linear-gap DP matrix)")
    if cfg.n_devices > 1:
        raise NotImplementedError(
            f"n_devices={cfg.n_devices}: multi-device waves come with "
            f"ROADMAP Queue 1 item 1 (the sharded all-pairs slice); scores "
            f"do not depend on it")
    dev = resolve_device(device)
    ids = np.asarray(ids, np.int8)
    pairs = np.asarray(pairs, np.int32)
    lens = np.asarray(lens, np.int32)
    P = len(pairs)
    t_all = time.perf_counter()
    scores = np.zeros(P, np.int32)
    pid = np.zeros(P) if cfg.with_pid else None
    aln = np.zeros(P, np.int64) if cfg.with_pid else None
    stats = _WaveStats()
    corpus = _DeviceCorpus(ids, lens, dev, cfg.len_quantum) if P else None

    everything = np.arange(P)
    ungapped = None
    kept = None
    subset = everything
    if cfg.prefilter and P:
        ungapped = np.zeros(P, np.int32)
        _run_score_waves(lens, pairs, everything, cfg, corpus, ungapped,
                         stats, kind="ungapped",
                         wave_batch=cfg.prefilter_batch)
        kept = ungapped >= cfg.prefilter_min
        scores[:] = ungapped        # lower bound for the rejected pairs
        subset = np.flatnonzero(kept)
    if len(subset):
        if cfg.with_pid:
            _run_pid_waves(lens, pairs, subset, cfg, corpus, scores, pid,
                           aln, stats)
        else:
            _run_score_waves(lens, pairs, subset, cfg, corpus, scores,
                             stats, kind="sw",
                             wave_batch=cfg.wave_batch)
    record_span("score_pairs", t_all, time.perf_counter(), cat="allpairs",
                pairs=P, waves=stats.n_waves, shapes=len(stats.shapes),
                prefiltered=0 if kept is None else int((~kept).sum()))
    return PairScores(scores=scores, pid=pid, aln_len=aln,
                      n_waves=stats.n_waves, n_shapes=len(stats.shapes),
                      ungapped=ungapped, kept=kept,
                      timings=dict(stats.t))
