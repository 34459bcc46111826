"""The pair dump of job 2: every (read, reference) pair within Hamming d,
through ``QueryEngine.search_pairs`` of the port (job 1 on the reads, then
the join, whose capacity doubles until nothing overflows), one job at a
time, closed loop.

Set-up makes the reference database from the seed, runs job 1 over it into
the index at the traffic's d and makes the traffic's read sets. Each timed
call dumps the pairs of one read set. The answers are judged against the
brute force of ``bench/reference/pairs.py``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from bench import deploy
from bench.reference.pairs import encode, pairs_within


@dataclass
class Job:
    set: int
    ids: np.ndarray        # (n, L) int8
    lens: np.ndarray       # (n,) int32

    @property
    def n(self) -> int:
        return len(self.lens)


class Driver:
    def __init__(self, config, traffic, generator, seed, device, *,
                 control=False):
        from repro_torch.index.service import QueryEngine
        self.device, self.traffic, self.control = device, traffic, control
        self.d = int(traffic["d"])
        self.lsh = deploy.lsh_config(config, self.d)
        self.ref_ids, self.ref_lens = deploy.make_refs(config, seed, device)
        self.index = deploy.build_index(config, self.lsh, self.ref_ids,
                                        self.ref_lens, device)
        self.engine = QueryEngine(self.index)
        self.sets = generator.query_sets(traffic, self.ref_ids,
                                         self.ref_lens, seed, device)
        self.job1 = self.ref = None
        self._expected = {}
        self._timing = None
        if control:
            self._reference()

    def _reference(self):
        if self.ref is None:
            self.job1 = deploy.reference_job1(self.lsh, self.device)
            self.ref = self.job1(self.ref_ids, self.ref_lens)
        return self.ref

    def plan(self) -> list[Job]:
        return [Job(s, q.ids, q.lens) for s, q in enumerate(self.sets)]

    def warmup(self, plan) -> None:
        for job in plan[:self.traffic["warmup_calls"]]:
            self.call(job)

    def call(self, job: Job):
        if self.control:
            codes = self._pairs(job, drop_at=self.d)
            pairs = np.stack([codes >> 24, (codes >> 4) & 0xFFFFF,
                              codes & 0xF], axis=1).astype(np.int32)
            return SimpleNamespace(pairs=torch.as_tensor(pairs),
                                   overflowed=False)
        return self.engine.search_pairs(job.ids, job.lens)

    def _pairs(self, job: Job, *, drop_at=None) -> np.ndarray:
        r_sigs, r_valid = self._reference()
        q_sigs, q_valid = self.job1(job.ids, job.lens)
        return pairs_within(q_sigs, q_valid, r_sigs, r_valid, f=self.lsh.f,
                            d=self.d, device=self.device, drop_at=drop_at)

    def describe(self) -> str:
        return f"{len(self.sets)} read sets of {self.sets[0].lens.size} reads"

    # ---------------------------------------------------------- traced run
    def trace_on(self) -> None:
        """Time job 1 and each join attempt that ``search_pairs`` makes,
        each up to a device sync, by wrapping its pipeline's methods."""
        sl = self.engine.sl
        self._timing = {"job1_s": 0.0, "join_s": 0.0, "attempts": 0}
        for name, key in (("signatures", "job1_s"),
                          ("feature_counts", "job1_s"),
                          ("search", "join_s")):
            setattr(sl, name, self._timed(getattr(sl, name), key))

    def _timed(self, fn, key):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._timing[key] += time.perf_counter() - t0
            if key == "join_s":
                self._timing["attempts"] += 1
            return out
        return run

    def trace_off(self) -> list[dict]:
        """Take the wrappers off again, so that what runs after the window
        (the profiled stretch) is the timed path as it is untraced."""
        for name in ("signatures", "feature_counts", "search"):
            vars(self.engine.sl).pop(name, None)
        self._timing = None
        return []

    def after_call(self) -> dict:
        if self._timing is None:
            return {}
        out = dict(self._timing)
        self._timing.update(job1_s=0.0, join_s=0.0, attempts=0)
        return out

    # ---------------------------------------------------------- judging
    def release(self) -> None:
        self.index_sigs = self.index.sigs
        self.index_valid = self.index.valid
        self.engine = self.index = None
        deploy.release(self.device)

    def check(self, records, rng):
        r_sigs, r_valid = self._reference()
        wrong_refs = deploy.ref_rows_wrong(r_sigs, r_valid, self.index_sigs,
                                           self.index_valid)
        pool = [r for r in records if r.out is not None]
        overflowed = sum(bool(r.out.overflowed) for r in pool)
        picks = rng.choice(len(pool), min(len(pool),
                                          self.traffic["check_calls"]),
                           replace=False) if pool else []
        missing = extra = 0
        for i in sorted(picks):
            job, out = pool[i].spec, pool[i].out
            if job.set not in self._expected:
                self._expected[job.set] = self._pairs(job)
            want = self._expected[job.set]
            p = out.pairs.cpu().numpy()
            p = p[p[:, 0] >= 0]
            got = encode(p[:, 0], p[:, 1], p[:, 2])
            uniq = np.unique(got)
            missing += int(np.setdiff1d(want, uniq).size)
            extra += int(np.setdiff1d(uniq, want).size + got.size - uniq.size)
        return [("ref_rows_wrong", wrong_refs, 0),
                ("pairs_missing", missing, 0),
                ("pairs_extra", extra, 0),
                ("jobs_overflowed", overflowed, 0)]
