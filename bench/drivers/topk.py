"""Top-k serving with a Smith-Waterman re-rank against a prepared index:
``QueryEngine.query_batch`` of the port, one client, closed loop.

Set-up makes the reference database from the seed, builds the band index
on the card, uploads the corpus for the re-rank and makes the traffic's
query sets. Each timed call serves one batch of a set, as the client cut
it, from submission to the numpy result. The answers are judged against
``bench/reference/topk.py``: the probe's top-k and the re-rank's order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from bench import deploy
from bench.reference.topk import Corpus, probe_topk, rerank


@dataclass
class Batch:
    set: int
    ids: np.ndarray        # (n, L) int8, L the batch's longest query
    lens: np.ndarray       # (n,) int32

    @property
    def n(self) -> int:
        return len(self.lens)


class Driver:
    def __init__(self, config, traffic, generator, seed, device, *,
                 control=False):
        from repro_torch.index.service import QueryEngine, ServingConfig
        self.device, self.traffic, self.control = device, traffic, control
        self.lsh = deploy.lsh_config(config)
        self.ref_ids, self.ref_lens = deploy.make_refs(config, seed, device)
        self.index = deploy.build_index(config, self.lsh, self.ref_ids,
                                        self.ref_lens, device)
        self.bands = self.index.n_bands
        self.ref_lens_np = self.ref_lens.cpu().numpy()
        serving = dict(config["serving"])
        serving["batch_ladder"] = tuple(serving["batch_ladder"])
        self.cfg = ServingConfig(**serving)
        self.engine = QueryEngine(
            self.index, self.cfg,
            ref_seqs=(self.ref_ids.cpu().numpy(), self.ref_lens_np))
        self.sets = generator.query_sets(traffic, self.ref_ids,
                                         self.ref_lens, seed, device)
        self.job1 = self.corpus = None
        if control:
            self._reference()

    def _reference(self):
        if self.corpus is None:
            self.job1 = deploy.reference_job1(self.lsh, self.device)
            self.corpus = Corpus(self.job1, self.ref_ids, self.ref_lens,
                                 bands=self.bands, device=self.device)
        return self.corpus

    def plan(self) -> list[Batch]:
        b = int(self.traffic["batch"])
        out = []
        for s, q in enumerate(self.sets):
            for i in range(0, len(q.lens), b):
                lens = q.lens[i:i + b]
                out.append(Batch(s, np.ascontiguousarray(
                    q.ids[i:i + b, :int(lens.max())]), lens.copy()))
        return out

    def _shape(self, batch: Batch):
        """The (batch rung, length quantum) the engine pads a batch to."""
        rung = min((r for r in self.cfg.batch_ladder if r >= batch.n),
                   default=self.cfg.max_batch)
        q = self.cfg.len_quantum
        return rung, -(-batch.ids.shape[1] // q) * q

    def warmup(self, plan) -> None:
        """Every shape the traffic sends, then its first calls (which also
        settle the probe's candidate cap)."""
        seen = {}
        for batch in plan:
            seen.setdefault(self._shape(batch), batch)
        for batch in list(seen.values()) + plan[:self.traffic["warmup_calls"]]:
            self.call(batch)

    def call(self, batch: Batch):
        if self.control:
            return self._answer(batch, ties="high")
        return self.engine.query_batch(batch.ids, batch.lens)

    def _answer(self, batch: Batch, *, ties: str):
        corpus = self._reference()
        q_sigs, q_valid = self.job1(batch.ids, batch.lens)
        ids, dists = probe_topk(corpus, q_sigs, q_valid, k=self.cfg.k,
                                bands=self.bands, ties=ties)
        return rerank(corpus, batch.ids, batch.lens, ids, dists)

    def describe(self) -> str:
        return (f"probe cap {self.engine._probe_cap}, "
                f"{self.engine.stats()['truncations']} truncated batches")

    # ---------------------------------------------------------- traced run
    def trace_on(self) -> None:
        from repro_torch.obs.trace import TRACER
        TRACER.clear()
        TRACER.enable(capacity=1 << 21)

    def trace_off(self) -> list[dict]:
        """The window's spans; the tracer is off again after it."""
        from repro_torch.obs.trace import TRACER
        spans = TRACER.spans()
        TRACER.disable()
        return spans

    def after_call(self) -> dict:
        return {}

    def rerank_pairs(self, batch: Batch, out):
        """Real lengths (query, reference) of every pair the re-rank scored
        for this batch's answer."""
        nid = out[0]
        qi, ki = np.nonzero(nid >= 0)
        return (batch.lens[qi].astype(np.int64),
                self.ref_lens_np[nid[qi, ki]].astype(np.int64))

    # ---------------------------------------------------------- judging
    def release(self) -> None:
        self.index_sigs = self.index.sigs
        self.index_valid = self.index.valid
        self.engine = self.index = None
        deploy.release(self.device)

    def check(self, records, rng):
        corpus = self._reference()
        wrong_refs = deploy.ref_rows_wrong(corpus.sigs, corpus.valid,
                                           self.index_sigs, self.index_valid)
        pool = [r for r in records if r.out is not None]
        picks = set(rng.choice(len(pool), min(len(pool),
                                              self.traffic["check_calls"]),
                               replace=False).tolist()) if pool else set()
        if pool:      # and the batch with the longest query
            picks.add(max(range(len(pool)),
                          key=lambda i: pool[i].spec.ids.shape[1]))
        wrong = 0
        for i in sorted(picks):
            batch, (got_ids, got_d) = pool[i].spec, pool[i].out
            ids, dists = self._answer(batch, ties="low")
            if np.shape(got_ids) != ids.shape or np.shape(got_d) != ids.shape:
                wrong += batch.n
                continue
            wrong += int(((got_ids != ids) | (got_d != dists)).any(1).sum())
        return [("ref_rows_wrong", wrong_refs, 0),
                ("topk_rows_wrong", wrong, 0)]
