#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. build    — compile every CUDA kernel of the port with nvcc (sm_90a),
              one nvcc per source, all started together.
2. serve    — the serving path at Swiss-Prot scale (454,401 synthetic
              refs, mean length 373): ``SignatureIndex.build`` on the
              card, then ``QueryEngine`` with the Smith-Waterman re-rank
              serves 256 queries in ``mode="probe"`` and in
              ``mode="dense"`` (kernel K2), 50 passes each after warmup,
              every 64-query batch timed on its own; the within-d
              neighbours must agree between the modes and with a
              brute-force sweep of K2's plain twin.
3. siggen   — the index of NC_000913 scale (4,146 refs, mean length 316)
              built with ``siggen_method="matmul"`` (kernel K1) must carry
              the same signatures as the table path.
4. allpairs — the all-vs-all path at myva scale (192,987 sequences, mean
              length 305, planted families of 4): ``all_pairs_search``
              on the card (join through K5, ungapped prefilter K4,
              Smith-Waterman K3), timed by stage; the card's join must
              equal the CPU's (K5's twin and the CPU pack) on the same
              index; the row wave (K7) over the prefilter survivors must
              give the wavefront's scores; and ``all_pairs_ingest`` of the
              last 4,096 rows onto a run over the rest must give the full
              run's family labels.
5. joins    — the self-join's two routes (keyed dup-free and sort-dedup)
              on the first 40,000 myva rows, where both apply: the same
              pairs, each route timed.
6. kernels  — every kernel held exactly against its plain torch twin and
              timed on the card alone (its launches captured in one CUDA
              graph): on the inputs the main paths gave it first, and K4
              and K7 on one full wave of their most used shape.
7. small    — a 2,000-ref index served, and a 2,000-sequence corpus
              clustered by ``all_pairs_search`` (the kernel route above,
              and the default PID route), on the card and on the CPU (the
              twins): identical outputs.

Each path is driven with every launch count set to 0 just before it and
read just after it: serving (phase 2), the K1 build (phase 3), and in
phase 4 the timed ``all_pairs_search`` (the all-pairs main path), the row
wave over the survivors (K7's path), the base run and the ingest, each on
its own. The kernel wrappers record their first inputs throughout phases
2-4. The output ends with the card's ``nvidia-smi`` name and
power limit, one JSON line of kernels, and the ``ok`` line. Needs one CUDA
card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

# Published peaks of one H100 SXM at its full 700 W power limit (NVIDIA
# data sheet, dense): HBM bytes/s, int8 tensor-core operations/s, and the
# CUDA cores' 32-bit rate (the data sheet's float32 figure; integer
# operations issue at no higher rate, so bounds from it are not too high).
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
CUDA_CORE_OPS_PER_S = 67e12

SWISSPROT = dict(n_refs=454_401, ref_len_mean=373)   # configs/scallops.py
NC_000913 = dict(n_refs=4_146, ref_len_mean=316)
SERVE_PASSES = 50       # timed passes over the 256 queries, per mode
# myva (configs/scallops.py: 192,987 sequences, mean length 305) as 16,384
# planted families of 4 plus 127,451 singletons
MYVA = dict(n_families=16_384, family_size=4, n_singletons=127_451,
            len_mean=305, len_std=80, sub_rate=0.1, seed=0)
INGEST_ROWS = 4_096     # rows the ingest check appends to the rest
JOIN_ROUTE_ROWS = 40_000  # <= PACKED_KEY_MAX_ID: both pack routes apply


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def _window(torch, ops, fn):
    """``fn()`` with every launch count set to 0 just before it: returns
    its result and the counts just after it."""
    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ops.LAUNCHES)


def _graph_ms(torch, fn, reps: int) -> float:
    """Mean device ms of one kernel launch: ``reps`` calls of ``fn``
    captured in one CUDA graph after a warm call, the graph replayed once
    to warm and once between two events, so no host work sits between the
    launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


def _timed(torch, fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` calls after one warm call, CUDA
    events around the whole run: device time and the host's issue time
    both (the twins are many small torch calls, as a user runs them)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _within_d(nid, nd, d):
    return [{(int(i), int(x)) for i, x in zip(nid[q], nd[q])
             if i >= 0 and x <= d} for q in range(nid.shape[0])]


def phase_serve(torch, ops, dev, log):
    from repro_torch.core.pipeline import LSHConfig
    from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                            make_protein_sets)
    from repro_torch.index.service import QueryEngine, ServingConfig
    from repro_torch.index.store import SignatureIndex
    from repro_torch.kernels.ref import hamming_dist_ref

    t0 = time.perf_counter()
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=SWISSPROT["n_refs"], ref_len_mean=SWISSPROT["ref_len_mean"],
        ref_len_std=80, n_homolog_queries=128, n_decoy_queries=128, seed=0))
    log(f"[serve] data: {SWISSPROT['n_refs']} refs x "
        f"{data['ref_ids'].shape[1]} padded residues, "
        f"{len(data['query_lens'])} queries, generated in "
        f"{time.perf_counter() - t0:.1f} s on the host")
    cfg = LSHConfig(k=3, T=13, f=32, d=1, scheme="splitmix")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = SignatureIndex.build(cfg, data["ref_ids"], data["ref_lens"],
                                 device=dev)
    index.partition(1).device_slabs()
    index.device_sigs
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[serve] index build on the card: {build_s:.3f} s "
        f"({int(index.valid.sum())} valid refs, {index.n_bands} bands)")
    refs = (data["ref_ids"], data["ref_lens"])
    qi, ql = data["query_ids"], data["query_lens"]
    batch = 64
    out = {}
    for mode, gap_mode in (("probe", "linear"), ("dense", "affine")):
        eng = QueryEngine(index, ServingConfig(
            k=10, max_batch=batch, rerank=True, mode=mode,
            gap_mode=gap_mode), ref_seqs=refs)
        t0 = time.perf_counter()
        eng.warmup(qi, ql)
        warm_s = time.perf_counter() - t0
        eng.reset_stats()
        # every batch timed on its own (query_batch returns host arrays, so
        # the device work of the batch is inside its time), with the kernel
        # launches it made
        wall, per_batch = [], set()
        first = None
        for _ in range(SERVE_PASSES):
            parts = []
            for i in range(0, len(ql), batch):
                before = dict(ops.LAUNCHES)
                t0 = time.perf_counter()
                parts.append(eng.query_batch(qi[i:i + batch],
                                             ql[i:i + batch]))
                wall.append(time.perf_counter() - t0)
                per_batch.add(tuple(sorted(
                    (k, v - before[k]) for k, v in ops.LAUNCHES.items()
                    if v != before[k])))
            nid = np.concatenate([p[0] for p in parts])
            nd = np.concatenate([p[1] for p in parts])
            if first is None:
                first = (nid, nd)
            elif not (np.array_equal(nid, first[0])
                      and np.array_equal(nd, first[1])):
                raise AssertionError(f"mode {mode}: a later pass gave "
                                     f"another top-k than the first")
        st = eng.stats()
        ms = np.asarray(wall) * 1e3
        if len(per_batch) != 1:
            raise AssertionError(f"mode {mode}: batches launched different "
                                 f"kernel counts: {sorted(per_batch)}")
        log(f"[serve] mode={mode} gap_mode={gap_mode}: warmup {warm_s:.2f} s,"
            f" then {st['n_queries']} queries in {len(ms)} batches of "
            f"{batch}: per-batch wall ms p50 {np.percentile(ms, 50):.4f}, "
            f"p95 {np.percentile(ms, 95):.4f}, min {ms.min():.4f}, max "
            f"{ms.max():.4f}, mean {ms.mean():.4f} (numpy percentiles over "
            f"all {len(ms)}); {st['qps']:.1f} qps; stats() bucket estimates "
            f"p50 {st['p50_ms']:.3f} ms, p95 {st['p95_ms']:.3f} ms; "
            f"stage_ms over all batches "
            + json.dumps({k: round(v, 3) for k, v in st["stage_ms"].items()})
            + f"; launches per batch {dict(next(iter(per_batch)))}; "
            f"truncations {st['truncations']}")
        nid, nd = first
        if nid.shape != (len(ql), 10) or nd.shape != nid.shape:
            raise AssertionError(f"top-k shape {nid.shape} in mode {mode}")
        if st["truncations"]:
            raise AssertionError(f"mode {mode} truncated candidates")
        out[mode] = first
    # within-d neighbours: the same in both modes, and the brute-force set
    # wherever that set fits in the top-k; the sweep is K2's plain twin, so
    # it does not lean on the kernel it checks
    qsig = index._pipeline.signatures(qi, ql)
    qvalid = (index._pipeline.feature_counts(qi, ql) > 0).cpu().numpy()
    dist = hamming_dist_ref(qsig, index.device_sigs)
    dist = torch.where(index.device_valid[None, :], dist, 1 << 30)
    a = _within_d(*out["probe"], cfg.d)
    b = _within_d(*out["dense"], cfg.d)
    checked = 0
    for q in range(len(ql)):
        if a[q] != b[q]:
            raise AssertionError(f"query {q}: probe {sorted(a[q])} != "
                                 f"dense {sorted(b[q])} within d={cfg.d}")
        hits = torch.nonzero(dist[q] <= cfg.d)[:, 0]
        if qvalid[q] and len(hits) <= 10:
            truth = {(int(i), int(dist[q, i])) for i in hits}
            if truth != a[q]:
                raise AssertionError(f"query {q}: top-k within d "
                                     f"{sorted(a[q])} != brute force "
                                     f"{sorted(truth)}")
            checked += 1
    n_hits = sum(len(s) for s in a)
    log(f"[serve] within-d neighbours agree in both modes for all "
        f"{len(ql)} queries ({n_hits} neighbours); {checked} queries "
        f"match the brute-force set exactly")
    return build_s


def phase_siggen(torch, ops, dev, log):
    from repro_torch.core.pipeline import LSHConfig, ScalLoPS
    from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                            make_protein_sets)
    from repro_torch.index.store import SignatureIndex

    n_refs = NC_000913["n_refs"]
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=n_refs, ref_len_mean=NC_000913["ref_len_mean"],
        ref_len_std=80, n_homolog_queries=0, n_decoy_queries=0, seed=0))
    kw = dict(k=3, T=13, f=32, d=1, scheme="splitmix")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, launches = _window(torch, ops, lambda: SignatureIndex.build(
        LSHConfig(siggen_method="matmul", **kw), data["ref_ids"],
        data["ref_lens"], device=dev))
    mm_s = time.perf_counter() - t0
    table = ScalLoPS(LSHConfig(**kw), device=dev).signatures(
        data["ref_ids"], data["ref_lens"]).cpu().numpy().view(np.uint32)
    if not np.array_equal(idx.sigs, table):
        bad = int((idx.sigs != table).any(axis=1).sum())
        raise AssertionError(f"K1 signatures differ from the table path "
                             f"on {bad} of {n_refs} refs")
    log(f"[siggen] {n_refs} refs: matmul-path build {mm_s:.3f} s with "
        f"launches {json.dumps(launches)}; signatures identical to the "
        f"table path")
    return launches


def _allpairs_config():
    """The all-vs-all configuration of the myva run: splitmix band keys
    (the java hash collapses each band into a few dozen buckets at this
    scale), every band collision scored (at d=1 the Hamming filter would
    drop most planted families), the ungapped prefilter before the
    wavefront Smith-Waterman, families at SW score >= 60."""
    from repro_torch.allpairs import AllPairsConfig, WaveConfig
    from repro_torch.core.pipeline import LSHConfig
    return AllPairsConfig(
        lsh=LSHConfig(k=3, T=13, f=32, d=1, scheme="splitmix"),
        hamming_filter=False,
        wave=WaveConfig(with_pid=False, prefilter=True, prefilter_min=40,
                        xdrop=None, dp_kernel="wavefront",
                        gap_mode="linear"),
        min_score=60)


def _family_quality(labels, truth, n_families):
    """(purity, pair recall): the share of found families (components of
    two or more) whose members share one planted family, and the share of
    planted within-family pairs that land in one component."""
    uniq, inv, counts = np.unique(labels, return_inverse=True,
                                  return_counts=True)
    multi = counts[inv] >= 2
    comp_truth = {}
    pure = {}
    for lab, t in zip(labels[multi], truth[multi]):
        first = comp_truth.setdefault(lab, t)
        pure[lab] = pure.get(lab, True) and first == t
    purity = sum(pure.values()) / max(len(pure), 1)
    planted = truth < n_families
    order = np.argsort(truth[planted], kind="stable")
    fam_labels = labels[planted][order].reshape(-1, MYVA["family_size"])
    same = fam_labels[:, :, None] == fam_labels[:, None, :]
    k = MYVA["family_size"]
    iu = np.triu_indices(k, 1)
    recall = float(same[:, iu[0], iu[1]].mean())
    return purity, recall, len(pure)


def _full_wave(torch, ids, lens, pairs, shape, quantum):
    """One wave of the plan's shape ``(B, Lq, Lr)`` filled with the first
    B of ``pairs`` whose padded lengths are (Lq, Lr): the (B, Lq) and
    (B, Lr) int8 blocks on the card, PAD past each length, as the wave
    gather builds them."""
    from repro_torch.core.alphabet import PAD

    B, Lq, Lr = shape
    q = np.maximum(quantum, -(-lens // quantum) * quantum)
    sel = pairs[(q[pairs[:, 0]] == Lq) & (q[pairs[:, 1]] == Lr)][:B]

    def block(rows, L):
        out = np.full((len(rows), L), PAD, np.int8)
        w = min(L, ids.shape[1])
        out[:, :w] = np.where(np.arange(w)[None, :] < lens[rows][:, None],
                              ids[rows, :w], PAD)
        return torch.from_numpy(out).cuda()

    return block(sel[:, 0], Lq), block(sel[:, 1], Lr)


def phase_allpairs(torch, ops, dev, log):
    from repro_torch.allpairs import (all_pairs_ingest, all_pairs_search,
                                      forest_from_result, score_pairs)
    from repro_torch.data.synthetic import (FamilyCorpusConfig,
                                            make_family_corpus)
    from repro_torch.index.store import SignatureIndex
    from repro_torch.obs import trace

    t0 = time.perf_counter()
    corpus = make_family_corpus(FamilyCorpusConfig(**MYVA))
    ids, lens, truth = corpus["ids"], corpus["lens"], corpus["labels"]
    N = len(lens)
    log(f"[allpairs] corpus: {N} sequences x {ids.shape[1]} padded "
        f"residues (mean length {lens.mean():.1f}), "
        f"{MYVA['n_families']} planted families of "
        f"{MYVA['family_size']}, generated in "
        f"{time.perf_counter() - t0:.1f} s on the host")
    cfg = _allpairs_config()
    # stage split from the port's spans: a ring large enough for one span
    # per wave
    trace.TRACER = trace.Tracer(capacity=1 << 22)
    trace.enable()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = SignatureIndex.build(cfg.lsh, ids, lens, device=dev)
    index.partition(1).device_slabs()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res, main_l = _window(torch, ops, lambda: all_pairs_search(
        ids, lens, cfg, index=index))
    t2 = time.perf_counter()
    trace.disable()
    spans = trace.TRACER.spans()
    trace.TRACER = trace.Tracer()
    join_s = next(sp["dur"] for sp in spans if sp["name"] == "emission")
    sc = next(sp for sp in spans if sp["name"] == "score_pairs")
    waves = [sp for sp in spans if sp["name"] == "wave"]
    first_sw = min((sp["ts"] for sp in waves if sp["args"]["kind"] == "sw"),
                   default=sc["ts"] + sc["dur"])
    pre_s = first_sw - sc["ts"]
    sw_s = sc["ts"] + sc["dur"] - first_sw
    cluster_s = (t2 - t1) - join_s - sc["dur"]
    part = index.partition(1)
    kept = res.scored.kept
    by_shape, fill = {}, {"ungapped": [], "sw": []}
    for sp in waves:
        a = sp["args"]
        shape = (a["kind"], a["B"], a["Lq"], a["Lr"])
        by_shape[shape] = by_shape.get(shape, 0) + 1
        fill[a["kind"]].append(a["n"] / a["B"])
    n_pre = len(fill["ungapped"])
    common = sorted(by_shape.items(), key=lambda kv: -kv[1])[:6]
    log(f"[allpairs] stages (host wall clock, s): index build "
        f"{t1 - t0:.3f}, join {join_s:.3f}, prefilter {pre_s:.3f}, SW "
        f"{sw_s:.3f}, clustering {cluster_s:.3f}; all_pairs_search "
        f"{t2 - t1:.3f} in all")
    log(f"[allpairs] counts: {int(index.valid.sum())} valid sequences; "
        f"buckets per band {[len(k) for k, _, _ in part.shards[0]]}; "
        f"within-bucket pairs per band {part.pair_totals[0].tolist()}; "
        f"{res.join.n_candidates} candidates; {int(kept.sum())} prefilter "
        f"survivors; {res.scored.n_waves} waves ({n_pre} prefilter, "
        f"{res.scored.n_waves - n_pre} SW) in {res.scored.n_shapes} "
        f"(kind, B, Lq, Lr) shapes, the most used {common}; mean fill "
        f"of B {np.mean(fill['ungapped']):.4f} (prefilter), "
        f"{np.mean(fill['sw'] or [0]):.4f} (SW); "
        f"{res.families.n_families} families")
    log(f"[main] kernel launches on the all-pairs path (the timed "
        f"all_pairs_search alone): {json.dumps(main_l)}")
    purity, recall, n_found = _family_quality(res.labels, truth,
                                              MYVA["n_families"])
    k = MYVA["family_size"]
    log(f"[allpairs] against the planted families (for information): "
        f"purity {purity:.4f} over {n_found} found families, pair recall "
        f"{recall:.4f} over {MYVA['n_families'] * k * (k - 1) // 2} planted "
        f"pairs")
    if res.join.n_candidates == 0 or not kept.any():
        raise AssertionError("the myva run found no candidates/survivors")
    for name in ("upper_pairs", "ungapped_scores", "wave_scores_linear"):
        if main_l[name] <= 0:
            raise AssertionError(f"all_pairs_search never launched {name}")

    # one full wave of each kernel's most used shape, from this run's
    # candidates (K4) and survivors (K7 runs the SW waves' plan)
    surv = res.pairs[kept]
    full = {}
    for name, kind, pool in (("ungapped_scores", "ungapped", res.pairs),
                             ("sw_rowwave", "sw", surv)):
        shape = max((s for s in by_shape if s[0] == kind),
                    key=lambda s: by_shape[s])[1:]
        full[name] = _full_wave(torch, ids, lens, pool, shape,
                                cfg.wave.len_quantum)
        log(f"[allpairs] {name} replay: one full wave of the most used "
            f"{kind} shape (B, Lq, Lr) = {shape} ({by_shape[(kind,) + shape]}"
            f" waves on the main path), {full[name][0].shape[0]} real pairs")

    # K7's path: the row wave over the survivors gives the wavefront's
    # scores
    t0 = time.perf_counter()
    rw, rw_l = _window(torch, ops, lambda: score_pairs(
        ids, lens, surv, replace(cfg.wave, prefilter=False,
                                 dp_kernel="rowwave"), device=dev))
    log(f"[allpairs] rowwave (K7) over the {len(surv)} survivors: "
        f"{time.perf_counter() - t0:.3f} s, {rw.n_waves} waves; launches "
        f"{json.dumps(rw_l)}")
    if rw_l["sw_rowwave"] <= 0:
        raise AssertionError("the row-wave path never launched sw_rowwave")
    if not np.array_equal(rw.scores, res.scored.scores[kept]):
        bad = int((rw.scores != res.scored.scores[kept]).sum())
        raise AssertionError(f"rowwave != wavefront on {bad} survivors")

    # ingest: a run over all but the last rows, then the last rows ingested
    base = N - INGEST_ROWS
    t0 = time.perf_counter()
    res_b, base_l = _window(torch, ops, lambda: all_pairs_search(
        ids[:base], lens[:base], cfg, device=dev))
    t1 = time.perf_counter()
    forest = forest_from_result(res_b)
    ing, ing_l = _window(torch, ops, lambda: all_pairs_ingest(
        ids, lens, base, cfg, index=res_b.index, forest=forest))
    t2 = time.perf_counter()
    log(f"[allpairs] ingest: all_pairs_search over {base} rows "
        f"{t1 - t0:.3f} s ({res_b.join.n_candidates} candidates; launches "
        f"{json.dumps(base_l)}), then all_pairs_ingest of {INGEST_ROWS} "
        f"rows {t2 - t1:.3f} s ({ing.join.n_candidates} delta candidates, "
        f"{int(ing.edge_mask.sum())} new edges; launches "
        f"{json.dumps(ing_l)})")
    if not np.array_equal(ing.labels, res.labels):
        bad = int((ing.labels != res.labels).sum())
        raise AssertionError(f"ingest labels differ from the full run's "
                             f"on {bad} sequences")
    log("[allpairs] ingest labels == full-run labels")
    return index, res, corpus, main_l, rw_l, full


def phase_join_routes(torch, corpus, dev, log):
    """The self-join's two routes on one index small enough for both
    (N <= PACKED_KEY_MAX_ID): the keyed dup-free route that
    ``lsh_self_join`` takes there (K5, the cross-band mask, one sort of
    int32 keys) and the sort-dedup route ``spgemm_join_self`` it takes
    above (K5, then ``pack_unique_pairs``: at this N two sorts of packed
    int32 keys). Same pairs; host wall clock per call, each call ending
    in its count's host sync, in turns keyed, sort-dedup, sort-dedup,
    keyed."""
    from repro_torch.core.join import PACKED_KEY_MAX_ID
    from repro_torch.index.spgemm import (spgemm_join_self,
                                          spgemm_join_self_keys)
    from repro_torch.index.store import SignatureIndex
    from repro_torch.util import next_pow2

    n = JOIN_ROUTE_ROWS
    assert n <= PACKED_KEY_MAX_ID
    cfg = _allpairs_config()
    index = SignatureIndex.build(cfg.lsh, corpus["ids"][:n],
                                 corpus["lens"][:n], device=dev)
    part = index.partition(1)
    _, offs_s, ids_s = part.device_slabs()
    offs_f = offs_s.reshape(-1, offs_s.shape[-1])
    ids_f = ids_s.reshape(-1, ids_s.shape[-1])
    cap = next_pow2(int(part.pair_totals.max()))
    out_cap = next_pow2(int(part.pair_totals.sum()))
    band_f = torch.arange(offs_s.shape[1]).repeat(offs_s.shape[0])
    routes = {
        "keyed": lambda: spgemm_join_self_keys(
            offs_f, ids_f, band_f, index.device_band_keys,
            index.device_sigs, cap=cap, out_cap=out_cap, d=None),
        "sort-dedup": lambda: spgemm_join_self(
            offs_f, ids_f, index.device_sigs, cap=cap, out_cap=out_cap,
            d=None)}
    out = {}
    for name, fn in routes.items():        # warm, and the outputs
        pairs, count = fn()
        out[name] = pairs[:int(count)].cpu().numpy()
    if not np.array_equal(out["keyed"], out["sort-dedup"]):
        raise AssertionError("keyed and sort-dedup self-join routes differ")
    times = {"keyed": [], "sort-dedup": []}
    for _ in range(5):
        for name in ("keyed", "sort-dedup", "sort-dedup", "keyed"):
            t0 = time.perf_counter()
            int(routes[name]()[1])
            times[name].append((time.perf_counter() - t0) * 1e3)
    log(f"[joins] {n} myva rows, {len(out['keyed'])} pairs from "
        f"{int(part.pair_totals.sum())} band slots, both routes identical; "
        f"ms per join (host wall clock, median of {len(times['keyed'])}): "
        f"keyed {np.median(times['keyed']):.4f} (min "
        f"{min(times['keyed']):.4f}), sort-dedup "
        f"{np.median(times['sort-dedup']):.4f} (min "
        f"{min(times['sort-dedup']):.4f})")


def phase_allpairs_cpu_join(index, res, log):
    """The card's pair array against the CPU's join (K5's twin and the
    CPU pack) on the same index."""
    from repro_torch.allpairs import lsh_self_join
    from repro_torch.index.store import SignatureIndex

    cpu = SignatureIndex(index.cfg, index.sigs, index.valid,
                         bands=index.bands, interleave=index.interleave,
                         key_hash=index.key_hash, device="cpu")
    t0 = time.perf_counter()
    join = lsh_self_join(cpu)
    if not np.array_equal(join.pairs, res.join.pairs):
        raise AssertionError(f"card join ({res.join.n_candidates} pairs) "
                             f"!= CPU join ({join.n_candidates} pairs)")
    log(f"[allpairs] card join == CPU join (K5 twin + CPU pack, "
        f"{time.perf_counter() - t0:.1f} s on the host): "
        f"{join.n_candidates} pairs")


def _bounds(name, args, kw):
    """(bound_ms, bound_by) of one kernel call from its inputs: the work
    these inputs need (real cells of a pair block, slots of a pair
    buffer), not the most the shapes could hold."""
    if name == "siggen_accumulate":
        rows, cb, H = args
        S, D = rows.shape
        W, f = H.shape
        nbytes = S * D * 4 + W * D + W * f + S * f * 4
        ops = 2 * S * W * (D + f)
        t_ops = ops / INT8_TC_OPS_PER_S
    elif name == "hamming_dist":
        q, r = args
        Q, nw = q.shape
        R = r.shape[0]
        nbytes = (Q + R) * nw * 4 + Q * R * 4
        t_ops = 3 * Q * R * nw / CUDA_CORE_OPS_PER_S
    elif name == "upper_pairs":
        offs, ids = args
        G, cap = ids.shape[0], kw["cap"]
        nbytes = offs.numel() * 4 + ids.numel() * 4 + G * cap * 8
        # a binary search of ~log2(E) steps and ~6 more operations a slot
        steps = max(int(ids.shape[1]).bit_length(), 1)
        t_ops = G * cap * (2 * steps + 6) / CUDA_CORE_OPS_PER_S
    else:
        qs, rs = args
        from repro_torch.core.alphabet import PAD
        qlen = (qs != PAD).sum(1).double()
        rlen = (rs != PAD).sum(1).double()
        cells = float((qlen * rlen).sum())
        per_cell = {"wave_scores_affine": 11, "ungapped_scores": 5}.get(
            name, 6)
        nbytes = qs.numel() + rs.numel() + 4 * qs.shape[0]
        t_ops = cells * per_cell / CUDA_CORE_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


KERNELS = {
    # name: (source, TPU kernel it replaces)
    "siggen_accumulate": ("src/repro_torch/kernels/csrc/siggen.cu",
                          "src/repro/kernels/siggen.py:56"),
    "hamming_dist": ("src/repro_torch/kernels/csrc/hamming.cu",
                     "src/repro/kernels/hamming.py:38"),
    "wave_scores_linear": ("src/repro_torch/kernels/csrc/sw.cu",
                           "src/repro/kernels/sw.py:165"),
    "wave_scores_affine": ("src/repro_torch/kernels/csrc/sw.cu",
                           "src/repro/kernels/sw.py:165"),
    "ungapped_scores": ("src/repro_torch/kernels/csrc/sw.cu",
                        "src/repro/kernels/sw.py:237"),
    "upper_pairs": ("src/repro_torch/kernels/csrc/spgemm.cu",
                    "src/repro/kernels/spgemm.py:93"),
    "sw_rowwave": ("src/repro_torch/kernels/csrc/sw.cu",
                   "src/repro/kernels/sw.py:95"),
}


def phase_kernels(torch, recorded, full, launches, log):
    from repro_torch.kernels import ref
    from repro_torch.kernels.hamming import hamming_dist
    from repro_torch.kernels.siggen import siggen_accumulate
    from repro_torch.kernels.spgemm import upper_pairs
    from repro_torch.kernels.sw import sw_rowwave, ungapped_scores, \
        wave_scores

    runners = {   # name: (kernel launcher, plain twin, reps, twin reps)
        "siggen_accumulate": (siggen_accumulate, ref.siggen_accumulate_ref,
                              3, 1),
        "hamming_dist": (hamming_dist, ref.hamming_dist_ref, 50, 3),
        "wave_scores_linear": (wave_scores, ref.wave_scores_ref, 20, 1),
        "wave_scores_affine": (wave_scores, ref.wave_scores_ref, 20, 1),
        "ungapped_scores": (ungapped_scores, ref.ungapped_scores_ref, 50, 1),
        "upper_pairs": (upper_pairs, ref.upper_pairs_ref, 10, 1),
        "sw_rowwave": (sw_rowwave, ref.sw_rowwave_ref, 50, 1),
    }
    rows = []
    for name, (source, replaces) in KERNELS.items():
        if name not in recorded:
            raise AssertionError(f"the main path never launched {name}")
        # K4 and K7: their first waves are nearly empty, so a full wave of
        # the most used shape (with the first launch's arguments)
        args, kw = recorded[name]
        args = full.get(name, args)
        run, twin, reps, twin_reps = runners[name]
        got = run(*args, **kw)
        want = twin(*args, **kw)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                                 f"twin {tuple(want.shape)}")
        err = int((got.long() - want.long()).abs().max()) \
            if got.numel() else 0
        if err != 0:
            raise AssertionError(f"{name} disagrees with its twin: max abs "
                                 f"err {err}")
        ms = _graph_ms(torch, lambda: run(*args, **kw), reps)
        plain_ms = _timed(torch, lambda: twin(*args, **kw), twin_reps)
        bound_ms, bound_by = _bounds(name, args, kw)
        shapes = " x ".join(str(tuple(a.shape)) for a in args)
        log(f"[kernels] {name} at {shapes}: exact vs twin; kernel "
            f"{ms:.4f} ms (device, {reps} launches in one CUDA graph), "
            f"twin {plain_ms:.4f} ms, bound "
            f"{bound_ms * 1e3:.3f} us ({bound_by}), "
            f"{launches[name]} launches on the main path")
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches[name],
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None))
    return rows


def phase_small(torch, dev, log):
    """Card vs CPU (kernels vs twins) end to end on a small index."""
    from repro_torch.core.pipeline import LSHConfig
    from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                            make_protein_sets)
    from repro_torch.index.service import QueryEngine, ServingConfig
    from repro_torch.index.store import SignatureIndex

    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=2000, ref_len_mean=150, ref_len_std=40, n_homolog_queries=48,
        n_decoy_queries=16, seed=7))
    refs = (data["ref_ids"], data["ref_lens"])
    cfg = LSHConfig(k=3, T=13, f=64, d=2, scheme="splitmix")
    res = {}
    for where in (dev, "cpu"):
        idx = SignatureIndex.build(cfg, *refs, device=where)
        for mode, gm in (("probe", "linear"), ("dense", "affine")):
            eng = QueryEngine(idx, ServingConfig(
                k=10, mode=mode, rerank=True, gap_mode=gm), ref_seqs=refs)
            res[(str(where), mode)] = eng.query_batch(
                data["query_ids"], data["query_lens"])
    for mode in ("probe", "dense"):
        a, b = res[(str(dev), mode)], res[("cpu", mode)]
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            raise AssertionError(f"card and CPU differ in mode={mode}")
    log("[small] 2000 refs, 64 queries, f=64, d=2: card == CPU twins, top-k "
        "ids and distances after re-rank, probe+linear and dense+affine")

    from repro_torch.allpairs import AllPairsConfig, all_pairs_search
    from repro_torch.data.synthetic import (FamilyCorpusConfig,
                                            make_family_corpus)
    c = make_family_corpus(FamilyCorpusConfig(
        n_families=250, family_size=4, n_singletons=1000, len_mean=150,
        len_std=40, sub_rate=0.1, seed=1))
    for label, cfg in (("kernel route", _allpairs_config()),
                       ("default PID route", AllPairsConfig())):
        a = all_pairs_search(c["ids"], c["lens"], cfg, device=dev)
        b = all_pairs_search(c["ids"], c["lens"], cfg, device="cpu")
        for what, x, y in (("pairs", a.pairs, b.pairs),
                           ("scores", a.scored.scores, b.scored.scores),
                           ("kept", a.scored.kept, b.scored.kept),
                           ("pid", a.scored.pid, b.scored.pid),
                           ("labels", a.labels, b.labels)):
            if (x is None) != (y is None) or (
                    x is not None and not np.array_equal(x, y)):
                raise AssertionError(f"all_pairs_search {label}: card and "
                                     f"CPU differ in {what}")
        log(f"[small] all_pairs_search, {len(c['lens'])} sequences, "
            f"{label}: card == CPU twins ({a.join.n_candidates} pairs, "
            f"{a.families.n_families} families; pairs, scores, kept, PID "
            f"and labels)")


def main() -> int:
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        return _fail(f"the port's sources are missing under {src}")
    try:
        import torch
    except ImportError:
        return _fail("torch is not installed")
    if not torch.cuda.is_available():
        return _fail("no CUDA device is available")
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build, ops

    def log(msg):
        print(msg, flush=True)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[build] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    build_s = build.build_all()
    log(f"[build] nvcc sm_90a, {len(build.SOURCES)} sources in parallel: "
        f"{build_s:.2f} s")

    ops.RECORDED = {}
    _, serve_l = _window(torch, ops, lambda: phase_serve(torch, ops, dev,
                                                         log))
    log(f"[main] kernel launches on the serving path: "
        f"{json.dumps(serve_l)}")
    siggen_l = phase_siggen(torch, ops, dev, log)
    index, res, corpus, pair_l, rowwave_l, full = phase_allpairs(
        torch, ops, dev, log)
    recorded, ops.RECORDED = ops.RECORDED, None
    phase_allpairs_cpu_join(index, res, log)
    del index, res
    phase_join_routes(torch, corpus, dev, log)
    del corpus
    # each kernel's count from its own path: K1 the matmul build, K2 and
    # K3 serving, K4 and K5 the timed all_pairs_search, K7 the row wave
    launches = {"siggen_accumulate": siggen_l["siggen_accumulate"]}
    launches.update({k: serve_l[k] for k in
                     ("hamming_dist", "wave_scores_linear",
                      "wave_scores_affine")})
    launches.update({k: pair_l[k] for k in
                     ("ungapped_scores", "upper_pairs")})
    launches["sw_rowwave"] = rowwave_l["sw_rowwave"]
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on their main path: "
                             f"{missing}")

    rows = phase_kernels(torch, recorded, full, launches, log)
    phase_small(torch, dev, log)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
