"""Serving CLI for indexed protein search on the card: build -> persist
-> load -> serve -> grow -> compact (the port of
``repro/launch/search_serve.py``, same flags and printed lines).

Pays the reference database cost once (paper §5.3), persists the
artifact, then serves query micro-batches with latency/throughput stats.
Growth is append-only: an ``--index`` path WITHOUT ``.npz`` is a segment
directory (manifest + per-segment files) where ``--add-fasta`` appends
O(delta) segment files and a live serving replica ingests the delta
without a full reload; ``--compact`` folds the segments back into one.

  PYTHONPATH=src python -m repro_torch.launch.search_serve \
      --n-refs 2048 --n-queries 256 --batch 32 --k 5 --d 1 \
      --index /tmp/scallops_idx [--shards 4] [--rerank] [--layout flip] \
      [--add-fasta new_refs.fasta] [--compact] [--device cpu]

Everything runs on the CUDA card unless ``--device`` names another
device (``--device cpu`` runs the kernels' plain torch twins); without a
card the default raises. ``--shards N`` lays the index's buckets out as N
shards, all on that one device (on one card, shards are a data layout).

With ``--replicas N`` the queries go through the asynchronous serving
tier instead (:mod:`repro_torch.serve`): N sharded replicas behind a
least-outstanding router, futures-based ``submit()`` with
``--deadline-ms`` admission control and a ``--max-wait-ms`` dispatch
policy; ``--add-fasta`` then ingests through the fleet's background loop
while serving stays live.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time


def _dump_obs(args) -> None:
    """Write the observability artifacts the flags asked for: Prometheus
    text exposition (--metrics-out) and/or the Chrome/Perfetto trace
    (--trace-out; open at https://ui.perfetto.dev)."""
    from ..obs import REGISTRY, TRACER
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            fh.write(REGISTRY.prometheus())
        print(f"[obs]   metrics -> {args.metrics_out}")
    if args.trace_out:
        n = TRACER.export(args.trace_out)
        print(f"[obs]   trace -> {args.trace_out} ({n} events; open in "
              f"chrome://tracing or ui.perfetto.dev)")


def _grown_refs(ref_seqs, new_ids, new_lens):
    """The re-rank's reference rows after an ingest: the old rows, then
    the new ones, padded to one width."""
    import numpy as np

    from ..core.alphabet import PAD
    ids, lens = ref_seqs
    L = max(ids.shape[1], new_ids.shape[1])
    grown = np.full((len(lens) + len(new_lens), L), PAD, np.int8)
    grown[:len(lens), :ids.shape[1]] = ids
    grown[len(lens):, :new_ids.shape[1]] = new_ids
    return grown, np.concatenate([np.asarray(lens, np.int32),
                                  np.asarray(new_lens, np.int32)])


def _serve_async(args, data, loaded, devices, ref_seqs, scfg, path):
    """Serve through the async tier: ReplicaFleet + AsyncEngine, one
    future per query, with ``--add-fasta`` ingested live mid-stream."""
    import numpy as np

    from ..data.fasta import load_fasta_encoded
    from ..serve import AsyncEngine, ReplicaFleet

    new = None
    if args.add_fasta:
        _names, new_ids, new_lens = load_fasta_encoded(args.add_fasta)
        new = (new_ids, new_lens)
        if args.rerank:
            # the replicas re-rank against rows the live ingest has not
            # added yet: give them every row up front, so a new reference
            # in a top-k has its sequence (the re-rank refuses an id past
            # its rows)
            ref_seqs = _grown_refs(ref_seqs, new_ids, new_lens)
    fleet = ReplicaFleet(loaded, scfg, n_replicas=args.replicas,
                         devices=devices, ref_seqs=ref_seqs)
    eng = AsyncEngine(fleet, max_wait_ms=args.max_wait_ms,
                      default_deadline_ms=args.deadline_ms)
    plan = None
    if args.chaos:
        # a small scripted demo of the fault machinery: two replica
        # crashes (each retried on the other replica, bit-exact) and one
        # slow call — deterministic because the dispatch thread serializes
        # fleet calls, so per-site call numbers are reproducible
        from ..faults import FaultPlan
        plan = (FaultPlan()
                .add("replica.query", "raise", on=2)
                .add("replica.query", "raise", on=5)
                .add("replica.query", "latency", on=6, delay_s=0.03)
                .install())
        print("[chaos] fault plan installed: replica.query raise@{2,5} "
              "latency@6 (expect 2 router retries, 0 degraded)")
    print(f"[async] {args.replicas} replica(s) x "
          f"{fleet._replicas[0].sharded.n_shards} shard(s), "
          f"max_wait={args.max_wait_ms}ms, "
          f"deadline={args.deadline_ms or 'none'}"
          f"{'' if args.deadline_ms is None else 'ms'}")
    # warm-up: every (rung, length-quantum) serving shape on every replica
    fleet.warmup(data["query_ids"], data["query_lens"])

    qids, qlens = data["query_ids"], data["query_lens"]
    ingest_ev = None
    new_count = 0
    futures = []
    t0 = time.time()
    for i in range(len(qlens)):
        if new is not None and i == len(qlens) // 2:
            # ingest the delta while requests are still streaming in:
            # serving never pauses, replicas refresh off-rotation
            new_count = len(new[1])
            ingest_ev = fleet.ingest(*new)
        futures.append(eng.submit(qids[i][:qlens[i]]))
    results = [f.result(timeout=120) for f in futures]
    wall = time.time() - t0

    hits = served = shed = degraded = 0
    epochs = {}
    for r, (parent, _rate) in zip(results, data["truth"]):
        if getattr(r, "degraded", False):
            degraded += 1
            continue
        if not r.ok:
            shed += 1
            continue
        served += 1
        epochs[r.epoch] = epochs.get(r.epoch, 0) + 1
        if parent >= 0 and parent in set(r.ids[r.ids >= 0]):
            hits += 1
    if ingest_ev is not None:
        if not ingest_ev.wait(timeout=120) or not ingest_ev.ok:
            raise SystemExit(f"live ingest failed: {ingest_ev.error}")
        loaded.save(path)               # appends ONLY the new segment
        print(f"[add]   +{new_count} refs ingested LIVE mid-stream -> "
              f"epoch {loaded.epoch}; served epochs "
              f"{dict(sorted(epochs.items()))} (every result tagged with "
              f"the index state it was answered at)")

    s = eng.stats()
    lat, qlat = s["latency"], s["queue"]
    n_hom = sum(1 for p, _ in data["truth"] if p >= 0)
    print(f"[serve] {served}/{len(results)} queries in {wall:.2f}s — "
          f"{served / max(wall, 1e-9):.0f} q/s, "
          f"p50={lat['p50_ms']:.1f}ms p95={lat['p95_ms']:.1f}ms "
          f"p99={lat['p99_ms']:.1f}ms (queue p95={qlat['p95_ms']:.1f}ms, "
          f"{s['counters']['batches']} batches, "
          f"shed={shed}, degraded={degraded}, k={args.k})")
    print(f"[quality] planted homologs in top-{args.k}: "
          f"{hits}/{n_hom} ({hits / max(n_hom, 1):.0%})")

    fs = fleet.stats()
    health = " ".join(
        f"{r['name']}:{'QUAR' if r['health']['quarantined'] else 'up'}"
        f"(fails={r['health']['fails']})" for r in fs["replicas"])
    print(f"[health] coverage={fs['coverage']:.0%} {health} — "
          f"retries={fs['counters'].get('retries', 0)} "
          f"retry_ok={fs['counters'].get('retry_success', 0)} "
          f"quarantines={fs['counters'].get('replica_quarantines', 0)} "
          f"degraded_batches={fs['counters'].get('degraded_batches', 0)}; "
          f"dispatch crashes="
          f"{s.get('dispatch', {}).get('crashes', 0)}, "
          f"wedged={s['wedged']}")
    if plan is not None:
        plan.uninstall()
        missed = plan.unfired()
        n_scripted = sum(plan.summary()["scripted"].values())
        print(f"[chaos] fired {plan.fired()} of {n_scripted} "
              f"scripted faults"
              + ("" if not missed else
                 f" — UNFIRED (traffic too short?): {missed}"))

    if args.compact:
        before = fleet.query_batch(qids[:args.batch], qlens[:args.batch])
        t1 = time.time()
        fleet.compact_index()
        loaded.save(path)
        after = fleet.query_batch(qids[:args.batch], qlens[:args.batch])
        same = (np.array_equal(before[0], after[0])
                and np.array_equal(before[1], after[1]))
        print(f"[compact] {time.time() - t1:.2f}s -> epoch {loaded.epoch} "
              f"gen {loaded.generation} (rolling, serving stayed live); "
              f"probe results "
              f"{'identical' if same else 'DIVERGED (BUG)'}")
        if not same:
            raise SystemExit(1)
    eng.close()
    fleet.close()
    _dump_obs(args)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-refs", type=int, default=2048)
    ap.add_argument("--n-queries", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--d", type=int, default=1)
    ap.add_argument("--f", type=int, default=32,
                    help="signature width in bits (multiple of 32; 64/128 "
                         "need --scheme splitmix, and band keys wider than "
                         "32 bits fold through the mix32 chain)")
    ap.add_argument("--scheme", default="splitmix",
                    choices=["splitmix", "java"],
                    help="signature hash bits; the serving default is "
                         "splitmix (>= 99%% of ideal bucket entropy vs "
                         "54-60%% for the Java hash — index.stats); pass "
                         "java for paper-fidelity runs")
    ap.add_argument("--index", default=None,
                    help="persisted index path (default: tmp). Paths ending "
                         "in .npz write the monolithic legacy container; "
                         "anything else is a SEGMENT DIRECTORY — manifest + "
                         "per-segment files, where repeated saves append "
                         "only the new segments (O(delta) persistence)")
    ap.add_argument("--layout", default="band", choices=["band", "flip"])
    ap.add_argument("--shards", type=int, default=1,
                    help="bucket shards: each shard owns the buckets "
                         "mix32(band_key) %% n_shards routes to it (the "
                         "MapReduce shuffle) and probes only those; query "
                         "blocks go round the shards in a ring. All shards "
                         "sit on --device (one card: shards are a data "
                         "layout). Works for both layouts (flip = one "
                         "expanded band)")
    ap.add_argument("--add-fasta", default=None, metavar="FASTA",
                    help="after the first serving pass, append these "
                         "sequences as a sealed index segment and keep "
                         "serving: the sharded replica ingests the delta "
                         "slab via refresh() (no full reload) and a "
                         "directory --index persists just the new segment")
    ap.add_argument("--compact", action="store_true",
                    help="fold all segments into one after serving "
                         "(results identical before/after; a directory "
                         "--index is rewritten as a single segment)")
    ap.add_argument("--rerank", action="store_true",
                    help="Smith-Waterman re-rank of the top-k")
    ap.add_argument("--dp-kernel", default="wavefront",
                    choices=["wavefront", "rowwave"],
                    help="re-rank DP sweep: the anti-diagonal wavefront "
                         "(kernel K3) is the default; rowwave is the row "
                         "wave (kernel K7), linear gaps only")
    ap.add_argument("--gap-mode", default="linear",
                    choices=["linear", "affine"],
                    help="re-rank gap model; affine (Gotoh -11/-1) needs "
                         "--dp-kernel wavefront")
    ap.add_argument("--gap-open", type=int, default=None,
                    help="affine gap-open score (default -11)")
    ap.add_argument("--gap-extend", type=int, default=None,
                    help="affine gap-extend score (default -1)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve through the ASYNC tier: this many "
                         "ShardedIndex replicas behind a least-outstanding "
                         "router with futures-based submit() and a "
                         "background ingest loop (0 = the synchronous "
                         "QueryEngine path)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline for the async tier: "
                         "requests whose queue time + predicted batch "
                         "cost exceed it are shed with a typed Rejected "
                         "outcome instead of served late (default: no "
                         "deadline, nothing is shed)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="async dispatch policy: a micro-batch launches "
                         "at --batch requests or when its oldest request "
                         "has waited this long (0 = greedy)")
    ap.add_argument("--chaos", action="store_true",
                    help="install a small scripted FaultPlan during the "
                         "async serving pass (needs --replicas >= 2): two "
                         "replica crashes and one slow call, each retried "
                         "or absorbed by the router; prints retry / "
                         "quarantine / coverage accounting at the end. "
                         "Deterministic")
    ap.add_argument("--recover", action="store_true",
                    help="load the index with crash recovery enabled: a "
                         "torn or checksum-failed trailing segment is "
                         "QUARANTINED (moved to quarantine/, manifest "
                         "rewritten) and serving continues on the longest "
                         "valid prefix instead of refusing to start")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the process-wide metrics registry as "
                         "Prometheus text exposition on exit (merged "
                         "histograms, counters, gauges)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable structured tracing and write a "
                         "Chrome/Perfetto trace_event JSON on exit (every "
                         "span carries its queries' trace IDs; open in "
                         "chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--device", default="cuda",
                    help="where the index, the probes and the kernels run "
                         "(default: the CUDA card, which must be present; "
                         "'cpu' runs the kernels' plain torch twins)")
    args = ap.parse_args(argv)

    if args.chaos and args.replicas < 2:
        ap.error("--chaos needs --replicas >= 2 (the router retries a "
                 "crashed call on a DIFFERENT replica)")

    if args.trace_out:
        from ..obs import enable as _trace_enable
        _trace_enable()     # before any serving work: spans from the first
                            # warm-up batch onward land in the buffer

    import numpy as np

    from ..core import LSHConfig
    from ..data import SyntheticProteinConfig, make_protein_sets
    from ..index import QueryEngine, ServingConfig, ShardedIndex, SignatureIndex
    from ..util import resolve_device

    dev = resolve_device(args.device)   # no card and no --device: raises

    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=args.n_refs, n_homolog_queries=args.n_queries // 4,
        n_decoy_queries=args.n_queries - args.n_queries // 4,
        ref_len_mean=150, ref_len_std=30, sub_rates=(0.05, 0.15), seed=13))
    cfg = LSHConfig(k=3, T=13, f=args.f, d=args.d, scheme=args.scheme,
                    max_pairs=1 << 15)

    # ---- build + persist (paid once per reference database)
    t0 = time.time()
    index = SignatureIndex.build(cfg, data["ref_ids"], data["ref_lens"],
                                 layout=args.layout, n_shards=args.shards,
                                 device=dev)
    index._ensure_built()
    t_build = time.time() - t0
    tmp_dir = None
    if args.index:
        path = args.index
    else:
        tmp_dir = tempfile.mkdtemp(prefix="scallops_idx_")
        path = os.path.join(tmp_dir, "idx")
    t0 = time.time()
    n_written = index.save(path)
    t_save = time.time() - t0
    container = "monolithic npz" if str(path).endswith(".npz") \
        else f"segment dir ({n_written} segment file(s))"
    print(f"[build] {index.size} refs -> {index.n_bands}-band {args.layout} "
          f"index in {t_build:.2f}s (save {t_save:.2f}s, {container}, "
          f"fp={index.fingerprint})")

    # ---- load (fingerprint-verified) + serve
    t0 = time.time()
    loaded = SignatureIndex.load(path, expected_cfg=cfg,
                                 recover=args.recover, device=dev)
    print(f"[load]  verified fingerprint in {time.time()-t0:.2f}s "
          f"(epoch={loaded.epoch})")
    if getattr(loaded, "recovery", None):
        rec = loaded.recovery
        print(f"[recover] quarantined {rec['n_segments_dropped']} damaged "
              f"segment(s) from {rec['file']} onward "
              f"({rec['n_rows_dropped']} rows dropped, "
              f"{rec['n_rows_served']} served): {rec['reason']}")

    # one shard per entry, all on the one device; None: unsharded serving
    devices = [dev] * args.shards if args.shards > 1 else None

    ref_seqs = (data["ref_ids"], data["ref_lens"])
    scfg = ServingConfig(k=args.k, max_batch=args.batch, rerank=args.rerank,
                         dp_kernel=args.dp_kernel, gap_mode=args.gap_mode,
                         gap_open=args.gap_open, gap_extend=args.gap_extend)

    if args.replicas >= 1:
        _serve_async(args, data, loaded, devices, ref_seqs, scfg, path)
        if args.index is None:
            import shutil
            shutil.rmtree(tmp_dir, ignore_errors=True)
        return

    sharded = None
    if devices is not None:
        sharded = ShardedIndex(loaded, devices)
        part = sharded._part
        print(f"[shard] {int(part.n_buckets.sum())} buckets over "
              f"{sharded.n_shards} shards on {dev} (per-shard buckets "
              f"{part.n_buckets.tolist()}, entries {part.n_entries.tolist()})")
    engine = QueryEngine(loaded, scfg, sharded=sharded, ref_seqs=ref_seqs)
    mode = "sharded-probe" if sharded is not None else engine._mode()
    print(f"[mode]  {mode} serving (probe candidates are exact within "
          f"Hamming d={args.d}; the dense path ranks ALL refs — raise --d "
          f"for deeper top-k recall under probe/sharded serving)")
    # warm-up: every (rung, length-quantum) serving shape, pre-traffic
    engine.warmup(data["query_ids"], data["query_lens"])

    # ---- grow the live index (append-only segment + delta refresh)
    if args.add_fasta:
        from ..data.fasta import load_fasta_encoded
        names, new_ids, new_lens = load_fasta_encoded(args.add_fasta)
        t0 = time.time()
        loaded.add(new_ids, new_lens)
        n_written = loaded.save(path)       # appends ONLY the new segment
        t_add = time.time() - t0
        if args.rerank:                     # re-rank gather needs the rows
            engine.ref_seqs = _grown_refs(ref_seqs, new_ids, new_lens)
        print(f"[add]   +{len(new_lens)} refs from {args.add_fasta} -> "
              f"epoch {loaded.epoch} ({n_written} segment file(s) appended, "
              f"{t_add:.2f}s); serving replica will ingest the delta on "
              f"its next batch (no reload)")
        t0 = time.time()
        engine.query_batch(data["query_ids"][:args.batch],
                           data["query_lens"][:args.batch])
        if sharded is not None:
            print(f"[add]   delta refresh + first batch {time.time()-t0:.2f}s "
                  f"(replica epochs base={sharded.epoch[0]} "
                  f"delta={sharded.epoch[1]})")
    engine.reset_stats()        # warm-up/ingest batches aren't traffic

    qids, qlens = data["query_ids"], data["query_lens"]
    hits = 0
    t0 = time.time()
    for i in range(0, len(qlens), args.batch):
        nid, nd = engine.query_batch(qids[i:i + args.batch],
                                     qlens[i:i + args.batch])
        for j, (parent, _rate) in enumerate(data["truth"][i:i + args.batch]):
            if parent >= 0 and parent in set(nid[j][nid[j] >= 0]):
                hits += 1
    wall = time.time() - t0
    s = engine.stats()
    n_hom = sum(1 for p, _ in data["truth"] if p >= 0)
    print(f"[serve] {s['n_queries']} queries in {wall:.2f}s — "
          f"{s['qps']:.0f} q/s, p50={s['p50_ms']:.1f}ms "
          f"p95={s['p95_ms']:.1f}ms (batch={args.batch}, k={args.k}"
          f"{', rerank' if args.rerank else ''}, "
          f"epoch={s['index_epoch']})")
    print(f"[quality] planted homologs in top-{args.k}: "
          f"{hits}/{n_hom} ({hits/max(n_hom,1):.0%})")

    # ---- explicit compaction (the reduce step; results must not move)
    if args.compact:
        before = engine.query_batch(qids[:args.batch], qlens[:args.batch])
        t0 = time.time()
        loaded.compact()
        n_written = loaded.save(path)
        if sharded is not None:
            sharded.compact()
        after = engine.query_batch(qids[:args.batch], qlens[:args.batch])
        same = (np.array_equal(before[0], after[0])
                and np.array_equal(before[1], after[1]))
        print(f"[compact] {time.time()-t0:.2f}s -> epoch {loaded.epoch} "
              f"({n_written} file(s) rewritten); probe results "
              f"{'identical' if same else 'DIVERGED (BUG)'} across "
              f"compaction")
        if not same:
            raise SystemExit(1)

    _dump_obs(args)
    if args.index is None:
        import shutil
        shutil.rmtree(tmp_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
