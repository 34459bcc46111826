"""Many-against-many CLI on the card: corpus -> similarity graph ->
protein families (the port of ``repro/launch/allpairs.py``, same flags,
printed lines and ``--out`` arrays).

  PYTHONPATH=src python -m repro_torch.launch.allpairs \
      --n-families 64 --family-size 4 --n-singletons 256 --d 1 \
      --min-pid 50 [--out families.npz] [--pallas] [--stats] \
      [--incremental 128] [--shards 4] [--device cpu]

Builds (or loads, --index) the corpus SignatureIndex, runs the LSH
self-join (K5), scores the candidate pairs with device-resident tiled
Smith-Waterman waves (fused gather, ungapped X-drop prefilter K4, the
wavefront K3 or the row wave K7, an asynchronous drain ring), and
clusters the thresholded similarity graph into families.

Everything runs on the CUDA card unless ``--device`` names another
device (``--device cpu`` runs the kernels' plain torch twins); without a
card the default raises. ``--shards N`` lays the joins' buckets out as N
shards on that one device and splits each score and prefilter wave into
N blocks there (on one card, shards are a data layout); every result is
the same for every N.

``--incremental N`` holds the last N sequences out of the batch run and
ingests them afterwards through the append-only lifecycle: the index
grows by a sealed segment, the delta self-join emits only new-vs-resident
pairs, only those pairs are scored, and the surviving edges union into
the persistent disjoint-set forest — families equal a from-scratch
recluster at delta cost. With a directory --index the forest persists
beside the manifest as ``families.npz``.

Band keys are splitmix-mixed before bucketing; the signature scheme stays
``java`` here because the self-join's Hamming threshold is calibrated to
the java hash's compressed distance scale (``--scheme splitmix`` needs a
larger ``--d``).
"""
from __future__ import annotations

import argparse
import os
import time


def _emit_metrics(args) -> None:
    """--metrics-merge folds worker snapshots into the process registry;
    --metrics-out writes it (.json: a mergeable registry_state snapshot,
    anything else: Prometheus text)."""
    import json

    from ..obs import REGISTRY, merge_registry_state, registry_state
    if args.metrics_merge:
        for path in args.metrics_merge:
            with open(path) as fh:
                merge_registry_state(json.load(fh))
        print(f"[metrics] merged {len(args.metrics_merge)} worker "
              f"snapshot(s)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            if str(args.metrics_out).endswith(".json"):
                json.dump(registry_state(REGISTRY), fh)
            else:
                fh.write(REGISTRY.prometheus())
        print(f"[metrics] wrote {args.metrics_out}")


def _incremental(args, ids, lens, labels, cfg, index) -> None:
    """Batch the resident corpus, then ingest the held-out rows."""
    import numpy as np

    from ..allpairs import (all_pairs_ingest, all_pairs_search,
                            forest_from_result)
    n = len(lens)
    base = n - args.incremental
    if base <= 0:
        raise SystemExit(f"--incremental {args.incremental} leaves no "
                         f"resident corpus (total {n} seqs)")
    if index is not None and index.size != base:
        print(f"[index] loaded index covers {index.size} != resident "
              f"{base} seqs; rebuilding")
        index = None
    t0 = time.time()
    res = all_pairs_search(ids[:base], lens[:base], cfg, index=index,
                           device=args.device)
    t_batch = time.time() - t0
    forest = forest_from_result(res)
    t0 = time.time()
    ing = all_pairs_ingest(ids, lens, base, cfg, index=res.index,
                           forest=forest)
    t_ingest = time.time() - t0
    print(f"[batch]  {base} seqs -> {res.join.n_candidates} pairs, "
          f"{res.families.n_families} families ({t_batch:.2f}s)")
    print(f"[ingest] +{args.incremental} seqs -> "
          f"{ing.join.n_candidates} DELTA pairs "
          f"(epoch {res.index.epoch}), "
          f"{int(ing.edge_mask.sum())} edges survived "
          f"({t_ingest:.2f}s vs {t_batch:.2f}s batch — the "
          f"resident corpus was never re-joined or re-scored)")
    fams = ing.families
    pure = sum(1 for fam in fams if len(set(labels[fam])) == 1)
    largest = max((len(f) for f in fams), default=0)
    print(f"[truth]  {pure}/{len(fams)} families over the grown corpus "
          f"are pure; largest={largest}")
    if args.index:
        n_seg = res.index.save(args.index)
        msg = f"[index]  persisted to {args.index} ({n_seg} file(s))"
        if not str(args.index).endswith(".npz"):
            fpath = os.path.join(args.index, "families.npz")
            # the forest lives beside the manifest, stamped with the
            # generation it was clustered against
            forest.save(fpath, generation=res.index.generation)
            msg += f" + forest {fpath}"
        print(msg)
    if args.out:
        pairs = np.concatenate([res.pairs, ing.join.pairs], axis=0)
        scores = np.concatenate([res.scored.scores, ing.scored.scores])
        payload = dict(pairs=pairs, scores=scores,
                       labels=ing.labels, truth=labels)
        if res.scored.pid is not None and ing.scored.pid is not None:
            payload["pid"] = np.concatenate([res.scored.pid,
                                             ing.scored.pid])
        np.savez_compressed(args.out, **payload)
        print(f"[out]    wrote {args.out}")


def _batch(args, ids, lens, labels, cfg, index) -> None:
    """One all_pairs_search over the whole corpus."""
    import numpy as np

    from ..allpairs import all_pairs_search
    from ..index import occupancy_report
    n = len(lens)
    t0 = time.time()
    res = all_pairs_search(ids, lens, cfg, index=index, device=args.device)
    wall = time.time() - t0
    if args.stats:
        print(occupancy_report(res.index))
    if args.index and index is None:
        res.index.save(args.index)
        print(f"[index] persisted to {args.index}")

    sc = res.scored
    print(f"[join]  {n} seqs -> {res.join.n_candidates} candidate pairs "
          f"({res.join.n_candidates / max(n*(n-1)//2, 1):.2%} of all pairs)")
    print(f"[score] {sc.n_waves} SW waves over {sc.n_shapes} fixed shapes"
          f"{' (pallas)' if args.pallas else ''}"
          + (f"; prefilter rejected {sc.n_prefiltered}/{len(res.pairs)} "
             f"({sc.n_prefiltered / max(len(res.pairs), 1):.0%})"
             if sc.kept is not None else ""))
    thresh = (f"SW score >= {args.min_score}" if args.pallas
              else f"{args.min_pid:.0f}% PID")
    print(f"[graph] {int(res.families.edge_mask.sum())} edges at {thresh} "
          f"-> {res.families.n_families} families (total {wall:.2f}s)")

    # ground-truth purity (synthetic corpora only)
    pure = sum(1 for fam in res.families.families
               if len(set(labels[fam])) == 1)
    largest = max((len(f) for f in res.families.families), default=0)
    print(f"[truth] {pure}/{res.families.n_families} discovered families "
          f"are pure; largest={largest}")

    if args.out:
        payload = dict(pairs=res.pairs, scores=sc.scores,
                       labels=res.labels, truth=labels)
        if sc.pid is not None:
            payload["pid"] = sc.pid
        np.savez_compressed(args.out, **payload)
        print(f"[out]   wrote {args.out}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="all-pairs corpus similarity search "
                    "(repro_torch.allpairs)")
    ap.add_argument("--n-families", type=int, default=64)
    ap.add_argument("--family-size", type=int, default=4)
    ap.add_argument("--n-singletons", type=int, default=256)
    ap.add_argument("--len-mean", type=int, default=200)
    ap.add_argument("--sub-rate", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d", type=int, default=1,
                    help="Hamming threshold for the candidate filter")
    ap.add_argument("--scheme", default="java",
                    choices=["java", "splitmix"],
                    help="signature hash bits. Stays java here (unlike the "
                         "serving CLIs): the self-join's d threshold is "
                         "calibrated to the java hash's compressed distance "
                         "scale — splitmix's honest bits need a larger --d")
    ap.add_argument("--no-hamming-filter", action="store_true",
                    help="score every band collision (no distance filter)")
    ap.add_argument("--prefilter", action="store_true",
                    help="skip full SW for pairs whose best ungapped "
                         "diagonal run scores < --prefilter-min. Opt-in "
                         "here: the ungapped score is a LOWER bound of the "
                         "gapped score, and for indel-rich homologs (runs "
                         "chopped by gaps) it can fall below any useful "
                         "threshold — calibrate on your corpus")
    ap.add_argument("--prefilter-min", type=int, default=40,
                    help="ungapped score below which full SW is skipped")
    ap.add_argument("--xdrop", type=int, default=None,
                    help="finite X-drop margin (default: best ungapped run)")
    ap.add_argument("--fuse-prefilter", action="store_true",
                    help="run the ungapped prefilter INSIDE the self-join "
                         "(rejected pairs never reach the host); same "
                         "thresholds as --prefilter, identical survivors")
    ap.add_argument("--dp-kernel", default="wavefront",
                    choices=["wavefront", "rowwave"],
                    help="DP sweep for score-only waves: the anti-diagonal "
                         "wavefront (K3 on the card) or the row wave (K7)")
    ap.add_argument("--gap-mode", default="linear",
                    choices=["linear", "affine"],
                    help="gap model: linear (-4/residue) or affine Gotoh "
                         "(open/extend; needs --dp-kernel wavefront and "
                         "--pallas/--min-score scoring, PID waves stay "
                         "linear)")
    ap.add_argument("--gap-open", type=int, default=None,
                    help="affine gap-open score (default -11)")
    ap.add_argument("--gap-extend", type=int, default=None,
                    help="affine gap-extend score (default -1)")
    ap.add_argument("--host-gather", action="store_true",
                    help="refused: the port gathers every wave on the "
                         "device (the reference's host copy loop is not "
                         "ported)")
    ap.add_argument("--min-pid", type=float, default=50.0,
                    help="percent-identity threshold for family edges")
    ap.add_argument("--shards", type=int, default=1,
                    help="bucket shards, all on --device: the self-join "
                         "and the delta join emit each shard's buckets' "
                         "pairs (mix32(key) %% n_shards ownership), and each "
                         "score and prefilter wave splits into that many "
                         "blocks; the PID traceback wave (the default "
                         "scoring mode here) stays whole. The results are "
                         "the same for every shard count")
    ap.add_argument("--tile", type=int, default=1024)
    ap.add_argument("--wave-batch", type=int, default=64)
    ap.add_argument("--pallas", action="store_true",
                    help="score-only mode: no PID traceback, families "
                         "threshold on SW score >= --min-score. The name is "
                         "the reference's; in the port the kernels are "
                         "chosen by device in either mode (the hand-written "
                         "CUDA kernels on the card, their twins on the CPU)")
    ap.add_argument("--min-score", type=int, default=60,
                    help="SW score threshold used with --pallas")
    ap.add_argument("--index", default=None,
                    help="reuse/persist the corpus index here (.npz = "
                         "legacy monolithic; otherwise a segment directory "
                         "with O(delta) appends)")
    ap.add_argument("--incremental", type=int, default=0, metavar="N",
                    help="hold the last N sequences out of the batch run "
                         "and ingest them afterwards via the delta "
                         "self-join + persistent family forest (families "
                         "equal the from-scratch recluster, at delta cost)")
    ap.add_argument("--join-impl", default="spgemm",
                    choices=["spgemm", "legacy"],
                    help="candidate-generation orchestration: the fused "
                         "device-resident masked-SpGEMM path; 'legacy' is "
                         "refused (not ported: the same pair arrays)")
    ap.add_argument("--out", default=None,
                    help="write edges + labels npz here")
    ap.add_argument("--stats", action="store_true",
                    help="print per-band bucket occupancy before joining")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write this process's metrics registry here: "
                         ".json = mergeable registry_state snapshot (what "
                         "--metrics-merge consumes), anything else = "
                         "Prometheus text exposition")
    ap.add_argument("--metrics-merge", nargs="*", default=None,
                    metavar="JSON",
                    help="fold worker registry_state JSON snapshots "
                         "(written by their --metrics-out *.json) into "
                         "this process's registry before rendering "
                         "--metrics-out — histogram buckets add exactly")
    ap.add_argument("--device", default="cuda",
                    help="where the index, the joins and the waves run "
                         "(default: the CUDA card, which must be present; "
                         "'cpu' runs the kernels' plain torch twins)")
    args = ap.parse_args(argv)

    if args.host_gather:
        raise SystemExit("--host-gather: the port has no host gather (every "
                         "wave is gathered on the device from the corpus "
                         "uploaded once); drop the flag")
    if args.join_impl == "legacy":
        raise SystemExit("--join-impl legacy: the port has no legacy "
                         "orchestration (not ported by decision; 'spgemm' "
                         "gives the same pair arrays)")

    from ..allpairs import AllPairsConfig, WaveConfig
    from ..core import LSHConfig
    from ..data import FamilyCorpusConfig, make_family_corpus
    from ..index import SignatureIndex
    from ..util import resolve_device

    dev = resolve_device(args.device)   # no card and no --device: raises
    args.device = dev
    corpus = make_family_corpus(FamilyCorpusConfig(
        n_families=args.n_families, family_size=args.family_size,
        n_singletons=args.n_singletons, len_mean=args.len_mean,
        sub_rate=args.sub_rate, seed=args.seed))
    ids, lens, labels = corpus["ids"], corpus["lens"], corpus["labels"]
    lsh = LSHConfig(k=3, T=13, f=32, d=args.d, scheme=args.scheme)

    index = None
    if args.index and os.path.exists(args.index):
        t0 = time.time()
        index = SignatureIndex.load(args.index, expected_cfg=lsh,
                                    device=dev)
        print(f"[index] loaded {index.size} sigs in {time.time()-t0:.2f}s "
              f"(fp={index.fingerprint})")
    cfg = AllPairsConfig(
        lsh=lsh, hamming_filter=not args.no_hamming_filter,
        min_pid=args.min_pid, min_score=args.min_score,
        n_shards=args.shards,
        devices=(dev,) * args.shards if args.shards > 1 else None,
        wave=WaveConfig(tile=args.tile, wave_batch=args.wave_batch,
                        with_pid=not args.pallas,
                        n_devices=args.shards,
                        prefilter=args.prefilter,
                        prefilter_min=args.prefilter_min,
                        xdrop=args.xdrop,
                        dp_kernel=args.dp_kernel,
                        gap_mode=args.gap_mode,
                        gap_open=args.gap_open,
                        gap_extend=args.gap_extend),
        fuse_prefilter=args.fuse_prefilter)

    if args.incremental:
        _incremental(args, ids, lens, labels, cfg, index)
    else:
        _batch(args, ids, lens, labels, cfg, index)
    _emit_metrics(args)


if __name__ == "__main__":
    main()
