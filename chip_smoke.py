#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. build   — compile every CUDA kernel of the port with nvcc (sm_90a).
2. serve   — the main path at Swiss-Prot scale (454,401 synthetic refs,
             mean length 373): ``SignatureIndex.build`` on the card, then
             ``QueryEngine`` with the Smith-Waterman re-rank serves 256
             queries in ``mode="probe"`` and in ``mode="dense"`` (kernel
             K2), 50 passes each after warmup, every 64-query batch timed
             on its own; the within-d neighbours must agree between the
             modes and with a brute-force sweep of K2's plain twin.
3. siggen  — the index of NC_000913 scale (4,146 refs, mean length 316)
             built with ``siggen_method="matmul"`` (kernel K1) must carry
             the same signatures as the table path.
4. kernels — every kernel, on the inputs the main path gave it, held
             exactly against its plain torch twin, and timed.
5. small   — a 2,000-ref index served on the card and on the CPU (the
             twins) must give identical top-k ids and distances.

Launch counts are zeroed, and the kernel wrappers record their first
inputs, just before phase 2; both are read just after phase 3. The output
ends with the card's ``nvidia-smi`` name and power limit, one JSON line of
kernels, and the ``ok`` line. Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
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


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def _timed(torch, fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` runs after one warm run (CUDA
    events around the whole run of launches)."""
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
    before = ops.LAUNCHES["siggen_accumulate"]
    t0 = time.perf_counter()
    idx = SignatureIndex.build(LSHConfig(siggen_method="matmul", **kw),
                               data["ref_ids"], data["ref_lens"], device=dev)
    torch.cuda.synchronize()
    mm_s = time.perf_counter() - t0
    n_k1 = ops.LAUNCHES["siggen_accumulate"] - before
    table = ScalLoPS(LSHConfig(**kw), device=dev).signatures(
        data["ref_ids"], data["ref_lens"]).cpu().numpy().view(np.uint32)
    if not np.array_equal(idx.sigs, table):
        bad = int((idx.sigs != table).any(axis=1).sum())
        raise AssertionError(f"K1 signatures differ from the table path "
                             f"on {bad} of {n_refs} refs")
    log(f"[siggen] {n_refs} refs: matmul-path build {mm_s:.3f} s with "
        f"{n_k1} K1 launches; signatures identical to the table path")


def _bounds(name, args):
    """(bound_ms, bound_by) of one kernel call from its inputs."""
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
    else:
        qs, rs = args
        from repro_torch.core.alphabet import PAD
        qlen = (qs != PAD).sum(1).double()
        rlen = (rs != PAD).sum(1).double()
        cells = float((qlen * rlen).sum())
        per_cell = 11 if name.endswith("affine") else 6
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
}


def phase_kernels(torch, recorded, launches, log):
    from repro_torch.kernels import ref
    from repro_torch.kernels.hamming import hamming_dist
    from repro_torch.kernels.siggen import siggen_accumulate
    from repro_torch.kernels.sw import wave_scores

    runners = {   # name: (kernel launcher, plain twin, reps, twin reps)
        "siggen_accumulate": (siggen_accumulate, ref.siggen_accumulate_ref,
                              3, 1),
        "hamming_dist": (hamming_dist, ref.hamming_dist_ref, 20, 3),
        "wave_scores_linear": (wave_scores, ref.wave_scores_ref, 5, 1),
        "wave_scores_affine": (wave_scores, ref.wave_scores_ref, 5, 1),
    }
    rows = []
    for name, (source, replaces) in KERNELS.items():
        if name not in recorded:
            raise AssertionError(f"the main path never launched {name}")
        args, kw = recorded[name]
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
        ms = _timed(torch, lambda: run(*args, **kw), reps)
        plain_ms = _timed(torch, lambda: twin(*args, **kw), twin_reps)
        bound_ms, bound_by = _bounds(name, args)
        shapes = " x ".join(str(tuple(a.shape)) for a in args)
        log(f"[kernels] {name} at {shapes}: exact vs twin; kernel "
            f"{ms:.4f} ms, twin {plain_ms:.4f} ms, bound "
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
    ops.reset_launches()
    phase_serve(torch, ops, dev, log)
    phase_siggen(torch, ops, dev, log)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    recorded, ops.RECORDED = ops.RECORDED, None
    log(f"[main] kernel launches on the main path: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    rows = phase_kernels(torch, recorded, launches, log)
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
