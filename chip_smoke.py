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
3. search   — job 2 at the paper's metagenomic scale: 547,169 queries of
              mean length 81 (``DATASETS["227_01_prot"]``, a quarter of
              them homolog fragments) against the Swiss-Prot refs of
              phase 2 (the same index): ``QueryEngine.search_pairs`` with
              the flip, band and dense joins (the dense count through
              kernel K6, its emission through K2), then one timed
              ``ScalLoPS.search`` per join; the joins must give one count
              and one (q, r, dist) set, every dist must equal the popcount
              and K6's counts must sum to the dense count; then d=0 and
              d=2, the paper's own ``perf_config()`` (java hash, d=0, flip;
              a query prefix if its pairs do not fit), and the flip-layout
              index serving phase 2's queries.
4. shard    — ``ShardedIndex`` over the index of phase 2 with 1, 2 and 4
              shards on the card: the ring's top-k, final cap and
              truncated flag equal ``topk_probe``'s for all 256 queries
              (once from cap=1, so grow-and-retry fires), each 64-query
              batch timed beside the unsharded probe's;
              ``QueryEngine(sharded=)`` with the linear and affine re-rank
              (K3) and the row wave (K7) equals the unsharded engine; on an
              index of its own over
              the same signatures, the 4,096 refs (seed 1) that phase 7
              adds are ingested by a delta ``refresh()``, after which the
              ring equals a ``ShardedIndex`` over an index built from all
              458,497 refs, and ``compact()`` leaves it identical.
5. fleet    — ``ReplicaFleet`` (2 replicas of 2 shards, SW re-rank)
              behind ``AsyncEngine`` takes 1,024 single-query futures with
              1,024 refs (seed 2) ingested mid-stream and the serving CLI's
              chaos script installed (raise at the 2nd and 5th replica
              call, latency at the 6th): 2 router retries, 0 degraded, and
              every result equals an engine over the index at the epoch it
              reports; queries/s and p50/p95 submit-to-result logged.
6. cli      — ``python -m repro_torch.launch.search_serve`` in a
              subprocess on the card: 454,401 refs, 4 shards, re-rank, a
              FASTA of 1,024 refs appended, compaction identical, and the
              ``--metrics-out`` and ``--trace-out`` files parsed; then
              ``--replicas 2 --chaos`` (65,536 refs, 2 shards, the same
              FASTA ingested live): 2 retries, 0 degraded.
7. persist  — index persistence on the index of phase 2 (454,401 refs):
              saved as a segment directory, grown by 4,096 refs and saved
              again (exactly one segment file written), loaded onto the
              card with its config: signatures, validity and CSR equal to
              the index in memory, and the phase-2 queries served by both
              in probe and dense modes with the SW re-rank give the same
              top-k ids, distances and SW scores; the legacy ``.npz``
              round trip; a wrong ``expected_cfg`` raises; a scripted torn
              write (``FaultPlan`` at ``store.write``) leaves the previous
              manifest loadable; a truncated segment raises
              ``CorruptSegment`` naming the file, and ``recover=True``
              serves the valid prefix (phase 2's top-k exactly) and
              reports what it dropped; occupancy statistics logged.
8. siggen   — the index of NC_000913 scale (4,146 refs, mean length 316)
              built with ``siggen_method="matmul"`` (kernel K1) must carry
              the same signatures as the table path.
9. quality  — the paper's §5.2 evaluation at NC_000913 scale with
              ``quality_config()`` (k=4, T=22, java, d=0, flip), 512
              homolog queries (sub_rates 0.03, 0.10, 0.20) and 512 decoys:
              the table path (k=4 tables built on the card) and the matmul
              path (K1 at k=4) give identical signatures and feature
              counts; ``ScalLoPS.search`` with the non-zero-signature
              masks; ``batch_percent_identity`` over the emitted pairs (at
              most 4,096), equal to the PID wave, whose scores K7
              (``sw_align_batch``) and K3 (``sw_wave_linear``) match on
              every pair; ``percent_identity`` on 8 pairs; the
              seed-and-extend baseline over as many queries as fit in
              15 s; recall, precision, PID quartiles and the intersection
              with the baseline logged for information; card == CPU on
              256 refs and 64 queries (pairs, PIDs, baseline hits; both
              sides search the card's signatures: the k=4 tables take
              minutes to build on the host).
10. allpairs — the all-vs-all path at myva scale (192,987 sequences, mean
              length 305, planted families of 4): ``all_pairs_search``
              on the card (join through K5, ungapped prefilter K4,
              Smith-Waterman K3), timed by stage; the card's join must
              equal the CPU's (K5's twin and the CPU pack) on the same
              index; the row wave (K7) over the prefilter survivors must
              give the wavefront's scores; and ``all_pairs_ingest`` of the
              last 4,096 rows onto an index of the rest must give the full
              run's family labels (the base run is cut to its join, which
              must equal the full join among those rows; their forest is
              the full run's surviving edges among them).
11. mapreduce — the sharded all-pairs paths and the paper's MapReduce
              engine on the objects of phases 3 and 10: the myva
              self-join at 2 and 4 shards == the one-shard join; the
              ingest's delta join at 1, 2 and 4 shards, equal, its pairs
              scored by waves split over 4 device entries (K4, K3; then
              K7 over the survivors) == the ingest's one-device scores;
              ``distributed_flip_join`` at 547,169 x 454,401 (map,
              shuffle sized from a host count of the records per (src,
              dst), salting, reduce) at 1, 2 and 4 shards with 0 dropped,
              its distinct within-d pairs == phase 3's flip join;
              ``ring_sweep`` (K2 a hop) over 512 homolog fragments and
              512 decoys == the flip join on them; the all-pairs CLI at
              ``--shards 4`` and 1 in subprocesses, the same ``--out``
              arrays, the first run's metrics snapshot merged by the
              second.
12. joins   — the self-join's two routes (keyed dup-free and sort-dedup)
              on the first 40,000 myva rows, where both apply: the same
              pairs, each route timed.
13. kernels — every kernel held exactly against its plain torch twin and
              timed on the card alone (its launches captured in one CUDA
              graph): on the inputs the main paths gave it first, and K4
              and K7 on one full wave of their most used shape; K2 and K6
              also against ``torch.cdist(p=0)`` on unpacked bits, and K1
              beside its function unfused in int8 (two blocked
              ``torch._int_mm`` products, a log line only). K3 (linear),
              K4 and K7 are also replayed, each replay checked and timed on
              its own, at the all-pairs waves of their most used shape: one
              full wave, and the first wave of that shape as the plan fills
              it (PAD slots included). Each logs its kernel share of its
              stage (K7: the row-wave step): launches x the real-fill
              wave's ms over the stage's wall clock. K1's first launch
              at k=4 (phase 9) has a row of its own,
              ``siggen_accumulate_k4``. The first inputs phase 11 gave
              K5, K4, K3, K7 and K2 are replayed too (``mr_*`` keys).
              ``table_sums`` (job 1's table route, which replaces no TPU
              kernel) is replayed at its first inputs, the index build's
              454,401 refs, and at phase 3's read set (``reads_*`` keys),
              the count table beside each (``counts_*`` keys); its bound
              is the table rows' L2 bytes at the L2 read rate measured on
              this card (``L2_BYTES_PER_S``).
14. small   — a 2,000-ref index served, and a 2,000-sequence corpus
              clustered by ``all_pairs_search`` (the kernel route above,
              and the default PID route), ``ScalLoPS.search`` with each
              join and a flip index's ``topk_probe``, on the card and on
              the CPU (the twins): identical outputs; the corpus also at
              ``n_shards=4`` on four entries of one device, card and
              CPU, equal to one shard.
15. wide    — widths and lengths past the kernels' old limits: f = 512
              (16 words) at NC_000913 scale through K1 (``siggen_method=
              "matmul"``, a grid per 256-column slice), the dense
              top-k (K2) and the dense join at d=1 (K6, then K2), card ==
              CPU; chains of 8,193, 12,000 and 34,350 residues planted in
              a 1,000-ref index and served with the SW re-rank (K3 past
              8,192 query rows, linear and affine), and in a small family
              corpus clustered by ``all_pairs_search`` with the row wave
              (K7 past 8,192 columns) and the wavefront, which must agree;
              each kernel held against its twin on the card at the inputs
              these paths gave it, and card == CPU where the CPU twins
              finish in seconds (the 34,350 query against short refs; the
              corpus without the 34,350 chain).
16. lm      — the LM serving path (``repro_torch.models``,
              ``repro_torch.launch.serve``): yi-9b at full width and depth
              (48 layers, d_model 4,096, 32/4 heads, d_ff 11,008, vocab
              64,000) in bf16 with weights drawn on the card, serving a
              batch of 8 prompts of 2,048 tokens and 32 greedy tokens:
              prefill s, decode ms a step and tokens/s, peak memory. Then
              each block family at full width in fp32, the same weights on
              the card and the CPU (drawn on the host, carried over), the
              same fed tokens, prefill and 8 decode steps: yi-9b (2
              layers, 2 x 24), olmoe-1b-7b (2 layers, 2 x 24),
              recurrentgemma-2b (one pattern repeat, 1 x 2,100, past its
              2,048 window) and xlstm-1.3b (one pattern repeat, 1 x 1,100,
              not a multiple of its 1,024 chunk; prefill + decode_step
              also == a full forward over 1,101 tokens on the card); max
              abs logit difference <= 2e-3 at every step. The LM path
              launches none of K1-K7 (its counts are read around the
              phase).
17. train   — LM training (``repro_torch.train``, ``checkpoint``,
              ``data.lm_data``, ``launch.train``): yi-9b at full width
              (d_model 4,096, 32/4 heads, d_ff 11,008, vocab 64,000), cut
              to 8 of 48 layers (48 layers of AdamW state do not fit 80
              GB), bf16 compute params under fp32 masters and moments,
              remat, batch 8 x 2,048 from ``lm_batches`` in 2
              microbatches: one warm step, then 3 timed steps (step s,
              tokens/s, peak memory, losses, grad norm, lr; the first loss
              within 2 of ln V, everything finite). Each block family at
              full width in fp32 (the ``[lm]`` models: yi-9b 2 layers,
              olmoe-1b-7b 2, recurrentgemma-2b 3, xlstm-1.3b 8) takes one
              ``make_train_step`` step of 2 x 16 tokens in one microbatch
              on the card and on the CPU from the same weights: loss
              within 1e-4, each gradient leaf within 1e-3 of its max abs,
              the masters within 1e-5 on all but 0.01% of the elements and
              none beyond 2·lr. The training CLI (yi-9b smoke, 6 steps
              of 8 x 32 tokens) in subprocesses with deterministic
              algorithms: 6 steps straight equal, byte for byte, a
              resume from their step-3 checkpoint, and its ``[dedup]``
              count equals the CPU's. The CLI and the checks run side by
              side; yi-9b trains last, with the card and the host to
              itself. The path launches none of K1-K7.
18. mesh    — the LM stack over a mesh of entries on the one card
              (``repro_torch.models.sharding``), tensor-parallel over
              "model": each entry of a DP row computes its heads, MLP
              columns, experts, vocab columns, RG-LRU channels and
              mLSTM / sLSTM heads of every layer and the row all-reduces
              the partials. The sharded training
              step (FSDP: each entry gathers its box of a layer at a
              time; fp32 gradient buffers, AdamW on the blocks) for
              yi-9b and olmoe-1b-7b at
              full width (2 layers, fp32, 4 x 16 tokens, 2 microbatches)
              on a ("data", "model") = (2, 2) mesh of ``cuda:0`` against
              the unsharded card step with [train]'s bars; yi-9b's
              stepped (2, 2) state saved (its files written while the card
              serves). yi-9b at full width and depth in bf16 on a (1, 4)
              mesh, [lm]'s weights and prompt (seed 0), served with the KV
              cache's sequence sharded over "model" (prefill, then
              MESH_GEN - 1 = 15 sequence-parallel decode steps); the
              cache after the sharded prefill, gathered, keeps the
              unsharded prefill's positions, and its k and v are within
              MESH_BF16_TOL times the unsharded model's own k/v route
              difference (its decode step's slot P against a prefill
              over P + 1 tokens); the greedy tokens are logged beside
              [lm]'s;
              the first decode step is fed the unsharded prefill's token
              (teacher forcing), and its logits are held against the
              unsharded decode step's within MESH_BF16_TOL times the
              unsharded model's own route difference there (its decode
              step against a prefill over the same P + 1 tokens).
              yi-9b (2 layers, fp32) on (2, 2): prefill of 4 x 1,100
              tokens and 8 decode steps, logits within 2e-4 of the
              unsharded card's at every step. recurrentgemma-2b (3
              layers) and xlstm-1.3b (8) at full width, fp32, on (2, 2)
              and (1, 4), the recurrent mixers (and recurrentgemma's 10
              heads, 3/3/2/2 on (1, 4)) tensor-parallel over "model":
              one train_step_fn of 4 x 16 tokens within [train]'s bars
              of the unsharded card's, a prefill of 2 x 1,100 tokens and
              8 decode steps within 2e-4 max abs logit or, where larger,
              MESH_ULP_TOL times the unsharded model's own logit movement
              under a 1e-7 relative weight perturbation, every replica of
              each recurrent state equal bit for bit; each entry's walked
              forward FLOPs logged beside the unsharded walk. The saved
              state restored
              onto (4, 1) and (1, 1), every leaf bit for bit. yi-9b at
              full width, 8 layers, bf16 under fp32 masters on (2, 2),
              batch 8 x 2,048 in 2 microbatches: a warm step and 3 timed
              steps. The mesh paths launch none of K1-K7.
19. dryrun  — ``launch.dryrun.lower_cell`` for yi-9b x {train_4k,
              decode_32k} on the (16, 16) production mesh of ``meta``
              entries (one entry's share: the per-device figures), and
              the counting walker over [mesh]'s timed step's
              shapes. The op-by-op walk of a 48-layer step takes minutes
              of host time, so it runs in one subprocess at the lowest
              CPU priority and one thread, started after the build; it
              ends minutes before [lm] begins (logged), so [lm], [train]
              and [mesh] never share the host with it. Last, the
              recompile sentinel's builds by site are logged, and any key
              built twice fails the run.

Each path is driven with every launch count set to 0 just before it and
read just after it: serving (phase 2), each join's ``search_pairs``
(phase 3; the dense join's is K6's path), the whole of phase 4 and of
phase 5 (K3, and K7 in phase 4, in the re-rank: the serving tier's
paths), the whole of
phase 7, the K1 build (phase 8), phase 9's matmul build (K1 at k=4) and
its scoring (K7, K3), and in phase 10 the timed ``all_pairs_search`` (the
all-pairs main path), the row wave over the survivors (K7's path), the
base join and the ingest, each on its own, in phase 11 each sharded
join, split score, row wave and ring sweep, in phase 15 each wide or
long path, and phases 16, 17 and 18 whole (no kernel may launch there).
The launches of phases 6, 11 and 17's CLI runs happen in their
processes and are not counted. K2's row also times the dense join's first
emission tile. The kernel wrappers record their first inputs throughout
phases 2-10, phases 4-5 and 9 each into a record of their own, and phase
11 the first inputs of its 4-shard self-join (K5), its split waves (K4,
K3, K7) and its 4-shard ring (K2), replayed against the twins under
``mr_*`` keys. The build logs ptxas's registers and spills of every sw.cu
and siggen.cu kernel. The output ends with the card's ``nvidia-smi`` name
and power limit, one JSON line of kernels, and the ``ok`` line. Needs one CUDA
card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import textwrap
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

# Published peaks of one H100 SXM at its full 700 W power limit (NVIDIA
# data sheet, dense): HBM bytes/s, int8 tensor-core operations/s, and the
# CUDA cores' 32-bit rate (the data sheet's float32 figure; integer
# operations issue at no higher rate, so bounds from it are not too high).
HBM_BYTES_PER_S = 3.35e12
# L2 read rate of an NVIDIA H100 80GB HBM3 at 700 W, the best that
# tools/l2_read_rate.py read: 16 B loads that bypass L1 (ld.global.cg)
# streamed over an L2-resident buffer of 4-32 MB read 6.84-7.42 TB/s (3.10
# TB/s over 4 GB, from HBM)
L2_BYTES_PER_S = 7.42e12
INT8_TC_OPS_PER_S = 1979e12
CUDA_CORE_OPS_PER_S = 67e12

# CUDA C++ Programming Guide, arithmetic-instruction throughput for compute
# capability 9.0, results per clock per SM: 32-bit popcount (__popc) 16;
# 32-bit integer add, compare and bitwise logic 64. Times the SM count and
# the card's maximum SM clock (read from nvidia-smi in main()), they bound
# K6, whose work is popcounts.
SMS = 132
POPC_PER_SM_CLK = 16
INT_ALU_PER_SM_CLK = 64
SM_CLOCK_HZ = 1.98e9    # replaced by nvidia-smi's clocks.max.sm in main()
SERVE_PASSES = 50       # timed passes over the 256 queries, per mode
# myva (configs/scallops.py: 192,987 sequences, mean length 305) as 16,384
# planted families of 4 plus 127,451 singletons
MYVA = dict(n_families=16_384, family_size=4, n_singletons=127_451,
            len_mean=305, len_std=80, sub_rate=0.1, seed=0)
INGEST_ROWS = 4_096     # rows the ingest check appends to the rest
# phase 3: pair capacities. A pair slot of the flip emission holds ~10
# int64 temporaries (~80 bytes), so 2^28 slots take ~21 GB of the card's
# 80; the band join's candidate slots (bands x capacity) cost about 48
# bytes each before the dedup sort.
PAIR_BUDGET = 1 << 28
BAND_SLOT_BUDGET = 1 << 29
MAX_GROW = 1 << 28      # search_pairs' capacity limit in phase 3
JOIN_ROUTE_ROWS = 40_000  # <= PACKED_KEY_MAX_ID: both pack routes apply
WIDE_F = 512            # [wide]: signature bits past 256 (16 words)
LONG_CHAINS = (8_193, 12_000, 34_350)   # [wide]: residues (titin ~34,350)
PERSIST_ADD = 4_096     # [persist]: refs add()ed before the delta save
PERSIST_TORN = 64       # [persist]: refs of the save the torn write hits
QUALITY_QUERIES = (512, 512)   # [quality]: homolog and decoy queries
PID_PAIRS = 4_096       # [quality]: emitted pairs aligned for PID, at most
SEED_EXTEND_S = 15.0    # [quality]: seconds of seed-and-extend search
QUALITY_CPU = (256, 64)  # [quality]: refs and queries of card == CPU
SHARD_COUNTS = (1, 2, 4)   # [shard]: shard counts of the ring, one card
SHARD_PASSES = 10       # [shard]: timed passes over the 256 queries
FLEET_QUERIES = 1_024   # [fleet]: single-query futures (4 x the 256)
FLEET_INGEST = 1_024    # [fleet]: refs ingested mid-stream (seed 2)
CLI_ADD = 1_024         # [cli]: refs of the FASTA --add-fasta appends
CLI_CHAOS_REFS = 65_536  # [cli]: refs of the --replicas 2 --chaos run
MR_SHARDS = (1, 2, 4)   # [mapreduce]: shard counts, all on the one card
RING_QUERIES = 512      # [mapreduce]: homolog and decoy queries each of
                        # the ring sweep (its (Q/n, R/n) distance block)
MR_CLI = ["--n-families", "1024", "--family-size", "4",
          "--n-singletons", "8192", "--len-mean", "305", "--prefilter",
          "--pallas", "--incremental", "1024"]
# the kernels [mapreduce] replays at the first inputs its paths gave them
MR_REPLAYED = ("upper_pairs", "ungapped_scores", "wave_scores_linear",
               "sw_rowwave", "hamming_dist")
LM_SERVE = ("yi-9b", 8, 2_048, 32)   # [lm]: arch, batch, prompt, tokens made
# [lm] card == CPU at full width in fp32: arch, layers, batch, prompt
LM_CHECKS = (("yi-9b", 2, 2, 24), ("olmoe-1b-7b", 2, 2, 24),
             ("recurrentgemma-2b", 3, 1, 2_100), ("xlstm-1.3b", 8, 1, 1_100))
LM_STEPS = 8            # [lm]: decode steps of the card == CPU check
LM_TOL = 2e-3           # [lm]: max abs logit difference, card vs CPU
# [train]: yi-9b at full width, cut in depth (48 layers of AdamW state do
# not fit 80 GB): arch, layers, batch, sequence, microbatches, timed steps
TRAIN_RUN = ("yi-9b", 8, 8, 2_048, 2, 3)
# [train] card == CPU at full width in fp32, one make_train_step step:
# arch, layers, batch, sequence, microbatches. yi-9b's 1,100 tokens cross
# TRAIN_RUN's chunk boundaries (two attention chunks of 1,024, three CE
# chunks of 512); olmoe's two microbatches sum their grads in fp32
TRAIN_CHECKS = (("yi-9b", 2, 1, 1_100, 1), ("olmoe-1b-7b", 2, 2, 16, 2),
                ("recurrentgemma-2b", 3, 2, 16, 1),
                ("xlstm-1.3b", 8, 2, 16, 1))
TRAIN_LOSS_TOL = 1e-4   # [train]: loss, card vs CPU
TRAIN_GRAD_TOL = 1e-3   # [train]: per gradient leaf, x the leaf's max abs
TRAIN_MASTER_TOL = 1e-5  # [train]: updated masters, max abs ...
TRAIN_MASTER_FLIPS = 1e-4  # ... on all but this share of the elements
TRAIN_CLI = ["--arch", "yi-9b", "--smoke", "--steps", "6", "--seq", "32"]
MESH_SERVE = (1, 4)     # [mesh]: (data, model) of the full-size serving
# [mesh]: tokens the full-size mesh serving makes (the first of [lm]'s 32:
# each decode step launches every split sublayer once an entry, and the
# smoke's other phases leave it little of its time limit)
MESH_GEN = 16
# [mesh] bf16 class of the sharded serving: its first decode step's max
# abs logit difference from the unsharded decode step, fed the same token,
# and its prefill's k and v difference from the unsharded prefill's, each
# within this many times the unsharded model's own difference between two
# routes to the same values (its decode step, and a prefill over P + 1
# tokens: the logits, and the k and v at slot P)
MESH_BF16_TOL = 4.0
# [mesh] sequence-parallel decode in fp32: arch, layers, batch, prompt,
# decode steps (1,100 tokens: two attention chunks); the reference test's
# bar on the logits
MESH_DECODE = ("yi-9b", 2, 4, 1_100, 8)
MESH_DECODE_TOL = 2e-4
# [mesh] the sharded step in fp32 at full width against the unsharded
# card step: arch, layers, batch, sequence, microbatches (each of the two
# DP rows: 2 x 16 tokens in 2 microbatches)
MESH_TRAIN_CHECKS = (("yi-9b", 2, 4, 16, 2), ("olmoe-1b-7b", 2, 4, 16, 2))
MESH_RESTORE = ((4, 1), (1, 1))   # [mesh]: meshes the (2, 2) state resumes on
# [mesh] the recurrent mixers tensor-parallel over "model", fp32 at full
# width: arch, layers (one pattern repeat each: recurrentgemma's rglru,
# rglru, local_attn; xlstm's 7 mLSTM and 1 sLSTM), on each of
# MESH_RECURRENT_SHAPES against the unsharded card: one train_step_fn of
# MESH_RECURRENT_TRAIN (batch, sequence) within [train]'s bars, a
# prefill and decode steps of MESH_RECURRENT_DECODE (batch, prompt,
# steps) within MESH_DECODE_TOL
MESH_RECURRENT = (("recurrentgemma-2b", 3), ("xlstm-1.3b", 8))
MESH_RECURRENT_SHAPES = ((2, 2), (1, 4))
MESH_RECURRENT_TRAIN = (4, 16)
MESH_RECURRENT_DECODE = (2, 1_100, 8)
# ... and where the unsharded model's own logits move more than
# MESH_DECODE_TOL when each block weight is scaled by (1 + MESH_ULP_REL ·
# N(0, 1)) — about an fp32 ulp, the size of what a split's reordered
# sums change (xlstm-1.3b at full width: 1.4e-4 to 5.7e-4 over a prefill
# and 3 steps) — within MESH_ULP_TOL times that movement
MESH_ULP_REL = 1e-7
MESH_ULP_TOL = 4.0


def _dataset(name: str) -> dict:
    """Size and mean length of one of the paper's datasets
    (``repro_torch/configs/scallops.py``, Tables 5.1/5.2)."""
    from repro_torch.configs.scallops import DATASETS
    return DATASETS[name]


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def _log_ptxas(build, log):
    """One line per kernel of every source: what ptxas reported for it
    (``-Xptxas -v``), names demangled by c++filt where the machine has
    it."""
    for src in build.SOURCES:
        usage = build.resource_usage(src)
        names = list(usage)
        try:
            names = subprocess.run(["c++filt"], input="\n".join(names),
                                   capture_output=True, text=True,
                                   check=True, timeout=60).stdout.splitlines()
        except (OSError, subprocess.SubprocessError):
            pass
        for name, u in zip(names, usage.values()):
            log(f"[build] ptxas {src}.cu {name}: {u.get('registers')} "
                f"registers, {u.get('stack')} bytes stack, "
                f"{u.get('spill_stores')} / {u.get('spill_loads')} bytes "
                f"spill stores / loads")


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

    sp = _dataset("swissprot")
    t0 = time.perf_counter()
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=sp["n"], ref_len_mean=sp["avg_len"],
        ref_len_std=80, n_homolog_queries=128, n_decoy_queries=128, seed=0))
    log(f"[serve] data: {sp['n']} refs x "
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
    return index, data, out["probe"]


def _pair_rows(torch, res, R):
    """Valid rows of a search result, sorted by (q, r): (keys q*R + r
    int64, dists int64), and their count checked against ``res.count``."""
    p = res.pairs[res.pairs[:, 0] >= 0].long()
    keys, order = torch.sort(p[:, 0] * R + p[:, 1])
    if len(keys) != int(res.count):
        raise AssertionError(f"{len(keys)} valid rows but count "
                             f"{int(res.count)}")
    if len(keys) > 1 and not bool((keys[1:] != keys[:-1]).all()):
        raise AssertionError("a pair appears twice in one buffer")
    return keys, p[order, 2]


def _check_dists(torch, keys, dists, q_sigs, r_sigs, d):
    """Every emitted dist is the popcount of its pair's signatures (plain
    torch, not a kernel) and at most d."""
    from repro_torch.core.hamming import hamming_distance
    R = r_sigs.shape[0]
    step = 1 << 25
    for i in range(0, len(keys), step):
        k = keys[i:i + step]
        want = hamming_distance(q_sigs[k // R], r_sigs[k % R])
        if not torch.equal(want.long(), dists[i:i + step]):
            raise AssertionError("an emitted dist differs from the popcount")
    if len(dists) and int(dists.max()) > d:
        raise AssertionError(f"an emitted pair lies beyond d={d}")


def _band_candidates(torch, q, r, f, bands):
    """Candidates per band of ``band_join`` (queries x refs sharing the
    band key), counted without emitting them."""
    from repro_torch.core.join import band_keys
    qk = band_keys(q, f, bands).T.contiguous()
    rk = band_keys(r, f, bands).T.contiguous()
    out = []
    for b in range(bands):
        rks = torch.sort(rk[b]).values
        out.append(int((torch.searchsorted(rks, qk[b], right=True)
                        - torch.searchsorted(rks, qk[b])).sum()))
    return out


def _timed_search(torch, sl, q, r, mp):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sl.search(q, r, max_pairs=mp)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_search(torch, ops, dev, index, serve_data, serve_probe, log):
    """Job 2 at the metagenomic scale against the Swiss-Prot index of
    phase 2. Returns the dense join's ``search_pairs`` launches (K6's
    path), the inputs of its first emission tile (K2), for [mapreduce]
    the d=1 signatures and the flip join's pair keys, and the count table
    and the first ``table_sums`` inputs of the flip join's job 1."""
    from repro_torch.configs.scallops import perf_config
    from repro_torch.core import simhash
    from repro_torch.core.pipeline import ScalLoPS
    from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                            make_protein_sets)
    from repro_torch.index.service import QueryEngine, ServingConfig
    from repro_torch.index.store import SignatureIndex
    from repro_torch.util import next_pow2

    sp, meta = _dataset("swissprot"), _dataset("227_01_prot")
    n_hom = meta["n"] // 4        # benchmarks/performance.py's split
    t0 = time.perf_counter()
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=sp["n"], ref_len_mean=sp["avg_len"], ref_len_std=80,
        n_homolog_queries=n_hom, n_decoy_queries=meta["n"] - n_hom,
        query_len_mean=meta["avg_len"], seed=0))
    gen_s = time.perf_counter() - t0
    if not (np.array_equal(data["ref_ids"], serve_data["ref_ids"])
            and np.array_equal(data["ref_lens"], serve_data["ref_lens"])):
        raise AssertionError("the search refs differ from the serving refs")
    qi, ql = data["query_ids"], data["query_lens"]
    del data
    Q, R = len(ql), index.size
    log(f"[search] data: {Q} queries (mean length {ql.mean():.1f}; {n_hom} "
        f"homolog fragments, {Q - n_hom} decoys) x the serving index's "
        f"{R} refs (the same arrays), generated in {gen_s:.1f} s on the "
        f"host")
    cfg = index.cfg
    r_sigs = index.device_sigs
    runs, launches = {}, {}
    emission = None
    for join in ("flip", "band", "dense"):
        jcfg = replace(cfg, join_method=join)
        eng = QueryEngine(SignatureIndex(jcfg, index.sigs, index.valid,
                                         device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_sigs = eng.sl.signatures(qi, ql)
        q_valid = eng.sl.feature_counts(qi, ql) > 0
        torch.cuda.synchronize()
        job1_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        # the dense join's first K2 launch is an emission tile: keep its
        # inputs apart from the serving batch that K2's row replays
        outer, ops.RECORDED = ops.RECORDED, {}
        res, lw = _window(torch, ops, lambda: eng.search_pairs(
            qi, ql, max_grow=MAX_GROW))
        inner, ops.RECORDED = ops.RECORDED, outer
        if join == "dense":
            emission = inner.get("hamming_dist")
        if join == "flip":
            table_reads = (simhash._device_table("count", cfg.k, cfg.T, 0,
                                                 "java", dev),
                           inner["table_sums"])
        if lw["table_sums"] != 2:
            raise AssertionError(f"{join}: search_pairs launched table_sums "
                                 f"{lw['table_sums']} times, not twice "
                                 f"(signatures, counts)")
        for name, rec in inner.items():
            outer.setdefault(name, rec)
        pairs_s = time.perf_counter() - t0
        if bool(res.overflowed):
            raise AssertionError(f"{join}: search_pairs still overflowed at "
                                 f"max_pairs {res.pairs.shape[0]}")
        mp = res.pairs.shape[0]
        raw, join_s = _timed_search(torch, eng.sl, q_sigs, r_sigs, mp)
        if bool(raw.overflowed):
            raise AssertionError(f"{join}: the unmasked join overflowed")
        runs[join] = (_pair_rows(torch, res, R), _pair_rows(torch, raw, R))
        launches[join] = lw
        log(f"[search] d={cfg.d} {join}: job 1 on the queries {job1_s:.3f}"
            f" s; search_pairs {pairs_s:.3f} s ({int(res.count)} pairs "
            f"after the validity masks, max_pairs reached {mp}, "
            f"{(mp // cfg.max_pairs).bit_length() - 1} retries); "
            f"ScalLoPS.search on the prepared signatures at that capacity "
            f"{join_s:.3f} s ({int(raw.count)} pairs); K6/K2/table_sums "
            f"launches in search_pairs {lw['hamming_count']}/"
            f"{lw['hamming_dist']}/{lw['table_sums']}")
    if launches["dense"]["hamming_count"] <= 0:
        raise AssertionError("the dense join never launched K6")
    if emission is None:
        raise AssertionError("the dense join emitted no K2 tile")
    (mkeys, mdist), (keys, dist) = runs["flip"]
    for join in ("band", "dense"):
        for (k1, d1), (k2, d2), what in ((runs[join][0], (mkeys, mdist),
                                          "search_pairs"),
                                         (runs[join][1], (keys, dist),
                                          "ScalLoPS.search")):
            if not (torch.equal(k1, k2) and torch.equal(d1, d2)):
                raise AssertionError(f"{what}: {join} gives {len(k1)} pairs,"
                                     f" flip {len(k2)}, or other pairs")
    _check_dists(torch, keys, dist, q_sigs, r_sigs, cfg.d)
    counts = ops.hamming_counts(q_sigs, r_sigs, cfg.d)
    if int(counts.long().sum()) != len(keys):
        raise AssertionError(f"K6 counts sum to {int(counts.long().sum())}, "
                             f"the dense join found {len(keys)}")
    # [mapreduce] runs the Signature Processor on the same signatures
    mr_data = dict(q_sigs=q_sigs.cpu(), r_sigs=r_sigs.cpu(),
                   flip_keys=keys.cpu(), n_hom=n_hom, f=cfg.f, d=cfg.d)
    log(f"[search] d={cfg.d}: flip, band and dense give one set of "
        f"{len(keys)} (q, r, dist) pairs ({len(mkeys)} after the masks), "
        f"none overflowed; every dist equals the popcount; K6's counts sum "
        f"to the dense count; queries with a pair: "
        f"{int((counts > 0).sum())}")

    # the paper's d sweep on the same signatures
    for d in (0, 2):
        counts = ops.hamming_counts(q_sigs, r_sigs, d).long()
        n = int(counts.sum())
        bands = _band_candidates(torch, q_sigs, r_sigs, cfg.f, d + 1)
        cap = next_pow2(max(n, max(bands), 1))
        joins = ["flip", "dense"]
        if (d + 1) * cap <= BAND_SLOT_BUDGET:
            joins.insert(1, "band")
        if next_pow2(max(n, 1)) > PAIR_BUDGET:
            raise AssertionError(f"d={d}: {n} pairs do not fit")
        found, times = {}, {}
        for join in joins:
            sl = ScalLoPS(replace(cfg, d=d, join_method=join), device=dev)
            mp = cap if join == "band" else next_pow2(max(n, 1))
            res, times[join] = _timed_search(torch, sl, q_sigs, r_sigs, mp)
            if bool(res.overflowed):
                raise AssertionError(f"d={d} {join} overflowed at {mp}")
            found[join] = _pair_rows(torch, res, R)
            del res
        k0, d0 = found["flip"]
        for join, (k1, d1) in found.items():
            if not (torch.equal(k0, k1) and torch.equal(d0, d1)):
                raise AssertionError(f"d={d}: {join} != flip")
        if len(k0) != n:
            raise AssertionError(f"d={d}: K6 counts {n}, the joins {len(k0)}")
        _check_dists(torch, k0, d0, q_sigs, r_sigs, d)
        log(f"[search] d={d}: {n} pairs (K6's count), band candidates per "
            f"band {bands}; ScalLoPS.search s: "
            + ", ".join(f"{j} {t:.3f}" for j, t in times.items())
            + ("" if "band" in joins else
               f"; band not run: {d + 1} x {cap} candidate slots exceed "
               f"{BAND_SLOT_BUDGET}")
            + "; the joins agree and every dist equals the popcount")
        del found, k0, d0
    del runs, keys, dist, mkeys, mdist

    # the paper's performance point: java hash, d=0, flip
    pcfg = perf_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    jidx = SignatureIndex.build(pcfg, serve_data["ref_ids"],
                                serve_data["ref_lens"], device=dev)
    jr = jidx.device_sigs
    jq = ScalLoPS(pcfg, device=dev).signatures(qi, ql)
    torch.cuda.synchronize()
    sig_s = time.perf_counter() - t0
    counts = ops.hamming_counts(jq, jr, 0).long()
    n = int(counts.sum())
    nq = Q
    if n > PAIR_BUDGET:
        nq = int(torch.searchsorted(torch.cumsum(counts, 0),
                                    torch.tensor(PAIR_BUDGET, device=dev),
                                    right=True))
    n_cut = int(counts[:nq].sum())
    res, join_s = _timed_search(torch, ScalLoPS(pcfg, device=dev), jq[:nq],
                                jr, next_pow2(max(n_cut, 1)))
    if bool(res.overflowed) or int(res.count) != n_cut:
        raise AssertionError(f"perf_config: {int(res.count)} pairs, K6 "
                             f"counted {n_cut}")
    k, dd = _pair_rows(torch, res, R)
    _check_dists(torch, k, dd, jq, jr, 0)
    del res, k, dd
    log(f"[search] perf_config() (java, k=3, T=13, d=0, flip): job 1 on "
        f"refs and queries {sig_s:.3f} s; {torch.unique(jr).numel()} "
        f"distinct ref signatures of {R}, {torch.unique(jq).numel()} of "
        f"{Q} queries; K6 counts {n} pairs over all {Q} queries"
        + (f"; above the {PAIR_BUDGET}-pair budget, so the join ran on the "
           f"first {nq} queries ({n_cut} pairs)" if nq < Q else "")
        + f"; flip join {join_s:.3f} s, every pair at distance 0")
    del jidx, jr, jq, counts

    # the flip layout under serving: phase 2's queries against a flip index
    # of the same refs; the within-d neighbours must be the band index's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fidx = SignatureIndex(cfg, index.sigs, index.valid, layout="flip",
                          device=dev)
    fidx.partition(1).device_slabs()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng = QueryEngine(fidx, ServingConfig(k=10, max_batch=64, mode="probe"))
    sq, sl_ = serve_data["query_ids"], serve_data["query_lens"]
    t0 = time.perf_counter()
    nid, nd = eng.query_batch(sq, sl_)
    serve_s = time.perf_counter() - t0
    a, b = _within_d(nid, nd, cfg.d), _within_d(*serve_probe, cfg.d)
    if a != b:
        bad = sum(x != y for x, y in zip(a, b))
        raise AssertionError(f"flip index: within-d neighbours differ from "
                             f"the band index's on {bad} queries")
    log(f"[search] flip-layout index over the {R} refs: built {build_s:.3f}"
        f" s ({len(fidx._csr_np[0][2])} keys, {len(fidx._csr_np[0][0])} "
        f"buckets); {len(sl_)} serving queries in {serve_s:.3f} s: within-d "
        f"neighbours == the band index's ({sum(map(len, a))})")
    del fidx, eng
    torch.cuda.empty_cache()
    return launches["dense"], emission, mr_data, table_reads


def _padded(*blocks):
    """Row blocks of residues (ids (N, L) int8) stacked into one (sum N,
    max L) block, PAD past each block's width."""
    from repro_torch.core.alphabet import PAD
    width = max(b.shape[1] for b in blocks)
    out = np.full((sum(b.shape[0] for b in blocks), width), PAD, np.int8)
    row = 0
    for b in blocks:
        out[row:row + b.shape[0], :b.shape[1]] = b
        row += b.shape[0]
    return out


def _topk_sw(torch, nid, q_ids, ref_ids, gap_mode, dev):
    """SW scores of every (query, neighbour) pair of a top-k, through K3
    (``sw_wave_linear`` / ``sw_wave_affine``): (n,) int32 numpy."""
    from repro_torch.align import sw_wave_affine, sw_wave_linear
    qi, ki = np.nonzero(nid >= 0)
    fn = sw_wave_linear if gap_mode == "linear" else sw_wave_affine
    return fn(q_ids[qi], ref_ids[nid[qi, ki]], device=dev).cpu().numpy()


def phase_persist(torch, ops, dev, index, serve_data, serve_probe, log):
    """Index persistence at Swiss-Prot scale on the index of phase 2 (it
    grows by PERSIST_ADD + PERSIST_TORN rows here)."""
    import tempfile

    from repro_torch.faults import FaultPlan, InjectedFault
    from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                            make_protein_sets)
    from repro_torch.index import (IndexConfigMismatch, SignatureIndex,
                                   occupancy_report)
    from repro_torch.index.segments import CorruptSegment
    from repro_torch.index.service import (QueryEngine, ServingConfig,
                                           topk_probe)

    t_phase = time.perf_counter()
    cfg = index.cfg
    sp = _dataset("swissprot")
    new = make_protein_sets(SyntheticProteinConfig(
        n_refs=PERSIST_ADD + PERSIST_TORN, ref_len_mean=sp["avg_len"],
        ref_len_std=80, n_homolog_queries=0, n_decoy_queries=0, seed=1))
    qi, ql = serve_data["query_ids"], serve_data["query_lens"]
    n0 = index.size

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def same_csr(a, b):
        a._ensure_built()
        b._ensure_built()
        return len(a._csr_np) == len(b._csr_np) and all(
            np.array_equal(x, y) and x.dtype == y.dtype
            for ca, cb in zip(a._csr_np, b._csr_np) for x, y in zip(ca, cb))

    def serve(idx, mode, gap_mode, refs):
        eng = QueryEngine(idx, ServingConfig(
            k=10, max_batch=64, rerank=True, mode=mode, gap_mode=gap_mode),
            ref_seqs=refs)
        return eng.query_batch(qi, ql)

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp) / "swissprot"
        files, save_s = timed(lambda: index.save(d))
        if files != 1:
            raise AssertionError(f"the first save wrote {files} files")
        index.add(new["ref_ids"][:PERSIST_ADD], new["ref_lens"][:PERSIST_ADD])
        files, delta_s = timed(lambda: index.save(d))
        if files != 1:
            raise AssertionError(f"the save after add() wrote {files} "
                                 f"segment files, not 1")
        def load_onto_card():
            idx = SignatureIndex.load(d, cfg, device=dev)
            idx.partition(1).device_slabs()
            idx.device_sigs
            return idx

        loaded, load_s = timed(load_onto_card)
        if not (loaded.epoch == 2 and loaded.device == index.device
                and np.array_equal(loaded.sigs, index.sigs)
                and np.array_equal(loaded.valid, index.valid)
                and same_csr(loaded, index)):
            raise AssertionError("the loaded index differs from the one "
                                 "in memory")
        size = sum(p.stat().st_size for p in d.glob("*"))
        log(f"[persist] {n0} refs saved as a segment directory in "
            f"{save_s:.3f} s; add() of {PERSIST_ADD} refs then save: 1 "
            f"segment file written in {delta_s:.3f} s; {size / 1e6:.1f} MB "
            f"on disk; loaded onto the card in {load_s:.3f} s (slabs and "
            f"signatures uploaded): signatures, validity and CSR equal to "
            f"the index in memory")
        refs = (_padded(serve_data["ref_ids"],
                        new["ref_ids"][:PERSIST_ADD]),
                np.concatenate([serve_data["ref_lens"],
                                new["ref_lens"][:PERSIST_ADD]]))
        for mode, gap_mode in (("probe", "linear"), ("dense", "affine")):
            (a, b), serve_s = timed(lambda: [
                serve(x, mode, gap_mode, refs) for x in (index, loaded)])
            if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
                raise AssertionError(f"mode {mode}: the loaded index serves "
                                     f"another top-k than the one in memory")
            sa = _topk_sw(torch, a[0], qi, refs[0], gap_mode, dev)
            sb = _topk_sw(torch, b[0], qi, refs[0], gap_mode, dev)
            if not np.array_equal(sa, sb):
                raise AssertionError(f"mode {mode}: SW scores differ")
            log(f"[persist] mode={mode} gap_mode={gap_mode}: {len(ql)} "
                f"queries served by the loaded index and the one in memory "
                f"({serve_s:.3f} s both): top-k ids, distances and the "
                f"{len(sa)} SW scores identical")
        q_sigs = index._pipeline.signatures(qi, ql)
        p = Path(tmp) / "swissprot.npz"
        _, npz_save_s = timed(lambda: index.save(p))
        mono, npz_load_s = timed(lambda: SignatureIndex.load(p, cfg,
                                                             device=dev))
        want = topk_probe(index, q_sigs, k=10, cap=64)
        got = topk_probe(mono, q_sigs, k=10, cap=64)
        if not (same_csr(mono, index) and all(
                torch.equal(x, y) for x, y in zip(want[:2], got[:2]))):
            raise AssertionError("the legacy .npz round trip differs")
        log(f"[persist] legacy .npz: saved {npz_save_s:.3f} s "
            f"({p.stat().st_size / 1e6:.1f} MB), loaded {npz_load_s:.3f} s; "
            f"CSR and probe top-k equal")
        try:
            SignatureIndex.load(d, replace(cfg, k=4, T=22), device=dev)
        except IndexConfigMismatch as err:
            log(f"[persist] a wrong expected_cfg raises IndexConfigMismatch:"
                f" {err}")
        else:
            raise AssertionError("a wrong expected_cfg loaded")
        index.add(new["ref_ids"][PERSIST_ADD:], new["ref_lens"][PERSIST_ADD:])
        plan = FaultPlan().add("store.write", "torn", on=1, frac=0.5)
        try:
            with plan:
                index.save(d)
        except InjectedFault as err:
            torn = err
        else:
            raise AssertionError("the scripted torn write did not fire")
        before = SignatureIndex.load(d, cfg, device=dev)
        if not (before.size == n0 + PERSIST_ADD and np.array_equal(
                before.sigs, index.sigs[:before.size])):
            raise AssertionError("after a torn segment write the previous "
                                 "manifest does not load whole")
        if index.save(d) != 1 or SignatureIndex.load(
                d, cfg, device=dev).size != index.size:
            raise AssertionError("the save after the torn write did not "
                                 "append the segment")
        log(f"[persist] a FaultPlan torn write at store.write ({torn}) left "
            f"the previous manifest loadable ({before.size} refs); the next "
            f"save appended the segment ({index.size} refs)")
        victim = d / "seg-g000-00001.npz"
        blob = victim.read_bytes()
        victim.write_bytes(blob[:len(blob) // 3])
        try:
            SignatureIndex.load(d, device=dev)
        except CorruptSegment as err:
            if victim.name not in err.file:
                raise AssertionError(f"CorruptSegment names {err.file}")
            log(f"[persist] a truncated segment raises CorruptSegment: {err}")
        else:
            raise AssertionError("a truncated segment loaded")
        rec, recover_s = timed(lambda: SignatureIndex.load(
            d, cfg, recover=True, device=dev))
        r = rec.recovery
        if not (r and r["n_rows_served"] == n0 == rec.size
                and r["n_segments_dropped"] == 2):
            raise AssertionError(f"recovery report {r}")
        nid, nd = serve(rec, "probe", "linear",
                        (serve_data["ref_ids"], serve_data["ref_lens"]))
        if not (np.array_equal(nid, serve_probe[0])
                and np.array_equal(nd, serve_probe[1])):
            raise AssertionError("the recovered prefix serves another top-k "
                                 "than the index of [serve]")
        log(f"[persist] recover=True in {recover_s:.3f} s served the valid "
            f"prefix ({rec.size} refs: the [serve] top-k exactly) and "
            f"reported: dropped {r['n_segments_dropped']} segments, "
            f"{r['n_rows_dropped']} rows, quarantined "
            f"{sorted(r['quarantined'])}")
        for line in occupancy_report(loaded).splitlines():
            log(f"[persist] stats {line}")
    wall = time.perf_counter() - t_phase
    log(f"[persist] phase wall clock {wall:.1f} s")
    return dict(save_s=save_s, delta_save_s=delta_s, load_s=load_s,
                wall_s=wall)


def _sharded_ms(torch, fn, q, batch, passes):
    """Per-batch wall ms of ``fn(q[i:i + batch])`` (results come back to
    the host inside the timing), ``passes`` times over ``q``."""
    fn(q[:batch])
    torch.cuda.synchronize()
    ms = []
    for _ in range(passes):
        for i in range(0, q.shape[0], batch):
            t0 = time.perf_counter()
            fn(q[i:i + batch])
            ms.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(ms)


def _device_busy_ms(torch, fn, q, batch):
    """Device-busy ms per batch of one pass of ``fn`` over ``q``'s batches
    under ``torch.profiler``: the union of the intervals of the kernels and
    copies it traced on the card, over the number of batches. None when the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(q[:batch])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(0, q.shape[0], batch):
            fn(q[i:i + batch])
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    return busy / 1e3 / -(-q.shape[0] // batch)


def _same_topk(got, want, what):
    """(ids, dists, cap, truncated) of a ring == ``topk_probe``'s."""
    ids, dists = (x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
                  for x in want[:2])
    if not (np.array_equal(got[0], ids) and np.array_equal(got[1], dists)
            and (got[2], bool(got[3])) == (want[2], bool(want[3]))):
        raise AssertionError(f"{what}: the ring's top-k (cap {got[2]}, "
                             f"truncated {got[3]}) differs from topk_probe's "
                             f"(cap {want[2]}, truncated {want[3]})")


def _fresh_index(index, dev):
    """An index of its own over ``index``'s signatures (one segment, its
    buckets built anew), to grow without touching ``index``."""
    from repro_torch.index import SignatureIndex
    return SignatureIndex(index.cfg, index.sigs, index.valid,
                          layout=index.layout, device=dev)


def phase_shard(torch, ops, dev, index, serve_data, log):
    """``ShardedIndex`` on the Swiss-Prot index of phase 2 (untouched: the
    refresh grows an index of its own over the same signatures)."""
    from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                            make_protein_sets)
    from repro_torch.index import (QueryEngine, ServingConfig, ShardedIndex,
                                   SignatureIndex, topk_probe)

    t_phase = time.perf_counter()
    qi, ql = serve_data["query_ids"], serve_data["query_lens"]
    refs = (serve_data["ref_ids"], serve_data["ref_lens"])
    q = index._pipeline.signatures(qi, ql)
    batch, k = 64, 10
    out = {}

    # the cap an engine settles on (it keeps what grow-and-retry reached):
    # every timed batch starts there, as a warmed engine's probe does
    cap = max(topk_probe(index, q[i:i + batch], k=k, cap=32)[2]
              for i in range(0, q.shape[0], batch))

    def probe(x):
        r = topk_probe(index, x, k=k, cap=cap)
        return r[0].cpu().numpy(), r[1].cpu().numpy(), r[2], r[3]

    ms = _sharded_ms(torch, probe, q, batch, SHARD_PASSES)
    out["unsharded"] = ms
    busy = {"unsharded": _device_busy_ms(torch, probe, q, batch)}
    for n in SHARD_COUNTS:
        sh = ShardedIndex(index, [dev] * n)
        for i in range(0, q.shape[0], batch):
            _same_topk(sh.topk(q[i:i + batch], k=k, cap=32),
                       topk_probe(index, q[i:i + batch], k=k, cap=32),
                       f"n_shards={n}, batch {i // batch}")
        got = sh.topk(q[:batch], k=k, cap=1)
        _same_topk(got, topk_probe(index, q[:batch], k=k, cap=1),
                   f"n_shards={n} from cap=1")
        out[n] = _sharded_ms(torch, lambda x: sh.topk(x, k=k, cap=cap), q,
                             batch, SHARD_PASSES)
        busy[n] = _device_busy_ms(torch, lambda x: sh.topk(x, k=k, cap=cap),
                                  q, batch)
        log(f"[shard] n_shards={n} on {dev}: ring top-k == topk_probe for "
            f"all {q.shape[0]} queries (ids, dists, cap, truncated; from "
            f"cap=1 the ring grew to {got[2]}); per-{batch}-query batch wall "
            f"ms at the settled cap {cap}: p50 "
            f"{np.percentile(out[n], 50):.4f}, p95 "
            f"{np.percentile(out[n], 95):.4f} over {len(out[n])} batches")
    log(f"[shard] unsharded topk_probe, same batches and cap: p50 "
        f"{np.percentile(ms, 50):.4f}, p95 {np.percentile(ms, 95):.4f} ms")
    for name, b in busy.items():
        wall = float(np.mean(out[name]))
        log(f"[shard] {name if name == 'unsharded' else f'n_shards={name}'}:"
            f" device busy " + ("not measured (torch.profiler traced no "
                                "device activity)" if b is None else
                                f"{b:.4f} ms a batch (torch.profiler, "
                                f"union of kernel and copy intervals over "
                                f"one pass) of {wall:.4f} ms mean wall, "
                                f"share {b / wall:.4f}"))
    ranked = {}
    for gap_mode, dp_kernel in (("linear", "wavefront"),
                                ("affine", "wavefront"),
                                ("linear", "rowwave")):
        cfg = ServingConfig(k=k, max_batch=batch, rerank=True, mode="probe",
                            gap_mode=gap_mode, dp_kernel=dp_kernel)
        a = QueryEngine(index, cfg, ref_seqs=refs).query_batch(qi, ql)
        b = QueryEngine(index, cfg, ref_seqs=refs, sharded=ShardedIndex(
            index, [dev] * 4)).query_batch(qi, ql)
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            raise AssertionError(f"QueryEngine(sharded=) with the {gap_mode} "
                                 f"{dp_kernel} re-rank differs from the "
                                 f"unsharded engine")
        ranked[gap_mode, dp_kernel] = b
    rw, wf = ranked["linear", "rowwave"], ranked["linear", "wavefront"]
    if not (np.array_equal(rw[0], wf[0]) and np.array_equal(rw[1], wf[1])):
        raise AssertionError("the sharded engine's linear row-wave re-rank "
                             "(K7) ranks otherwise than its linear wavefront "
                             "re-rank (K3)")
    log(f"[shard] QueryEngine(sharded=4 shards, rerank=True) == the "
        f"unsharded engine, {len(ql)} queries, with the linear and affine "
        f"wavefront re-rank (K3) and the linear row wave (K7); the row "
        f"wave's (ids, dists) == the linear wavefront's")

    sp = _dataset("swissprot")
    new = make_protein_sets(SyntheticProteinConfig(
        n_refs=PERSIST_ADD + PERSIST_TORN, ref_len_mean=sp["avg_len"],
        ref_len_std=80, n_homolog_queries=0, n_decoy_queries=0, seed=1))
    new_ids, new_lens = (new["ref_ids"][:PERSIST_ADD],
                         new["ref_lens"][:PERSIST_ADD])
    grown = _fresh_index(index, dev)
    sh = ShardedIndex(grown, [dev] * 4)
    grown.add(new_ids, new_lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh.refresh()
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    if sh._delta is None or sh.epoch != (1, 2):
        raise AssertionError(f"refresh() re-placed instead of carrying a "
                             f"delta (epoch {sh.epoch})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = SignatureIndex.build(
        index.cfg, _padded(refs[0], new_ids),
        np.concatenate([refs[1], new_lens]), device=dev)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    if not np.array_equal(full.sigs, grown.sigs):
        raise AssertionError("job 1 over all refs gives other signatures "
                             "than the base plus the delta")
    sh_full = ShardedIndex(full, [dev] * 4)
    delta_out = []
    for i in range(0, q.shape[0], batch):
        got = sh.topk(q[i:i + batch], k=k, cap=32)
        _same_topk(got, sh_full.topk(q[i:i + batch], k=k, cap=32),
                   f"after refresh, batch {i // batch}")
        _same_topk(got, topk_probe(full, q[i:i + batch], k=k, cap=32),
                   f"after refresh vs topk_probe, batch {i // batch}")
        delta_out.append(got)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    for i, want in zip(range(0, q.shape[0], batch), delta_out):
        _same_topk(sh.topk(q[i:i + batch], k=k, cap=32), want,
                   f"after compact, batch {i // batch}")
    if sh._delta is not None:
        raise AssertionError("compact() left a delta slab")
    wall = time.perf_counter() - t_phase
    log(f"[shard] {grown.size} refs: +{PERSIST_ADD} refs (seed 1) carried as "
        f"a delta slab, refresh() {refresh_s:.4f} s, then == a ShardedIndex "
        f"over an index built from all {full.size} refs ({full_s:.2f} s) and "
        f"== its topk_probe; compact() {compact_s:.4f} s, results identical; "
        f"phase wall clock {wall:.1f} s")
    return dict(
        cap=cap, probe_ms={str(n): dict(p50=float(np.percentile(v, 50)),
                                        p95=float(np.percentile(v, 95)))
                           for n, v in out.items()},
        busy_ms={str(n): b for n, b in busy.items()},
        refresh_s=refresh_s, compact_s=compact_s, wall_s=wall)


def phase_fleet(torch, ops, dev, index, serve_data, log):
    """``ReplicaFleet`` (2 replicas of 2 shards) behind ``AsyncEngine`` on
    an index of its own over phase 2's signatures: FLEET_QUERIES
    single-query futures, FLEET_INGEST refs ingested mid-stream, the
    serving CLI's chaos script installed."""
    from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                            make_protein_sets)
    from repro_torch.faults import FaultPlan
    from repro_torch.index import QueryEngine, ServingConfig
    from repro_torch.serve import AsyncEngine, Completed, ReplicaFleet

    t_phase = time.perf_counter()
    sp = _dataset("swissprot")
    new = make_protein_sets(SyntheticProteinConfig(
        n_refs=FLEET_INGEST, ref_len_mean=sp["avg_len"], ref_len_std=80,
        n_homolog_queries=0, n_decoy_queries=0, seed=2))
    qi, ql = serve_data["query_ids"], serve_data["query_lens"]
    # the re-rank may meet an ingested ref before the ingest is over:
    # every replica holds the rows of both
    refs = (_padded(serve_data["ref_ids"], new["ref_ids"]),
            np.concatenate([serve_data["ref_lens"], new["ref_lens"]]))
    cfg = ServingConfig(k=10, max_batch=64, rerank=True, mode="probe")
    live = _fresh_index(index, dev)
    fleet = ReplicaFleet(live, cfg, n_replicas=2, devices=[dev] * 2,
                         ref_seqs=refs)
    fleet.warmup(qi, ql)
    if ops.RECORDED is not None:    # K3's record: an AsyncEngine batch
        ops.RECORDED.clear()
    plan = (FaultPlan()
            .add("replica.query", "raise", on=2)
            .add("replica.query", "raise", on=5)
            .add("replica.query", "latency", on=6, delay_s=0.03))
    rows = [qi[j % len(ql)][:ql[j % len(ql)]] for j in range(FLEET_QUERIES)]
    eng = AsyncEngine(fleet, max_wait_ms=2.0)
    try:
        with plan:
            futs = []
            t0 = time.perf_counter()
            for j, row in enumerate(rows):
                if j == FLEET_QUERIES // 2:
                    # a quarter served at the base epoch, then the ingest
                    # races the rest
                    futs[FLEET_QUERIES // 4].result(timeout=300)
                    ticket = fleet.ingest(new["ref_ids"], new["ref_lens"])
                futs.append(eng.submit(row))
            got = [f.result(timeout=300) for f in futs]
            wall = time.perf_counter() - t0
            if not ticket.wait(timeout=300) or not ticket.ok:
                raise AssertionError(f"the live ingest failed: "
                                     f"{ticket.error}")
        st = eng.stats()
        fs = fleet.stats()
    finally:
        clean = eng.close(timeout=60) and fleet.close(timeout=60)
    if not clean:
        raise AssertionError("a serving thread did not stop")
    c = fs["counters"]
    degraded = sum(1 for r in got if getattr(r, "degraded", False))
    if (c["retries"], c["retry_success"], degraded, plan.fired()) != \
            (2, 2, 0, 3) or plan.unfired():
        raise AssertionError(f"chaos accounting: retries {c['retries']}, "
                             f"retry_ok {c['retry_success']}, degraded "
                             f"{degraded}, fired {plan.fired()} of 3")
    # what each epoch's index answers: epoch 1 the base, epoch 2 an index
    # built anew over the grown signatures
    expect = {1: QueryEngine(index, cfg, ref_seqs=refs).query_batch(qi, ql),
              2: QueryEngine(_fresh_index(live, dev), cfg,
                             ref_seqs=refs).query_batch(qi, ql)}
    epochs = {}
    for j, r in enumerate(got):
        if not isinstance(r, Completed):
            raise AssertionError(f"future {j}: {r}")
        want = expect.get(r.epoch)
        if want is None or not (
                np.array_equal(r.ids, want[0][j % len(ql)])
                and np.array_equal(r.dists, want[1][j % len(ql)])):
            raise AssertionError(f"future {j} at epoch {r.epoch} differs "
                                 f"from an engine over the index at that "
                                 f"epoch")
        epochs[r.epoch] = epochs.get(r.epoch, 0) + 1
    lat = st["latency"]
    qps = FLEET_QUERIES / wall
    phase_s = time.perf_counter() - t_phase
    log(f"[fleet] 2 replicas x 2 shards on {dev} behind AsyncEngine: "
        f"{FLEET_QUERIES} single-query futures in {wall:.3f} s ({qps:.1f} "
        f"queries/s; p50 {lat['p50_ms']:.3f} ms, p95 {lat['p95_ms']:.3f} ms, "
        f"p99 {lat['p99_ms']:.3f} ms submit to result; "
        f"{st['counters']['batches']} batches) with {FLEET_INGEST} refs "
        f"ingested mid-stream; served epochs {dict(sorted(epochs.items()))}, "
        f"each result == an engine over the index at its epoch; chaos "
        f"script: {c['retries']} retries, 0 degraded, fired "
        f"{plan.fired()} of 3; phase wall clock {phase_s:.1f} s")
    return dict(qps=qps, p50_ms=lat["p50_ms"], p95_ms=lat["p95_ms"],
                wall_s=phase_s)


def _replay_tier(torch, records, log):
    """The kernels of the [shard], [fleet] and [mapreduce] windows held
    exactly against their twins at the first inputs each window launched
    them on, and timed. Returns per kernel the JSON keys of those
    shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.hamming import hamming_dist
    from repro_torch.kernels.spgemm import upper_pairs
    from repro_torch.kernels.sw import sw_rowwave, ungapped_scores, \
        wave_scores
    runners = {"wave_scores_linear": (wave_scores, ref.wave_scores_ref),
               "wave_scores_affine": (wave_scores, ref.wave_scores_ref),
               "sw_rowwave": (sw_rowwave, ref.sw_rowwave_ref),
               "ungapped_scores": (ungapped_scores, ref.ungapped_scores_ref),
               "upper_pairs": (upper_pairs, ref.upper_pairs_ref),
               "hamming_dist": (hamming_dist, ref.hamming_dist_ref)}
    keys = {}
    for path, rec, names in records:
        for name in names:
            if name not in rec:
                raise AssertionError(f"the [{path}] window recorded no "
                                     f"{name} launch")
            args, kw = rec[name]
            run, twin = runners[name]
            _, err, ms, plain_ms, bound_ms, by = _check_and_time(
                torch, name, args, kw, run, twin, 20, 0)
            shapes = " x ".join(str(tuple(a.shape)) for a in args)
            log(f"[{path}] {name} at {shapes} (its first launch there): "
                f"exact vs twin; kernel {ms:.4f} ms (device, 20 launches in "
                f"one CUDA graph), twin {plain_ms:.4f} ms, bound "
                f"{bound_ms * 1e3:.3f} us ({by})")
            keys.setdefault(name, {}).update({
                f"{path}_shape": [list(a.shape) for a in args],
                f"{path}_ms": ms, f"{path}_plain_ms": plain_ms,
                f"{path}_bound_ms": bound_ms, f"{path}_max_abs_err": err})
    return keys


def _run_cli(args, log, what, cli="search_serve", tag="[cli]"):
    """``python -m repro_torch.launch.<cli>`` with ``args`` in a
    subprocess on the card: its output, which must end in exit code 0."""
    src = Path(__file__).resolve().parent / "src"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{cli}", *args],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(src)})
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"{tag} {what}: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{cli} {what} exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    log(f"{tag} {what}: exit 0 in {wall:.1f} s")
    return proc.stdout


def phase_cli(log):
    """The port's serving CLI at Swiss-Prot scale (4 shards, re-rank, a
    FASTA appended, compaction, metrics and trace files), then the async
    tier with the chaos script."""
    import tempfile

    from repro_torch.data.fasta import write_fasta
    from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                            make_protein_sets)

    sp = _dataset("swissprot")
    new = make_protein_sets(SyntheticProteinConfig(
        n_refs=CLI_ADD, ref_len_mean=150, ref_len_std=30,
        n_homolog_queries=0, n_decoy_queries=0, seed=3))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        fasta = tmp / "add.fasta"
        write_fasta(fasta, [f"add{i}" for i in range(CLI_ADD)],
                    new["ref_ids"], new["ref_lens"])
        metrics, trace = tmp / "metrics.prom", tmp / "trace.json"
        out = _run_cli(["--n-refs", str(sp["n"]), "--shards", "4",
                        "--rerank", "--add-fasta", str(fasta), "--compact",
                        "--index", str(tmp / "idx"),
                        "--metrics-out", str(metrics),
                        "--trace-out", str(trace)], log, "4 shards")
        if "identical" not in out or "[quality]" not in out:
            raise AssertionError("search_serve: no [quality] line or "
                                 "compaction not identical")
        text = metrics.read_text()
        families = [ln for ln in text.splitlines() if ln.startswith("# TYPE")]
        events = json.loads(trace.read_text())["traceEvents"]
        names = {e["name"] for e in events}
        if not families or not {"ring_probe", "refresh", "query_batch"} <= names:
            raise AssertionError(f"metrics or trace incomplete: "
                                 f"{len(families)} families, spans "
                                 f"{sorted(names)}")
        log(f"[cli] --metrics-out parsed: {len(families)} metric families; "
            f"--trace-out parsed: {len(events)} events, spans include "
            f"ring_probe, refresh, query_batch")
        out = _run_cli(["--n-refs", str(CLI_CHAOS_REFS), "--shards", "2",
                        "--replicas", "2", "--chaos", "--rerank",
                        "--add-fasta", str(fasta), "--compact",
                        "--index", str(tmp / "idx_chaos")], log,
                       "2 replicas, chaos")
        for want in ("retries=2", "degraded_batches=0", "fired 3 of 3",
                     "identical", "shed=0, degraded=0"):
            if want not in out:
                raise AssertionError(f"search_serve --chaos: no {want!r}")


def _pair_blocks(pairs, q_ids, q_lens, r_ids, r_lens):
    """(qm, rm) PAD-padded int8 blocks of (q, r) pair rows, each side as
    wide as its longest member."""
    from repro_torch.core.alphabet import PAD
    qm = np.full((len(pairs), int(q_lens[pairs[:, 0]].max())), PAD, np.int8)
    rm = np.full((len(pairs), int(r_lens[pairs[:, 1]].max())), PAD, np.int8)
    for n, (q, r) in enumerate(pairs[:, :2]):
        qm[n, :q_lens[q]] = q_ids[q, :q_lens[q]]
        rm[n, :r_lens[r]] = r_ids[r, :r_lens[r]]
    return qm, rm


def _quality_card_vs_cpu(torch, dev, cfg, data, log):
    """The quality path on QUALITY_CPU's refs and queries on the card and
    on the CPU: the same pairs, PIDs and seed-and-extend hits. Both sides
    search the card's signatures (the k=4 tables would take minutes to
    build on the host)."""
    from repro_torch.align import SeedExtendBaseline, batch_percent_identity
    from repro_torch.core.pipeline import ScalLoPS

    n_r, n_q = QUALITY_CPU
    kids = [q for q, (p, _) in enumerate(data["truth"]) if 0 <= p < n_r]
    decoys = [q for q, (p, _) in enumerate(data["truth"]) if p < 0]
    sel = np.array((kids + decoys)[:n_q])
    refs = (data["ref_ids"][:n_r], data["ref_lens"][:n_r])
    queries = (data["query_ids"][sel], data["query_lens"][sel])
    sl = ScalLoPS(cfg, device=dev)
    sides = [(sl.signatures(*x), sl.feature_counts(*x) > 0)
             for x in (refs, queries)]
    out = []
    for where in (dev, "cpu"):
        (rs, rv), (qs, qv) = [(a.to(where), b.to(where)) for a, b in sides]
        res = ScalLoPS(cfg, device=where).search(qs, rs, q_valid=qv,
                                                 r_valid=rv)
        pairs = res.pairs[res.pairs[:, 0] >= 0].cpu().numpy()
        pid = batch_percent_identity(pairs, *queries, *refs, device=where)
        hits = SeedExtendBaseline(k=3, T=11, s_min=35, device=where
                                  ).build_index(*refs).search(*queries)
        out.append((pairs, pid, hits))
    (pa, ia, ha), (pb, ib, hb) = out
    if not (np.array_equal(pa, pb) and np.array_equal(ia, ib)
            and ha == hb):
        raise AssertionError("[quality] card and CPU differ in pairs, PIDs "
                             "or seed-and-extend hits")
    log(f"[quality] card == CPU on {n_r} refs x {len(sel)} queries "
        f"({len(kids[:n_q])} homologs of those refs): {len(pa)} pairs, their "
        f"PIDs, and {len(ha)} seed-and-extend hits identical")


def phase_quality(torch, ops, dev, log):
    """The paper's §5.2 quality evaluation at NC_000913 scale. Returns
    the kernel launches of the matmul build (K1 at k=4) and of the
    scoring (K7, K3), and the phase's seconds."""
    from repro_torch.align import (SeedExtendBaseline,
                                   batch_percent_identity, percent_identity,
                                   sw_align_batch, sw_wave_linear)
    from repro_torch.align.smith_waterman import sw_wave_pid
    from repro_torch.configs.scallops import quality_config
    from repro_torch.core.join import pairs_to_set
    from repro_torch.core.pipeline import ScalLoPS
    from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                            make_protein_sets)

    t_phase = time.perf_counter()
    nc = _dataset("NC_000913")
    n_hom, n_dec = QUALITY_QUERIES
    t0 = time.perf_counter()
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=nc["n"], ref_len_mean=nc["avg_len"], ref_len_std=80,
        n_homolog_queries=n_hom, n_decoy_queries=n_dec,
        sub_rates=(0.03, 0.10, 0.20), seed=0))
    refs = (data["ref_ids"], data["ref_lens"])
    queries = (data["query_ids"], data["query_lens"])
    log(f"[quality] data: {nc['n']} refs (mean length "
        f"{refs[1].mean():.1f}), {n_hom} homolog queries at sub_rates "
        f"(0.03, 0.10, 0.20) and {n_dec} decoys, generated in "
        f"{time.perf_counter() - t0:.1f} s on the host")
    cfg = quality_config()
    sl = ScalLoPS(cfg, device=dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, contrib_s = timed(lambda: sl.signatures(refs[0][:1], refs[1][:1]))
    _, count_s = timed(lambda: sl.feature_counts(refs[0][:1], refs[1][:1]))
    sides, table_s = timed(lambda: [
        (sl.signatures(*x), sl.feature_counts(*x)) for x in (refs, queries)])
    sm = ScalLoPS(replace(cfg, siggen_method="matmul"), device=dev)
    t0 = time.perf_counter()
    mat, k1_l = _window(torch, ops, lambda: [
        (sm.signatures(*x), sm.feature_counts(*x)) for x in (refs, queries)])
    matmul_s = time.perf_counter() - t0
    for (ts, tc), (ms, mc) in zip(sides, mat):
        if not (torch.equal(ts, ms) and torch.equal(tc, mc)):
            raise AssertionError("k=4: the matmul path (K1) and the table "
                                 "path give other signatures or counts")
    log(f"[quality] quality_config() {cfg}: k=4 tables built on the card "
        f"by the first calls, contribution table {contrib_s:.3f} s, feature "
        f"count table {count_s:.3f} s; table path over refs and queries "
        f"{table_s:.3f} s, matmul path (K1 at k=4) {matmul_s:.3f} s with "
        f"launches {json.dumps(k1_l)}: identical signatures and feature "
        f"counts")
    (rs, rc), (qs, qc) = sides
    rv, qv = rc > 0, qc > 0
    mp = cfg.max_pairs
    while True:
        res = sl.search(qs, rs, max_pairs=mp, q_valid=qv, r_valid=rv)
        if not bool(res.overflowed):
            break
        mp *= 2
    got = pairs_to_set(res.pairs)
    pairs = res.pairs[res.pairs[:, 0] >= 0].cpu().numpy()
    truth = {(q, p) for q, (p, _) in enumerate(data["truth"]) if p >= 0}
    cut = pairs[:PID_PAIRS]
    log(f"[quality] ScalLoPS.search (flip, d=0, non-zero-signature masks: "
        f"{int(rv.sum())} of {len(rv)} refs, {int(qv.sum())} of {len(qv)} "
        f"queries valid): {len(pairs)} pairs (max_pairs {mp}); recall "
        f"{len(got & truth) / len(truth):.4f}, precision "
        f"{len(got & truth) / max(len(got), 1):.4f} (for information); "
        f"PID over {len(cut)} of them"
        + (f" (the first {PID_PAIRS}, cut from {len(pairs)})"
           if len(pairs) > PID_PAIRS else ""))
    pid, pid_s = timed(lambda: batch_percent_identity(cut, *queries, *refs,
                                                      device=dev))
    qm, rm = _pair_blocks(cut, *queries, *refs)
    (pid2, length, score), wave_pid_s = timed(lambda: sw_wave_pid(
        torch.as_tensor(qm, device=dev), torch.as_tensor(rm, device=dev)))
    if np.isnan(pid).any() or not np.array_equal(pid, pid2):
        raise AssertionError("batch_percent_identity differs from the PID "
                             "wave on the same blocks")
    (k7, k3), sw_l = _window(torch, ops, lambda: (
        sw_align_batch(qm, rm, device=dev),
        sw_wave_linear(qm, rm, device=dev).cpu().numpy()))
    if not (np.array_equal(k7, score) and np.array_equal(k3, score)):
        raise AssertionError("K7 and K3 scores differ from the PID path's")
    for n in range(min(8, len(cut))):
        q, r = cut[n, :2]
        one = percent_identity(queries[0][q, :queries[1][q]],
                               refs[0][r, :refs[1][r]], device=dev)
        if one != (pid[n], length[n], score[n]):
            raise AssertionError(f"percent_identity of pair {n}: {one} != "
                                 f"the batch's {pid[n], length[n], score[n]}")
    q1, med, q3 = np.percentile(pid, [25, 50, 75]) if len(pid) else (0,) * 3
    log(f"[quality] batch_percent_identity over {len(cut)} pairs "
        f"{pid_s:.3f} s (the PID wave on the same blocks {wave_pid_s:.3f} s:"
        f" equal); PID quartiles {q1:.1f} / {med:.1f} / {q3:.1f}; "
        f"sw_align_batch (K7) and sw_wave_linear (K3) == the PID path's "
        f"scores on every pair (launches {json.dumps(sw_l)}); "
        f"percent_identity == the batch on {min(8, len(cut))} pairs")
    base = SeedExtendBaseline(k=3, T=11, s_min=35, device=dev)
    _, se_build_s = timed(lambda: base.build_index(*refs))
    hits, n_q = [], 0
    t0 = time.perf_counter()
    while n_q < len(queries[1]) and time.perf_counter() - t0 < SEED_EXTEND_S:
        part = base.search(queries[0][n_q:n_q + 8], queries[1][n_q:n_q + 8])
        hits += [(q + n_q, r, s) for q, r, s in part]
        n_q += 8
    se_s = time.perf_counter() - t0
    bl = {(q, r) for q, r, _ in hits}
    mine = {(q, r) for q, r in got if q < n_q}
    log(f"[quality] SeedExtendBaseline(k=3, T=11, s_min=35): index over "
        f"{nc['n']} refs {se_build_s:.3f} s; {n_q} queries searched in "
        f"{se_s:.1f} s ({len(hits)} hits); ScalLoPS pairs of those queries "
        f"found by the baseline: {len(mine & bl)} of {len(mine)} "
        f"(intersection {len(mine & bl) / max(len(mine), 1):.4f}, for "
        f"information)")
    _quality_card_vs_cpu(torch, dev, cfg, data, log)
    wall = time.perf_counter() - t_phase
    log(f"[quality] phase wall clock {wall:.1f} s")
    launches = dict(k1_l)
    launches.update({k: v for k, v in sw_l.items() if v})
    return launches, dict(contrib_table_s=contrib_s, count_table_s=count_s,
                          wall_s=wall, seed_extend_queries=n_q)


def phase_kernel_k4(torch, record, launches, log):
    """K1's first launch at k=4 (the [quality] matmul build) held against
    its twin and timed, as ``phase_kernels`` does the others: its JSON row
    ``siggen_accumulate_k4``. The twin builds its score matrix 2,048 rows
    at a time (160,000 float64 words a row)."""
    import functools

    from repro_torch.kernels import ref
    from repro_torch.kernels.siggen import siggen_accumulate

    args, kw = record
    twin = functools.partial(ref.siggen_accumulate_ref, block=2048)
    got, err, ms, plain_ms, bound_ms, bound_by = _check_and_time(
        torch, "siggen_accumulate", args, kw, siggen_accumulate, twin, 10, 0)
    del got
    shapes = " x ".join(str(tuple(a.shape)) for a in args)
    log(f"[kernels] siggen_accumulate_k4 at {shapes} {json.dumps(kw)}: exact "
        f"vs twin; kernel {ms:.4f} ms (device, 10 launches in one CUDA "
        f"graph), twin {plain_ms:.4f} ms, bound {bound_ms * 1e3:.3f} us "
        f"({bound_by}; {100 * bound_ms / ms:.1f}% of it), {launches} "
        f"launches on the [quality] path")
    torch.cuda.empty_cache()
    return dict(name="siggen_accumulate_k4", route="cuda",
                source=KERNELS["siggen_accumulate"][0],
                replaces=KERNELS["siggen_accumulate"][1], launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def phase_siggen(torch, ops, dev, log):
    from repro_torch.core.pipeline import LSHConfig, ScalLoPS
    from repro_torch.data.synthetic import (SyntheticProteinConfig,
                                            make_protein_sets)
    from repro_torch.index.store import SignatureIndex

    nc = _dataset("NC_000913")
    n_refs = nc["n"]
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=n_refs, ref_len_mean=nc["avg_len"],
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


def _plan_wave(corpus, lens, pool, shape, wcfg, wave_batch):
    """The first wave of the plan's shape ``(B, Lq, Lr)`` as
    ``score_pairs`` issues it over the pairs ``pool``: its (B, Lq) and
    (B, Lr) blocks on the card, all-PAD rows in the slots past its real
    pairs, and the number of real pairs."""
    from repro_torch.allpairs.tiles import _iter_wave_chunks
    for chunk, B, Lq, Lr in _iter_wave_chunks(pool, lens, wcfg, wave_batch):
        if (B, Lq, Lr) == shape:
            return corpus.wave(pool, chunk, B, Lq, Lr), len(chunk)
    raise AssertionError(f"the plan issues no wave of shape {shape}")


def phase_allpairs(torch, ops, dev, log):
    from repro_torch.allpairs import (FamilyForest, all_pairs_ingest,
                                      all_pairs_search, lsh_self_join,
                                      score_pairs)
    from repro_torch.allpairs.tiles import _DeviceCorpus
    from repro_torch.data.synthetic import (FamilyCorpusConfig,
                                            make_family_corpus)
    from repro_torch.index.store import SignatureIndex
    from repro_torch.obs import trace

    t0 = time.perf_counter()
    corpus = make_family_corpus(FamilyCorpusConfig(**MYVA))
    ids, lens, truth = corpus["ids"], corpus["lens"], corpus["labels"]
    N = len(lens)
    assert N == _dataset("myva")["n"]
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
    # candidates (K4) and survivors (K3 and K7 run the SW waves' plan),
    # and the first wave of that shape as the plan fills it
    surv = res.pairs[kept]
    full, real = {}, {}
    wave_corpus = _DeviceCorpus(ids, lens, dev, cfg.wave.len_quantum)
    for name, kind, pool, wb in (
            ("ungapped_scores", "ungapped", res.pairs,
             cfg.wave.prefilter_batch),
            ("wave_scores_linear", "sw", surv, cfg.wave.wave_batch)):
        shape = max((s for s in by_shape if s[0] == kind),
                    key=lambda s: by_shape[s])[1:]
        full[name] = _full_wave(torch, ids, lens, pool, shape,
                                cfg.wave.len_quantum)
        real[name], n_real = _plan_wave(wave_corpus, lens, pool, shape,
                                        cfg.wave, wb)
        log(f"[allpairs] {name} replays: the most used {kind} shape "
            f"(B, Lq, Lr) = {shape} ({by_shape[(kind,) + shape]} waves on "
            f"the main path), one full wave ({full[name][0].shape[0]} real "
            f"pairs) and its first wave on the main path ({n_real} real "
            f"pairs of {shape[0]})")
    del wave_corpus
    # the row wave plans the same SW waves over the survivors
    full["sw_rowwave"] = full["wave_scores_linear"]
    real["sw_rowwave"] = real["wave_scores_linear"]

    # K7's path: the row wave over the survivors gives the wavefront's
    # scores
    t0 = time.perf_counter()
    rw, rw_l = _window(torch, ops, lambda: score_pairs(
        ids, lens, surv, replace(cfg.wave, prefilter=False,
                                 dp_kernel="rowwave"), device=dev))
    rw_s = time.perf_counter() - t0
    log(f"[allpairs] rowwave (K7) over the {len(surv)} survivors: "
        f"{rw_s:.3f} s, {rw.n_waves} waves; launches {json.dumps(rw_l)}")
    if rw_l["sw_rowwave"] <= 0:
        raise AssertionError("the row-wave path never launched sw_rowwave")
    if not np.array_equal(rw.scores, res.scored.scores[kept]):
        bad = int((rw.scores != res.scored.scores[kept]).sum())
        raise AssertionError(f"rowwave != wavefront on {bad} survivors")

    # ingest: the last rows ingested onto an index of the rest. The base
    # run is cut to its join: the base rows' pairs are the full run's
    # pairs among them, scored alike, so its forest is the full run's
    # surviving edges among them (a whole base run repeats ~250 s of the
    # host's wave loop)
    base = N - INGEST_ROWS
    t0 = time.perf_counter()
    b_index = SignatureIndex.build(cfg.lsh, ids[:base], lens[:base],
                                   device=dev)
    b_join, base_l = _window(torch, ops, lambda: lsh_self_join(
        b_index, max_pairs=cfg.max_pairs))
    in_base = res.pairs[:, 1] < base
    if not np.array_equal(b_join.pairs, res.pairs[in_base]):
        raise AssertionError("the base rows' join differs from the full "
                             "join's pairs among them")
    forest = FamilyForest(base)
    forest.union_edges(res.pairs[in_base & res.families.edge_mask])
    t1 = time.perf_counter()
    ing, ing_l = _window(torch, ops, lambda: all_pairs_ingest(
        ids, lens, base, cfg, index=b_index, forest=forest))
    t2 = time.perf_counter()
    log(f"[allpairs] ingest: index and join over {base} rows {t1 - t0:.3f}"
        f" s ({b_join.n_candidates} candidates == the full join's among "
        f"them; launches {json.dumps(base_l)}), the forest of their "
        f"surviving edges in the full run, then all_pairs_ingest of "
        f"{INGEST_ROWS} rows {t2 - t1:.3f} s ({ing.join.n_candidates} "
        f"delta candidates, {int(ing.edge_mask.sum())} new edges; launches "
        f"{json.dumps(ing_l)})")
    if not np.array_equal(ing.labels, res.labels):
        bad = int((ing.labels != res.labels).sum())
        raise AssertionError(f"ingest labels differ from the full run's "
                             f"on {bad} sequences")
    log("[allpairs] ingest labels == full-run labels")
    # each replayed kernel's stage: (name, host wall clock s)
    stages = {"ungapped_scores": ("the all-pairs prefilter stage", pre_s),
              "wave_scores_linear": ("the all-pairs SW stage", sw_s),
              "sw_rowwave": ("the row-wave step", rw_s)}
    return (index, res, corpus, main_l, rw_l, full, real, stages,
            b_index, ing)


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


def _recording(ops, into, fn):
    """``fn()`` with the kernel wrappers recording into a dict of its
    own; the first inputs of each kernel it launched join ``into`` unless
    ``into`` has that kernel already."""
    outer, ops.RECORDED = ops.RECORDED, {}
    try:
        out = fn()
    finally:
        inner, ops.RECORDED = ops.RECORDED, outer
    for name, rec in inner.items():
        into.setdefault(name, rec)
    return out


def _padded_rows(x, ids, n):
    """Rows padded with zeros (signatures) and -1 (ids) to a multiple of
    n shards."""
    import torch
    pad = -len(ids) % n
    return (torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]),
            torch.cat([ids, ids.new_full((pad,), -1)]))


def _route_counts(qs, rs, masks, n, n_salt):
    """Host count of the shuffle's records per (src, dst): each source
    shard's query keys (one record per salt and the unsalted key) and
    reference flip keys, by owner ``key % n``. Salting XORs bits 24 and
    up, which leaves ``key % n`` alone for n dividing 2^24."""
    assert (1 << 24) % n == 0
    out = np.zeros((n, n), np.int64)
    q = qs.reshape(n, -1)
    r = rs.reshape(n, -1)
    for src in range(n):
        qk = q[src][q[src] >= 0].astype(np.int64)
        rk = r[src][r[src] >= 0].astype(np.int64)
        out[src] = (np.bincount(qk % n, minlength=n) * (n_salt + 1)
                    + np.bincount(((rk[:, None] ^ masks[None, :]) % n)
                                  .ravel(), minlength=n))
    return out


def phase_mapreduce(torch, ops, dev, index, res, ing_index, ing, corpus,
                    search, log):
    """The sharded all-pairs paths and the paper's MapReduce engine on
    the card, each against its one-shard or flip-join answer: the myva
    self-join at 2 and 4 shards, the ingest's delta join at 1, 2 and 4
    and its pairs scored by waves split over 4 devices (K4, K3, then K7);
    ``distributed_flip_join`` at [search]'s scale and ``ring_sweep`` over
    1,024 of its queries, at 1, 2 and 4 shards; the all-pairs CLI at 4
    shards and at 1. Returns the launches of its paths by kernel and the
    first inputs they gave K5 (4 shards), K4/K3 and K7 (the split waves)
    and K2 (a hop of the 4-shard ring)."""
    from repro_torch.allpairs import (lsh_delta_join, lsh_self_join,
                                      score_pairs)
    from repro_torch.allpairs.selfjoin import _shard_caps
    from repro_torch.core import mapreduce as mr
    from repro_torch.core.hamming import hamming_distance
    from repro_torch.core.join import flip_masks
    from repro_torch.util import next_pow2

    t_phase = time.perf_counter()
    cfg = _allpairs_config()
    ids, lens = corpus["ids"], corpus["lens"]
    launches = {name: 0 for name in ops.LAUNCHES}
    record = {}

    def count(l):
        for name, v in l.items():
            launches[name] += v

    # the myva self-join at 2 and 4 shards == [allpairs]' one-shard join
    for n in (2, 4):
        caps = _shard_caps(index.partition(n))
        live = caps[caps > 0]
        route = "uniform" if live.min() == live.max() else "skewed"
        t0 = time.perf_counter()
        join, l = _window(torch, ops, lambda: _recording(
            ops, record if n == 4 else {}, lambda: lsh_self_join(
                index, max_pairs=cfg.max_pairs, n_shards=n,
                devices=[dev] * n)))
        dt = time.perf_counter() - t0
        count(l)
        if not np.array_equal(join.pairs, res.join.pairs):
            raise AssertionError(f"the {n}-shard self-join differs from the "
                                 f"one-shard join")
        if l["upper_pairs"] <= 0:
            raise AssertionError(f"the {n}-shard self-join never launched "
                                 f"upper_pairs")
        log(f"[mapreduce] self-join, {index.size} myva rows, {n} shards "
            f"on the card: {dt:.3f} s, {join.n_candidates} pairs == the "
            f"one-shard join; {route} caps {caps.tolist()}; K5 launches "
            f"{l['upper_pairs']}")

    # the ingest's delta join at 1, 2 and 4 shards, its pairs scored by
    # waves split over 4 devices (all the card) == one device
    base = len(lens) - INGEST_ROWS
    deltas = {}
    for n in MR_SHARDS:
        t0 = time.perf_counter()
        deltas[n], l = _window(torch, ops, lambda: lsh_delta_join(
            ing_index, base_size=base, max_pairs=cfg.max_pairs, n_shards=n,
            devices=[dev] * n))
        count(l)
        log(f"[mapreduce] delta join of the {INGEST_ROWS} ingested rows, "
            f"{n} shards: {time.perf_counter() - t0:.3f} s, "
            f"{deltas[n].n_candidates} pairs; K5 launches "
            f"{l['upper_pairs']}")
        if not np.array_equal(deltas[n].pairs, deltas[1].pairs):
            raise AssertionError(f"the {n}-shard delta join differs from "
                                 f"the one-shard one")
    pairs = deltas[1].pairs
    if not np.array_equal(pairs, ing.join.pairs):
        raise AssertionError("the delta join differs from the ingest's")
    one = ing.scored        # [allpairs]' ingest scored them on one device
    t1 = time.perf_counter()
    four, l = _window(torch, ops, lambda: _recording(
        ops, record, lambda: score_pairs(ids, lens, pairs, cfg.wave,
                                         devices=[dev] * 4)))
    t2 = time.perf_counter()
    count(l)
    for what in ("scores", "kept"):
        if not np.array_equal(getattr(four, what), getattr(one, what)):
            raise AssertionError(f"waves split over 4 devices: {what} "
                                 f"differ from one device's")
    for name in ("ungapped_scores", "wave_scores_linear"):
        if l[name] <= 0:
            raise AssertionError(f"the split waves never launched {name}")
    log(f"[mapreduce] the {len(pairs)} delta pairs scored (prefilter K4, "
        f"then K3 on {int(one.kept.sum())} survivors): one device (the "
        f"ingest's run) {one.n_waves} waves; split over 4 devices "
        f"{four.n_waves} waves, {t2 - t1:.3f} s; scores and kept equal; "
        f"launches {json.dumps({k: v for k, v in l.items() if v})}")
    surv = pairs[one.kept]
    rcfg = replace(cfg.wave, prefilter=False, dp_kernel="rowwave")
    t0 = time.perf_counter()
    rw4, l = _window(torch, ops, lambda: _recording(
        ops, record, lambda: score_pairs(ids, lens, surv, rcfg,
                                         devices=[dev] * 4)))
    count(l)
    if not np.array_equal(rw4.scores, one.scores[one.kept]):
        raise AssertionError("the split row wave differs from one device's "
                             "wavefront")
    if l["sw_rowwave"] <= 0:
        raise AssertionError("the split row wave never launched sw_rowwave")
    log(f"[mapreduce] row wave (K7) over the survivors, split over 4 "
        f"devices: {rw4.n_waves} waves, {time.perf_counter() - t0:.3f} s, "
        f"scores equal to one device's wavefront; K7 launches "
        f"{l['sw_rowwave']}")
    del deltas, four, rw4

    # the Signature Processor at [search]'s scale: map, shuffle, reduce
    q_sigs, r_sigs = search["q_sigs"], search["r_sigs"]
    f, d = search["f"], search["d"]
    Nq, Nr = q_sigs.shape[0], r_sigs.shape[0]
    flip = search["flip_keys"].to(dev)
    masks = flip_masks(f, d)[:, 0].astype(np.int64)
    q_dev, r_dev = q_sigs.to(dev), r_sigs.to(dev)
    for n in MR_SHARDS:
        qs, qid = _padded_rows(q_sigs, torch.arange(Nq, dtype=torch.int32),
                               n)
        rs, rid = _padded_rows(r_sigs, torch.arange(Nr, dtype=torch.int32),
                               n)
        qk = np.where(qid.numpy() >= 0, qs[:, 0].numpy().view(np.uint32),
                      -1).astype(np.int64)
        rk = np.where(rid.numpy() >= 0, rs[:, 0].numpy().view(np.uint32),
                      -1).astype(np.int64)
        mcfg = mr.MapReduceConfig(n_shards=n)
        routes = _route_counts(qk, rk, masks, n, mcfg.n_salt)
        mcfg = replace(mcfg, shuffle_capacity=int(routes.max()),
                       max_pairs_per_shard=1 << 16)
        args = [x.to(dev) for x in (qs, rs, qid, rid)]
        calls = []
        while True:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = mr.distributed_flip_join(*args, f=f, d=d, cfg=mcfg,
                                           devices=[dev] * n)
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
            got, counts, dropped = out
            need = int(counts.max())
            if need <= mcfg.max_pairs_per_shard:
                break
            mcfg = replace(mcfg, max_pairs_per_shard=next_pow2(need))
        if int(dropped.sum()) != 0:
            raise AssertionError(f"distributed_flip_join, {n} shards: "
                                 f"{dropped.tolist()} records dropped")
        p = got[got[:, 0] >= 0].long()
        keep = hamming_distance(q_dev[p[:, 0]], r_dev[p[:, 1]]) <= d
        keys = torch.unique(p[keep, 0] * Nr + p[keep, 1])
        if not torch.equal(keys, flip):
            raise AssertionError(f"distributed_flip_join, {n} shards: "
                                 f"{len(keys)} pairs within d, the flip "
                                 f"join {len(flip)}")
        hot = 0
        for s in range(n):      # the keys the map phase salted, per shard
            k, _ = mr._map_records(
                *(x.reshape((n, -1) + tuple(x.shape[1:]))[s:s + 1]
                  .to(dev) for x in (qs, rs, qid.long(), rid.long())),
                torch.from_numpy(masks).to(dev),
                replace(mcfg, salting=False))
            isq = torch.zeros_like(k, dtype=torch.bool)
            isq[:, :qs.shape[0] // n] = True
            _, hmask = mr.salt_hot_keys(k, hot_threshold=mcfg.hot_threshold,
                                        n_salt=mcfg.n_salt, is_query=isq)
            hot += int(torch.unique(
                k[hmask & ~isq & (k != mr.EMPTY)]).numel())
        log(f"[mapreduce] distributed_flip_join, {Nq} queries x {Nr} refs, "
            f"f={f}, d={d}, {n} shards on the card: "
            f"{len(calls)} call(s) of {', '.join(f'{c:.3f}' for c in calls)}"
            f" s; shuffle_capacity {mcfg.shuffle_capacity} (the host's "
            f"largest (src, dst) count), max_pairs_per_shard "
            f"{mcfg.max_pairs_per_shard}; counts {counts.tolist()}, dropped "
            f"0; {len(p)} pairs, {int(keep.sum())} within d, "
            f"{len(keys)} distinct == [search]'s flip join; "
            f"{hot} hot reference keys salted")
        del args, out, got, p, keys

    # the ring sweep over 512 homolog fragments and 512 decoys
    sel = torch.cat([torch.arange(RING_QUERIES),
                     search["n_hom"] + torch.arange(RING_QUERIES)])
    in_sel = torch.zeros(Nq, dtype=torch.bool, device=dev)
    in_sel[sel.to(dev)] = True
    want = flip[in_sel[flip // Nr]]
    for n in MR_SHARDS:
        rs, rid = _padded_rows(r_sigs, torch.arange(Nr, dtype=torch.int32),
                               n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (rp, rc), l = _window(torch, ops, lambda: _recording(
            ops, record if n == 4 else {}, lambda: mr.ring_sweep(
                q_dev[sel.to(dev)], rs.to(dev), d=d, devices=[dev] * n,
                max_pairs_per_shard=next_pow2(max(len(want), 1)),
                q_ids=sel.to(torch.int32).to(dev), r_ids=rid.to(dev))))
        dt = time.perf_counter() - t0
        count(l)
        p = rp[rp[:, 0] >= 0].long()
        keys = torch.unique(p[:, 0] * Nr + p[:, 1])
        if not (torch.equal(keys, want) and int(rc.sum()) == len(want)):
            raise AssertionError(f"ring_sweep, {n} shards: {len(keys)} "
                                 f"pairs, the flip join {len(want)}")
        if l["hamming_dist"] <= 0:
            raise AssertionError("the ring sweep never launched "
                                 "hamming_dist")
        log(f"[mapreduce] ring_sweep, {len(sel)} queries x {Nr} refs, {n} "
            f"shards: {dt:.3f} s, {len(keys)} pairs == the flip join's on "
            f"those queries; K2 launches {l['hamming_dist']} "
            f"({n} hops x {n} shards)")

    # the all-pairs CLI at 4 shards and at 1: the same arrays; the
    # 4-shard run's metrics snapshot merged into the 1-shard run's
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        outs = {}
        for n in (4, 1):
            extra = (["--metrics-out", str(tmp / "w.json")] if n == 4 else
                     ["--metrics-merge", str(tmp / "w.json"),
                      "--metrics-out", str(tmp / "m.prom")])
            out = _run_cli(MR_CLI + ["--shards", str(n), "--out",
                                     str(tmp / f"{n}.npz"), *extra], log,
                           f"allpairs --shards {n}", cli="allpairs",
                           tag="[mapreduce]")
            outs[n] = np.load(tmp / f"{n}.npz")
            for want_line in ("[batch]", "[ingest]", "[truth]", "[metrics]"):
                if want_line not in out:
                    raise AssertionError(f"allpairs --shards {n}: no "
                                         f"{want_line} line")
        for key in outs[1].files:
            if not np.array_equal(outs[4][key], outs[1][key]):
                raise AssertionError(f"allpairs CLI: --shards 4 and 1 "
                                     f"differ in {key}")
        snap = json.loads((tmp / "w.json").read_text())
        if "families" not in snap or not (tmp / "m.prom").exists():
            raise AssertionError("allpairs CLI: metrics not written")
        log(f"[mapreduce] allpairs CLI: --shards 4 and --shards 1 write "
            f"the same arrays ({', '.join(sorted(outs[1].files))}; "
            f"{len(outs[1]['pairs'])} pairs); the 4-shard run's snapshot "
            f"({len(snap['families'])} families) merged and rendered")
    log(f"[mapreduce] phase {time.perf_counter() - t_phase:.1f} s; "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    return launches, record


def _bounds(name, args, kw):
    """(bound_ms, bound_by) of one kernel call from its inputs: the work
    these inputs need (real cells of a pair block, slots of a pair
    buffer), not the most the shapes could hold."""
    if name == "table_sums":
        # the residues inside the lengths, the lengths and the outputs once
        # from HBM; every valid shingle's table row from L2, where the
        # table stays
        ids, lens, table = args
        N, L = ids.shape
        k = kw["k"]
        row = table[0].numel() * 4
        inside = lens.clamp(0, L)
        nbytes = (int(inside.sum()) + lens.numel() * lens.element_size()
                  + table.numel() * 4 + N * max(row // 32, 4))
        shingles = int((inside - k + 1).clamp_min(0).sum())
        t_l2, t_bytes = shingles * row / L2_BYTES_PER_S, nbytes / \
            HBM_BYTES_PER_S
        return ((t_l2 * 1e3, "L2 bytes") if t_l2 >= t_bytes
                else (t_bytes * 1e3, "bytes"))
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
    elif name == "hamming_count":
        # the work is popcounts: one per (query, ref, word), and an XOR,
        # a compare and an add beside each on the integer ALUs
        q, r = args
        Q, nw = q.shape
        R = r.shape[0]
        nbytes = (Q + R) * nw * 4 + Q * 4
        t_ops = max(Q * R * nw / POPC_PER_SM_CLK,
                    Q * R * (nw + 2) / INT_ALU_PER_SM_CLK) / (
                        SMS * SM_CLOCK_HZ)
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
    "hamming_count": ("src/repro_torch/kernels/csrc/hamming.cu",
                      "src/repro/kernels/hamming.py:75"),
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
    "table_sums": ("src/repro_torch/kernels/csrc/tablesum.cu",
                   "none: src/repro/core/simhash.py:169 is plain jnp"),
}


def _once(torch, fn):
    """``fn()`` and its ms, CUDA events around the one call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _count_twin(q, r, *, d):
    """K6's twin over query chunks: the twin is row-wise and materializes
    its (rows, R) distances, so the chunks keep them near 2^27 cells."""
    import torch
    from repro_torch.kernels import ref
    rows = max(1, (1 << 27) // max(r.shape[0], 1))
    return torch.cat([ref.hamming_count_ref(q[i:i + rows], r, d)
                      for i in range(0, q.shape[0], rows)])


def _table_twin(ids, lens, table, *, k):
    """table_sums' twin over row chunks of the pipeline's CPU budget: the
    twin gathers (rows, S, f) int32, ~47 GB for the refs at once."""
    import torch
    from repro_torch.kernels import ref
    L = ids.shape[1]
    rows = max(1, (1 << 30) // (L * 8 * max(table[0].numel(), 2)))
    return torch.cat([ref.table_sums_ref(ids[i:i + rows], lens[i:i + rows],
                                         table, k=k)
                      for i in range(0, ids.shape[0], rows)])


def _table_sums_extra(torch, args, kw, reads, log):
    """table_sums with the count table at its first inputs, then both
    tables at phase 3's read set: each checked exactly against the twin
    and timed. The JSON keys they add to its row."""
    from repro_torch.kernels.tablesum import table_sums
    count_table, (reads_args, reads_kw) = reads
    out = {}
    for tag, (ids, lens, table), tkw in (
            ("counts", (args[0], args[1], count_table), {"k": kw["k"]}),
            ("reads", reads_args, reads_kw),
            ("reads_counts", (reads_args[0], reads_args[1], count_table),
             {"k": reads_kw["k"]})):
        _, _, ms, plain_ms, bound_ms, bound_by = _check_and_time(
            torch, "table_sums", (ids, lens, table), tkw, table_sums,
            _table_twin, 20, 1)
        log(f"[kernels] table_sums {tag} at {tuple(ids.shape)} x "
            f"{tuple(table.shape)}: exact vs twin; kernel {ms:.4f} ms "
            f"(device, 20 launches in one CUDA graph), twin {plain_ms:.4f} "
            f"ms, bound {bound_ms * 1e3:.3f} us ({bound_by})")
        out.update({f"{tag}_ms": ms, f"{tag}_plain_ms": plain_ms,
                    f"{tag}_bound_ms": bound_ms,
                    f"{tag}_shape": [list(ids.shape), list(table.shape)]})
        torch.cuda.empty_cache()
    return out


def _library(torch, name, args, kw, got, log):
    """ms of one torch call that computes the kernel's function —
    ``torch.cdist(p=0)`` on signatures unpacked to float bits, which counts
    the differing bits — or None where no single call can; logged with
    whether it agrees with the kernel."""
    from repro_torch.core.simhash import unpack_bits
    if name not in ("hamming_dist", "hamming_count"):
        return None
    q, r = args
    f = 32 * q.shape[1]
    qb, rb = unpack_bits(q, f).float(), unpack_bits(r, f).float()
    if name == "hamming_dist":
        out = torch.cdist(qb, rb, p=0)
        ms = _timed(torch, lambda: torch.cdist(qb, rb, p=0), 20)
        log(f"[kernels] hamming_dist library: torch.cdist(p=0) on unpacked "
            f"bits {ms:.4f} ms, equal to K2: "
            f"{bool(torch.equal(out.to(torch.int32), got))}")
        return ms
    d = kw["d"]
    rows, n = 2048, min(q.shape[0], 4 * 2048)
    out, ms = _once(torch, lambda: torch.cat([
        (torch.cdist(qb[i:i + rows], rb, p=0) <= d).sum(1)
        for i in range(0, n, rows)]))
    log(f"[kernels] hamming_count library: no single call — one "
        f"torch.cdist(p=0) over all {q.shape[0]} x {r.shape[0]} would write "
        f"{q.shape[0] * r.shape[0] * 4 / 1e9:.1f} GB of float32 distances; "
        f"cdist plus (<= d).sum(1) over the first {n} queries, "
        f"{-(-n // rows)} calls of {rows}, took {ms:.1f} ms, equal to K6 "
        f"there: {bool(torch.equal(out.to(torch.int32), got[:n]))}")
    return None


def _siggen_int_mm(torch, args, kw, got, log):
    """A yardstick for K1, logged only: its function unfused in int8, per
    block of rows two ``torch._int_mm`` products with ``torch.where``
    between (D zero-padded to a multiple of 8), checked equal to K1 and
    timed with CUDA events around whole runs (the host's launch time
    included). It is several calls, so not the library column, and the
    port never calls it."""
    rows, cb, H = args
    T = kw["T"]
    S, D = rows.shape
    if int(rows.abs().max()) > 127:
        log("[kernels] siggen_accumulate int8 yardstick: not run, a row "
            "value leaves int8")
        return
    pad = (0, -D % 8)
    x = torch.nn.functional.pad(rows.to(torch.int8), pad)
    # the second operands column-major, as int8 GEMMs take them
    cbT = torch.nn.functional.pad(cb, pad).T
    Hc = H.T.contiguous().T
    blk = 1 << 16
    starts = list(range(0, S, blk))
    if len(starts) > 1 and S - starts[-1] <= 16:   # _int_mm takes m > 16
        starts.pop()
    ends = starts[1:] + [S]

    def run():
        out = torch.empty((S, H.shape[1]), dtype=torch.int32,
                          device=rows.device)
        for i, j in zip(starts, ends):
            sc = torch._int_mm(x[i:j], cbT)
            out[i:j] = torch._int_mm(
                torch.where(sc >= T, sc, 0).to(torch.int8), Hc)
        return out

    same = bool(torch.equal(run(), got))
    reps = 5
    ms = _timed(torch, run, reps)
    log(f"[kernels] siggen_accumulate int8 yardstick (not the library "
        f"column): {len(starts)} blocks of <= {blk} rows, each "
        f"torch._int_mm, torch.where, torch._int_mm: {ms:.4f} ms a run "
        f"(mean of {reps}, host launch time included), equal to K1: {same}")


def _check_and_time(torch, name, args, kw, run, twin, reps, twin_reps):
    """One kernel call held exactly against its twin on the same inputs,
    then timed: (got, max abs err, kernel ms, twin ms, bound ms,
    bound_by). Raises if the two disagree."""
    got = run(*args, **kw)
    want, once_ms = _once(torch, lambda: twin(*args, **kw))
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"twin {tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err != 0:
        raise AssertionError(f"{name} disagrees with its twin: max abs "
                             f"err {err}")
    del want
    ms = _graph_ms(torch, lambda: run(*args, **kw), reps)
    plain_ms = (_timed(torch, lambda: twin(*args, **kw), twin_reps)
                if twin_reps else once_ms)
    return (got, err, ms, plain_ms) + _bounds(name, args, kw)


def _k2_emission(torch, emission, log):
    """K2 at the dense join's first emission tile: checked exactly against
    the twin and timed. The JSON keys it adds to K2's row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.hamming import hamming_dist
    q, r = emission[0]
    got = hamming_dist(q, r)
    if not torch.equal(got, ref.hamming_dist_ref(q, r)):
        raise AssertionError(f"K2 at the emission tile {tuple(q.shape)} x "
                             f"{tuple(r.shape)} disagrees with its twin")
    del got
    ms = _graph_ms(torch, lambda: hamming_dist(q, r), 20)
    bound, _ = _bounds("hamming_dist", (q, r), {})
    log(f"[kernels] hamming_dist at {tuple(q.shape)} x {tuple(r.shape)} "
        f"(the dense join's first emission tile): exact vs twin; kernel "
        f"{ms:.4f} ms (device, 20 launches in one CUDA graph), bound "
        f"{bound * 1e3:.3f} us")
    torch.cuda.empty_cache()
    return {"emission_ms": ms, "emission_bound_ms": bound,
            "emission_shape": [list(q.shape), list(r.shape)]}


def phase_kernels(torch, recorded, full, real, stages, launches, wave_l,
                  emission, table_reads, log):
    from repro_torch.core.alphabet import PAD
    from repro_torch.kernels import ref
    from repro_torch.kernels.hamming import hamming_count, hamming_dist
    from repro_torch.kernels.siggen import siggen_accumulate
    from repro_torch.kernels.spgemm import upper_pairs
    from repro_torch.kernels.sw import sw_rowwave, ungapped_scores, \
        wave_scores
    from repro_torch.kernels.tablesum import table_sums

    runners = {   # name: (kernel launcher, plain twin, reps, twin reps);
        # twin reps 0: the twin is timed by the one call that checks it
        "siggen_accumulate": (siggen_accumulate, ref.siggen_accumulate_ref,
                              20, 1),
        "hamming_dist": (hamming_dist, ref.hamming_dist_ref, 50, 3),
        "hamming_count": (hamming_count, _count_twin, 5, 0),
        "wave_scores_linear": (wave_scores, ref.wave_scores_ref, 20, 1),
        "wave_scores_affine": (wave_scores, ref.wave_scores_ref, 20, 1),
        "ungapped_scores": (ungapped_scores, ref.ungapped_scores_ref, 50, 1),
        "upper_pairs": (upper_pairs, ref.upper_pairs_ref, 10, 1),
        "sw_rowwave": (sw_rowwave, ref.sw_rowwave_ref, 50, 1),
        "table_sums": (table_sums, _table_twin, 20, 1),
    }
    # K4 and K7: their first waves are nearly empty, so their row is a
    # full wave of the most used shape (with the first launch's arguments)
    main_full = ("ungapped_scores", "sw_rowwave")
    rows = []
    for name, (source, replaces) in KERNELS.items():
        if name not in recorded:
            raise AssertionError(f"the main path never launched {name}")
        args, kw = recorded[name]
        if name in main_full:
            args = full[name]
        run, twin, reps, twin_reps = runners[name]
        got, err, ms, plain_ms, bound_ms, bound_by = _check_and_time(
            torch, name, args, kw, run, twin, reps, twin_reps)
        library_ms = _library(torch, name, args, kw, got, log)
        if name == "siggen_accumulate":
            _siggen_int_mm(torch, args, kw, got, log)
        del got
        extra = (_k2_emission(torch, emission, log)
                 if name == "hamming_dist" else
                 _table_sums_extra(torch, args, kw, table_reads, log)
                 if name == "table_sums" else {})
        shapes = " x ".join(str(tuple(a.shape)) for a in args)
        log(f"[kernels] {name} at {shapes}{' ' + json.dumps(kw) if kw else ''}"
            f": exact vs twin; kernel "
            f"{ms:.4f} ms (device, {reps} launches in one CUDA graph), "
            f"twin {plain_ms:.4f} ms, bound "
            f"{bound_ms * 1e3:.3f} us ({bound_by}), "
            f"{launches[name]} launches on the main path")
        row = dict(name=name, route="cuda", source=source,
                   replaces=replaces, launches=launches[name],
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms, **extra)
        if name in real:
            # the all-pairs waves: a full wave and the first wave as the
            # plan fills it, each its own check and time
            waves = {"full": full[name], "real": real[name]}
            for which, wargs in waves.items():
                if which == "full" and name in main_full:
                    row["wave_ms_full"] = ms
                    continue
                _, werr, wms, wplain, wbound, wby = _check_and_time(
                    torch, name, wargs, kw, run, twin, reps, twin_reps)
                n_real = int((wargs[0] != PAD).any(1).sum())
                log(f"[kernels] {name} all-pairs {which} wave at "
                    f"{tuple(wargs[0].shape)} x {tuple(wargs[1].shape)} "
                    f"({n_real} pairs with a residue): exact vs twin; "
                    f"kernel {wms:.4f} ms (device, {reps} launches in one "
                    f"CUDA graph), twin {wplain:.4f} ms, bound "
                    f"{wbound * 1e3:.3f} us ({wby})")
                row["max_abs_err"] = max(row["max_abs_err"], werr)
                row[f"wave_ms_{which}"] = wms
            row["allpairs_launches"] = wave_l[name]
            stage, stage_s = stages[name]
            share = wave_l[name] * row["wave_ms_real"] / 1e3 / stage_s
            log(f"[kernels] {name} kernel share of {stage}: "
                f"{wave_l[name]} launches x {row['wave_ms_real']:.4f} ms "
                f"(the real-fill wave) / {stage_s:.3f} s of its wall "
                f"clock = {share:.4f} (a lower bound on the card's busy "
                f"share of it)")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def _rows(seqs, width=None):
    """Sequences as one (N, width) int8 block, PAD past each length, and
    their (N,) int32 lengths."""
    from repro_torch.core.alphabet import PAD
    width = width or max(len(x) for x in seqs)
    ids = np.full((len(seqs), width), PAD, np.int8)
    for i, x in enumerate(seqs):
        ids[i, :len(x)] = x
    return ids, np.asarray([len(x) for x in seqs], np.int32)


def _trim_pairs(torch, qs, rs):
    """The pairs of a (B, Lq) x (B, Lr) block with a residue on both sides,
    cut to the longest such residue run on each side (trailing all-PAD
    columns only decay, so every score is unchanged); and their rows."""
    from repro_torch.core.alphabet import PAD
    qn, rn = qs != PAD, rs != PAD
    keep = torch.nonzero(qn.any(1) & rn.any(1))[:, 0]
    col = lambda m: int((m * torch.arange(1, m.shape[1] + 1,
                                          device=m.device)).amax())
    q, r = qs[keep], rs[keep]
    return (q[:, :col(qn[keep])].contiguous(),
            r[:, :col(rn[keep])].contiguous(), keep)


def phase_wide(torch, ops, dev, log):
    """[wide]: f = 512 at NC_000913 scale (K1, K2, K6 past 8 words) and
    chains past 8,192 residues (K3 past 8,192 query rows, K7 past 8,192
    reference columns). Each path's launches counted on its own, each
    kernel held against its twin on the card at the inputs the path gave
    it, and card == CPU where the CPU twins can finish in seconds. Returns
    per kernel the JSON keys of its new shapes."""
    from repro_torch.allpairs import all_pairs_search
    from repro_torch.core.alphabet import PAD
    from repro_torch.core.pipeline import LSHConfig, ScalLoPS
    from repro_torch.data.synthetic import (FamilyCorpusConfig,
                                            SyntheticProteinConfig,
                                            make_family_corpus,
                                            make_protein_sets, mutate,
                                            random_protein)
    from repro_torch.index.service import QueryEngine, ServingConfig
    from repro_torch.index.store import SignatureIndex
    from repro_torch.kernels import ref
    from repro_torch.kernels.hamming import hamming_count, hamming_dist
    from repro_torch.kernels.siggen import siggen_accumulate
    from repro_torch.kernels.sw import sw_rowwave, wave_scores
    from repro_torch.obs import trace

    t_start = time.perf_counter()
    keys = {}

    def replay(name, run, twin, args, kw, reps, what):
        got, err, ms, plain_ms, bound_ms, by = _check_and_time(
            torch, name, args, kw, run, twin, reps, 0)
        shapes = " x ".join(str(tuple(a.shape)) for a in args)
        log(f"[wide] {name} at {shapes} ({what}): exact vs twin; kernel "
            f"{ms:.4f} ms (device, {reps} launches in one CUDA graph), twin "
            f"{plain_ms:.4f} ms, bound {bound_ms * 1e3:.3f} us ({by})")
        keys.setdefault(name, {}).update(
            {"wide_shape": [list(a.shape) for a in args], "wide_ms": ms,
             "wide_plain_ms": plain_ms, "wide_bound_ms": bound_ms})
        return got

    # --- f = 512 (16 words) at NC_000913 scale
    nc = _dataset("NC_000913")
    data = make_protein_sets(SyntheticProteinConfig(
        n_refs=nc["n"], ref_len_mean=nc["avg_len"], ref_len_std=80,
        n_homolog_queries=24, n_decoy_queries=8, seed=0))
    refs = (data["ref_ids"], data["ref_lens"])
    # 32 queries and 32 copies of refs (distance 0: pairs for the join)
    qi, ql = _rows([x[:n] for x, n in zip(data["query_ids"],
                                          data["query_lens"])]
                   + [x[:n] for x, n in zip(refs[0][:32], refs[1][:32])])
    cfg = LSHConfig(k=3, T=13, f=WIDE_F, d=1, scheme="splitmix",
                    siggen_method="matmul")
    table_cfg = replace(cfg, siggen_method="table")
    outer, ops.RECORDED = ops.RECORDED, {}
    idx, l_sig = _window(torch, ops, lambda: SignatureIndex.build(
        cfg, *refs, device=dev))
    table = ScalLoPS(table_cfg, device=dev).signatures(*refs)
    if not np.array_equal(idx.sigs, table.cpu().numpy().view(np.uint32)):
        raise AssertionError(f"f={WIDE_F}: K1 signatures differ from the "
                             f"table path")
    eng = QueryEngine(idx, ServingConfig(k=10, mode="dense"))
    (nid, nd), l_top = _window(torch, ops, lambda: eng.query_batch(qi, ql))
    cpu_idx = SignatureIndex(table_cfg, idx.sigs, idx.valid, device="cpu")
    cid, cd = QueryEngine(cpu_idx, ServingConfig(k=10, mode="dense")) \
        .query_batch(qi, ql)
    if not (np.array_equal(nid, cid) and np.array_equal(nd, cd)):
        raise AssertionError(f"f={WIDE_F}: dense top-k, card != CPU")
    jcfg = replace(cfg, join_method="dense")
    jeng = QueryEngine(SignatureIndex(jcfg, idx.sigs, idx.valid, device=dev))
    res, l_join = _window(torch, ops, lambda: jeng.search_pairs(qi, ql))
    cres = QueryEngine(SignatureIndex(replace(jcfg, siggen_method="table"),
                                      idx.sigs, idx.valid, device="cpu")) \
        .search_pairs(qi, ql)
    for what, x, y in zip(res._fields, res, cres):
        if not torch.equal(x.cpu(), y):
            raise AssertionError(f"f={WIDE_F}: dense join, card != CPU in "
                                 f"{what}")
    rec, ops.RECORDED = ops.RECORDED, outer
    n_zero = int((nd[:, 0] == 0).sum())
    log(f"[wide] f={WIDE_F}: {nc['n']} refs built through K1 (launches "
        f"{json.dumps(l_sig)}) == the table path; dense top-k of {len(ql)} "
        f"queries (launches {json.dumps(l_top)}; {n_zero} at distance 0) "
        f"and the dense join at d=1 ({int(res.count)} pairs; launches "
        f"{json.dumps(l_join)}): card == CPU")
    if l_sig["siggen_accumulate"] <= 0 or l_top["hamming_dist"] <= 0 or \
            l_join["hamming_count"] <= 0 or l_join["hamming_dist"] <= 0:
        raise AssertionError(f"f={WIDE_F}: a kernel did not launch")
    replay("siggen_accumulate", siggen_accumulate, ref.siggen_accumulate_ref,
           *rec["siggen_accumulate"], 5, f"f={WIDE_F}, the K1 build")
    replay("hamming_dist", hamming_dist, ref.hamming_dist_ref,
           *rec["hamming_dist"], 20, f"f={WIDE_F}, the dense top-k")
    replay("hamming_count", hamming_count, _count_twin,
           *rec["hamming_count"], 20, f"f={WIDE_F}, the dense join")
    keys["launches"] = {"f512_build": l_sig, "f512_topk": l_top,
                        "f512_join": l_join}
    del idx, eng, jeng, res, cres, table, data

    # --- chains past 8,192 residues: serving with the SW re-rank
    rng = np.random.default_rng(16)
    base = make_protein_sets(SyntheticProteinConfig(
        n_refs=1000, ref_len_mean=150, ref_len_std=40, n_homolog_queries=0,
        n_decoy_queries=0, seed=5))
    chains = [random_protein(rng, n) for n in LONG_CHAINS]
    short = [x[:n] for x, n in zip(base["ref_ids"], base["ref_lens"])]
    r_ids, r_lens = _rows(short + chains)
    # near copies of the 12,000 and 34,350 chains (they re-rank their
    # source first) and an unrelated chain of 8,193
    queries = [mutate(rng, chains[1], sub_rate=0.01),
               mutate(rng, chains[2], sub_rate=0.01),
               random_protein(rng, LONG_CHAINS[0])]
    q_ids, q_lens = _rows(queries)
    scfg = LSHConfig(k=3, T=13, f=32, d=1, scheme="splitmix")
    sidx = SignatureIndex.build(scfg, r_ids, r_lens, device=dev)
    long_ids = [len(short) + i for i in range(len(chains))]
    for gm in ("linear", "affine"):
        name = f"wave_scores_{gm}"
        eng = QueryEngine(sidx, ServingConfig(k=4, mode="dense", rerank=True,
                                              gap_mode=gm),
                          ref_seqs=(r_ids, r_lens))
        outer, ops.RECORDED = ops.RECORDED, {}
        (nid, nd), l_rr = _window(torch, ops,
                                  lambda: eng.query_batch(q_ids, q_lens))
        rec, ops.RECORDED = ops.RECORDED, outer
        if l_rr[name] <= 0:
            raise AssertionError(f"the long re-rank never launched {name}")
        if list(nid[:2, 0]) != long_ids[1:]:
            raise AssertionError(f"{gm}: the near copies re-rank "
                                 f"{list(nid[:2, 0])} first, not their "
                                 f"sources {long_ids[1:]}")
        (qs, rs), kw = rec[name]
        full = wave_scores(qs, rs, **kw)
        tq, tr, keep = _trim_pairs(torch, qs, rs)
        got = replay(name, wave_scores, ref.wave_scores_ref, (tq, tr), kw, 3,
                     f"the long re-rank's pairs, {gm} gaps")
        if not torch.equal(full[keep], got):
            raise AssertionError(f"{name}: the full block and its trimmed "
                                 f"pairs score differently")
        ms = _graph_ms(torch, lambda: wave_scores(qs, rs, **kw), 3)
        keys[name]["wide_block_ms"] = ms
        keys[name]["wide_block_shape"] = [list(qs.shape), list(rs.shape)]
        # card == CPU where the CPU twin is quick: the 34,350 query
        # against the short refs among its candidates
        rl = (tr != PAD).sum(1)
        ql_ = (tq != PAD).sum(1)
        pick = torch.nonzero((ql_ == LONG_CHAINS[2]) & (rl < 2000))[:, 0]
        if len(pick) == 0:
            raise AssertionError("the 34,350 query has no short candidate")
        cq, cr, _ = _trim_pairs(torch, tq[pick], tr[pick])
        cpu = ref.wave_scores_ref(cq.cpu(), cr.cpu(), **kw)
        if not torch.equal(got[pick].cpu(), cpu):
            raise AssertionError(f"{name}: card != CPU on the 34,350 query")
        log(f"[wide] re-rank of {len(queries)} queries of "
            f"{[len(x) for x in queries]} residues against 1,000 refs and "
            f"chains of {list(LONG_CHAINS)}, {gm} gaps: launches "
            f"{json.dumps(l_rr)}; each near copy re-ranks its source first;"
            f" the whole block {tuple(qs.shape)} x {tuple(rs.shape)} on the "
            f"card {ms:.4f} ms; card == CPU on the 34,350 query x "
            f"{len(pick)} short refs")
        keys["launches"][f"long_rerank_{gm}"] = l_rr
    del sidx, eng

    # --- chains past 8,192 residues: all-vs-all, row wave and wavefront
    fam = make_family_corpus(FamilyCorpusConfig(
        n_families=50, family_size=4, n_singletons=200, len_mean=150,
        len_std=40, sub_rate=0.1, seed=2))
    seqs = [x[:n] for x, n in zip(fam["ids"], fam["lens"])]
    copies = [mutate(rng, c, sub_rate=0.001) for c in chains]
    a_ids, a_lens = _rows(seqs + chains + copies)
    n0 = len(seqs)
    long_pairs = {(n0 + i, n0 + len(chains) + i) for i in range(len(chains))}
    acfg = _allpairs_config()
    runs = {}
    for dp in ("rowwave", "wavefront"):
        c = replace(acfg, wave=replace(acfg.wave, dp_kernel=dp))
        trace.TRACER = trace.Tracer(capacity=1 << 16)
        trace.enable()
        r, l_ap = _window(torch, ops, lambda: all_pairs_search(
            a_ids, a_lens, c, device=dev))
        trace.disable()
        waves = [sp["args"] for sp in trace.TRACER.spans()
                 if sp["name"] == "wave" and sp["args"]["kind"] == "sw"]
        trace.TRACER = trace.Tracer()
        widest = max((w["Lr"] for w in waves), default=0)
        runs[dp] = r
        kname = "sw_rowwave" if dp == "rowwave" else "wave_scores_linear"
        if l_ap[kname] <= 0 or widest <= 8192:
            raise AssertionError(f"all_pairs_search ({dp}): {kname} "
                                 f"launches {l_ap[kname]}, widest SW wave "
                                 f"{widest}")
        found = {tuple(p) for p in r.pairs[r.scored.kept].tolist()}
        if not long_pairs <= found:
            raise AssertionError(f"{dp}: a long chain and its copy were not "
                                 f"scored: {sorted(long_pairs - found)}")
        log(f"[wide] all_pairs_search over {len(a_lens)} sequences (chains "
            f"of {list(LONG_CHAINS)} and a near copy of each), dp_kernel="
            f"{dp}: {r.join.n_candidates} candidates, "
            f"{int(r.scored.kept.sum())} survivors, {len(waves)} SW waves, "
            f"the widest {widest} columns, {r.families.n_families} "
            f"families; launches {json.dumps(l_ap)}")
        keys["launches"][f"long_allpairs_{dp}"] = l_ap
    a, b = runs["rowwave"], runs["wavefront"]
    if not (np.array_equal(a.pairs, b.pairs)
            and np.array_equal(a.scored.scores, b.scored.scores)
            and np.array_equal(a.labels, b.labels)):
        raise AssertionError("long all-pairs: row wave != wavefront")
    # K7 at the long pairs themselves: each chain against its copy
    lq, lr = _rows(chains), _rows(copies)
    qs = torch.from_numpy(lq[0]).to(dev)
    rs = torch.from_numpy(lr[0]).to(dev)
    got = replay("sw_rowwave", sw_rowwave, ref.sw_rowwave_ref, (qs, rs),
                 {"gap": -4}, 3, "each long chain against its near copy")
    if not torch.equal(got, ops.wavefront_scores(qs, rs)):
        raise AssertionError("K7 != K3 on the long chains")
    # card == CPU on the corpus without the 34,350 chain (its CPU twins
    # take tens of seconds a pair)
    keep = np.ones(len(a_lens), bool)
    keep[[n0 + 2, n0 + 5]] = False
    cids, clens = a_ids[keep][:, :max(LONG_CHAINS[:2])], a_lens[keep]
    x = all_pairs_search(cids, clens, acfg, device=dev)
    y = all_pairs_search(cids, clens, acfg, device="cpu")
    for what, u, v in (("pairs", x.pairs, y.pairs),
                       ("scores", x.scored.scores, y.scored.scores),
                       ("labels", x.labels, y.labels)):
        if not np.array_equal(u, v):
            raise AssertionError(f"long all-pairs: card != CPU in {what}")
    log(f"[wide] long all-pairs: row wave == wavefront (pairs, scores, "
        f"labels); K7 == K3 on each chain against its copy; card == CPU on "
        f"the corpus without the 34,350 chain ({x.join.n_candidates} "
        f"candidates); phase {time.perf_counter() - t_start:.1f} s")
    return keys


def _lm_steps(torch, model, toks):
    """``prefill`` of ``toks[:, :-LM_STEPS]``, then one ``decode_step`` for
    each of the last LM_STEPS tokens, fed from ``toks``: the logits of
    every step as fp32 host arrays."""
    from repro_torch.models import decode_step, init_cache, prefill
    dev = model.device
    t = torch.from_numpy(toks).to(dev)
    B, n = toks.shape
    P = n - LM_STEPS
    cache = init_cache(model.cfg, B, n, dev)
    logits, cache = prefill(model, t[:, :P], cache)
    out = [logits.cpu().numpy()]
    for s in range(LM_STEPS):
        logits, cache = decode_step(model, cache, t[:, P + s:P + s + 1],
                                    P + s)
        out.append(logits.cpu().numpy())
    return out


def _lm_serve(torch, dev, smi, log):
    """yi-9b at full width and depth in bf16, served through
    ``repro_torch.launch.serve.generate``: prefill of a B x P prompt, then
    greedy decode."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params
    arch, B, P, G = LM_SERVE
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    # warm the matmul and allocator paths the timed run takes
    generate(model, torch.randint(0, cfg.vocab_size, (B, 64), generator=gen,
                                  device=dev), 2)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)
    ids, logits, prefill_s, decode_s = generate(model, prompt, G)
    peak = torch.cuda.max_memory_allocated(dev)
    if ids.shape != (B, G) or not (0 <= ids.min() <= ids.max()
                                   < cfg.vocab_size):
        raise AssertionError(f"[lm] {arch}: generated ids {ids.shape} out "
                             f"of shape or vocabulary")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[lm] {arch}: non-finite logits")
    steps = G - 1
    out = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "batch": B, "prompt": P, "generated": G,
           "weights_gb": weights / 1e9, "init_s": init_s,
           "prefill_s": prefill_s, "decode_ms_step": 1e3 * decode_s / steps,
           "decode_tok_s": B * steps / decode_s,
           "prefill_tok_s": B * P / prefill_s,
           "peak_gib": peak / 2**30}
    log(f"[lm] {arch} full width and depth ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}) in bf16, "
        f"{weights / 1e9:.2f} GB of weights (drawn on the card in "
        f"{init_s:.2f} s): batch {B} x prompt {P}, {G} tokens; prefill "
        f"{prefill_s:.3f} s ({out['prefill_tok_s']:.0f} tok/s), decode "
        f"{out['decode_ms_step']:.2f} ms a step ({out['decode_tok_s']:.1f} "
        f"tok/s), peak memory {out['peak_gib']:.2f} GiB "
        f"(max_memory_allocated); {smi}")
    log(f"[lm] {arch} generated ids, first row: {ids[0].tolist()}")
    out["ids"] = ids.tolist()
    del model, logits
    torch.cuda.empty_cache()
    return out


def phase_lm(torch, ops, dev, smi, log):
    """The LM serving path (``repro_torch.models``, ``launch/serve.py``):
    yi-9b served at full width, then each block family at full width in
    fp32 on the card against the CPU, with the same weights (drawn on the
    host, carried to the card) and the same fed tokens; xlstm's
    prefill + decode also against a full forward over P + 1 tokens on the
    card. The LM path reaches none of K1-K7."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    t_phase = time.perf_counter()
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("[lm] fp32 products must not run in TF32")
    cfgs = [get_config(a).scaled(n_layers=n, dtype="float32")
            for a, n, _, _ in LM_CHECKS]
    # torch's CPU generator is sequential: the host models are drawn in
    # threads of their own while the card serves yi-9b
    pool = ThreadPoolExecutor(len(cfgs))
    try:
        hosts = [pool.submit(init_params, cfg,
                             torch.Generator().manual_seed(i), "cpu")
                 for i, cfg in enumerate(cfgs)]
        (serve, checks), launches = _window(torch, ops, lambda: (
            _lm_serve(torch, dev, smi, log),
            _lm_card_vs_cpu(torch, dev, hosts, log)))
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    if any(launches.values()):
        raise AssertionError(f"[lm] the LM path launched a kernel of the "
                             f"port: {launches}")
    phase_s = time.perf_counter() - t_phase
    log(f"[lm] the LM path launches none of K1-K7 (counts "
        f"{json.dumps(launches)}): its products are torch.matmul / "
        f"torch.einsum, as the JAX package leaves them to XLA; phase "
        f"{phase_s:.1f} s")
    return {"serve": serve, "checks": checks, "phase_s": phase_s}


def _lm_card_vs_cpu(torch, dev, hosts, log):
    """Each host model and its copy on the card over the same fed tokens
    (``LM_CHECKS``); the mLSTM archs also against a full forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM, forward
    out = {}
    for i, ((arch, n, B, P), fut) in enumerate(zip(LM_CHECKS, hosts)):
        t0 = time.perf_counter()
        host = fut.result()
        cfg = host.cfg
        card = LM(cfg, dev)
        card.load_state_dict(host.state_dict())
        toks = np.random.default_rng(100 + i).integers(
            0, cfg.vocab_size, (B, P + LM_STEPS))
        want = _lm_steps(torch, host, toks)
        got = _lm_steps(torch, card, toks)
        errs = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
        row = {"layers": n, "batch": B, "prompt": P, "max_abs_err": max(errs)}
        if max(errs) > LM_TOL or not all(np.isfinite(g).all() for g in got):
            raise AssertionError(f"[lm] {arch}: card != CPU, max abs logit "
                                 f"difference per step {errs}")
        msg = ""
        if "mlstm" in cfg.block_pattern:
            with torch.no_grad():
                h = forward(card, torch.from_numpy(toks[:, :P + 1]).to(dev))[0]
                full = (h[:, -1].float() @ card.head()).cpu().numpy()
            row["full_forward_err"] = float(np.abs(full - got[1]).max())
            if row["full_forward_err"] > LM_TOL:
                raise AssertionError(
                    f"[lm] {arch}: prefill({P}) + decode_step != forward "
                    f"over {P + 1} tokens: {row['full_forward_err']}")
            msg = (f"; prefill({P}) + decode_step == forward over {P + 1} "
                   f"tokens on the card (chunk {cfg.attn_chunk}, max abs "
                   f"{row['full_forward_err']:.2e})")
        if cfg.window:
            msg += f"; window {cfg.window} < prompt {P}: the ring wrapped"
        row["s"] = time.perf_counter() - t0
        log(f"[lm] {arch} full width (d_model {cfg.d_model}, {n} of "
            f"{get_config(arch).n_layers} layers) fp32: card == CPU over prefill({B} x {P}) and "
            f"{LM_STEPS} decode steps, max abs logit diff {max(errs):.2e} "
            f"<= {LM_TOL}{msg}; {row['s']:.1f} s")
        out[arch] = row
        del host, card
        torch.cuda.empty_cache()
    return out


def _train_config():
    """TRAIN_RUN's microbatches and the CLI's AdamW for a run of its warm
    and timed steps (lr 3e-4, warmup min(20, steps // 5))."""
    from repro_torch.train import AdamWConfig, TrainConfig
    steps = 1 + TRAIN_RUN[5]
    return TrainConfig(n_microbatches=TRAIN_RUN[4], opt=AdamWConfig(
        lr=3e-4, warmup_steps=min(20, steps // 5), total_steps=steps))


def _train_check_config(i):
    """TRAIN_CHECKS[i]'s step: its microbatches, TRAIN_RUN's AdamW."""
    return replace(_train_config(), n_microbatches=TRAIN_CHECKS[i][4])


def _train_full_width(torch, dev, smi, log):
    """yi-9b at full width, TRAIN_RUN's depth, bf16 compute params under
    fp32 masters: one warm step, then timed steps, each ending in a
    device sync."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import LMDataConfig, lm_batches
    from repro_torch.train import init_train_state, make_train_step
    arch, n, B, S, nm, timed = TRAIN_RUN
    cfg = get_config(arch).scaled(n_layers=n)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device=dev).manual_seed(0),
                             cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.model.parameters())
    step = make_train_step(cfg, _train_config())
    dc = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    rows = []
    for s in range(1 + timed):
        x, y = lm_batches(dc, s, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, {"inputs": x, "targets": y})
        torch.cuda.synchronize()
        rows.append({"step_s": time.perf_counter() - t0,
                     **{k: float(v) for k, v in m.items()}})
    peak = torch.cuda.max_memory_allocated(dev)
    bad = [k for r in rows for k in ("loss", "grad_norm")
           if not math.isfinite(r[k])]
    if bad or not all(bool(torch.isfinite(p).all())
                      for p in state.model.parameters()):
        raise AssertionError(f"[train] {arch}: non-finite loss, grad norm "
                             f"or parameter: {rows}")
    if abs(rows[0]["loss"] - math.log(cfg.vocab_size)) > 2.0:
        raise AssertionError(f"[train] {arch}: first loss {rows[0]['loss']} "
                             f"is not within 2 of ln V")
    tokens = B * S
    step_s = [r["step_s"] for r in rows[1:]]
    flop = 6 * n_params * tokens
    out = {"arch": arch, "layers": n, "d_model": cfg.d_model,
           "params": n_params, "batch": B, "seq": S, "microbatches": nm,
           "init_s": init_s, "warm_step_s": rows[0]["step_s"],
           "step_s": step_s, "tok_s": [tokens / t for t in step_s],
           "peak_gib": peak / 2**30,
           "losses": [r["loss"] for r in rows],
           "grad_norms": [r["grad_norm"] for r in rows],
           "lrs": [r["lr"] for r in rows],
           "six_n_tokens_tflop": flop / 1e12,
           "six_n_tokens_tflop_s": [flop / t / 1e12 for t in step_s]}
    log(f"[train] {arch} full width ({n} of {get_config(arch).n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
        f"{n_params / 1e9:.3f} B parameters, bf16 compute params under fp32 "
        f"masters, remat: batch {B} x {S} tokens in {nm} microbatches; "
        f"warm step {rows[0]['step_s']:.3f} s, then step s "
        f"{[round(t, 4) for t in step_s]} "
        f"({[round(t) for t in out['tok_s']]} tok/s); peak memory "
        f"{out['peak_gib']:.2f} GiB (max_memory_allocated); {smi}")
    log(f"[train] {arch} losses {[round(v, 4) for v in out['losses']]}, "
        f"grad_norm {[round(v, 4) for v in out['grad_norms']]}, lr "
        f"{[f'{v:.3e}' for v in out['lrs']]}; 6·N·tokens = "
        f"{flop / 1e12:.1f} TFLOP a step, "
        f"{[round(v, 1) for v in out['six_n_tokens_tflop_s']]} TFLOP/s "
        f"(for information; remat recomputes the blocks' forward on top)")
    del state
    torch.cuda.empty_cache()
    return out


def _train_check_cfg(i):
    """TRAIN_CHECKS[i]'s arch at full width and its depth, in fp32."""
    from repro_torch.configs import get_config
    arch, n = TRAIN_CHECKS[i][:2]
    return get_config(arch).scaled(n_layers=n, dtype="float32")


def _train_check_gen(torch, dev, i):
    """TRAIN_CHECKS[i]'s generator on the card: the same weights every
    time it draws."""
    return torch.Generator(device=dev).manual_seed(10 + i)


def _train_check_batch(torch, cfg, i):
    """TRAIN_CHECKS[i]'s batch on the host, from seed 200 + i."""
    B, S = TRAIN_CHECKS[i][2:4]
    rng = np.random.default_rng(200 + i)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    inputs = toks[:, :-1]
    if cfg.embedding_inputs:
        inputs = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
    return {"inputs": inputs, "targets": toks[:, 1:]}


def _train_host_steps(torch, hosts, out):
    """The CPU side of the checks, one after another (a thread of its
    own): each (cfg, host weight dict) from the queue ``hosts``, until a
    None, becomes a model and AdamW state and takes one step; (loss, lr,
    mu, master, seconds) goes into the queue ``out``, or the exception
    that stopped the run."""
    from repro_torch.models import LM, reference_params
    from repro_torch.train import TrainState, adamw_init, make_train_step
    try:
        for i, (cfg, weights) in enumerate(iter(hosts.get, None)):
            t0 = time.perf_counter()
            model = LM(cfg, "cpu")
            model.load_state_dict(weights, assign=True)
            del weights
            state = TrainState(model, adamw_init(reference_params(model)),
                               torch.zeros((), dtype=torch.int32))
            step = make_train_step(cfg, _train_check_config(i))
            state, m = step(state, _train_check_batch(torch, cfg, i))
            out.put((float(m["loss"]), float(m["lr"]),
                     state.opt_state["mu"], state.opt_state["master"],
                     time.perf_counter() - t0))
            del state, model
    except Exception as e:     # raised again by the reader
        out.put(e)


def _train_card_vs_cpu(torch, dev, results, log):
    """TRAIN_CHECKS on the card, each against its CPU step from the queue
    ``results`` (the same weights, the same batch). The first step's mu is
    (1 - b1) x clip scale x grad, so it is held as the gradient; the
    comparison runs on the card."""
    from repro_torch.configs import get_config
    from repro_torch.train import init_train_state, make_train_step
    out = {}
    for i, (arch, n, B, S, nm) in enumerate(TRAIN_CHECKS):
        t0 = time.perf_counter()
        cfg = _train_check_cfg(i)
        card = init_train_state(_train_check_gen(torch, dev, i), cfg, dev)
        step = make_train_step(cfg, _train_check_config(i))
        card, mc = step(card, {k: v.to(dev) for k, v in
                               _train_check_batch(torch, cfg, i).items()})
        res = results.get(timeout=600)
        if isinstance(res, Exception):
            raise res
        loss_h, lr, mu_h, master_h, cpu_s = res
        loss_err = abs(float(mc["loss"]) - loss_h)
        grad_err, worst, far, total = 0.0, 0.0, 0, 0
        for name, w in master_h.items():
            g_h = mu_h[name].to(dev)
            scale = float(g_h.abs().max())
            if scale > 0:
                grad_err = max(grad_err, float(
                    (card.opt_state["mu"][name] - g_h).abs().max()) / scale)
            d = (card.opt_state["master"][name] - w.to(dev)).abs()
            far += int((d > TRAIN_MASTER_TOL).sum())
            total += d.numel()
            worst = max(worst, float(d.max()))
        del mu_h, master_h
        row = {"layers": n, "batch": B, "seq": S, "microbatches": nm,
               "attn_chunks": -(-S // cfg.attn_chunk),
               "ce_chunks": -(-S // cfg.ce_chunk), "loss": loss_h,
               "loss_err": loss_err, "grad_rel_err": grad_err,
               "master_max_err": worst, "master_far": far,
               "master_elems": total, "lr": lr, "cpu_s": cpu_s,
               "s": time.perf_counter() - t0}
        if (loss_err > TRAIN_LOSS_TOL or grad_err > TRAIN_GRAD_TOL
                or far > TRAIN_MASTER_FLIPS * total
                or worst > 2 * lr * (1 + 1e-3)):     # + the rounding of w
            raise AssertionError(f"[train] {arch}: card != CPU: {row}")
        log(f"[train] {arch} full width (d_model {cfg.d_model}, {n} of "
            f"{get_config(arch).n_layers} layers) fp32, one step of {B} x "
            f"{S} in {nm} microbatch(es), {row['attn_chunks']} attention "
            f"and {row['ce_chunks']} CE chunk(s) a sequence: card == CPU, "
            f"loss diff {loss_err:.2e} "
            f"<= {TRAIN_LOSS_TOL}, max grad leaf diff {grad_err:.2e} x its "
            f"max abs <= {TRAIN_GRAD_TOL}, masters {far} of {total} "
            f"elements past {TRAIN_MASTER_TOL} (<= {TRAIN_MASTER_FLIPS:.0e} "
            f"of them), max {worst:.2e} <= 2·lr = {2 * lr:.2e}; CPU step "
            f"{cpu_s:.1f} s, card side {row['s']:.1f} s")
        out[arch] = row
        del card
        torch.cuda.empty_cache()
    return out


def _train_cli(log):
    """The training CLI in subprocesses on the card with deterministic
    algorithms on: TRAIN_CLI straight through into A with a checkpoint at
    step 3; then B holding only A's step-3 checkpoint (a crash after that
    save) and ``--resume``. A's and B's step-6 files must be equal byte
    for byte, and the ``[dedup]`` count the CPU's. A run of ``--steps 3``
    would not do for the first half: the schedule's length and warmup
    come from ``--steps``."""
    import filecmp
    import re
    import shutil
    import tempfile

    from repro_torch.data.lm_data import (LMDataConfig, dedup_corpus,
                                          synth_corpus)
    from repro_torch.configs import get_smoke_config
    src = Path(__file__).resolve().parent / "src"
    # torch.use_deterministic_algorithms also imports torch._inductor's
    # config (2-7 s a process), which nothing here compiles, so the flag
    # is set itself: in torch 2.11 and 2.13 the public call sets only
    # this flag and inductor's ``deterministic``. The assert fails loudly
    # if a later torch moves the flag
    code = ("import sys, torch\n"
            "torch._C._set_deterministic_algorithms(True)\n"
            "assert torch.are_deterministic_algorithms_enabled()\n"
            "from repro_torch.launch.train import main\n"
            "main(sys.argv[1:])\n")
    # the CLI computes on the card: at one host thread its processes took
    # 16-20 s beside the CPU checks, at the default 8, 20-33 s
    env = {**os.environ, "PYTHONPATH": str(src), "OMP_NUM_THREADS": "1",
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}

    def run(what, *args):
        t_start = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code, *TRAIN_CLI, *args],
                              capture_output=True, text=True, env=env,
                              timeout=600)
        for line in proc.stdout.splitlines():
            log(f"[train] cli {what}: {line}")
        if proc.returncode != 0:
            raise AssertionError(f"[train] cli {what} exited "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        log(f"[train] cli {what}: exit 0 in "
            f"{time.perf_counter() - t_start:.1f} s")
        return proc.stdout

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        a, b = Path(tmp, "A"), Path(tmp, "B")
        out_a = run("A (straight)", "--dedup", "--ckpt-every", "3",
                    "--ckpt-dir", str(a))
        shutil.copytree(a / "step_00000003", b / "step_00000003")
        out_r = run("B (A's step 3, --resume)", "--resume", "--ckpt-dir",
                    str(b))
        for out in (out_a, out_r):
            if not (re.search(r"^step +\d+ loss=[\d.]+ lr=\S+ gnorm=[\d.]+ "
                              r"tok/s=\d+$", out, re.M)
                    and out.rstrip().endswith("done.")):
                raise AssertionError(f"[train] cli lines: {out}")
        if "[resume] restored step 3" not in out_r:
            raise AssertionError(f"[train] cli resume: {out_r}")
        names = sorted(p.name for p in (a / "step_00000006").iterdir())
        same, diff, errs = filecmp.cmpfiles(a / "step_00000006",
                                            b / "step_00000006", names,
                                            shallow=False)
        if diff or errs or names != sorted(
                p.name for p in (b / "step_00000006").iterdir()):
            raise AssertionError(
                f"[train] cli restart not bitwise: {diff} {errs} (does "
                f"torch._C._set_deterministic_algorithms still cover what "
                f"torch.use_deterministic_algorithms does in this torch?)")
    cfg = get_smoke_config("yi-9b")
    dc = LMDataConfig(vocab_size=cfg.vocab_size,
                      seq_len=int(TRAIN_CLI[TRAIN_CLI.index("--seq") + 1]),
                      global_batch=8)
    keep, n_dups = dedup_corpus(*synth_corpus(dc, n_docs=256,
                                              dup_fraction=0.1),
                                device="cpu")
    want = (f"[dedup] ScalLoPS SimHash stage: {n_dups} near-duplicates "
            f"dropped of {len(keep)} docs")
    if want not in out_a.splitlines():
        raise AssertionError(f"[train] cli dedup line != CPU's {want!r}")
    wall = time.perf_counter() - t0
    log(f"[train] cli: {' '.join(TRAIN_CLI)} straight == its step-3 "
        f"checkpoint + --resume, {len(same)} files of step 6 equal byte for "
        f"byte (deterministic algorithms on the card); [dedup] {n_dups} of "
        f"{len(keep)} == the CPU's; {wall:.1f} s")
    return {"files_equal": len(same), "dedup": n_dups, "s": wall}


def phase_train(torch, ops, dev, smi, log):
    """LM training (``repro_torch.train``, ``checkpoint``,
    ``data.lm_data``, ``launch/train.py``): the training CLI's bitwise
    restart on the card, each block family held card == CPU in fp32 over
    one step, and yi-9b trained at full width. The CLI's processes run
    beside the checks (their weights drawn on the card and copied to the
    host, their CPU steps in a thread); yi-9b trains last, with the card
    and the host to itself. The training path reaches none of K1-K7."""
    import queue
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.models import init_params
    t_phase = time.perf_counter()
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("[train] fp32 products must not run in TF32")

    def draw_hosts():
        for i in range(len(TRAIN_CHECKS)):
            cfg = _train_check_cfg(i)
            model = init_params(cfg, _train_check_gen(torch, dev, i), dev)
            hosts.put((cfg, {k: v.cpu() for k, v in
                             model.state_dict().items()}))
            del model
        torch.cuda.empty_cache()

    hosts, results = queue.Queue(), queue.Queue()
    with ThreadPoolExecutor(2) as pool:
        cli = pool.submit(_train_cli, log)
        host = pool.submit(_train_host_steps, torch, hosts, results)
        try:
            _, draw_l = _window(torch, ops, draw_hosts)
        finally:
            hosts.put(None)          # the host thread stops there
        checks, check_l = _window(torch, ops, lambda: _train_card_vs_cpu(
            torch, dev, results, log))
        host.result()
        cli = cli.result()
    log(f"[train] the CLI and the checks: "
        f"{time.perf_counter() - t_phase:.1f} s")
    run, run_l = _window(torch, ops, lambda: _train_full_width(
        torch, dev, smi, log))
    launches = {k: draw_l[k] + run_l[k] + check_l[k] for k in run_l}
    if any(launches.values()):
        raise AssertionError(f"[train] the training path launched a kernel "
                             f"of the port: {launches}")
    phase_s = time.perf_counter() - t_phase
    log(f"[train] the training path launches none of K1-K7 (counts "
        f"{json.dumps(launches)}): its products are torch.matmul / "
        f"torch.einsum and autograd's, as the JAX package leaves them to "
        f"XLA; phase {phase_s:.1f} s")
    return {"run": run, "checks": checks, "cli": cli, "phase_s": phase_s}


def _dryrun_start():
    """The [dryrun] walks in a subprocess at the lowest CPU priority and
    one host thread: the production cells (``lower_cell`` on the (16, 16)
    mesh of ``meta`` entries), then [mesh]'s timed step's shapes (every
    row of a (2, 2) meta mesh). Its last stdout line is a JSON object,
    with the wall-clock time the walks ended."""
    src = Path(__file__).resolve().parent / "src"
    arch, n, B, S, nm, _ = TRAIN_RUN
    code = textwrap.dedent(f"""
        import json, os, time
        os.nice(19)
        import torch
        torch.set_num_threads(1)
        from repro_torch.configs import get_config
        from repro_torch.launch.dryrun import lower_cell
        from repro_torch.launch.hlo_walk import walk
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.models import LM
        from repro_torch.models.model import reference_params
        from repro_torch.models.sharding import Mesh
        from repro_torch.train import (AdamWConfig, TrainConfig,
                                       make_train_step)
        from repro_torch.train.optimizer import adamw_init
        from repro_torch.train.train_lib import (TrainState, place_batch,
                                                 shard_train_state)
        out = {{}}
        mesh = make_production_mesh()
        for shape in ("train_4k", "decode_32k"):
            t0 = time.perf_counter()
            mem, r = lower_cell({arch!r}, shape, mesh, "single")
            out[shape] = {{**r.__dict__, "mem": mem,
                           "walk_s": time.perf_counter() - t0}}
        # the timed step's shapes, every row of a (2, 2) meta mesh
        cfg = get_config({arch!r}).scaled(n_layers={n})
        m4 = Mesh((2, 2), ("data", "model"), "meta")
        lm = LM(cfg, "meta")
        state = shard_train_state(TrainState(
            lm, adamw_init(reference_params(lm)),
            torch.zeros((), dtype=torch.int32, device="meta")), m4)
        step = make_train_step(cfg, TrainConfig(n_microbatches={nm},
                               opt=AdamWConfig()), m4)
        batch = {{k: torch.empty(({B}, {S}), dtype=torch.int32,
                                 device="meta") for k in ("inputs",
                                                          "targets")}}
        t0 = time.perf_counter()
        w = walk(step, state, place_batch(batch, m4, cfg))
        out["timed_step"] = {{"flops": w.flops, "hbm_bytes": w.hbm_bytes,
                              "collective_bytes": w.collective_bytes,
                              "walk_s": time.perf_counter() - t0}}
        out["ended"] = time.time()
        print(json.dumps(out))
        """)
    env = {**os.environ, "PYTHONPATH": str(src), "OMP_NUM_THREADS": "1"}
    # files, not pipes: nothing reads them until [dryrun]
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=out, stderr=err, text=True)
    proc.files = (out, err)
    return proc


def _mesh_cache_diff(torch, a, b):
    """The max abs difference between an unsharded cache's k and v and
    the sharded one's, gathered whole (None where a layer's positions
    differ)."""
    worst = 0.0
    for la, lb in zip(a, b):
        if not torch.equal(la["pos"], lb["pos"].full(la["pos"].device)):
            return None
        for k in ("k", "v"):
            d = (la[k].float() - lb[k].full(la[k].device).float()).abs()
            worst = max(worst, float(d.max()))
    return worst


def _mesh_kv_route(a, b, slot):
    """The max abs difference between two unsharded caches' k and v at
    one slot: the bf16 class of a cache entry, from two routes to it."""
    return max(float((la[k][:, slot].float() - lb[k][:, slot].float())
                     .abs().max()) for la, lb in zip(a, b) for k in ("k", "v"))


def _mesh_bf16_class(torch, lg_u0, lg_s0, lg_u1, lg_s1, lg_p1):
    """The sharded bf16 serving's logits against the unsharded model's on
    the same tokens: the prefill's, and the first decode step's (both
    fed the unsharded prefill's token), beside the unsharded model's own
    difference between its decode step and its prefill over the same
    P + 1 tokens; for each row whose argmax differs, the unsharded and
    sharded top-2 margins."""
    d0 = float((lg_s0 - lg_u0).abs().max())
    d1 = float((lg_s1 - lg_u1).abs().max())
    route = float((lg_p1 - lg_u1).abs().max())
    flips = (lg_s1.argmax(-1) != lg_u1.argmax(-1)).nonzero()[:, 0].tolist()
    route_flips = int((lg_p1.argmax(-1) != lg_u1.argmax(-1)).sum())

    def margin(lg, r):
        top = torch.topk(lg[r], 2).values
        return float(top[0] - top[1])
    return {"prefill_max_abs": d0, "max_abs": d1, "route_max_abs": route,
            "logit_abs_max": float(lg_u1.abs().max()),
            "flipped_rows": flips, "route_flipped_rows": route_flips,
            "margins": [{"row": r, "unsharded": margin(lg_u1, r),
                         "sharded": margin(lg_s1, r)} for r in flips]}


def _mesh_serve(torch, dev, smi, lm, log):
    """yi-9b at full width and depth in bf16, [lm]'s weights and prompt,
    on a (1, 4) mesh of ``dev``: the unsharded prefill's cache kept, the
    model placed as blocks, then the tensor-parallel sharded prefill (its
    cache gathered beside the unsharded one) and greedy decode."""
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill)
    from repro_torch.models.model import ShardedLM
    from repro_torch.models.sharding import Mesh, make_rules
    arch, B, P, _ = LM_SERVE
    G = MESH_GEN
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_params(cfg, gen, dev)          # [lm]'s draws, in order
    torch.randint(0, cfg.vocab_size, (B, 64), generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)
    want = init_cache(cfg, B, P + G, dev)
    lg_u0, _ = prefill(model, prompt, want)
    first = torch.argmax(lg_u0, -1)[:, None]
    # the unsharded model's first decode step (on a copy of the cache) and
    # the same position's logits and k/v by the chunked prefill route
    lg_u1, c_u1 = decode_step(model, [{k: v.clone() for k, v in c.items()}
                                      for c in want], first, P)
    lg_p1, c_p1 = prefill(model, torch.cat([prompt, first], 1),
                          init_cache(cfg, B, P + 1, dev))
    route_kv = _mesh_kv_route(c_u1, c_p1, P)
    del c_u1, c_p1
    mesh = Mesh(MESH_SERVE, ("data", "model"), [dev] * 4)
    rules = make_rules(cfg, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = ShardedLM.place(model, mesh, rules)
    del model
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    def run(toks, steps, check=None, fed=None):
        """Prefill and greedy decode; ``fed`` (B, 1), when given, is the
        first decode step's token in place of the prefill's argmax."""
        cache = init_cache(cfg, B, toks.shape[1] + steps + 1, rules=rules)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(sharded, toks, cache, rules)
        tok = torch.argmax(logits, -1)[:, None] if fed is None else fed
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        same = None if check is None else _mesh_cache_diff(torch, check,
                                                           cache)
        out, seen = [tok], [logits]
        t2 = time.perf_counter()
        for i in range(steps):
            logits, cache = decode_step(sharded, cache, tok,
                                        toks.shape[1] + i, rules)
            tok = torch.argmax(logits, -1)[:, None]
            out.append(tok)
            if i == 0:
                seen.append(logits)
        torch.cuda.synchronize()
        return (torch.cat(out, 1).cpu().numpy(), logits, t1 - t0,
                time.perf_counter() - t2, same, seen)

    # warm the sharded paths (64 + 3 + 1 slots: the cache's sequence
    # divides over "model", so the decode is sequence-parallel too)
    run(prompt[:, :64], 3)
    torch.cuda.reset_peak_memory_stats(dev)
    ids, logits, prefill_s, decode_s, same, (lg_s0, lg_s1) = run(
        prompt, G - 1, want, first)
    peak = torch.cuda.max_memory_allocated(dev)
    bf16 = _mesh_bf16_class(torch, lg_u0, lg_s0, lg_u1, lg_s1, lg_p1)
    if same is None:
        raise AssertionError(f"[mesh] {arch}: the cache's positions after "
                             f"the sharded prefill != the unsharded's")
    if not bool(torch.isfinite(logits).all()) or ids.shape != (B, G):
        raise AssertionError(f"[mesh] {arch}: sharded serving gave "
                             f"non-finite logits or ids {ids.shape}")
    lm_ids = np.asarray(lm["serve"]["ids"])[:, :G]
    agree = float(np.mean(ids == lm_ids))
    differ = (ids != lm_ids).any(0)
    first_diff = int(np.argmax(differ)) if differ.any() else G
    steps = G - 1
    out = {"mesh": MESH_SERVE, "place_s": place_s, "prefill_s": prefill_s,
           "decode_ms_step": 1e3 * decode_s / steps,
           "decode_tok_s": B * steps / decode_s, "peak_gib": peak / 2**30,
           "ids_agree": agree, "first_diverging_token": first_diff,
           "cache_max_abs": same, "cache_route_max_abs": route_kv,
           "bf16": bf16}
    u = lm["serve"]
    log(f"[mesh] {arch} full width and depth in bf16 on a (data, model) = "
        f"{MESH_SERVE} mesh of {dev} x 4 (the KV cache's sequence over "
        f"'model', {(P + G) // MESH_SERVE[1]} slots an entry; weights "
        f"placed as blocks in {place_s:.2f} s): batch {B} x prompt {P}, "
        f"{G} tokens; prefill {prefill_s:.3f} s (unsharded [lm] "
        f"{u['prefill_s']:.3f}), decode {out['decode_ms_step']:.2f} ms a "
        f"step, {out['decode_tok_s']:.1f} tok/s (unsharded "
        f"{u['decode_ms_step']:.2f} ms, {u['decode_tok_s']:.1f}), peak "
        f"{out['peak_gib']:.2f} GiB (unsharded {u['peak_gib']:.2f}); {smi}")
    log(f"[mesh] {arch} the cache after the sharded prefill, gathered: "
        f"positions == the unsharded prefill's, k and v within {same:.4g} "
        f"max abs over {cfg.n_layers} layers x {P} slots (bf16, each "
        f"entry's heads projected from the all-reduced residual); the "
        f"unsharded model's k and v at slot {P}, its decode step - its "
        f"prefill over {P + 1} tokens, {route_kv:.4g}; bar {MESH_BF16_TOL} "
        f"x that; greedy ids agree with [lm]'s on {agree:.4f} of "
        f"{B} x {G} (first token where a row differs: {first_diff}; "
        f"greedy tokens are compared for information, the bf16 class "
        f"and the fp32 check below hold the route)")
    flips = [(m["row"], round(m["unsharded"], 4), round(m["sharded"], 4))
             for m in bf16["margins"]]
    log(f"[mesh] {arch} bf16 class, teacher forced (the first decode step "
        f"fed the unsharded prefill's token on both sides): sharded - "
        f"unsharded max abs logit {bf16['prefill_max_abs']:.4g} at the "
        f"prefill, {bf16['max_abs']:.4g} at the first decode step (logits "
        f"up to {bf16['logit_abs_max']:.4g}); the unsharded model's decode "
        f"step - its prefill over the same {P + 1} tokens "
        f"{bf16['route_max_abs']:.4g} (argmax differs on "
        f"{bf16['route_flipped_rows']} of {B} rows); bar {MESH_BF16_TOL} x "
        f"that; rows whose argmax flips and their top-2 margins "
        f"(unsharded, sharded): {flips}")
    if not same <= MESH_BF16_TOL * route_kv:
        raise AssertionError(
            f"[mesh] {arch}: the sharded prefill's k and v are {same:.4g} "
            f"from the unsharded one's, past {MESH_BF16_TOL} x the "
            f"unsharded routes' {route_kv:.4g}")
    if not bf16["max_abs"] <= MESH_BF16_TOL * bf16["route_max_abs"]:
        raise AssertionError(
            f"[mesh] {arch}: the sharded decode step's logits are "
            f"{bf16['max_abs']:.4g} from the unsharded one's, past "
            f"{MESH_BF16_TOL} x the unsharded routes' "
            f"{bf16['route_max_abs']:.4g}")
    del sharded, want, logits, lg_u0, lg_u1, lg_p1, lg_s0, lg_s1
    torch.cuda.empty_cache()
    return out


def _mesh_decode_check(torch, dev, log):
    """MESH_DECODE in fp32: the same weights unsharded and on a (2, 2)
    mesh of ``dev``, the same tokens; logits within MESH_DECODE_TOL at
    the prefill and every decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill)
    from repro_torch.models.model import ShardedLM
    from repro_torch.models.sharding import Mesh, make_rules
    arch, n, B, P, steps = MESH_DECODE
    cfg = get_config(arch).scaled(n_layers=n, dtype="float32")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(20),
                        dev)
    mesh = Mesh((2, 2), ("data", "model"), [dev] * 4)
    rules = make_rules(cfg, mesh)
    sharded = ShardedLM.place(model, mesh, rules)
    toks = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (B, P + steps))).to(dev)

    def run(m, r):
        cache = init_cache(cfg, B, P + steps, dev, rules=r)
        lg, cache = prefill(m, toks[:, :P], cache, r)
        out = [lg]
        for s in range(P, P + steps):
            lg, cache = decode_step(m, cache, toks[:, s:s + 1], s, r)
            out.append(lg)
        return out

    want, got = run(model, None), run(sharded, rules)
    errs = [float((a - b).abs().max()) for a, b in zip(want, got)]
    if max(errs) > MESH_DECODE_TOL:
        raise AssertionError(f"[mesh] {arch} sharded decode != unsharded: "
                             f"max abs logit per step {errs}")
    wall = time.perf_counter() - t0
    log(f"[mesh] {arch} full width ({n} layers) fp32 on a (2, 2) mesh of "
        f"{dev}: prefill {B} x {P} ({-(-P // cfg.attn_chunk)} attention "
        f"chunks) + {steps} sequence-parallel decode steps == the "
        f"unsharded card within {max(errs):.2e} <= {MESH_DECODE_TOL} max "
        f"abs logit (per step {[f'{e:.1e}' for e in errs]}); {wall:.1f} s")
    del model, sharded
    torch.cuda.empty_cache()
    return {"max_abs_err": max(errs), "errs": errs, "s": wall}


def _mesh_train_checks(torch, dev, log):
    """MESH_TRAIN_CHECKS: one fp32 step unsharded and on a (2, 2) mesh
    of ``dev`` from the same state and batch, held to [train]'s bars.
    Returns the rows and yi-9b's stepped (2, 2) state."""
    from repro_torch.configs import get_config
    from repro_torch.models.sharding import Mesh
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.train_lib import place_batch, shard_train_state
    out, keep = {}, None
    for i, (arch, n, B, S, nm) in enumerate(MESH_TRAIN_CHECKS):
        t0 = time.perf_counter()
        cfg = get_config(arch).scaled(n_layers=n, dtype="float32")
        state = init_train_state(torch.Generator(device=dev).manual_seed(
            30 + i), cfg, dev)
        mesh = Mesh((2, 2), ("data", "model"), [dev] * 4)
        sharded = shard_train_state(state, mesh)
        rng = np.random.default_rng(31 + i)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                     .astype(np.int32)).to(dev)
                 for k in ("inputs", "targets")}
        tc = replace(_train_config(), n_microbatches=nm)
        state, mu = make_train_step(cfg, tc)(state, batch)
        sharded, ms = make_train_step(cfg, tc, mesh)(
            sharded, place_batch(batch, mesh, cfg))
        lr = float(mu["lr"])
        loss_err = abs(float(ms["loss"]) - float(mu["loss"]))
        grad_err, worst, far, total = 0.0, 0.0, 0, 0
        for name, w in state.opt_state["master"].items():
            g = state.opt_state["mu"][name]
            scale = float(g.abs().max())
            if scale > 0:
                grad_err = max(grad_err, float((sharded.opt_state["mu"][
                    name].full(dev) - g).abs().max()) / scale)
            d = (sharded.opt_state["master"][name].full(dev) - w).abs()
            far += int((d > TRAIN_MASTER_TOL).sum())
            total += d.numel()
            worst = max(worst, float(d.max()))
        row = {"layers": n, "batch": B, "seq": S, "microbatches": nm,
               "loss": float(mu["loss"]), "loss_err": loss_err,
               "grad_rel_err": grad_err, "master_max_err": worst,
               "master_far": far, "master_elems": total, "lr": lr,
               "s": time.perf_counter() - t0}
        if (loss_err > TRAIN_LOSS_TOL or grad_err > TRAIN_GRAD_TOL
                or far > TRAIN_MASTER_FLIPS * total
                or worst > 2 * lr * (1 + 1e-3)):
            raise AssertionError(f"[mesh] {arch}: sharded step != "
                                 f"unsharded: {row}")
        log(f"[mesh] {arch} full width ({n} layers) fp32, one step of {B} x "
            f"{S} in {nm} microbatches on a (2, 2) mesh of {dev} (each "
            f"entry's box of a layer gathered at a time, tensor-parallel "
            f"over 'model', fp32 gradient buffers, AdamW on the blocks) "
            f"== the unsharded card step: loss diff "
            f"{loss_err:.2e} <= {TRAIN_LOSS_TOL}, max grad leaf diff "
            f"{grad_err:.2e} x its max abs <= {TRAIN_GRAD_TOL}, masters "
            f"{far} of {total} past {TRAIN_MASTER_TOL}, max {worst:.2e} <= "
            f"2·lr; {row['s']:.1f} s")
        out[arch] = row
        if i == 0:
            keep = sharded
        del state, sharded
        torch.cuda.empty_cache()
    return out, keep


def _entry_walks(torch, cfg, shape, B, S):
    """forward's walked FLOPs at B x S on ``meta``: unsharded, and each
    entry's of the first DP row of a ``shape`` mesh (``Mesh.walk``)."""
    from repro_torch.launch.hlo_walk import walk
    from repro_torch.models import LM, forward
    from repro_torch.models.model import ShardedLM
    from repro_torch.models.sharding import Mesh, make_rules
    lm = LM(cfg, "meta")
    x = torch.zeros((B, S), dtype=torch.int64, device="meta")
    whole = walk(lambda: forward(lm, x)).flops
    mesh = Mesh(shape, ("data", "model"), "meta")
    rules = make_rules(cfg, mesh)
    sharded = ShardedLM.place(lm, mesh, rules)
    row = mesh.rows(("data",), B)[0]
    per = []
    for e in row.entries:
        with mesh.walk((e,)):
            per.append(walk(lambda: forward(sharded, x, {
                **rules, "_rows": (row,)})).flops)
    return whole, per


def _ulp_spread(torch, model, serve, want):
    """The largest max abs logit movement over ``serve(model)``'s steps
    when every block weight is scaled by (1 + MESH_ULP_REL · N(0, 1)),
    from ``want`` (its logits unperturbed); the weights are put back."""
    blocks = [p for n, p in model.named_parameters()
              if n.startswith("layers.")]
    saved = [p.detach().clone() for p in blocks]
    g = torch.Generator(device=blocks[0].device).manual_seed(43)
    with torch.no_grad():
        for p in blocks:
            p.mul_(1 + MESH_ULP_REL * torch.randn(
                p.shape, generator=g, device=p.device, dtype=p.dtype))
        got = serve(model)
        for p, w in zip(blocks, saved):
            p.copy_(w)
    return max(float((a - b).abs().max()) for a, b in zip(want, got))


def _replicas_equal(torch, cache):
    """Whether every replica of each recurrent state leaf of a mesh cache
    holds the same bits as the others."""
    for layer in cache:
        if isinstance(layer, dict) and "k" in layer:
            continue
        for sh in (layer.values() if isinstance(layer, dict) else layer):
            for holders in sh.holders.values():
                if not all(torch.equal(sh.blocks[e], sh.blocks[holders[0]])
                           for e in holders[1:]):
                    return False
    return True


def _mesh_recurrent_checks(torch, dev, log):
    """MESH_RECURRENT in fp32 at full width on each of
    MESH_RECURRENT_SHAPES' meshes of ``dev``: the recurrent mixers (and
    recurrentgemma's 10 heads, unevenly on (1, 4)) tensor-parallel over
    "model", against the unsharded card: one train_step_fn (loss and
    every gradient leaf by [train]'s bars), a prefill and decode steps
    (logits within MESH_DECODE_TOL at every step, or within MESH_ULP_TOL
    times the unsharded model's own movement under an ulp-sized weight
    perturbation where that is larger; every replica of each recurrent
    state equal bit for bit after them); each entry's walked forward
    FLOPs beside the unsharded walk."""
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill, train_step_fn)
    from repro_torch.models.model import ShardedLM
    from repro_torch.models.sharding import Mesh, make_rules
    Bt, St = MESH_RECURRENT_TRAIN
    Bd, P, steps = MESH_RECURRENT_DECODE
    out = {}
    for i, (arch, n) in enumerate(MESH_RECURRENT):
        cfg = get_config(arch).scaled(n_layers=n, dtype="float32")
        t0 = time.perf_counter()
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(
            40 + i), dev)
        rng = np.random.default_rng(41 + i)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (
            Bt, St)).astype(np.int32)).to(dev) for k in ("inputs", "targets")}
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
            Bd, P + steps))).to(dev)

        def serve(m, r):
            cache = init_cache(cfg, Bd, P + steps, dev, rules=r)
            lg, cache = prefill(m, toks[:, :P], cache, r)
            lgs = [lg]
            for s in range(P, P + steps):
                lg, cache = decode_step(m, cache, toks[:, s:s + 1], s, r)
                lgs.append(lg)
            return lgs, cache

        loss0, _, grads0 = train_step_fn(model, batch)
        want, _ = serve(model, None)
        spread = _ulp_spread(torch, model, lambda m: serve(m, None)[0], want)
        bar = max(MESH_DECODE_TOL, MESH_ULP_TOL * spread)
        unsharded_s = time.perf_counter() - t0
        for shape in MESH_RECURRENT_SHAPES:
            t1 = time.perf_counter()
            mesh = Mesh(shape, ("data", "model"), [dev] * 4)
            rules = make_rules(cfg, mesh)
            sharded = ShardedLM.place(model, mesh, rules)
            loss, _, grads = train_step_fn(sharded, batch, rules)
            loss_err = abs(float(loss) - float(loss0))
            grad_err = 0.0
            for name, g in grads.items():
                scale = float(grads0[name].abs().max())
                if scale > 0:
                    grad_err = max(grad_err, float((g.full(dev) - grads0[
                        name]).abs().max()) / scale)
            del grads
            got, cache = serve(sharded, rules)
            errs = [float((a - b).abs().max()) for a, b in zip(want, got)]
            same = _replicas_equal(torch, cache)
            del cache, sharded
            run_s = time.perf_counter() - t1
            whole, per = _entry_walks(torch, cfg, shape, Bt, St)
            row = {"loss_err": loss_err, "grad_rel_err": grad_err,
                   "max_abs_err": max(errs), "errs": errs,
                   "ulp_spread": spread, "decode_bar": bar,
                   "replicas_equal": same, "walk_whole": whole,
                   "walk_entries": per, "s": run_s,
                   "walk_s": time.perf_counter() - t1 - run_s}
            if (loss_err > TRAIN_LOSS_TOL or grad_err > TRAIN_GRAD_TOL
                    or max(errs) > bar or not same or max(per) >= whole):
                raise AssertionError(f"[mesh] {arch} on {shape}: sharded != "
                                     f"unsharded: {row}")
            log(f"[mesh] {arch} full width ({n} layers) fp32 on a {shape} "
                f"mesh of {dev} (recurrent mixers and attention "
                f"tensor-parallel over 'model'): train_step_fn {Bt} x {St} "
                f"== the unsharded card's: loss diff {loss_err:.2e} <= "
                f"{TRAIN_LOSS_TOL}, max grad leaf diff {grad_err:.2e} x its "
                f"max abs <= {TRAIN_GRAD_TOL}; prefill {Bd} x {P} + {steps} "
                f"decode steps within {max(errs):.2e} max abs logit <= "
                f"{bar:.2e} (the larger of {MESH_DECODE_TOL} and "
                f"{MESH_ULP_TOL} x the unsharded model's own {spread:.2e} "
                f"under a {MESH_ULP_REL} relative weight perturbation); "
                f"every recurrent-state replica equal bit for bit; "
                f"{run_s:.1f} s")
            for j, f in enumerate(per):
                log(f"[mesh] {arch} on {shape}: entry {j} of the first row "
                    f"walks {f:.6g} forward FLOPs at {Bt} x {St} "
                    f"(unsharded {whole:.6g}, x{whole / f:.3f})")
            out[f"{arch}/{shape[0]}x{shape[1]}"] = row
            torch.cuda.empty_cache()
        out[f"{arch}/unsharded_s"] = unsharded_s
        del model, grads0
        torch.cuda.empty_cache()
    return out


def _mesh_save(state):
    """Start saving ``state`` (a mesh state): the host copy now, the
    files by the manager's writer thread while the card serves. Returns
    what ``_mesh_restore`` needs."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    tmp = tempfile.TemporaryDirectory()
    mgr = CheckpointManager(tmp.name, async_writes=True)
    t0 = time.perf_counter()
    mgr.save(1, state.tree(), block=False)
    return tmp, mgr, time.perf_counter() - t0


def _mesh_restore(torch, dev, state, saved, log):
    """``state``'s checkpoint (``_mesh_save``) restored onto each of
    MESH_RESTORE's meshes of ``dev``: every leaf, gathered, bit for bit."""
    from repro_torch.models.sharding import Mesh, Sharded
    from repro_torch.train.train_lib import state_sharding
    from repro_torch.util import tree_flatten
    tmp, mgr, copy_s = saved
    out = {"host_copy_s": copy_s}
    try:
        t0 = time.perf_counter()
        mgr.wait()
        out["write_wait_s"] = time.perf_counter() - t0
        before = tree_flatten(state.tree())
        for shape in MESH_RESTORE:
            t1 = time.perf_counter()
            mesh = Mesh(shape, ("data", "model"), [dev] * math.prod(shape))
            tree, _ = mgr.restore(state.tree(),
                                  sharding_tree=state_sharding(state, mesh))
            for (path, a), (_, b) in zip(before, tree_flatten(tree)):
                x = a.full(dev) if isinstance(a, Sharded) else a
                y = b.full(dev) if isinstance(b, Sharded) else b
                if isinstance(b, Sharded) and b.mesh is not mesh:
                    raise AssertionError(f"[mesh] restore: {path} not on "
                                         f"{shape}")
                if x.dtype != y.dtype or not torch.equal(x, y):
                    raise AssertionError(f"[mesh] restore onto {shape}: "
                                         f"leaf {path} differs")
            out[f"{shape[0]}x{shape[1]}_s"] = time.perf_counter() - t1
            del tree
    finally:
        tmp.cleanup()
    nbytes = sum(a.numel() * a.element_size() for _, a in before)
    log(f"[mesh] elastic restore: the (2, 2) state ({len(before)} leaves, "
        f"{nbytes / 1e9:.2f} GB) copied to the host in {copy_s:.1f} s and "
        f"written while the card served ({out['write_wait_s']:.1f} s "
        f"waited after), restored onto "
        f"{' and '.join(str(s) for s in MESH_RESTORE)} in "
        f"{', '.join(f'{out[k]:.1f}' for k in out if 'x' in k[:4])} s: "
        f"every leaf, gathered, equal bit for bit")
    return out


def _mesh_train_full(torch, dev, smi, train, log):
    """TRAIN_RUN's yi-9b on a (2, 2) mesh of ``dev``: a warm step, then
    timed steps, beside [train]'s unsharded numbers."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import LMDataConfig, lm_batches
    from repro_torch.models.sharding import Mesh
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.train_lib import place_batch
    arch, n, B, S, nm, timed = TRAIN_RUN
    cfg = get_config(arch).scaled(n_layers=n)
    mesh = Mesh((2, 2), ("data", "model"), [dev] * 4)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device=dev).manual_seed(0),
                             cfg, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, _train_config(), mesh)
    dc = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    rows = []
    for s in range(1 + timed):
        x, y = lm_batches(dc, s, device=dev)
        batch = place_batch({"inputs": x, "targets": y}, mesh, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        rows.append({"step_s": time.perf_counter() - t0,
                     **{k: float(v) for k, v in m.items()}})
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(r[k]) for r in rows
               for k in ("loss", "grad_norm")):
        raise AssertionError(f"[mesh] {arch}: non-finite loss or grad "
                             f"norm: {rows}")
    if abs(rows[0]["loss"] - math.log(cfg.vocab_size)) > 2.0:
        raise AssertionError(f"[mesh] {arch}: first loss {rows[0]['loss']}")
    step_s = [r["step_s"] for r in rows[1:]]
    tokens = B * S
    out = {"layers": n, "mesh": (2, 2), "init_s": init_s,
           "warm_step_s": rows[0]["step_s"], "step_s": step_s,
           "tok_s": [tokens / t for t in step_s], "peak_gib": peak / 2**30,
           "losses": [r["loss"] for r in rows]}
    u = train["run"]
    log(f"[mesh] {arch} full width ({n} of {get_config(arch).n_layers} "
        f"layers), bf16 under fp32 masters, remat, on a (2, 2) mesh of "
        f"{dev} (FSDP blocks, tensor-parallel over 'model'; each DP row "
        f"{B // 2} x {S} in {nm} "
        f"microbatches): state placed in {init_s:.2f} s, warm step "
        f"{rows[0]['step_s']:.3f} s, then step s "
        f"{[round(t, 4) for t in step_s]} "
        f"({[round(t) for t in out['tok_s']]} tok/s; unsharded [train] "
        f"{[round(t, 4) for t in u['step_s']]} s); peak "
        f"{out['peak_gib']:.2f} GiB (unsharded {u['peak_gib']:.2f}); "
        f"losses {[round(v, 4) for v in out['losses']]}; {smi}")
    del state
    torch.cuda.empty_cache()
    return out


def phase_dryrun(proc, lm_began, run, smi, log):
    """The [dryrun] subprocess's results (phase 19), logged with when its
    walks ended against ``lm_began`` (the wall-clock start of [lm], or
    None when [lm] ran first); the walker's FLOPs of [mesh]'s timed
    step's shapes over its measured step time."""
    from repro_torch.launch.roofline import HBM_BW, NVLINK_BW, PEAK_FLOPS
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stdout, stderr = [f.seek(0) or f.read() for f in proc.files]
    for f in proc.files:
        f.close()
    if proc.returncode != 0:
        raise AssertionError(f"[dryrun] exited {proc.returncode}: "
                             f"{stderr[-3000:]}")
    res = json.loads(stdout.strip().splitlines()[-1])
    for shape in ("train_4k", "decode_32k"):
        r = res[shape]
        mem = r["mem"]
        colls = {k: v for k, v in r["collectives"].items() if v}
        log(f"[dryrun] {TRAIN_RUN[0]} x {shape} x single ((16, 16) meta "
            f"entries, the first entry of a DP row of {r['row_entries']} "
            f"walked, "
            f"{r['walk_s']:.1f} s): per device argument "
            f"{mem['argument'] / 2**30:.2f} GiB, temp "
            f"{mem['temp'] / 2**30:.2f} GiB; flops {r['hlo_flops']:.4e}, "
            f"bytes {r['hlo_bytes']:.4e}, collective bytes "
            f"{r['collective_bytes']:.4e} {json.dumps(colls)}; terms at the "
            f"H100's data-sheet rates ({PEAK_FLOPS:.4g} FLOP/s, "
            f"{HBM_BW:.3g} B/s, NVLink {NVLINK_BW:.3g} B/s): compute "
            f"{1e3 * r['compute_s']:.2f} ms, memory "
            f"{1e3 * r['memory_s']:.2f} ms, collective "
            f"{1e3 * r['collective_s']:.2f} ms -> {r['bottleneck']}-bound, "
            f"useful_ratio {r['useful_ratio']:.4f} (one entry's share: "
            f"its tensor-parallel slice of the row; the walk of the whole "
            f"row on one entry, before tensor parallelism: train_4k "
            f"5.0179e15 FLOP, decode_32k 3.4323e11)")
    t = res["timed_step"]
    step_s = float(np.median(run["step_s"]))
    waited_s = time.perf_counter() - t0
    before_lm = None if lm_began is None else lm_began - res["ended"]
    if before_lm is None:
        when = "ran after the card's phases"
    elif before_lm >= 0:
        when = f"ended {before_lm:.1f} s before [lm] began"
    else:
        when = f"ran {-before_lm:.1f} s into [lm]"
    log(f"[dryrun] the timed step's shapes ({TRAIN_RUN[0]}, "
        f"{TRAIN_RUN[1]} layers, {TRAIN_RUN[2]} x {TRAIN_RUN[3]}, every "
        f"row of a (2, 2) meta mesh; walked in {t['walk_s']:.1f} s): "
        f"{t['flops'] / 1e12:.1f} TFLOP of products over [mesh]'s "
        f"measured median step {step_s:.4f} s on the card = "
        f"{t['flops'] / step_s / 1e12:.1f} TFLOP/s ({smi}); "
        f"{t['hbm_bytes'] / 1e12:.2f} TB of op traffic, "
        f"{t['collective_bytes'] / 1e9:.2f} GB between entries; the walks "
        f"{when}; waited {waited_s:.1f} s for them")
    return {**res, "timed_step_tflop_s": t["flops"] / step_s / 1e12,
            "before_lm_s": before_lm}


def phase_mesh(torch, ops, dev, smi, lm, train, log):
    """The LM stack over a mesh of entries on the one card (phase 18):
    sequence-parallel serving at full size, the fp32 decode and training
    checks against the unsharded card, the elastic restore and the
    sharded training step at full width. Every check fails the run; the
    mesh paths reach none of K1-K7."""
    t_phase = time.perf_counter()
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("[mesh] fp32 products must not run in TF32")

    def paths():
        checks, state = _mesh_train_checks(torch, dev, log)
        saved = _mesh_save(state)
        serve = _mesh_serve(torch, dev, smi, lm, log)
        decode = _mesh_decode_check(torch, dev, log)
        t0 = time.perf_counter()
        recurrent = _mesh_recurrent_checks(torch, dev, log)
        recurrent["s"] = time.perf_counter() - t0
        restore = _mesh_restore(torch, dev, state, saved, log)
        del state
        torch.cuda.empty_cache()
        run = _mesh_train_full(torch, dev, smi, train, log)
        return {"serve": serve, "decode": decode, "checks": checks,
                "recurrent": recurrent, "restore": restore, "run": run}

    out, launches = _window(torch, ops, paths)
    if any(launches.values()):
        raise AssertionError(f"[mesh] the mesh paths launched a kernel of "
                             f"the port: {launches}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[mesh] the mesh paths launch none of K1-K7 (counts "
        f"{json.dumps(launches)}); phase {out['phase_s']:.1f} s")
    return out


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

    # job 2: ScalLoPS.search with each join (masks on; a capacity that
    # holds every pair and one that truncates), and a flip index's top-k
    from repro_torch.core.pipeline import ScalLoPS
    from repro_torch.index.service import topk_probe
    scfg = LSHConfig(k=3, T=13, f=32, d=2, scheme="splitmix")
    sl = ScalLoPS(scfg, device=dev)
    side = {}
    for name, ids, lens in (("r", *refs), ("q", data["query_ids"],
                                           data["query_lens"])):
        side[name] = (sl.signatures(ids, lens),
                      sl.feature_counts(ids, lens) > 0)
    (rs, rv), (qs, qv) = side["r"], side["q"]
    n_pairs = {}
    for join in ("flip", "band", "dense"):
        for mp in (1 << 14, 4):
            a, b = (ScalLoPS(replace(scfg, join_method=join),
                             device=w).search(
                qs.to(w), rs.to(w), max_pairs=mp, q_valid=qv.to(w),
                r_valid=rv.to(w)) for w in (dev, "cpu"))
            for what, x, y in zip(a._fields, a, b):
                if not torch.equal(x.cpu(), y):
                    raise AssertionError(f"ScalLoPS.search {join} at "
                                         f"max_pairs {mp}: card and CPU "
                                         f"differ in {what}")
            n_pairs[(join, mp)] = (int(b.count), bool(b.overflowed))
    tk = []
    for w in (dev, "cpu"):
        fidx = SignatureIndex(scfg, rs.cpu().numpy().view(np.uint32),
                              rv.cpu().numpy(), layout="flip", device=w)
        tk.append([x.cpu() if isinstance(x, torch.Tensor) else x
                   for x in topk_probe(fidx, qs.to(w), k=10, cap=4)])
    for x, y in zip(*tk):
        if not (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y):
            raise AssertionError("flip index topk_probe: card and CPU differ")
    log(f"[small] ScalLoPS.search, 64 queries x 2000 refs, f=32, d=2, with "
        f"masks: card == CPU twins for every join (pairs, count, "
        f"overflowed; (count, overflowed) by (join, max_pairs): {n_pairs}); "
        f"a flip index's topk_probe: card == CPU (cap reached {tk[0][2]})")

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
        # 4 shards on one device stack: the joins sharded, the score
        # waves split 4 ways; the same outputs as one shard
        for where in (dev, "cpu"):
            sh = all_pairs_search(c["ids"], c["lens"], replace(
                cfg, n_shards=4, devices=(where,) * 4))
            for what, x, y in (("pairs", sh.pairs, b.pairs),
                               ("scores", sh.scored.scores, b.scored.scores),
                               ("kept", sh.scored.kept, b.scored.kept),
                               ("pid", sh.scored.pid, b.scored.pid),
                               ("labels", sh.labels, b.labels)):
                if (x is None) != (y is None) or (
                        x is not None and not np.array_equal(x, y)):
                    raise AssertionError(f"all_pairs_search {label}, 4 "
                                         f"shards on {where}: {what} "
                                         f"differ from one shard's")
        log(f"[small] all_pairs_search, {label}, n_shards=4 with "
            f"devices=[device] * 4 on the card and on the CPU: the same "
            f"outputs as one shard")


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
    from repro_torch.obs import SENTINEL

    def log(msg):
        print(msg, flush=True)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    global SM_CLOCK_HZ
    SM_CLOCK_HZ = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    log(f"[build] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, max SM clock "
        f"{SM_CLOCK_HZ / 1e6:.0f} MHz")
    build_s = build.build_all()
    log(f"[build] nvcc sm_90a, {len(build.SOURCES)} sources in parallel: "
        f"{build_s:.2f} s")
    _log_ptxas(build, log)
    dryrun_proc = _dryrun_start()
    try:
        return _run_phases(torch, ops, SENTINEL, log, t_start, dev, smi,
                           dryrun_proc)
    finally:
        if dryrun_proc.poll() is None:
            dryrun_proc.kill()
            dryrun_proc.wait()


def _run_phases(torch, ops, SENTINEL, log, t_start, dev, smi, dryrun_proc):
    """Phases 2-19 (see the module docstring), then the closing lines."""

    ops.RECORDED = {}
    (index, serve_data, serve_probe), serve_l = _window(
        torch, ops, lambda: phase_serve(torch, ops, dev, log))
    log(f"[main] kernel launches on the serving path: "
        f"{json.dumps(serve_l)}")
    search_l, emission, mr_data, table_reads = phase_search(
        torch, ops, dev, index, serve_data, serve_probe, log)
    log(f"[main] kernel launches on the dense join's search_pairs (K6's "
        f"path): {json.dumps(search_l)}")
    # the serving tier records into dicts of its own (K7's first launch
    # stays the all-pairs one, and no kernel's record moves), replayed
    # against the twins at the shapes these paths gave the kernels
    main_record, ops.RECORDED = ops.RECORDED, {}
    shard, shard_l = _window(torch, ops, lambda: phase_shard(
        torch, ops, dev, index, serve_data, log))
    shard_rec, ops.RECORDED = ops.RECORDED, {}
    fleet, fleet_l = _window(torch, ops, lambda: phase_fleet(
        torch, ops, dev, index, serve_data, log))
    fleet_rec, ops.RECORDED = ops.RECORDED, main_record
    tier = _replay_tier(torch, (
        ("shard", shard_rec, ("wave_scores_linear", "wave_scores_affine",
                              "sw_rowwave")),
        ("fleet", fleet_rec, ("wave_scores_linear",))), log)
    del shard_rec, fleet_rec
    log(f"[main] kernel launches on the [shard] path: {json.dumps(shard_l)}; "
        f"on the [fleet] path: {json.dumps(fleet_l)}")
    log(f"[main] [shard] {json.dumps(shard)}; [fleet] {json.dumps(fleet)}")
    phase_cli(log)
    persist, persist_l = _window(torch, ops, lambda: phase_persist(
        torch, ops, dev, index, serve_data, serve_probe, log))
    log(f"[main] kernel launches on the [persist] path: "
        f"{json.dumps(persist_l)}")
    del index, serve_data, serve_probe
    siggen_l = phase_siggen(torch, ops, dev, log)
    # [quality] records into a dict of its own: K1's first launch at k=4
    # is kept apart from its k=3 record, and no kernel's record moves
    main_record, ops.RECORDED = ops.RECORDED, {}
    quality_l, quality = phase_quality(torch, ops, dev, log)
    k4_record = ops.RECORDED["siggen_accumulate"]
    ops.RECORDED = main_record
    log(f"[main] kernel launches on the [quality] paths (the matmul build, "
        f"the scoring): {json.dumps(quality_l)}")
    for path, counts, names in (
            ("[shard]", shard_l, ("wave_scores_linear",
                                  "wave_scores_affine", "sw_rowwave")),
            ("[fleet]", fleet_l, ("wave_scores_linear",)),
            ("[persist]", persist_l, ("hamming_dist", "wave_scores_linear",
                                      "wave_scores_affine", "table_sums")),
            ("[quality]", quality_l, ("siggen_accumulate", "sw_rowwave",
                                      "wave_scores_linear", "table_sums")),
            ("[serve] (the index build and serving)", serve_l,
             ("table_sums",))):
        missing = [k for k in names if counts.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {path} "
                                 f"path: {missing}")
    log(f"[main] [persist] {json.dumps(persist)}; [quality] "
        f"{json.dumps(quality)}")
    (index, res, corpus, pair_l, rowwave_l, full, real, stages,
     ing_index, ing) = phase_allpairs(torch, ops, dev, log)
    recorded, ops.RECORDED = ops.RECORDED, None
    phase_allpairs_cpu_join(index, res, log)
    mr_l, mr_rec = phase_mapreduce(torch, ops, dev, index, res, ing_index,
                                   ing, corpus, mr_data, log)
    del index, res, ing_index, ing, mr_data
    phase_join_routes(torch, corpus, dev, log)
    del corpus
    mr = _replay_tier(torch, (("mr", mr_rec, MR_REPLAYED),), log)
    del mr_rec
    # each kernel's count from its own path: K1 the matmul build, K2 and
    # K3 serving, K6 and table_sums the dense join's search_pairs, K4 and
    # K5 the timed all_pairs_search, K7 the row wave
    launches = {"siggen_accumulate": siggen_l["siggen_accumulate"],
                "hamming_count": search_l["hamming_count"],
                "table_sums": search_l["table_sums"]}
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

    # launches on the paths of the replayed waves: K4 and K3 the timed
    # all_pairs_search, K7 the row wave
    wave_l = {"ungapped_scores": pair_l["ungapped_scores"],
              "wave_scores_linear": pair_l["wave_scores_linear"],
              "sw_rowwave": rowwave_l["sw_rowwave"]}
    rows = phase_kernels(torch, recorded, full, real, stages, launches,
                         wave_l, emission, table_reads, log)
    rows.append(phase_kernel_k4(torch, k4_record,
                                quality_l["siggen_accumulate"], log))
    phase_small(torch, dev, log)
    wide = phase_wide(torch, ops, dev, log)
    log(f"[main] kernel launches on the [wide] paths: "
        f"{json.dumps(wide.pop('launches'))}")
    for row in rows:
        row.update(wide.get(row["name"], {}))
        if row["name"] in ("wave_scores_linear", "wave_scores_affine",
                           "sw_rowwave"):
            row["shard_launches"] = shard_l[row["name"]]
            row["fleet_launches"] = fleet_l[row["name"]]
        row.update(tier.get(row["name"], {}))
        if row["name"] in MR_REPLAYED:
            row["mr_launches"] = mr_l[row["name"]]
            row.update(mr.get(row["name"], {}))
    lm_began = time.time()
    lm = phase_lm(torch, ops, dev, smi, log)
    log(f"[main] [lm] {json.dumps(lm)}")
    train = phase_train(torch, ops, dev, smi, log)
    log(f"[main] [train] {json.dumps(train)}")
    mesh = phase_mesh(torch, ops, dev, smi, lm, train, log)
    log(f"[main] [mesh] {json.dumps(mesh)}")
    dryrun = phase_dryrun(dryrun_proc, lm_began, mesh["run"], smi, log)
    log(f"[main] [dryrun] {json.dumps(dryrun)}")
    log(f"[sentinel] builds by site: {json.dumps(SENTINEL.by_site())}")
    rebuilt = SENTINEL.recompiled()
    if rebuilt:
        raise AssertionError(f"[sentinel] keys built more than once: "
                             f"{rebuilt}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
