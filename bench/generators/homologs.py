"""Query sets of homologs and decoys against the reference database, made
on the device from the run seed (``bench/gen.py`` draws).

The traffic's ``queries`` block: n, len_mean, len_sd, min_len, max_len,
length_seed, homolog_share. A homolog is a random reference, mutated by
the point-substitution channel at the planted rates (0.05, 0.15, 0.30 in
turn) and cut to a drawn length; a decoy is drawn from the composition.
``n_sets`` distinct sets are made, each in an order drawn from the seed.
"""
from __future__ import annotations

import torch

from bench import gen
from bench.deploy import Queries

SUB_RATES = (0.05, 0.15, 0.30)


def query_sets(traffic: dict, ref_ids, ref_lens, seed: int,
               device) -> list[Queries]:
    """The traffic's distinct query sets, on the host."""
    out = []
    for s in range(int(traffic["n_sets"])):
        ids, lens, _ = query_set(traffic["queries"], ref_ids, ref_lens, seed,
                                 1 + s, device)
        out.append(Queries(ids.cpu().numpy(),
                           lens.to(torch.int32).cpu().numpy()))
    return out


def query_set(spec: dict, ref_ids: torch.Tensor, ref_lens: torch.Tensor,
              seed: int, stream: int, device):
    """One query set: (ids (n, W) int8, lens (n,) int64, parent (n,) int64
    with -1 for decoys), on ``device``."""
    g = gen.generator(seed, stream, device)
    n = spec["n"]
    target = gen.lengths(n, spec["len_mean"], spec["len_sd"],
                         lo=spec["min_len"], hi=spec.get("max_len"),
                         length_seed=spec["length_seed"], order=g,
                         device=device)
    n_hom = int(round(n * spec["homolog_share"]))
    W = int(target.max())
    ids = gen.residues(n, W, g, device)              # decoys, and substitutes
    parent = torch.full((n,), -1, dtype=torch.int64, device=device)
    parent[:n_hom] = torch.randint(ref_ids.shape[0], (n_hom,), generator=g,
                                   device=device)
    lens = target.clone()
    for i in range(0, n_hom, gen.ROW_CHUNK):
        j = min(i + gen.ROW_CHUNK, n_hom)
        src = ref_ids[parent[i:j]]
        w = min(W, src.shape[1])
        rows = torch.full((j - i, W), gen.PAD, dtype=torch.int8,
                          device=device)
        rows[:, :w] = src[:, :w]
        rate = torch.tensor(SUB_RATES, device=device)[
            torch.arange(i, j, device=device) % len(SUB_RATES)]
        hit = torch.rand((j - i, W), generator=g, device=device) < rate[:, None]
        ids[i:j] = torch.where(hit, ids[i:j], rows)
        lens[i:j] = torch.minimum(target[i:j], ref_lens[parent[i:j]])
    order = torch.randperm(n, generator=g, device=device)
    ids, lens, parent = ids[order], lens[order], parent[order]
    return gen.pad_past(ids, lens), lens, parent
