"""LM token pipeline with the paper's LSH as a first-class dedup stage —
the port of ``repro/data/lm_data.py``.

Token documents are sketched with the same signature machinery as
protein sequences — k-shingles of tokens, splitmix hyperplanes, Hamming
join (the port's own ``core/join.py::band_join``) — and near-duplicate
documents (distance <= d) are dropped before batching. The batch
iterator is a *stateless* function of (seed, step, shard): a restarted
worker re-joins at a step boundary with identical data order.

uint32 arithmetic runs in int64 holding the unsigned value, masked to 32
bits after each step; the splitmix products (32 x 32 bits) go through
the split multiply ``core/join.py::_mul32``, so signatures are bit-exact
against the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.join import _M32, _mul32, band_join
from ..core.simhash import pack_bits
from ..util import resolve_device


@dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    dedup: bool = True
    # Calibration (see tests): a mutation rate m changes ~m*L*k of ~L
    # shingle features; expected signature distance ≈ f·acos(1-k·m)/π.
    # With k=4, f=128: 2%-mutated twins land at E[dist]≈16 (σ≈3.8) while
    # unrelated docs sit at f/2=64 (σ≈5.7) — d=28 splits them by >6σ.
    dedup_k: int = 4        # token-shingle length
    dedup_f: int = 128      # signature bits
    dedup_d: int = 28       # Hamming threshold


def _splitmix(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``_splitmix_jnp``: a 32-bit splitmix finalizer over
    uint32 values held in int64."""
    x = (x + 0x9E3779B9) & _M32
    z = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    z = _mul32(z ^ (z >> 13), 0xC2B2AE35)
    return z ^ (z >> 16)


def token_signatures(tokens, lengths, *, k: int = 8, f: int = 64,
                     device=None) -> torch.Tensor:
    """SimHash over token k-shingles, unit weights, hash-derived
    hyperplanes.

    tokens: (N, L) int; PAD = -1. Returns (N, f//32) int32 words (the
    port's signature layout: the reference's uint32 bits). The feature
    set is the shingle multiset itself (Manku et al.'s document regime).
    """
    dev = resolve_device(device)
    t = torch.as_tensor(np.asarray(tokens)).to(dev, torch.int64) & _M32
    lens = torch.as_tensor(np.asarray(lengths)).to(dev, torch.int64)
    N, L = t.shape
    S = L - k + 1
    pos = torch.arange(S, device=dev)
    sh = t[:, pos[:, None] + torch.arange(k, device=dev)[None, :]]
    valid = (pos[None, :] + k) <= lens[:, None]               # (N, S)
    # rolling polynomial hash of each shingle, mod 2^32
    h = torch.zeros((N, S), dtype=torch.int64, device=dev)
    for i in range(k):
        h = (h * 1000003 + sh[:, :, i]) & _M32
    shifts = torch.arange(32, device=dev)
    Vs = []
    for w in range(f // 32):
        hw = _splitmix(h ^ ((w * 0x9E3779B9) & _M32))
        pm = ((hw[..., None] >> shifts) & 1) * 2 - 1          # (N, S, 32)
        Vs.append((pm * valid[..., None]).sum(dim=1))          # (N, 32)
    return pack_bits(torch.cat(Vs, dim=-1) >= 0)


def dedup_corpus(tokens, lengths, *, k: int = 4, f: int = 128, d: int = 28,
                 max_pairs: int = 1 << 16, device=None):
    """Drop near-duplicate documents: returns (keep_mask (N,) bool numpy,
    n_dups).

    Self-join of the corpus signatures; for every duplicate pair the
    higher index is dropped (first occurrence wins — deterministic). A
    truncated join would silently keep real duplicates, so the capacity
    doubles until the join fits.
    """
    sigs = token_signatures(tokens, lengths, k=k, f=f, device=device)
    while True:
        pairs, count, truncated = band_join(sigs, sigs, f=f, d=d,
                                            max_pairs=max_pairs)
        if not (bool(truncated) or int(count) > max_pairs):
            break
        max_pairs *= 2
    p = pairs.cpu().numpy()
    keep = np.ones(sigs.shape[0], bool)
    later = (p[:, 0] >= 0) & (p[:, 1] > p[:, 0])
    keep[p[later, 1]] = False          # drop the later twin
    return keep, int((~keep).sum())


def synth_corpus(cfg: LMDataConfig, n_docs: int, dup_fraction: float = 0.1):
    """Synthetic token corpus with planted near-duplicates (mutation rate
    2%); numpy, so the same arrays as the reference's."""
    rng = np.random.default_rng(cfg.seed)
    docs = rng.integers(0, cfg.vocab_size, (n_docs, cfg.seq_len), np.int32)
    n_dup = int(n_docs * dup_fraction)
    for i in range(n_dup):
        src = int(rng.integers(n_docs - n_dup))
        twin = docs[src].copy()
        flips = rng.random(cfg.seq_len) < 0.02
        twin[flips] = rng.integers(0, cfg.vocab_size, int(flips.sum()))
        docs[n_docs - n_dup + i] = twin
    lens = np.full(n_docs, cfg.seq_len, np.int32)
    return docs, lens


def batch_generator(*seeds: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of numbers (numpy's
    ``SeedSequence`` mixes them), so the draws are the same whichever
    device the result is moved to."""
    s = int(np.random.SeedSequence(list(seeds)).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(s)


def lm_batches(cfg: LMDataConfig, step: int, *, shard: int = 0,
               n_shards: int = 1, device=None):
    """Stateless batch for ``step``: (tokens, targets) int32 (per-shard
    slice), targets the tokens shifted by one.

    Deterministic in (cfg.seed, step, shard) — a restarted worker
    regenerates exactly the batch it would have seen. The draws are
    torch's (a CPU generator seeded from those three numbers), not
    ``jax.random``'s, as ``init_params`` draws torch's numbers.
    """
    per_shard = cfg.global_batch // n_shards
    toks = torch.randint(0, cfg.vocab_size, (per_shard, cfg.seq_len + 1),
                         generator=batch_generator(cfg.seed, step, shard),
                         dtype=torch.int32).to(resolve_device(device))
    return toks[:, :-1], toks[:, 1:]
