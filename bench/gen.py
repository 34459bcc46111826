"""The benchmark's draws of proteins on the device from a seed: the
reference database of a configuration, and the pieces the traffic's
generators (``bench/generators/<name>.py``) build their query sets from.

Shapes follow the repository's synthetic datasets (``data/synthetic.py``):
residues drawn from the Swiss-Prot amino-acid composition, lengths from a
normal distribution truncated toward zero and held at 30 or more. Here
every draw is one large call on the device instead of a Python loop on the
host.

Lengths come from ``length_seed`` (a constant of the traffic or the
configuration), so every run seed gets the same multiset of sizes; the run
seed draws the residues, the parents, the substitutions and the order.
That keeps the work of a run the same from seed to seed.
"""
from __future__ import annotations

import numpy as np
import torch

PAD = 20                    # padding residue id; the alphabet has 20
# Swiss-Prot composition in the order ARNDCQEGHILKMFPSTWYV (a frozen copy of
# the repository's AA_FREQ)
AA_FREQ = (0.0826, 0.0553, 0.0406, 0.0546, 0.0137, 0.0393, 0.0674, 0.0708,
           0.0227, 0.0593, 0.0966, 0.0582, 0.0241, 0.0386, 0.0474, 0.0660,
           0.0535, 0.0110, 0.0292, 0.0687)
ROW_CHUNK = 1 << 16         # rows drawn per call: bounds the float temporaries


def generator(seed: int, stream: int, device) -> torch.Generator:
    """An independent generator for one use (``stream``) of a run seed."""
    word = np.random.SeedSequence([int(seed) % 2**64, int(stream)]
                                  ).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(word[0]) << 32 | int(word[1]))
    return g


def lengths(n: int, mean: float, sd: float, *, lo: int, hi: int | None,
            length_seed: int, order: torch.Generator, device) -> torch.Tensor:
    """(n,) int64 lengths: the multiset from ``length_seed``, permuted by
    ``order``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(length_seed))
    x = torch.normal(float(mean), float(sd), (n,), generator=g, device=device)
    L = x.to(torch.int64).clamp_min(lo)             # int() truncates to 0
    if hi is not None:
        L = L.clamp_max(hi)
    return L[torch.randperm(n, generator=order, device=device)]


def residues(n: int, width: int, g: torch.Generator, device) -> torch.Tensor:
    """(n, width) int8 residues drawn from the composition."""
    cdf = torch.cumsum(torch.tensor(AA_FREQ, dtype=torch.float64), 0)
    cdf = (cdf / cdf[-1]).to(torch.float32).to(device)
    out = torch.empty((n, width), dtype=torch.int8, device=device)
    for i in range(0, n, ROW_CHUNK):
        u = torch.rand((min(ROW_CHUNK, n - i), width), generator=g,
                       device=device)
        out[i:i + ROW_CHUNK] = torch.searchsorted(cdf, u, right=True).clamp_max(
            19).to(torch.int8)
    return out


def pad_past(ids: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Residues at or past each row's length become PAD (in place)."""
    pos = torch.arange(ids.shape[1], device=ids.device)
    return ids.masked_fill_(pos[None, :] >= lens[:, None], PAD)


def proteins(spec: dict, seed: int, stream: int, device):
    """A reference database: (ids (n, W) int8 PAD-padded, lens (n,) int64)
    on ``device``. ``spec``: n, len_mean, len_sd, min_len, length_seed."""
    g = generator(seed, stream, device)
    L = lengths(spec["n"], spec["len_mean"], spec["len_sd"],
                lo=spec["min_len"], hi=spec.get("max_len"),
                length_seed=spec["length_seed"], order=g, device=device)
    ids = residues(spec["n"], int(L.max()), g, device)
    return pad_past(ids, L), L
