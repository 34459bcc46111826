"""Minimal FASTA I/O (strings live only at this edge; everything inside the
framework is int8 arrays). A copy of ``repro/data/fasta.py``."""
from __future__ import annotations

import numpy as np

from ..core.alphabet import decode, encode_batch


def read_fasta(path) -> tuple[list[str], list[str]]:
    """Returns (names, sequences)."""
    names, seqs, cur = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                    cur = []
                names.append(line[1:].split()[0])
            else:
                cur.append(line)
    if cur:
        seqs.append("".join(cur))
    return names, seqs


def write_fasta(path, names, ids, lens) -> None:
    with open(path, "w") as f:
        for i, name in enumerate(names):
            f.write(f">{name}\n{decode(np.asarray(ids[i])[:int(lens[i])])}\n")


def load_fasta_encoded(path, max_len: int | None = None):
    """(names, ids (N, L) int8 PAD-padded, lens (N,) int32)."""
    names, seqs = read_fasta(path)
    ids, lens = encode_batch(seqs, max_len)
    return names, ids, lens
