"""Amino-acid alphabet encoding and the BLOSUM62 substitution matrix.

Sequences are int8 tensors end-to-end (DESIGN.md §2: "no JVM strings
anywhere"); FASTA/strings exist only at the I/O edge.
"""
from __future__ import annotations

import numpy as np

# Canonical 20-letter amino-acid alphabet, in the standard BLOSUM row order.
AMINO_ACIDS = "ARNDCQEGHILKMFPSTWYV"
ALPHABET_SIZE = len(AMINO_ACIDS)  # 20
PAD = ALPHABET_SIZE               # padding token id (scores 0 everywhere)

_CHAR_TO_ID = {c: i for i, c in enumerate(AMINO_ACIDS)}

# BLOSUM62 (Henikoff & Henikoff 1992), 20x20, row/col order = AMINO_ACIDS.
# fmt: off
BLOSUM62 = np.array([
    #  A   R   N   D   C   Q   E   G   H   I   L   K   M   F   P   S   T   W   Y   V
    [  4, -1, -2, -2,  0, -1, -1,  0, -2, -1, -1, -1, -1, -2, -1,  1,  0, -3, -2,  0],  # A
    [ -1,  5,  0, -2, -3,  1,  0, -2,  0, -3, -2,  2, -1, -3, -2, -1, -1, -3, -2, -3],  # R
    [ -2,  0,  6,  1, -3,  0,  0,  0,  1, -3, -3,  0, -2, -3, -2,  1,  0, -4, -2, -3],  # N
    [ -2, -2,  1,  6, -3,  0,  2, -1, -1, -3, -4, -1, -3, -3, -1,  0, -1, -4, -3, -3],  # D
    [  0, -3, -3, -3,  9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1],  # C
    [ -1,  1,  0,  0, -3,  5,  2, -2,  0, -3, -2,  1,  0, -3, -1,  0, -1, -2, -1, -2],  # Q
    [ -1,  0,  0,  2, -4,  2,  5, -2,  0, -3, -3,  1, -2, -3, -1,  0, -1, -3, -2, -2],  # E
    [  0, -2,  0, -1, -3, -2, -2,  6, -2, -4, -4, -2, -3, -3, -2,  0, -2, -2, -3, -3],  # G
    [ -2,  0,  1, -1, -3,  0,  0, -2,  8, -3, -3, -1, -2, -1, -2, -1, -2, -2,  2, -3],  # H
    [ -1, -3, -3, -3, -1, -3, -3, -4, -3,  4,  2, -3,  1,  0, -3, -2, -1, -3, -1,  3],  # I
    [ -1, -2, -3, -4, -1, -2, -3, -4, -3,  2,  4, -2,  2,  0, -3, -2, -1, -2, -1,  1],  # L
    [ -1,  2,  0, -1, -3,  1,  1, -2, -1, -3, -2,  5, -1, -3, -1,  0, -1, -3, -2, -2],  # K
    [ -1, -1, -2, -3, -1,  0, -2, -3, -2,  1,  2, -1,  5,  0, -2, -1, -1, -1, -1,  1],  # M
    [ -2, -3, -3, -3, -2, -3, -3, -3, -1,  0,  0, -3,  0,  6, -4, -2, -2,  1,  3, -1],  # F
    [ -1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4,  7, -1, -1, -4, -3, -2],  # P
    [  1, -1,  1,  0, -1,  0,  0,  0, -1, -2, -2,  0, -1, -2, -1,  4,  1, -3, -2, -2],  # S
    [  0, -1,  0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1,  1,  5, -2, -2,  0],  # T
    [ -3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1,  1, -4, -3, -2, 11,  2, -3],  # W
    [ -2, -2, -2, -3, -2, -1, -2, -3,  2, -1, -1, -2, -1,  3, -3, -2, -2,  2,  7, -2],  # Y
    [  0, -3, -3, -3, -1, -2, -2, -3, -3,  3,  1, -2,  1, -1, -2, -2,  0, -3, -2,  4],  # V
], dtype=np.int32)
# fmt: on

# Padded variant: row/col PAD scores 0 so padded positions never contribute.
BLOSUM62_PADDED = np.zeros((ALPHABET_SIZE + 1, ALPHABET_SIZE + 1), dtype=np.int32)
BLOSUM62_PADDED[:ALPHABET_SIZE, :ALPHABET_SIZE] = BLOSUM62


def encode(seq: str) -> np.ndarray:
    """Encode an amino-acid string to an int8 id array (unknowns -> PAD)."""
    return np.array([_CHAR_TO_ID.get(c, PAD) for c in seq.upper()], dtype=np.int8)


def decode(ids) -> str:
    """Decode an id array back to a string (PAD -> 'X')."""
    out = []
    for i in np.asarray(ids).ravel():
        out.append(AMINO_ACIDS[int(i)] if 0 <= int(i) < ALPHABET_SIZE else "X")
    return "".join(out)


def encode_batch(seqs: list[str], max_len: int | None = None):
    """Encode a ragged batch -> (ids (N, L) int8 padded with PAD, lengths (N,))."""
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    L = int(max_len if max_len is not None else (lens.max() if len(seqs) else 0))
    ids = np.full((len(seqs), L), PAD, dtype=np.int8)
    for i, s in enumerate(seqs):
        e = encode(s)[:L]
        ids[i, : len(e)] = e
    return ids, np.minimum(lens, L)
