"""Job 1 of the search (shingles, neighbours, SimHash) and job 2 (Hamming
distance, the flip, band and dense joins, ``ScalLoPS.search``).

Public API: LSHConfig, ScalLoPS (pipeline.py); signature generation
(simhash.py); joins (join.py)."""
from .alphabet import (AMINO_ACIDS, ALPHABET_SIZE, PAD, BLOSUM62, encode,
                       decode, encode_batch)
from .pipeline import LSHConfig, ScalLoPS, SearchResult

__all__ = [
    "AMINO_ACIDS", "ALPHABET_SIZE", "PAD", "BLOSUM62",
    "encode", "decode", "encode_batch", "LSHConfig", "ScalLoPS",
    "SearchResult",
]
