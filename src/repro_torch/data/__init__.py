"""Synthetic protein corpora with planted homology, and FASTA I/O."""
from .synthetic import (FamilyCorpusConfig, SyntheticProteinConfig,
                        make_family_corpus, make_protein_sets, mutate)
from .fasta import read_fasta, write_fasta

__all__ = ["SyntheticProteinConfig", "make_protein_sets", "mutate",
           "FamilyCorpusConfig", "make_family_corpus",
           "read_fasta", "write_fasta"]
