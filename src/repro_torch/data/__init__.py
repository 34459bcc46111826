"""Data substrate: synthetic protein sets with planted homology, FASTA
I/O, and the LM token pipeline with the paper's LSH as a dedup stage."""
from .synthetic import (FamilyCorpusConfig, SyntheticProteinConfig,
                        make_family_corpus, make_protein_sets, mutate)
from .fasta import read_fasta, write_fasta
from .lm_data import LMDataConfig, dedup_corpus, lm_batches

__all__ = ["SyntheticProteinConfig", "make_protein_sets", "mutate",
           "FamilyCorpusConfig", "make_family_corpus",
           "read_fasta", "write_fasta", "LMDataConfig", "lm_batches",
           "dedup_corpus"]
