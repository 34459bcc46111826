"""Alignment: Smith-Waterman scoring (row wave, kernel K7; wavefront,
kernel K3) with percent identity, and the BLAST-like seed-and-extend
baseline the paper compares against."""
from .smith_waterman import (batch_percent_identity, percent_identity,
                             sw_align_batch, sw_score, sw_scores_device)
from .gotoh import sw_wave_affine, sw_wave_linear
from .seed_extend import SeedExtendBaseline

__all__ = ["sw_align_batch", "sw_score", "sw_scores_device",
           "percent_identity", "batch_percent_identity",
           "sw_wave_linear", "sw_wave_affine", "SeedExtendBaseline"]
