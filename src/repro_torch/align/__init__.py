"""Smith-Waterman scoring for the serving re-rank."""
