"""Job 1 of the search (shingles, neighbours, SimHash) and the pieces of
job 2 the serving path needs (Hamming distance, band keys)."""
