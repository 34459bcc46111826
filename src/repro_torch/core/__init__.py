"""Job 1 of the search (shingles, neighbours, SimHash) and job 2 (Hamming
distance, the flip, band and dense joins, ``ScalLoPS.search``)."""
