"""Synthetic protein corpora with planted homology."""
