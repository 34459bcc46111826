"""Spans and mergeable metrics for the serving path."""
from .registry import REGISTRY, Histogram
from .trace import TRACER, record, span

__all__ = ["REGISTRY", "Histogram", "TRACER", "record", "span"]
