"""Utilities: observability."""

from .profiling import (Metrics, Span, metrics, profile_trace, recording, span, spans, stage,
                        trace)

__all__ = ["Metrics", "Span", "metrics", "profile_trace", "recording", "span", "spans", "stage",
           "trace"]
