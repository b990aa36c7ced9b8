"""Utilities: observability."""

from .profiling import Metrics, metrics, profile_trace, trace

__all__ = ["Metrics", "metrics", "profile_trace", "trace"]
