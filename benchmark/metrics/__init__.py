"""Metric readers, one a measurement: ``<name>.py`` with ``read(ctx)``.
A metric of ``BENCHMARK.json`` is read by the file of its name up to the
first dot (``harness.metric_reader``): ``prep_ms.jpeg_sync`` by
``prep_ms.py``."""
