"""prep_ms: the mean, over the window's batches, of the benchmark's span
around the decoder's ``prep`` (host clock; the loader's worker thread)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.mean_ms(ctx, "prep")
