"""prep_queue_ms: the mean, over the window's batches, of the program's
``pipeline.queue`` span: from the loader's submit of the batch's prep to
a worker starting it (``DecodePipeline``; profiler's clock)."""

from benchmark.metrics import _program


def read(ctx):
    return _program.mean_a_batch(ctx, lambda n: n == "pipeline.queue", _program.ms)
