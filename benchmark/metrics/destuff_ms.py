"""destuff_ms: the mean, over the window's batches, of the program's
``<route>.prep.destuff`` spans of a batch summed: the FF00 destuffing of
each of its images in the host prep (``_destuff``)."""

from benchmark.metrics import _program


def read(ctx):
    return _program.mean_a_batch(ctx, lambda n: n.endswith(".prep.destuff"), _program.ms)
