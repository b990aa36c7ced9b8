"""upload_ms: the mean, over the window's batches, of the
benchmark's span around the decoder's ``upload`` (host clock; the
loader's calling thread): ``PinnedUpload``'s packing of the op streams
into a pinned buffer and the copy's issue."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.mean_ms(ctx, "upload")
