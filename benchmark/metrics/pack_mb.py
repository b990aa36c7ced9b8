"""pack_mb: the mean, over the window's batches, of the bytes
``PinnedUpload`` packed into its pinned buffer on the caller's thread (the
``packed_bytes`` of the program's ``upload.pack`` spans; 0 where a prep
staged its arrays there itself), in MB (1e6 bytes)."""

from benchmark.metrics import _program


def read(ctx):
    return _program.mean_a_batch(
        ctx, lambda n: n == "upload.pack",
        lambda spans: sum(s.counts.get("packed_bytes", 0) for s in spans) / 1e6)
