"""idle_pack_ms: the card's idle time inside the caller's ``upload.pack``
spans (``PinnedUpload``'s packing copy), over the window's batches, in
ms: the idle gaps of the traced window (``devtrace.busy_and_gaps`` over
the card's ops) intersected with the program's spans on the profiler's
clock.  Nothing where the card ran no op."""

from benchmark import devtrace
from benchmark.metrics import _program


def read(ctx):
    tr = ctx.win.trace
    found = _program.by_batch(ctx, lambda n: n == "upload.pack")
    if not found or not tr.dev:
        return None
    gaps = devtrace.busy_and_gaps(tr.dev, tr.lo, tr.hi)[1]
    packs = sorted((s.start_ns, s.end_ns) for spans in found.values() for s in spans)
    idle, i = 0, 0
    for a, b in packs:  # both sorted and each free of overlaps
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            idle += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
    return idle / 1e6 / len(ctx.win.asks)
