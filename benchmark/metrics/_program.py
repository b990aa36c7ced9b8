"""Shared arithmetic of the readers of the program's own spans
(``zpix_tpu_torch.utils.profiling.spans()``; not a metric: no manifest
entry names it).  The program stamps its spans on the clock the profiler
stamps its host events with, so the traced window's bounds
(``ctx.win.trace.lo``, ``hi``) select them; each carries the loader's
batch id, the harness's global batch index, so they join the window's
batches.  A program that records no spans reads nothing."""


def by_batch(ctx, match):
    """The program's spans that ``match(name)`` accepts, started inside the
    traced window and serving a batch it delivered -> {batch: [span]};
    None where the run was not traced, the program records no spans, or
    its buffer dropped some (a mean would then hold the early batches
    alone)."""
    tr = ctx.win.trace
    if tr is None:
        return None
    from zpix_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    if read is None or profiling.metrics.spans_dropped:
        return None
    delivered = {a[3] for a in ctx.win.asks}
    out = {}
    for s in read():
        if match(s.name) and tr.lo <= s.start_ns < tr.hi and s.batch in delivered:
            out.setdefault(s.batch, []).append(s)
    return out


def mean_a_batch(ctx, match, value):
    """The mean, over the window's batches with such spans, of ``value``
    of each batch's spans; None where no batch has one."""
    found = by_batch(ctx, match)
    if not found:
        return None
    return sum(value(spans) for spans in found.values()) / len(found)


def ms(spans) -> float:
    """The spans' summed durations, in ms."""
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6
