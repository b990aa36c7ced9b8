"""Shared arithmetic of the span readers (not a metric: no manifest entry
names it)."""


def mean_ms(ctx, name: str):
    """The mean of the ``name`` spans that started in the window, in ms."""
    d = ctx.spans.durations(name, ctx.win.t0, ctx.win.t_end)
    return sum(d) / len(d) * 1e3 if d else None
