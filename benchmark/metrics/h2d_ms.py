"""h2d_ms: the card's time in host-to-device copies inside the traced
window (``torch.profiler``'s "Memcpy HtoD" ops), in ms, over the window's
batches: ``PinnedUpload``'s copy of each batch's buffers."""


def read(ctx):
    tr = ctx.win.trace
    if tr is None or not ctx.win.asks:
        return None
    s = tr.op_seconds(lambda name: "HtoD" in name)
    return s * 1e3 / len(ctx.win.asks) if s > 0 else None
